"""What ``tools/b1_phase_split.py`` and ``tools/b2_phase_split.py`` share:
building a kernel library with its phase clocks on and timing a launch
phase by phase.

``build`` compiles ``csrc/<name>.cu`` with ``-DEFTA_PHASE_CLOCKS`` (see
``csrc/efta_common.cuh``: thread 0 of every thread block adds the
``clock64()`` cycles between the kernel's phase marks) into
``build/repro_torch/phase/`` and makes this process's wrapper launch that
build. ``split`` runs a launch, then times ``reps`` more with CUDA events
and prints one JSON line: the tiling and layout, the cycles and share of
each phase, and the launch's time with the clocks on.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Callable, Sequence


def build(name: str, bind: Callable, defines: Sequence[str] = ()
          ) -> Callable[[], list]:
    """Build and install the clocked ``csrc/<name>.cu`` (``defines``: more
    ``-D`` options) and return a function that reads the 16 phase sums and
    zeroes them. Raises RuntimeError with the compiler's output if the
    build fails."""
    from repro_torch.kernels import _build
    tag = "".join("_" + d.removeprefix("-D").lower() for d in defines)
    out = _build.BUILD_DIR / "phase" / f"lib{name}{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        _build._command(name, out, ["-DEFTA_PHASE_CLOCKS", *defines]),
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = bind(ctypes.CDLL(str(out)))
    read = getattr(lib, f"{name}_phase_clocks")
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    _build._loaded[name] = lib  # this process launches it

    def clocks() -> list:
        buf = (ctypes.c_ulonglong * 16)()
        rc = read(buf)   # read, then zeroed
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks: CUDA error {rc}")
        return list(buf)

    return clocks


def split(torch, what: str, regime: str, call: Callable[[], object],
          clocks: Callable[[], list], phases: Sequence[str], reps: int,
          tiling, out: str = "") -> None:
    """One warm launch, then ``reps`` timed; print the regime's JSON line
    (and append it to ``out``)."""
    call()
    torch.cuda.synchronize()
    clocks()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        call()
    ev[1].record()
    torch.cuda.synchronize()
    cyc = clocks()[:len(phases)]
    line = json.dumps({
        "what": what, "regime": regime,
        "device": torch.cuda.get_device_name(0),
        "tiling": tiling._asdict(), "layout": tiling.layout,
        "clocked_ms": ev[0].elapsed_time(ev[1]) / reps,
        "cycles": dict(zip(phases, cyc)),
        "share": {p: c / max(sum(cyc), 1) for p, c in zip(phases, cyc)}})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
