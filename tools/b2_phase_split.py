"""Where kernel B2's cluster layout spends its time at deepseek-coder-33b's
32k prefill launch (56 query heads of 128 on 8 KV heads, 32,768 tokens,
causal, block_kv 2,048, bf16, correct mode), phase by phase, on the card.

    PYTHONPATH=src python tools/b2_phase_split.py [--out FILE]

Builds ``csrc/efta_attention.cu`` with ``-DEFTA_PHASE_CLOCKS`` into
``build/repro_torch/phase/`` (thread 0 of every CTA adds the ``clock64()``
cycles between the kernel's phase marks) and makes this process's wrapper
launch that build. Then it launches B2 on random inputs (seed 0) and
prints one JSON line: the tiling, the cycles and share of each phase, and
the launch's CUDA-event time with the clocks on. Thread 0 sits in the
first row group, so a row phase's share is that group's, and waits for
the other groups land in the next phase that ends in a barrier. Needs the
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

PHASES = ("setup", "K pass: GEMM I, K folds", "fold check", "max",
          "EXP, rowsum", "V pass: GEMM II, V and O checksums", "block tail",
          "finalize", "cluster waits", "K-chunk waits", "V-chunk waits",
          "V checksums", "O-checksum products")
HEADS, KV_HEADS, SEQ, DIM, BLOCK_KV, REPS = 56, 8, 32768, 128, 2048, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="append the JSON line here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("b2_phase_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import efta_attention as ea

    out = _build.BUILD_DIR / "phase" / "libefta_attention.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        _build._command("efta_attention", out, ["-DEFTA_PHASE_CLOCKS"]),
        capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ea.bind(ctypes.CDLL(str(out)))
    lib.efta_attention_phase_clocks.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.efta_attention_phase_clocks.restype = ctypes.c_int
    _build._loaded["efta_attention"] = lib  # this process launches it

    def clocks() -> list:
        buf = (ctypes.c_ulonglong * 16)()
        rc = lib.efta_attention_phase_clocks(buf)   # read, then zeroed
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks: CUDA error {rc}")
        return list(buf)[:len(PHASES)]

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, h, SEQ, DIM), generator=g)
               .to("cuda", torch.bfloat16)
               for h in (HEADS, KV_HEADS, KV_HEADS))
    cfg = EFTAConfig(mode="correct", block_kv=BLOCK_KV)

    def call():
        return ea.efta_attention(q, k, v, cfg=cfg, causal=True)

    call()
    torch.cuda.synchronize()
    clocks()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(REPS):
        call()
    ev[1].record()
    torch.cuda.synchronize()
    cyc = clocks()
    t = ea.kernel_tiling(1, 128, BLOCK_KV, DIM, cfg.kv_stride(BLOCK_KV),
                         cfg.out_stride(DIM))
    line = json.dumps({
        "what": "b2_phase_split", "device": torch.cuda.get_device_name(0),
        "tiling": t._asdict(), "layout": t.layout,
        "clocked_ms": ev[0].elapsed_time(ev[1]) / REPS,
        "cycles": dict(zip(PHASES, cyc)),
        "share": {p: c / sum(cyc) for p, c in zip(PHASES, cyc)}})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
