"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/lib<name>.so`` at
the root of the checkout, then loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. A library is rebuilt when its source is newer.
Nothing is built at import time; the first launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under ``csrc``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled on the machine that has the GPU")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _command(name: str, out: Path, extra: Sequence[str]) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, *extra, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def start_build(name: str, extra: Sequence[str] = ()) -> subprocess.Popen:
    """Start ``nvcc`` for one source without waiting; finish with
    :func:`finish_build`. Used to compile every source in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(_command(name, Path(tmp), extra),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.repro_name = name
    proc.repro_tmp = tmp
    return proc


def finish_build(proc: subprocess.Popen) -> str:
    """Wait for a build started by :func:`start_build`; install the library
    and return the compiler's output, or raise with it."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(proc.repro_tmp)
        raise RuntimeError(f"nvcc failed for {proc.repro_name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.repro_tmp, library_path(proc.repro_name))
    return log


def build(name: str, extra: Sequence[str] = ()) -> str:
    return finish_build(start_build(name, extra))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if it is
    missing or older than its source or a shared ``csrc/*.cuh`` header."""
    if name in _loaded:
        return _loaded[name]
    lib = library_path(name)
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    if not lib.exists() or lib.stat().st_mtime < newest:
        build(name)
    _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]
