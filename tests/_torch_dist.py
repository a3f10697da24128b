"""A harness that runs ``torch.distributed`` ranks for the CPU tests
without putting the pytest worker at risk.

* Each rank is ``subprocess.Popen([sys.executable, "-c", ...])`` with
  ``PYTHONPATH=src``: no ``fork`` and no ``torch.multiprocessing`` inside
  a worker that may have loaded JAX.
* The ranks meet through ``init_method="file://<tmp>/store"``, never a
  fixed TCP port (workers running side by side would collide).
* ``init_process_group`` has a timeout, the wait for the ranks has a
  deadline, and ``try``/``finally`` kills every rank still running: a rank
  that fails takes the others down at once instead of leaving them in a
  collective.
* Each rank runs one thread (``OMP_NUM_THREADS=1``,
  ``torch.set_num_threads(1)``) and prints one JSON line last, which the
  test reads. At most 4 ranks a launch.

Importing this module starts nothing and imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MAX_RANKS = 4

PRELUDE = """\
import datetime, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK,
                        world_size=WORLD,
                        timeout=datetime.timedelta(seconds={pg_timeout}))
"""


def launch(code: str, world: int, tmp_path: Path, *, timeout: float = 120,
           pg_timeout: int = 60, args=()):
    """Start ``world`` ranks running ``code`` after the prelude (``RANK``,
    ``WORLD``, an initialised default group; ``sys.argv[4:]`` are
    ``args``). Returns their last JSON lines, by rank. Raises
    AssertionError (with the rank's stderr) if a rank fails or the
    deadline passes."""
    if not 1 <= world <= MAX_RANKS:
        raise ValueError(f"1 to {MAX_RANKS} ranks a launch, not {world}")
    tmp_path.mkdir(parents=True, exist_ok=True)
    store = tmp_path / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    script = PRELUDE.format(pg_timeout=pg_timeout) + code
    procs, logs = [], []
    try:
        for r in range(world):
            out = open(tmp_path / f"rank{r}.out", "w+")
            err = open(tmp_path / f"rank{r}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(world),
                 str(store), *map(str, args)],
                stdout=out, stderr=err, env=env, cwd=str(REPO)))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks ran past {timeout} s:\n"
                                     + _tails(logs))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() != 0]
        if failed:
            raise AssertionError(f"rank(s) {failed} failed:\n" + _tails(logs))
        results = []
        for out, _ in logs:
            out.seek(0)
            lines = [ln for ln in out.read().splitlines() if ln.strip()]
            results.append(json.loads(lines[-1]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for out, err in logs:
            out.close()
            err.close()


def _tails(logs) -> str:
    parts = []
    for r, (_, err) in enumerate(logs):
        err.seek(0)
        parts.append(f"--- rank {r} stderr ---\n{err.read()[-3000:]}")
    return "\n".join(parts)
