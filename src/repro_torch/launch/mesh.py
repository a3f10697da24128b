"""Production mesh construction over the ranks of the default process
group (the JAX package's ``launch/mesh.py``): 16x16 = 256 ranks per pod;
2x16x16 = two pods. Scaling past two pods appends to the leading ``pod``
axis (pure DP/FSDP across pods: only gradient syncs cross pods).
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {world}: launch {n} "
            f"processes (torchrun --nproc-per-node ... --nnodes ...)")
    return Mesh(shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    return Mesh(shape, axes)
