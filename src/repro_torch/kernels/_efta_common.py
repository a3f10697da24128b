"""What the two fused EFTA kernels' wrappers share: the plain PyTorch
versions of the EFTA tile helpers (the JAX package keeps them in
``kernels/efta_attention.py``; in CUDA each is a device loop of
``csrc/efta_paged.cu`` / ``csrc/efta_attention.cu``), which act on tiles
with any number of leading batch dimensions, folding the last dimension,
and the codes both C entry points take."""
from __future__ import annotations

import numpy as np
import torch

NO_WINDOW = 1 << 30     # "global attention" sentinel for the window scalar
MODES = {"off": 0, "detect": 1, "correct": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def as_descriptor(fault) -> list:
    """An int32[8] fault descriptor (None = no fault) as 8 Python ints."""
    if fault is None:
        return [0] * 8
    if isinstance(fault, torch.Tensor):
        fault = fault.tolist()
    desc = [int(x) for x in np.asarray(fault).reshape(-1)]
    if len(desc) != 8:
        raise ValueError("fault descriptor must hold 8 ints")
    return desc


def _bitmask(bit: int) -> int:
    """int32 value with only ``bit`` set (bit 31 is the sign bit)."""
    return -(1 << 31) if bit == 31 else (1 << bit)


def _flip(tile: torch.Tensor, *, on: bool, index: tuple, bit: int
          ) -> torch.Tensor:
    """XOR one bit of the f32 ``tile[index]`` when ``on``; a coordinate out
    of range (or a bit outside 0..31) flips nothing, as in the kernel.
    Returns a new tensor; the input is left as it was."""
    if not on or not 0 <= bit < 32:
        return tile
    if any(not 0 <= i < n for i, n in zip(index, tile.shape)):
        return tile
    out = tile.clone()
    cell = out[index[:-1]][index[-1]:index[-1] + 1]
    cell.view(torch.int32).bitwise_xor_(_bitmask(bit))
    return out


def _fold_slices(tile: torch.Tensor, stride: int, weighted: bool
                 ) -> torch.Tensor:
    """Strided fold of the last dim, (..., W) -> (..., stride), summed in
    segment order from zero in f32."""
    g = tile.shape[-1] // stride
    acc = torch.zeros(tile.shape[:-1] + (stride,), dtype=torch.float32,
                      device=tile.device)
    for l in range(g):
        seg = tile[..., l * stride:(l + 1) * stride].float()
        acc = acc + (float(l + 1) * seg if weighted else seg)
    return acc


def _fold_prod(tile: torch.Tensor, stride: int) -> torch.Tensor:
    g = tile.shape[-1] // stride
    acc = torch.ones(tile.shape[:-1] + (stride,), dtype=torch.float32,
                     device=tile.device)
    for l in range(g):
        acc = acc * tile[..., l * stride:(l + 1) * stride].float()
    return acc


def _correct_strided(tile: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                     bad: torch.Tensor, stride: int) -> torch.Tensor:
    """Locate (segment l* from the weighted/unweighted delta ratio) and add
    the delta back — paper §4.1 correction, per fold segment."""
    g = tile.shape[-1] // stride
    safe = torch.where(bad, d1, torch.ones_like(d1))
    l_star = torch.clamp(torch.round(d2 / safe) - 1, 0, g - 1).to(torch.int32)
    out = tile.clone()
    for l in range(g):
        patch = torch.where(bad & (l_star == l), d1, torch.zeros_like(d1))
        out[..., l * stride:(l + 1) * stride] = \
            out[..., l * stride:(l + 1) * stride] + patch
    return out
