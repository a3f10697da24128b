"""Tensor-checksum algebra (paper §4.1), the fold definitions shared by the
fused paged-attention kernel, its plain PyTorch version and the paged cache.

Given a fold with ``g = width // s`` segments:

  ``fold1(X)[i, j] = sum_l X[i, j + s*l]``              (weights r1 = 1)
  ``fold2(X)[i, j] = sum_l (l+1) * X[i, j + s*l]``      (weights r2 = l+1)

For ``S = Q @ K^T``, ``fold1(S) = Q @ encode_kv(K).c1^T``: checksums of the
inputs predict folds of the output, and a mismatch localizes and corrects a
single error per (row, fold column). Resident KV blocks carry an
``encode_kv`` pair written on append and re-folded at read time.

Every fold accumulates in float32; checksums stored beside data are rounded
ONCE to the storage dtype, exactly as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAPER_STRIDE = 8     # SM80 MMA atom N-dim (paper fidelity)
TPU_STRIDE = 128     # the JAX package's default maximum stride


def _check_fold(width: int, stride: int) -> int:
    if width % stride != 0:
        raise ValueError(f"fold width {width} not divisible by stride {stride}")
    return width // stride


def fold1(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Unweighted strided fold along the last dim: (..., W) -> (..., stride)."""
    g = _check_fold(x.shape[-1], stride)
    return x.reshape(*x.shape[:-1], g, stride).sum(dim=-2)


def fold2(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Index-weighted strided fold along the last dim (weights l+1)."""
    g = _check_fold(x.shape[-1], stride)
    w = torch.arange(1, g + 1, dtype=x.dtype, device=x.device)
    return (x.reshape(*x.shape[:-1], g, stride) * w[:, None]).sum(dim=-2)


class Checksums(NamedTuple):
    """Pair of fold checksums (unweighted, index-weighted) of one operand."""

    c1: torch.Tensor
    c2: torch.Tensor


def encode_kv(x: torch.Tensor, stride: int) -> Checksums:
    """Checksums of K or V blocks (..., Bs, d) folded along the block's token
    axis (-2): returns (..., stride, d) planes. f32 accumulation, one
    rounding to ``x``'s dtype."""
    g = _check_fold(x.shape[-2], stride)
    xr = x.float().reshape(*x.shape[:-2], g, stride, x.shape[-1])
    c1 = xr.sum(dim=-3)
    w = torch.arange(1, g + 1, dtype=torch.float32, device=x.device)
    c2 = (xr * w[:, None, None]).sum(dim=-3)
    return Checksums(c1.to(x.dtype), c2.to(x.dtype))


def encode_kv_tile(x: torch.Tensor, stride: int) -> Checksums:
    """:func:`encode_kv` as the fused kernel computes it on one streamed
    (Bs, d) tile: f32 segments accumulated in order from zero, weights
    ``l + 1``, left in float32 (the kernel compares it, never stores it)."""
    g = _check_fold(x.shape[-2], stride)
    c1 = torch.zeros(x.shape[:-2] + (stride, x.shape[-1]), dtype=torch.float32,
                     device=x.device)
    c2 = torch.zeros_like(c1)
    for l in range(g):
        seg = x[..., l * stride:(l + 1) * stride, :].float()
        c1 = c1 + seg
        c2 = c2 + float(l + 1) * seg
    return Checksums(c1, c2)


def kv_block_threshold(dtype) -> float:
    """Relative threshold for resident-KV block verification: 1e-3 in f32,
    5e-2 for 16-bit storage (one rounding leaves ~2^-8 relative error)."""
    return 1e-3 if dtype == torch.float32 else 5e-2


def block_fold_bad(fresh: Checksums, stored: Checksums, *,
                   threshold: float) -> torch.Tensor:
    """Compare a freshly recomputed fold pair against the resident pair.

    ``fresh``/``stored``: (..., stride, d) planes. Returns ``bad`` bool
    (...,) per block. The relative threshold carries a per-block magnitude
    floor (mean |c|); the negated ``<=`` form makes NaN/inf deltas count as
    mismatches. The single definition of "block checksum mismatch", shared
    by the append-time guard and the fused kernel.
    """
    c1 = stored.c1.float()
    c2 = stored.c2.float()
    floor1 = torch.clamp(c1.abs().mean(dim=(-2, -1), keepdim=True), min=1e-6)
    floor2 = torch.clamp(c2.abs().mean(dim=(-2, -1), keepdim=True), min=1e-6)
    ok1 = (c1 - fresh.c1.float()).abs() <= threshold * torch.maximum(c1.abs(),
                                                                    floor1)
    ok2 = (c2 - fresh.c2.float()).abs() <= threshold * torch.maximum(c2.abs(),
                                                                    floor2)
    return ~(ok1 & ok2).flatten(-2).all(dim=-1)


def verify_block(x: torch.Tensor, checks: Checksums, stride: int, *,
                 threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrity check of stored KV blocks (..., Bs, d) against their
    resident checksums (..., stride, d). Returns (``bad`` bool (...,),
    total mismatch count)."""
    fresh = encode_kv(x.float(), stride)
    bad = block_fold_bad(fresh, checks, threshold=threshold)
    return bad, bad.sum(dtype=torch.int32)
