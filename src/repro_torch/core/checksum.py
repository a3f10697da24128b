"""Tensor-checksum algebra (paper §4.1), the fold definitions shared by the
fused paged-attention kernel, its plain PyTorch version and the paged cache.

Given a fold with ``g = width // s`` segments:

  ``fold1(X)[i, j] = sum_l X[i, j + s*l]``              (weights r1 = 1)
  ``fold2(X)[i, j] = sum_l (l+1) * X[i, j + s*l]``      (weights r2 = l+1)

For ``S = Q @ K^T``, ``fold1(S) = Q @ encode_kv(K).c1^T``: checksums of the
inputs predict folds of the output, and a mismatch localizes and corrects a
single error per (row, fold column). Resident KV blocks carry an
``encode_kv`` pair written on append and re-folded at read time. The
traditional rank-1 helpers at the end (one unweighted and one
index-weighted checksum per row) serve the decoupled baseline and the
classic ABFT of linear layers.

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


def foldprod(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided product fold along the last dim — the EXP identity
    ``exp(fold1(S) - g*m) == prod_l exp(S[..., j+s*l] - m)`` (Alg.1 l.13)."""
    g = _check_fold(x.shape[-1], stride)
    return x.reshape(*x.shape[:-1], g, stride).prod(dim=-2)


def encode_cols(x: torch.Tensor, stride: int) -> Checksums:
    """Checksums of V (..., Bc, d) folded along its *feature* axis: returns
    (..., Bc, stride) such that ``P @ c1 == fold1(P @ V)``. f32
    accumulation, one rounding to ``x``'s dtype."""
    xf = x.float()
    return Checksums(fold1(xf, stride).to(x.dtype),
                     fold2(xf, stride).to(x.dtype))


class Verdict(NamedTuple):
    """Outcome of a checksum verification over one tensor. On a batched
    tensor ``n_detected`` is per leading (batch) row."""

    corrected: torch.Tensor   # the (possibly) corrected tensor
    n_detected: torch.Tensor  # int32: # of (row, fold-col) mismatches
    max_delta: torch.Tensor   # f32 scalar: largest |checksum - fold|


def verify_and_correct(x: torch.Tensor, checks: Checksums, stride: int, *,
                       threshold: float, correct: bool = True,
                       batch_dims: int = 0) -> Verdict:
    """Detect + locate + correct single errors per (row, fold column).

    ``x``: (..., W); ``checks.c1/c2``: predicted folds (..., stride). An
    error ``delta`` at ``x[..., j + s*l]`` shows as ``c1 - fold1 = -delta``
    at fold column j, and ``(c2 - fold2) / (c1 - fold1) = l + 1`` locates
    the segment; correction adds the delta back (paper §4.1). The relative
    threshold is floored at the mean |c1|, taken over everything after the
    first ``batch_dims`` dims: with ``batch_dims=1`` each batch row is
    verified on its own, exactly as the JAX package's function vmapped over
    that axis, and ``n_detected`` is per row.
    """
    g = _check_fold(x.shape[-1], stride)
    xf = x.float()
    d1 = checks.c1.float() - fold1(xf, stride)
    d2 = checks.c2.float() - fold2(xf, stride)
    c1f = checks.c1.float().abs()
    red = tuple(range(batch_dims, c1f.dim()))
    floor = torch.clamp(c1f.mean(dim=red, keepdim=True), min=1e-6)
    # negated-<= form: a NaN/inf delta counts as detected
    bad = ~(d1.abs() <= threshold * torch.maximum(c1f, floor))
    n_detected = bad.flatten(batch_dims).sum(-1, dtype=torch.int32)
    max_delta = (d1.abs().max() if d1.numel()
                 else torch.zeros((), device=x.device))
    if not correct:
        return Verdict(x, n_detected, max_delta)
    # segment l* = round(d2 / d1) - 1, clamped to [0, g - 1]
    safe = torch.where(bad, d1, torch.ones_like(d1))
    l_star = torch.clamp(torch.round(d2 / safe) - 1, 0, g - 1).long()
    seg = torch.arange(g, device=x.device)
    onehot = (seg[:, None] == l_star[..., None, :]).float()
    patch = onehot * (d1 * bad)[..., None, :]
    fixed = xf.reshape(*xf.shape[:-1], g, stride) + patch
    return Verdict(fixed.reshape(x.shape).to(x.dtype), n_detected, max_delta)


# f32 exp() leaves the normal range below log(2^-126) ~= -87.3; entries
# deeper than this floor have no faithful log-domain image in P and are
# excluded from the log check (they are <= 1e-38 attention weights)
LOG_PROD_FLOOR = -87.0


def verify_product_log(p: torch.Tensor, log_check1: torch.Tensor,
                       stride: int, *, threshold: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-domain EXP-stage verification: ``fold1(log P) == S_check1 -
    g*m`` stays exact down to the f32 normal-range floor, where the linear
    product check goes blind once one segment underflows. The threshold is
    absolute in nats relative to ``max(|check|, 1)``; NaN (a sign-bit flip
    makes ``log`` NaN) counts as detected. Returns (bad (..., stride),
    total count)."""
    logp = torch.log(p.float())               # -inf for 0, nan for < 0
    logp = torch.maximum(logp, torch.full_like(logp, LOG_PROD_FLOOR))
    chk = log_check1.float()
    ref = torch.clamp(chk.abs(), min=1.0)
    bad = ~((fold1(logp, stride) - chk).abs() <= threshold * ref)
    return bad, bad.sum(dtype=torch.int32)


def verify_product(p: torch.Tensor, p_check1: torch.Tensor, stride: int, *,
                   threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """EXP-stage verification (Alg.1 line 13): the strided product of
    ``P = exp(S - m)`` against ``exp(S_check1 - g*m)``, relative, with a
    1e-20 floor. Returns (bad (..., stride), total count)."""
    floor = 1e-20
    chk = p_check1.float()
    ref = torch.clamp(chk.abs(), min=floor)
    bad = (foldprod(p.float(), stride) - chk).abs() > threshold * ref + floor
    return bad, bad.sum(dtype=torch.int32)


# --- traditional (rank-1) ABFT: linear layers and the decoupled baseline ---


def traditional_encode_rows(a: torch.Tensor) -> torch.Tensor:
    """Classic ABFT column checksums: ``(..., M, K) -> (..., 2, K)`` with
    ``c1 = ones @ A`` and ``c2 = (1..M) @ A``. f32 accumulation, one
    rounding to ``a``'s dtype."""
    af = a.float()
    w = torch.arange(1, a.shape[-2] + 1, dtype=torch.float32,
                     device=a.device)
    c1 = af.sum(dim=-2, keepdim=True)
    c2 = (af * w[:, None]).sum(dim=-2, keepdim=True)
    return torch.cat([c1, c2], dim=-2).to(a.dtype)


def traditional_encode_cols(b: torch.Tensor) -> torch.Tensor:
    """Classic ABFT row checksums: ``(..., K, N) -> (..., K, 2)``, the
    columns ``B @ 1`` and ``B @ (1..N)``. f32 accumulation, one rounding to
    ``b``'s dtype."""
    bf = b.float()
    w = torch.arange(1, b.shape[-1] + 1, dtype=torch.float32,
                     device=b.device)
    r1 = bf.sum(dim=-1, keepdim=True)
    r2 = (bf * w).sum(dim=-1, keepdim=True)
    return torch.cat([r1, r2], dim=-1).to(b.dtype)


def traditional_verify_correct(c: torch.Tensor, row_checks: torch.Tensor, *,
                               threshold: float,
                               correct: bool = True) -> Verdict:
    """Verify and correct ``C`` (..., M, N) against its classic row
    checksums ``row_checks`` (..., M, 2), the predicted [sum, weighted sum]
    of each row. Single-error model: a bad row's error is located to a
    column by the ratio of the weighted to the plain difference. The
    relative threshold is floored at the mean |c1| over the whole tensor;
    the negated ``<=`` form makes a NaN/inf difference count as detected.
    ``n_detected`` is the total over every row."""
    n = c.shape[-1]
    cf = c.float()
    w = torch.arange(1, n + 1, dtype=torch.float32, device=c.device)
    d1 = row_checks[..., 0].float() - cf.sum(dim=-1)
    d2 = row_checks[..., 1].float() - (cf * w).sum(dim=-1)
    c1f = row_checks[..., 0].float().abs()
    floor = torch.clamp(c1f.mean(), min=1e-6)
    bad = ~(d1.abs() <= threshold * torch.maximum(c1f, floor))
    n_detected = bad.sum(dtype=torch.int32)
    max_delta = (d1.abs().max() if d1.numel()
                 else torch.zeros((), device=c.device))
    if not correct:
        return Verdict(c, n_detected, max_delta)
    safe = torch.where(bad, d1, torch.ones_like(d1))
    col = torch.clamp(torch.round(d2 / safe) - 1, 0, n - 1).long()
    onehot = (torch.arange(n, device=c.device) == col[..., None]).float()
    fixed = cf + onehot * (d1 * bad)[..., None]
    return Verdict(fixed.to(c.dtype), n_detected, max_delta)
