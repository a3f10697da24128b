"""ABFT-protected linear layers (feed-forward and attention projections).

The paper (§4.1) notes that the tensor-checksum encoding extends to the
mixed-precision linear operations of the feed-forward layers; this module
is that extension, in two variants:

  * ``abft_matmul``         — classic rank-1 ABFT (the baseline)
  * ``tensor_abft_matmul``  — strided tensor-checksum ABFT

Both protect ``y = x @ w``; a ``Site.GEMM1`` fault strikes ``y`` between
the product and its verification. The products are plain matrix products
(``torch.matmul``), as the JAX package leaves them to XLA; the fold,
verify and correct steps are the checksum algebra of ``core.checksum``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import checksum as cks
from repro_torch.core.fault import FaultSpec, Site, inject


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result (the JAX package's
    ``preferred_element_type=f32``). 16-bit operands on the card stay
    16-bit: cuBLAS multiplies them on the tensor cores and writes its f32
    accumulator (``out_dtype``); elsewhere both are widened to f32, where
    every product of two 16-bit values is exact."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    b = b.to(a.dtype)
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    y = torch.bmm(a3, b3, out_dtype=torch.float32)
    return y.reshape(*lead, a.shape[-2], b.shape[-1])


def _threshold_for(dtype, override: Optional[float]) -> float:
    # relative to the checksum magnitude (see checksum.verify_and_correct)
    if override is not None:
        return override
    return 1e-3 if dtype == torch.float32 else 5e-2


def abft_matmul(x: torch.Tensor, w: torch.Tensor, *, correct: bool = True,
                threshold: Optional[float] = None,
                fault: Optional[FaultSpec] = None):
    """``y = x @ w`` with classic rank-1 row-checksum ABFT. ``x``: (..., M,
    K), ``w``: (K, N). Returns (y in x's dtype, n_detected int32)."""
    wc = cks.traditional_encode_cols(w)               # (K, 2)
    y = product_f32(x, w)
    y = inject(y, fault, Site.GEMM1, 0)
    y_checks = product_f32(x, wc)
    verdict = cks.traditional_verify_correct(
        y, y_checks, threshold=_threshold_for(x.dtype, threshold),
        correct=correct)
    return verdict.corrected.to(x.dtype), verdict.n_detected


def tensor_abft_matmul(x: torch.Tensor, w: torch.Tensor, *,
                       stride: int = cks.TPU_STRIDE, correct: bool = True,
                       threshold: Optional[float] = None,
                       fault: Optional[FaultSpec] = None):
    """``y = x @ w`` with strided tensor-checksum ABFT (paper §4.1): the
    checksums fold the output feature axis with stride ``s = min(stride,
    max(N // 2, 4))``. Returns (y in x's dtype, n_detected int32)."""
    n = w.shape[-1]
    s = min(stride, max(n // 2, 4))
    wc = cks.encode_cols(w, s)                        # (K, s) x2
    y = product_f32(x, w)
    y = inject(y, fault, Site.GEMM1, 0)
    c1 = product_f32(x, wc.c1)
    c2 = product_f32(x, wc.c2)
    verdict = cks.verify_and_correct(
        y, cks.Checksums(c1, c2), s,
        threshold=_threshold_for(x.dtype, threshold), correct=correct)
    return verdict.corrected.to(x.dtype), verdict.n_detected
