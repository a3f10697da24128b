"""Decoupled fault-tolerant attention — the paper's baseline (§3.1, Figs
2-3), the scheme EFTA's headline speed-up is measured against.

Three separate stages, each its own set of kernels, with the O(n²)
intermediates materialised in device memory between them:

  stage I   : ABFT-GEMM  S = Q·Kᵀ   (classic rank-1 checksums)
  stage II  : DMR row-softmax        (redundant re-execution + comparison)
  stage III : ABFT-GEMM  O = P·V    (classic rank-1 checksums)

S and P round-trip through HBM between the stages: that is the memory the
paper's Fig. 9 shows running out at 16k tokens
(:func:`decoupled_memory_bytes`). PyTorch runs eagerly, so every stage's
tensors are real allocations and nothing fuses across a boundary.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import checksum as cks
from repro_torch.core.abft_gemm import product_f32
from repro_torch.core.efta import MASK_VALUE, FTReport
from repro_torch.core.fault import FaultSpec, Site, inject


def _threshold(dtype) -> float:
    return 1e-3 if dtype == torch.float32 else 5e-2


def abft_gemm_qk(q: torch.Tensor, k: torch.Tensor, *, correct: bool = True,
                 fault: Optional[FaultSpec] = None):
    """Stage I: ``S = Q Kᵀ · scale`` in f32 with traditional rank-1 ABFT
    (paper eq. 9-10). A ``Site.GEMM1`` fault strikes S between the product
    and its verification, inside the stage, as in the paper's model.
    Returns (S f32, n_detected)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    # row checksums of S predicted from K's column checksums: S @ [1, w]
    k_t = k.transpose(-1, -2)                         # (B, H, D, Skv)
    kc = cks.traditional_encode_cols(k_t)             # (B, H, D, 2)
    s = product_f32(q, k_t) * scale
    s = inject(s, fault, Site.GEMM1, 0)
    s_checks = product_f32(q, kc) * scale
    verdict = cks.traditional_verify_correct(
        s, s_checks, threshold=_threshold(q.dtype), correct=correct)
    return verdict.corrected, verdict.n_detected


def dmr_row_softmax(s: torch.Tensor, *, causal: bool = False):
    """Stage II: row softmax with dual modular redundancy (paper eq.
    11-12). The softmax runs twice; the results must agree within 1e-6 and
    each row of P must sum to 1 within 1e-3. Returns (P in s's dtype,
    n_detected)."""
    if causal:
        # query row i sits at position i + Skv - Sq: it sees keys up to it
        sq, skv = s.shape[-2], s.shape[-1]
        m = torch.ones((sq, skv), dtype=torch.bool,
                       device=s.device).tril(skv - sq)
        s = torch.where(m, s, torch.full_like(s, MASK_VALUE))
    sf = s.float()
    p1 = torch.softmax(sf, dim=-1)
    # the redundant execution: PyTorch eager has no common-subexpression
    # elimination, so this second softmax really runs (the JAX package
    # needs an optimization barrier to keep XLA from merging the two)
    p2 = torch.softmax(sf, dim=-1)
    agree = (p1 - p2).abs() < 1e-6
    rowsum_ok = (p1.sum(dim=-1) - 1.0).abs() < 1e-3
    n_detected = ((~agree).sum(dtype=torch.int32)
                  + (~rowsum_ok).sum(dtype=torch.int32))
    p = torch.where(agree, (p1 + p2) * 0.5, p1)
    return p.to(s.dtype), n_detected


def abft_gemm_pv(p: torch.Tensor, v: torch.Tensor, *, correct: bool = True,
                 fault: Optional[FaultSpec] = None):
    """Stage III: ``O = P V`` with traditional rank-1 ABFT. A
    ``Site.GEMM2`` fault strikes O between the product and its
    verification. Returns (O in p's dtype, n_detected)."""
    vc = cks.traditional_encode_cols(v)               # (B, H, Skv, 2)
    o = product_f32(p, v)
    o = inject(o, fault, Site.GEMM2, 0)
    o_checks = product_f32(p, vc)
    verdict = cks.traditional_verify_correct(
        o, o_checks, threshold=_threshold(p.dtype), correct=correct)
    return verdict.corrected.to(p.dtype), verdict.n_detected


def decoupled_ft_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = False,
                           fault: Optional[FaultSpec] = None,
                           correct: bool = True):
    """The decoupled pipeline: three stages, S and P materialised. ``q``:
    (B, H, Sq, D); ``k``, ``v``: (B, Hkv, Skv, D). GQA repeats the KV heads
    (the baseline predates GQA kernels; repetition is what a naive
    integration does, and it pays the memory bill for it).

    Faults at the GEMM sites strike inside their stage and meet its ABFT.
    A ``Site.EXP`` fault strikes P *between* stages II and III, the
    decoupled scheme's unprotected gap: stage III checksums the P it is
    given, so nothing detects it. Returns (out in q's dtype, FTReport with
    (5,) counts ``[gemm1, dmr, 0, 0, gemm2]``)."""
    h, hkv = q.shape[1], k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s, n1 = abft_gemm_qk(q, k, correct=correct, fault=fault)
    p, n2 = dmr_row_softmax(s, causal=causal)
    p = inject(p, fault, Site.EXP, 0)
    p = p.to(q.dtype)
    o, n3 = abft_gemm_pv(p, v, correct=correct, fault=fault)
    zero = torch.zeros((), dtype=torch.int32, device=q.device)
    detected = torch.stack([n1, n2, zero, zero, n3])
    rep = FTReport(detected,
                   detected if correct else torch.zeros_like(detected),
                   torch.zeros((3,), dtype=torch.float32, device=q.device))
    return o.to(q.dtype), rep


def decoupled_memory_bytes(b: int, h: int, sq: int, skv: int,
                           dtype=torch.bfloat16) -> int:
    """Bytes of the intermediates S and P that the decoupled scheme
    materialises in device memory, at ``dtype`` (the quantity that runs out
    at 16k tokens in the paper's Fig. 9)."""
    return 2 * b * h * sq * skv * dtype.itemsize
