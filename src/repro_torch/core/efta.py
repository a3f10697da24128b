"""End-to-End Fault Tolerant Attention (EFTA) — paper Algorithm 1 in plain
PyTorch, over contiguous K/V: a flash-attention style loop over KV blocks
with the paper's hybrid fault-tolerance scheme in the same computation:

  * GEMM I (S = Q·Kᵀ)      — tensor-checksum ABFT (K checksums predict the
                             strided folds of S; locate + correct)
  * subtract-max + EXP     — checksum reuse, verified in the log domain
                             (``fold1(log P) == S_check1 - g*m``), corrected
                             by recomputation, plus an exact recompute
                             backstop
  * ROWMAX                 — a shadow recompute-compare
  * ROWSUM (l)             — SNVR range restriction plus a shadow rowsum
  * GEMM II + rescale      — unified verification of one carried output
                             checksum, once at the end

``EFTAConfig`` keeps the JAX package's ``kv_stride``/``out_stride``/
``thresholds`` rules unchanged: the fold widths and detection thresholds
decide which values a verification compares, so detections only agree
between the two packages if these agree. The fused kernels
(``repro_torch.kernels.efta_attention``, ``.efta_paged``) carry the same
scheme.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.checksum import TPU_STRIDE
from repro_torch.core.fault import FaultSpec, Site, inject

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class EFTAConfig:
    """Fault-tolerance + tiling configuration for EFTA."""

    mode: str = "correct"          # "off" | "detect" | "correct"
    stride: int = TPU_STRIDE       # max checksum fold stride (8 = paper)
    block_kv: int = 512            # KV block size (Bc)
    unified: bool = True           # unified verification (EFTA-o) vs per-block
    kv_stride_override: Optional[int] = None
    out_stride_override: Optional[int] = None
    # exact rowsum correction via a shadow accumulator (beyond the paper)
    shadow_rowsum: bool = True
    # recompute-compare on the running rowmax (beyond the paper)
    shadow_rowmax: bool = True
    eps_gemm1: Optional[float] = None
    eps_exp: Optional[float] = None
    eps_out: Optional[float] = None

    def thresholds(self, dtype) -> tuple[float, float, float]:
        # relative to checksum magnitude; bf16/fp16 keep coarse thresholds
        if dtype == torch.float32:
            d = (1e-3, 1e-3, 1e-3)
        else:
            d = (5e-2, 1.0, 5e-2)
        return (
            self.eps_gemm1 if self.eps_gemm1 is not None else d[0],
            self.eps_exp if self.eps_exp is not None else d[1],
            self.eps_out if self.eps_out is not None else d[2],
        )

    def out_stride(self, head_dim: int) -> int:
        # keep >= 2 fold segments so the output checksum is a real fold
        if self.out_stride_override:
            s = min(self.out_stride_override, head_dim // 2)
        else:
            s = max(min(self.stride, head_dim // 16, 64), 4)
        while s > 1 and head_dim % s:
            s -= 1
        return max(s, 1)

    def kv_stride(self, block_kv: int) -> int:
        if self.kv_stride_override:
            return min(self.kv_stride_override, max(block_kv // 2, 1))
        p = max(block_kv // 32, 1)
        pow2 = 1 << (p.bit_length() - 1)
        return max(min(self.stride, pow2), 4)


class FTReport(NamedTuple):
    """Fault-tolerance telemetry for one attention call. ``detected`` /
    ``corrected`` are per request, (B, 5) int32 ``[gemm1, exp, rowmax,
    rowsum, gemm2]`` (or (5,) for a single call of the contiguous kernel);
    ``max_delta`` is (3,) f32 ``[gemm1 linear, exp product, out]``."""

    detected: torch.Tensor
    corrected: torch.Tensor
    max_delta: torch.Tensor

    @staticmethod
    def zero(batch: Optional[int] = None, device=None) -> "FTReport":
        shape = (5,) if batch is None else (batch, 5)
        return FTReport(torch.zeros(shape, dtype=torch.int32, device=device),
                        torch.zeros(shape, dtype=torch.int32, device=device),
                        torch.zeros((3,), dtype=torch.float32, device=device))

    def merge(self, other: "FTReport") -> "FTReport":
        return FTReport(self.detected + other.detected,
                        self.corrected + other.corrected,
                        torch.maximum(self.max_delta, other.max_delta))


def _at(i: int, value: torch.Tensor) -> torch.Tensor:
    """A (3,) f32 vector of ``value`` (>= 0) at ``i`` and 0 elsewhere: the
    report's ``max_delta`` is updated out of place, off the autograd
    graph."""
    return torch.where(torch.arange(3, device=value.device) == i,
                       value.float(), 0.0)


def _pad_kv(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-2]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x


def _rows(x, b: int, device, *, dims: int) -> Optional[torch.Tensor]:
    """A scalar, (n,) or (B, n) argument as a (B, ...) int64 tensor."""
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=device).long()
    while t.dim() < dims:
        t = t[None]
    return t.expand(b, *t.shape[1:])


def _full_mask(sq, skv, *, causal, window, kv_len, q_offset,
               kv_positions=None, batch: int = 1, device=None):
    """(B, Sq, Skv) visibility mask. ``q_offset``: scalar or (B,);
    ``kv_positions``: (Skv,) or (B, Skv) absolute positions, -1 = empty."""
    off = _rows(q_offset, batch, device, dims=1)
    qpos = torch.arange(sq, device=device)[None, :, None] + off[:, None, None]
    if kv_positions is not None:
        kpos = _rows(kv_positions, batch, device, dims=2)[:, None, :]
        m = kpos >= 0
    else:
        kpos = torch.arange(skv, device=device)[None, None, :]
        m = torch.ones((1, sq, skv), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (qpos - kpos < int(window))
    if kv_len is not None and kv_positions is None:
        m = m & (kpos < int(kv_len))
    return m.expand(batch, sq, skv)


def reference_attention(q, k, v, *, causal=False, window=None, kv_len=None,
                        q_offset=0, sm_scale=None, kv_positions=None):
    """Naive softmax attention oracle (O(n^2) memory), GQA-aware, in f32."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, sq, d)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) * scale
    s = s.reshape(b, h, sq, skv)
    mask = _full_mask(sq, skv, causal=causal, window=window, kv_len=kv_len,
                      q_offset=q_offset, kv_positions=kv_positions, batch=b,
                      device=q.device)[:, None]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    p = torch.where(mask, torch.softmax(s, dim=-1), torch.zeros_like(s))
    o = torch.matmul(p.reshape(b, hkv, g, sq, skv), v.float()[:, :, None])
    return o.reshape(b, h, sq, d).to(q.dtype)


def efta_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    cfg: EFTAConfig,
    causal: bool = False,
    window: Optional[int] = None,
    kv_len: Optional[int] = None,
    q_offset=0,
    sm_scale: Optional[float] = None,
    fault: Optional[FaultSpec] = None,
    kv_positions=None,
) -> tuple[torch.Tensor, FTReport]:
    """EFTA forward. q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D), H % Hkv == 0.

    Returns (output (B, H, Sq, D) in q's dtype, FTReport with per-row (B, 5)
    counts). ``kv_len`` masks a ragged KV tail; ``q_offset`` (scalar or
    (B,)) is the absolute position of query row 0 (decode: the cache
    position); ``kv_positions`` ((Skv,) or (B, Skv)) gives the absolute
    position held in each KV slot of a ring cache, -1 for empty slots, and
    supersedes ``kv_len``. ``fault``: a :class:`FaultSpec` of (n_faults,)
    entries, or per-row (B, n_faults) entries with row-relative coordinates
    (the serve engine's per-slot batch).

    Each batch row is verified on its own: this is the JAX package's
    ``efta_attention`` vmapped over the batch, as its ring serve engine calls
    it. (Called on B > 1 rows at once, the JAX function floors its relative
    GEMM thresholds at a mean over the whole batch and bounds the output by
    the whole batch's max|V|.)
    """
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    grp = h // hkv
    dev = q.device
    f32 = torch.float32
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    ft = cfg.mode != "off"
    correct = cfg.mode == "correct"
    eps1, eps2, eps3 = cfg.thresholds(q.dtype)

    block = min(cfg.block_kv, max(skv, 1))
    # round the block to a multiple of the fold stride (odd cache lengths
    # from serving are padded + masked below)
    for _ in range(2):
        s_fix = cfg.kv_stride(block)
        block = -(-block // s_fix) * s_fix
    k = _pad_kv(k, block)
    v = _pad_kv(v, block)
    skv_p = k.shape[2]
    nblk = skv_p // block
    kvp = _rows(kv_positions, b, dev, dims=2)
    if kvp is not None and skv_p != skv:
        kvp = torch.nn.functional.pad(kvp, (0, skv_p - skv), value=-1)
    if kv_len is None and skv_p != skv and kvp is None:
        kv_len = skv
    s_kv = cfg.kv_stride(block)
    s_out = cfg.out_stride(d)
    g_kv = block // s_kv
    cap = 80.0 / g_kv

    qf = q.reshape(b, hkv, grp, sq, d).float()
    qpos = (torch.arange(sq, device=dev)[None, :]
            + _rows(q_offset, b, dev, dims=1)[:, None])          # (B, Sq)

    def block_mask(j: int) -> torch.Tensor:
        if kvp is not None:
            kpos = kvp[:, None, j * block:(j + 1) * block]
            m = kpos >= 0
        else:
            kpos = j * block + torch.arange(block, device=dev)[None, None, :]
            m = torch.ones((b, sq, block), dtype=torch.bool, device=dev)
        if causal:
            m = m & (kpos <= qpos[:, :, None])
        if window is not None:
            m = m & (qpos[:, :, None] - kpos < int(window))
        if kv_len is not None and kvp is None:
            m = m & (kpos < int(kv_len))
        return m.expand(b, sq, block)[:, None]                  # (B,1,Sq,Bc)

    def per_row(x: torch.Tensor) -> torch.Tensor:
        return x.flatten(1).sum(-1, dtype=torch.int32)

    m = torch.full((b, h, sq), MASK_VALUE, dtype=f32, device=dev)
    l = torch.zeros((b, h, sq), dtype=f32, device=dev)
    lsh = torch.zeros_like(l)
    r = torch.zeros_like(l)
    o = torch.zeros((b, h, sq, d), dtype=f32, device=dev)
    oc1 = torch.zeros((b, h, sq, s_out), dtype=f32, device=dev)
    oc2 = torch.zeros_like(oc1)
    det = torch.zeros((b, 5), dtype=torch.int32, device=dev)
    cor = torch.zeros_like(det)
    max_delta = torch.zeros((3,), dtype=f32, device=dev)

    for j in range(nblk):
        k_j = k[:, :, j * block:(j + 1) * block]
        v_j = v[:, :, j * block:(j + 1) * block]
        # --- CCG: checksums of this K/V block (Alg.1 line 8) ---
        if ft:
            kc = cks.encode_kv(k_j, s_kv)                   # (B,Hkv,s_kv,D)
            vc = cks.encode_cols(v_j, s_out)                # (B,Hkv,Bc,s_out)

        # --- GEMM I (f32 accumulate) + NVR clip ---
        s = torch.matmul(qf, k_j.float()[:, :, None].transpose(-1, -2))
        s = (s * scale).reshape(b, h, sq, block)
        s = inject(s, fault, Site.GEMM1, j)
        if ft:
            s = torch.where(torch.isfinite(s), s.clamp(-1e6, 1e6),
                            torch.zeros_like(s))
            kt1 = kc.c1.float()[:, :, None].transpose(-1, -2)
            kt2 = kc.c2.float()[:, :, None].transpose(-1, -2)
            sc1 = (torch.matmul(qf, kt1) * scale).reshape(b, h, sq, s_kv)
            sc2 = (torch.matmul(qf, kt2) * scale).reshape(b, h, sq, s_kv)
            verdict = cks.verify_and_correct(
                s, cks.Checksums(sc1, sc2), s_kv, threshold=eps1,
                correct=correct, batch_dims=1)
            s = verdict.corrected
            det[:, 0] += verdict.n_detected
            if correct:
                cor[:, 0] += verdict.n_detected
            max_delta = torch.maximum(
                max_delta, _at(0, verdict.max_delta.detach()))

        # --- mask + running max, shadow recompute-compare ---
        bm = block_mask(j)
        s_m = torch.where(bm, s, torch.full_like(s, MASK_VALUE))
        blockmax = s_m.amax(dim=-1)                             # (B,H,Sq)
        m_new = inject(torch.maximum(m, blockmax), fault, Site.ROWMAX, j)
        if ft and cfg.shadow_rowmax:
            # the shadow is a second computation from a copy: eager
            # PyTorch never merges the two
            m_chk = torch.maximum(m.clone(), blockmax)
            bad_m = m_new != m_chk
            det[:, 2] += per_row(bad_m)
            if correct:
                cor[:, 2] += per_row(bad_m)
                m_new = torch.where(bad_m, m_chk, m_new)
        alive = m_new > MASK_VALUE / 2

        # --- EXP with checksum reuse, log-domain check ---
        m_sub = torch.where(alive, m_new, torch.zeros_like(m_new))[..., None]
        p_raw = torch.exp(torch.clamp(s - m_sub, max=cap))
        p_raw = inject(p_raw, fault, Site.EXP, j)
        if ft:
            lc1 = torch.clamp(sc1 - g_kv * m_sub, max=cap * g_kv)
            bad_exp, _ = cks.verify_product_log(p_raw, lc1, s_kv,
                                                threshold=eps2)
            # columns the cap breaks, or below the exp-underflow floor
            shift = s - m_sub
            excl = (shift > (cap - 1e-3)) | (shift < cks.LOG_PROD_FLOOR)
            col_ok = ~excl.reshape(*excl.shape[:-1], g_kv, s_kv).any(dim=-2)
            bad_exp = bad_exp & col_ok
            det[:, 1] += per_row(bad_exp)
            if correct:
                cor[:, 1] += per_row(bad_exp)
                recompute = torch.exp(torch.clamp(s - m_sub, max=cap))
                expand = bad_exp[..., None, :].expand(
                    *bad_exp.shape[:-1], g_kv, s_kv).reshape(p_raw.shape)
                p_raw = torch.where(expand, recompute, p_raw)
        if ft and cfg.shadow_rowmax and correct:
            # exact recompute backstop
            recheck = torch.exp(torch.clamp(s - m_sub, max=cap))
            slipped = p_raw != recheck
            det[:, 1] += per_row(slipped)
            cor[:, 1] += per_row(slipped)
            p_raw = torch.where(slipped, recheck, p_raw)
        p = torch.where(bm, p_raw, torch.zeros_like(p_raw))

        # --- rescale + ROWSUM (SNVR tracker r) ---
        alpha = torch.where(alive, torch.exp(m - m_new), torch.ones_like(m))
        l_new = inject(alpha * l + p.sum(dim=-1), fault, Site.ROWSUM, j)
        if ft and cfg.shadow_rowsum:
            lsh = alpha * lsh + p.clone().sum(dim=-1)
        blk_alive = blockmax > MASK_VALUE / 2
        r = alpha * r + torch.where(blk_alive,
                                    torch.exp(blockmax - m_sub[..., 0]),
                                    torch.zeros_like(blockmax))

        # --- GEMM II + rescale, checksums carried (Alg.1 l.18-21) ---
        pr = p.to(q.dtype).float().reshape(b, hkv, grp, sq, block)
        o_blk = torch.matmul(pr, v_j.float()[:, :, None]).reshape(b, h, sq, d)
        o = inject(alpha[..., None] * o + o_blk, fault, Site.GEMM2, j)
        if ft:
            oc1_b = torch.matmul(pr, vc.c1.float()[:, :, None])
            oc2_b = torch.matmul(pr, vc.c2.float()[:, :, None])
            oc1 = alpha[..., None] * oc1 + oc1_b.reshape(b, h, sq, s_out)
            oc2 = alpha[..., None] * oc2 + oc2_b.reshape(b, h, sq, s_out)
            if not cfg.unified:
                # unoptimized EFTA: verify the output checksum every step
                d1o = oc1 - cks.fold1(o, s_out)
                bad_o = d1o.abs() > eps3 * torch.clamp(oc1.abs(), min=1.0)
                det[:, 4] += per_row(bad_o)
        m, l = m_new, l_new

    # --- SNVR range restriction on the final rowsum (Alg.1 l.22-24) ---
    if ft:
        n_keys = kv_len if kv_len is not None else skv
        upper = torch.tensor(float(n_keys), dtype=f32, device=dev) + 1e-3
        in_range = (l >= r - 1e-3) & (l <= upper) & torch.isfinite(l)
        if cfg.shadow_rowsum:
            mism = (l - lsh).abs() > 1e-5 * torch.clamp(lsh.abs(), min=1e-6)
            bad_l = (~in_range | mism) & (r > 0)
            fallback = torch.where(
                (lsh >= r - 1e-3) & (lsh <= upper) & torch.isfinite(lsh),
                lsh, r)
        else:
            bad_l = ~in_range & (r > 0)
            fallback = r                 # paper-faithful analytic value
        det[:, 3] += per_row(bad_l)
        if correct:
            cor[:, 3] += per_row(bad_l)
            l = torch.where(bad_l, fallback, l)

    # --- normalization, applied to output and checksums alike ---
    l_safe = torch.where(l == 0, torch.ones_like(l), l)[..., None]
    o = o / l_safe

    # --- unified verification of GEMM II + rescale + normalization ---
    if ft:
        if correct:
            # NVR: O/l is a convex combination of V rows, |o| <= max|V|
            vbound = v.float().abs().amax(dim=(1, 2, 3)) * 1.001 + 1e-6
            vbound = vbound[:, None, None, None]
            o = torch.where(torch.isfinite(o) & (o.abs() <= vbound), o,
                            torch.zeros_like(o))
        verdict = cks.verify_and_correct(
            o, cks.Checksums(oc1 / l_safe, oc2 / l_safe), s_out,
            threshold=eps3, correct=correct, batch_dims=1)
        o = verdict.corrected
        det[:, 4] += verdict.n_detected
        if correct:
            cor[:, 4] += verdict.n_detected
        max_delta = torch.maximum(max_delta,
                                  _at(2, verdict.max_delta.detach()))

    return o.to(q.dtype), FTReport(det, cor, max_delta)


def efta_mha(q, k, v, *, cfg: EFTAConfig, **kw):
    """Convenience wrapper returning only the output (report discarded)."""
    return efta_attention(q, k, v, cfg=cfg, **kw)[0]
