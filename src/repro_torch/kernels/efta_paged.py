"""Fused block-table EFTA paged attention: the CUDA kernel's wrapper and its
plain PyTorch version.

One call attends every request of a mixed batch straight off its block
table: each request brings a chunk of up to ``C`` query rows (``q_lens``
valid), chunk row ``c`` sits at absolute position ``kv_len - q_len + c``,
and masking is causal within the chunk, sliding-window and ragged per row.
GQA folds the query-head group and the chunk into the rows of one score tile
per (request, kv head), group-major (row ``g * C + c``). The paper's EFTA
scheme runs inside the same pass: tensor-checksum ABFT on GEMM I, the
checksum-reuse EXP check (linear product fold) with an exact recompute
backstop, a shadow rowmax, SNVR plus a shadow rowsum, and one unified output
verification. Every streamed KV block is also re-folded and compared with
its resident checksum pair (telemetry site 6, ``kv``), which yields the
per-(request, table slot) ``bad`` plane the serve engine repairs from.

``efta_paged_attention`` dispatches on the device of ``q``: a CPU tensor
runs :func:`efta_paged_attention_torch`; a CUDA tensor launches the kernel
of ``csrc/efta_paged.cu`` (built with ``nvcc`` on first use) or raises.
There is no fallback from one to the other.

Fault descriptor (int32[8]): [site, table_block j, batch b, kv-head h,
tile-row (group_row * C + chunk_row), col, bit, enabled] — one SEU per call.
``Site.KV`` faults strike the resident pool between steps instead
(``PagedServeEngine.inject_kv_fault``); this pass is what catches them.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.efta import MASK_VALUE, EFTAConfig
from repro_torch.core.fault import Site
from repro_torch.kernels import _build
from repro_torch.kernels._efta_common import (DTYPES, MODES, NO_WINDOW,
                                              _correct_strided, _flip,
                                              _fold_prod, _fold_slices,
                                              as_descriptor)
from repro_torch.utils.opcount import record_launch

# fault descriptor layout (int32[8]):
# [site, table_block, batch, kv_head, tile_row, col, bit, enabled]
P_SITE, P_BLOCK, P_B, P_H, P_ROW, P_COL, P_BIT, P_ON = range(8)


class PagedReport(NamedTuple):
    """Per-request outcome of one fused paged-attention call."""

    out: torch.Tensor         # (B, H, head_dim) or (B, H, C, head_dim)
    detected: torch.Tensor    # (B, 6) int32 — [gemm1, exp, rowmax, rowsum,
    #                           gemm2, kv] per request, summed over kv heads
    bad_blocks: torch.Tensor  # (B, table_len) bool — resident-checksum
    #                           mismatches, addressed by table slot


class _Call(NamedTuple):
    """Shapes, strides and thresholds of one call, shared by both paths."""

    squeeze: bool
    qr: torch.Tensor          # (B, Hkv, grp * C, D), rows group-major
    heads: int
    chunk: int
    q_lens: torch.Tensor
    window: int
    fault: list
    scale: float
    s_kv: int
    s_out: int
    eps: Tuple[float, float, float]
    kv_thr: float


def _as_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _prepare(q, k_pool, k_checks, block_tables, kv_lens, q_lens, *, cfg,
             check_threshold, window, sm_scale, fault) -> _Call:
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, :, None, :]
    b, h, chunk, d = q.shape
    nb1, hkv, bs, hd = k_pool.shape
    if hd != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pool {hd}")
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    cs = k_checks.c1.shape[-2]
    s_kv = cfg.kv_stride(bs)
    s_out = cfg.out_stride(d)
    for what, n, s in (("check stride", bs, cs), ("kv stride", bs, s_kv),
                       ("out stride", d, s_out)):
        if n % s:
            raise ValueError(f"{what} {s} does not divide {n}")
    if block_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError("block_tables / kv_lens do not match the batch")
    if q_lens is None:
        q_lens = torch.full((b,), chunk, dtype=torch.int32, device=q.device)
    return _Call(
        squeeze=squeeze,
        qr=q.reshape(b, hkv, (h // hkv) * chunk, d),
        heads=h, chunk=chunk, q_lens=q_lens,
        window=NO_WINDOW if window is None else _as_int(window),
        fault=as_descriptor(fault),
        scale=sm_scale if sm_scale is not None else 1.0 / (d ** 0.5),
        s_kv=s_kv, s_out=s_out, eps=cfg.thresholds(q.dtype),
        kv_thr=(check_threshold if check_threshold is not None
                else cks.kv_block_threshold(k_pool.dtype)))


def _report(call: _Call, out, rep, bad) -> PagedReport:
    b, _, _, d = call.qr.shape
    out = out.reshape(b, call.heads, call.chunk, d)
    return PagedReport(out=out[:, :, 0, :] if call.squeeze else out,
                       detected=rep, bad_blocks=bad)


def efta_paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_checks: cks.Checksums,
    v_checks: cks.Checksums,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    *,
    cfg: EFTAConfig,
    check_threshold: Optional[float] = None,
    window=None,
    sm_scale: Optional[float] = None,
    fault=None,
) -> PagedReport:
    """Fused batched ragged paged attention with in-loop verification.

    Same signature and layouts as the JAX package's
    ``efta_paged_attention_pallas``. ``q``: (B, H, D) or (B, H, C, D).
    ``k_pool``/``v_pool``: (num_blocks + 1, Hkv, block_size, D), row 0 the
    null block. ``k_checks``/``v_checks``: the resident
    :func:`repro_torch.core.checksum.encode_kv` pairs, (num_blocks + 1, Hkv,
    check_stride, D). ``block_tables``: (B, table_len) int32, null-padded.
    ``kv_lens``: (B,) valid tokens per request including the chunk's rows
    (already appended). ``q_lens``: (B,) valid chunk rows (default C).
    ``window``: sliding-window size (int) or None. ``fault``: int32[8]
    descriptor. Returns a :class:`PagedReport` whose ``out`` matches ``q``.

    A CPU ``q`` runs the plain version; a CUDA ``q`` launches the kernel
    (``efta_paged_attention.launches`` counts those launches, and
    ``.launches_by_layout`` them by (layout, chunk width)).
    """
    call = _prepare(q, k_pool, k_checks, block_tables, kv_lens, q_lens,
                    cfg=cfg, check_threshold=check_threshold, window=window,
                    sm_scale=sm_scale, fault=fault)
    if q.device.type == "cpu":
        out, rep, bad = _paged_torch(call, k_pool, v_pool, k_checks,
                                     v_checks, block_tables, kv_lens, cfg)
    elif q.device.type == "cuda":
        out, rep, bad = _paged_cuda(call, k_pool, v_pool, k_checks, v_checks,
                                    block_tables, kv_lens, cfg)
        # a call without its work: that depends on the tables' contents
        record_launch("efta_paged_attention")
    else:
        raise ValueError(f"efta_paged_attention runs on cpu or cuda tensors; "
                         f"got {q.device}")
    return _report(call, out, rep, bad)


efta_paged_attention.launches = 0
efta_paged_attention.launches_by_layout = collections.Counter()


def efta_paged_attention_torch(q, k_pool, v_pool, k_checks, v_checks,
                               block_tables, kv_lens, q_lens=None, *,
                               cfg: EFTAConfig, check_threshold=None,
                               window=None, sm_scale=None,
                               fault=None) -> PagedReport:
    """The kernel's plain PyTorch version, on any device: the JAX package's
    ``_paged_kernel`` step for step, with the (b, kv_head) grid written out
    as batch dimensions and the sequential block axis as a Python loop."""
    call = _prepare(q, k_pool, k_checks, block_tables, kv_lens, q_lens,
                    cfg=cfg, check_threshold=check_threshold, window=window,
                    sm_scale=sm_scale, fault=fault)
    return _report(call, *_paged_torch(call, k_pool, v_pool, k_checks,
                                       v_checks, block_tables, kv_lens, cfg))


def _paged_split_torch(q, k_pool, v_pool, k_checks, v_checks, block_tables,
                       kv_lens, q_lens=None, *, cfg: EFTAConfig, warps: int,
                       check_threshold=None, window=None, sm_scale=None,
                       fault=None) -> PagedReport:
    """The plain version with the KV blocks split over ``warps`` spans, as a
    kernel that parallelises over KV blocks would run them: span ``w``
    walks blocks ``j = w, w + warps, ...`` from a fresh row state, the spans'
    states are merged in span order and the finalize runs once. Used by
    tests and ``chip_smoke.py`` to hold that merge against the sequential
    order of :func:`efta_paged_attention_torch`: equal on clean input (in
    bf16 within about a bf16 ulp, since each span rounds p for GEMM II at
    its own running max), but an SEU on the running state strikes one
    span's partial value, so detections can differ — why the kernel
    replays the running state in block order instead of merging spans."""
    call = _prepare(q, k_pool, k_checks, block_tables, kv_lens, q_lens,
                    cfg=cfg, check_threshold=check_threshold, window=window,
                    sm_scale=sm_scale, fault=fault)
    return _report(call, *_paged_torch(call, k_pool, v_pool, k_checks,
                                       v_checks, block_tables, kv_lens, cfg,
                                       warps=warps))


def _merge_spans(parts):
    """Merge per-span row states (m, l, lsh, r, acc, oc1, oc2, vmax) in span
    order: the running max over all spans, then each span's sums rescaled
    to it by exp(m_span - m) and added in order; max|V| by maximum."""
    m = parts[0][0]
    for part in parts[1:]:
        m = torch.maximum(m, part[0])
    alive = m > MASK_VALUE / 2
    sums = [None] * 6
    vmax = parts[0][7]
    for part in parts:
        a = torch.where(alive, torch.exp(part[0] - m), torch.ones_like(m))
        for i in range(6):
            x = a * part[1 + i]
            sums[i] = x if sums[i] is None else sums[i] + x
        vmax = torch.maximum(vmax, part[7])
    return (m, *sums, vmax)


def _paged_torch(call: _Call, k_pool, v_pool, k_checks, v_checks,
                 block_tables, kv_lens, cfg: EFTAConfig, warps: int = 1):
    qr = call.qr
    dev = qr.device
    B, hkv, R, D = qr.shape
    bs = k_pool.shape[2]
    cs = k_checks.c1.shape[-2]
    mb = block_tables.shape[1]
    C = call.chunk
    s_kv, s_out = call.s_kv, call.s_out
    eps1, eps2, eps3 = call.eps
    ft = cfg.mode != "off"
    correct = cfg.mode == "correct"
    g_kv = bs // s_kv
    cap = 80.0 / g_kv
    f32 = torch.float32
    fd = call.fault
    f_on = fd[P_ON] == 1

    def hit(site: Site, j: int) -> bool:
        return f_on and fd[P_SITE] == int(site) and fd[P_BLOCK] == j

    qf = qr.float()
    bt = block_tables.to(device=dev, dtype=torch.long)
    kvl = kv_lens.to(device=dev, dtype=torch.long)
    base = kvl - call.q_lens.to(device=dev, dtype=torch.long)
    ql = call.q_lens.to(device=dev, dtype=torch.long)
    win = call.window

    det = torch.zeros((B, hkv, 6), dtype=torch.int32, device=dev)
    bad = torch.zeros((B, hkv, mb), dtype=torch.int32, device=dev)

    crow = torch.arange(R, device=dev) % C                     # (R,)
    qpos = base[:, None] + crow[None, :]                       # (B, R)

    def count(site: int, flags: torch.Tensor, run4: torch.Tensor):
        n = flags.flatten(2).sum(-1, dtype=torch.int32)        # (B, hkv)
        det[..., site] += torch.where(run4[:, :, 0, 0], n, 0)

    def span(first: int):
        """The sequential block loop over blocks first, first + warps, ...
        from a fresh row state (all blocks when warps is 1)."""
        m = torch.full((B, hkv, R, 1), MASK_VALUE, dtype=f32, device=dev)
        l = torch.zeros((B, hkv, R, 1), dtype=f32, device=dev)
        lsh = torch.zeros_like(l)
        r = torch.zeros_like(l)
        acc = torch.zeros((B, hkv, R, D), dtype=f32, device=dev)
        oc1 = torch.zeros((B, hkv, R, s_out), dtype=f32, device=dev)
        oc2 = torch.zeros_like(oc1)
        vmax = torch.zeros((B, hkv), dtype=f32, device=dev)

        for j in range(first, mb, warps):
            kv_start = j * bs
            run = (kv_start < kvl) & (base - (kv_start + bs - 1) < win)   # (B,)
            if not bool(run.any()):
                continue
            run4 = run[:, None, None, None].expand(B, hkv, 1, 1)
            ids = bt[:, j]
            k = k_pool[ids]                                        # (B,hkv,bs,D)
            v = v_pool[ids]
            real = ids > 0

            if ft:
                fk = cks.encode_kv_tile(k, cs)
                fv = cks.encode_kv_tile(v, cs)
                bad_k = cks.block_fold_bad(
                    fk, cks.Checksums(k_checks.c1[ids], k_checks.c2[ids]),
                    threshold=call.kv_thr)
                bad_v = cks.block_fold_bad(
                    fv, cks.Checksums(v_checks.c1[ids], v_checks.c2[ids]),
                    threshold=call.kv_thr)
                flag = (bad_k | bad_v) & real[:, None] & run[:, None]
                det[..., 5] += flag.to(torch.int32)
                bad[..., j] = flag.to(torch.int32)
                vm = torch.maximum(vmax, v.float().abs().amax(dim=(-2, -1)))
                vmax = torch.where(run[:, None], vm, vmax)

            # ---- GEMM I (f32 accumulate) + tensor-checksum ABFT ----
            s = torch.matmul(qf, k.float().transpose(-1, -2)) * call.scale
            s = _flip(s, on=hit(Site.GEMM1, j),
                      index=(fd[P_B], fd[P_H], fd[P_ROW], fd[P_COL]),
                      bit=fd[P_BIT])
            if ft:
                s = torch.where(torch.isfinite(s), s.clamp(-1e6, 1e6),
                                torch.zeros_like(s))
                kc1, kc2 = cks.encode_kv_tile(k, s_kv)
                sc1 = torch.matmul(qf, kc1.transpose(-1, -2)) * call.scale
                sc2 = torch.matmul(qf, kc2.transpose(-1, -2)) * call.scale
                d1 = sc1 - _fold_slices(s, s_kv, weighted=False)
                d2 = sc2 - _fold_slices(s, s_kv, weighted=True)
                bad_g = d1.abs() > eps1
                count(0, bad_g, run4)
                if correct:
                    s = _correct_strided(s, d1, d2, bad_g, s_kv)

            # ---- per-row causal + window + ragged mask, running max ----
            cols = kv_start + torch.arange(bs, device=dev)
            mask = ((cols[None, None, :] <= qpos[:, :, None])
                    & (qpos[:, :, None] - cols[None, None, :] < win)
                    & (crow[None, :, None] < ql[:, None, None]))[:, None]
            s_m = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
            blockmax = s_m.amax(dim=-1, keepdim=True)
            m_prev = m
            m_new = torch.maximum(m_prev, blockmax)
            m_new = _flip(m_new, on=hit(Site.ROWMAX, j),
                          index=(fd[P_B], fd[P_H], fd[P_ROW], 0), bit=fd[P_BIT])
            if ft and cfg.shadow_rowmax:
                m_chk = torch.maximum(m_prev.clone(), blockmax)
                bad_m = m_new != m_chk
                count(2, bad_m, run4)
                if correct:
                    m_new = torch.where(bad_m, m_chk, m_new)
            alive = m_new > MASK_VALUE / 2
            m_sub = torch.where(alive, m_new, torch.zeros_like(m_new))

            # ---- EXP with checksum reuse (paper Case 2) ----
            p_raw = torch.exp(torch.clamp(s - m_sub, max=cap))
            p_raw = _flip(p_raw, on=hit(Site.EXP, j),
                          index=(fd[P_B], fd[P_H], fd[P_ROW], fd[P_COL]),
                          bit=fd[P_BIT])
            if ft:
                pc1 = torch.exp(torch.clamp(sc1 - g_kv * m_sub, max=cap * g_kv))
                prod = _fold_prod(p_raw, s_kv)
                ref = torch.clamp(pc1.abs(), min=1e-20)
                bad_e = (prod - pc1).abs() > eps2 * ref + 1e-20
                capped = (s - m_sub) > (cap - 1e-3)
                for seg in range(g_kv):
                    bad_e &= ~capped[..., seg * s_kv:(seg + 1) * s_kv]
                count(1, bad_e, run4)
                if correct:
                    recomputed = torch.exp(torch.clamp(s - m_sub, max=cap))
                    p_raw = p_raw.clone()
                    for seg in range(g_kv):
                        sl = slice(seg * s_kv, (seg + 1) * s_kv)
                        p_raw[..., sl] = torch.where(bad_e, recomputed[..., sl],
                                                     p_raw[..., sl])
            if ft and cfg.shadow_rowmax and correct:
                # exact recompute backstop
                recheck = torch.exp(torch.clamp(s - m_sub, max=cap))
                slipped = p_raw != recheck
                count(1, slipped, run4)
                p_raw = torch.where(slipped, recheck, p_raw)
            p = torch.where(mask, p_raw, torch.zeros_like(p_raw))

            # ---- rescale + rowsum (+ shadow) ----
            alpha = torch.where(alive, torch.exp(m_prev - m_new),
                                torch.ones_like(m_new))
            l_new = alpha * l + p.sum(dim=-1, keepdim=True)
            l_new = _flip(l_new, on=hit(Site.ROWSUM, j),
                          index=(fd[P_B], fd[P_H], fd[P_ROW], 0), bit=fd[P_BIT])
            lsh_new = lsh
            if ft and cfg.shadow_rowsum:
                lsh_new = alpha * lsh + p.clone().sum(dim=-1, keepdim=True)
            blk_alive = blockmax > MASK_VALUE / 2
            r_new = alpha * r + torch.where(blk_alive, torch.exp(blockmax - m_sub),
                                            torch.zeros_like(blockmax))

            # ---- GEMM II + rescale, checksums carried ----
            pv = torch.matmul(p.to(v.dtype).float(), v.float())
            acc_new = alpha * acc + pv
            acc_new = _flip(acc_new, on=hit(Site.GEMM2, j),
                            index=(fd[P_B], fd[P_H], fd[P_ROW], fd[P_COL]),
                            bit=fd[P_BIT])
            oc1_new, oc2_new = oc1, oc2
            if ft:
                vcs1 = _fold_slices(v, s_out, weighted=False)      # (.., bs, s_out)
                vcs2 = _fold_slices(v, s_out, weighted=True)
                oc1_new = alpha * oc1 + torch.matmul(p, vcs1)
                oc2_new = alpha * oc2 + torch.matmul(p, vcs2)
                if not cfg.unified:
                    d1o = oc1_new - _fold_slices(acc_new, s_out, weighted=False)
                    count(4, d1o.abs() > eps3, run4)

            m = torch.where(run4, m_new, m)
            l = torch.where(run4, l_new, l)
            lsh = torch.where(run4, lsh_new, lsh)
            r = torch.where(run4, r_new, r)
            acc = torch.where(run4, acc_new, acc)
            oc1 = torch.where(run4, oc1_new, oc1)
            oc2 = torch.where(run4, oc2_new, oc2)
        return m, l, lsh, r, acc, oc1, oc2, vmax

    parts = [span(w) for w in range(warps)]
    m, l, lsh, r, acc, oc1, oc2, vmax = (
        parts[0] if warps == 1 else _merge_spans(parts))

    # ---- finalize: SNVR on l + unified output verification ----
    if ft:
        upper = (torch.minimum(qpos + 1, kvl[:, None]).to(f32)
                 + 1e-3)[:, None, :, None]                     # (B,1,R,1)
        in_range = (l >= r - 1e-3) & (l <= upper) & torch.isfinite(l)
        if cfg.shadow_rowsum:
            mism = (l - lsh).abs() > 1e-5 * torch.clamp(lsh.abs(), min=1e-6)
            bad_l = (~in_range | mism) & (r > 0)
            fb_ok = (lsh >= r - 1e-3) & (lsh <= upper) & torch.isfinite(lsh)
            fallback = torch.where(fb_ok, lsh, r)
        else:
            bad_l = ~in_range & (r > 0)
            fallback = r
        det[..., 3] += bad_l.flatten(2).sum(-1, dtype=torch.int32)
        if correct:
            l = torch.where(bad_l, fallback, l)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l_safe
    if ft:
        if correct:
            bound = (vmax * 1.001 + 1e-6)[:, :, None, None]
            o = torch.where(torch.isfinite(o) & (o.abs() <= bound), o,
                            torch.zeros_like(o))
        d1 = oc1 / l_safe - _fold_slices(o, s_out, weighted=False)
        d2 = oc2 / l_safe - _fold_slices(o, s_out, weighted=True)
        bad_o = ~(d1.abs() <= eps3)
        det[..., 4] += bad_o.flatten(2).sum(-1, dtype=torch.int32)
        if correct:
            o = _correct_strided(o, d1, d2, bad_o, s_out)
    return o.to(qr.dtype), det.sum(dim=1, dtype=torch.int32), bad.any(dim=1)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_int]                        # dtype code
             + [ctypes.c_void_p] * 10              # q k v kc1 kc2 vc1 vc2 bt
             #                                       kv_lens q_lens
             + [ctypes.c_void_p] * 3               # out rep bad
             + [ctypes.c_int] * 11                 # B Hkv R C D bs cs mb
             #                                       s_kv s_out window
             + [ctypes.c_float] * 5                # scale kv_thr eps1-3
             + [ctypes.c_int] * 4                  # mode unified shadows
             + [ctypes.c_int] * 8                  # fault descriptor
             + [ctypes.c_void_p]                   # fold scratch
             + [ctypes.c_void_p])                  # stream

# csrc/efta_paged.cu's constants: one SM's shared memory, the first
# layout's threads a block and fold segments; the tile layout's rows a CTA,
# blocks a step, keys a block, ABFT stride, GEMM II n-tiles a warpgroup;
# the decode layout's CTAs a cluster, rows a unit, warps a CTA, blocks a
# phase-A step at most, score row stride and row scalars a block
_SMEM_LIMIT = 232448
_MAX_THREADS = 512
_MAX_G = 32
_PT_ROWS, _PT_G, _PT_BS, _PT_SKV, _PT_NT2 = 64, 4, 16, 4, 4
_PD_CTAS, _PD_ROWS, _PD_WARPS, _PD_KG, _PD_LDS, _PD_RN = 8, 16, 8, 4, 20, 2
_PD_SMEM_PAIR = 115712     # shared bytes a CTA for two CTAs an SM
_PL_G, _PL_GY, _PL_RN = 8, 64, 3
_PL_SMEM_TRIPLE = 76800    # shared bytes a CTA for three CTAs an SM


class PagedTiling(NamedTuple):
    """The kernel's choice for one call's shapes: 16-row groups a thread
    block W, KV blocks a step G, ring stages ST, shared-memory bytes, the
    scratch's floats a (request, KV head, block) (0 but on the tile layout,
    the fold pass's, and the long-table layout, the workspace's), the tile
    layout, the CTAs of a cluster (0 but on the decode layout, whose G is
    the blocks of a phase-A step), and the long-table layout (whose G is
    the blocks of a group, ST the CTAs a unit of its score and EXP passes
    and smem the larger pass's bytes)."""

    W: int
    G: int
    ST: int
    smem: int
    fold_floats: int
    tile: int
    cluster: int = 0
    long: int = 0

    @property
    def layout(self) -> str:
        """"decode", "long", "tile" or "narrow" (the first layout)."""
        return ("decode" if self.cluster else "long" if self.long
                else "tile" if self.tile else "narrow")

    @property
    def rows(self) -> int:
        """Rows of a thread block (the decode and long-table layouts: of a
        unit): a tile of the rows of one (request, KV head)."""
        return _PT_ROWS if self.tile else 16 * self.W

    def count_rows(self, R: int) -> int:
        """Rows of the count tensor a (request, KV head), as
        ``efta_paged_tiling`` returns them: a row tile's, a decode CTA's, a
        long-table unit's GY score / EXP CTAs and 16 state CTAs."""
        units = -(-R // self.rows)
        if self.long:
            return units * (self.ST + _PD_ROWS)
        return units * (self.cluster or 1)


def _up16(n: int) -> int:
    return (n + 15) & ~15


def _slice_of(d: int) -> int:
    return next((ds for ds in (64, 48, 32, 16) if d % ds == 0), 0)


def _layout(W, G, ST, D, bs, cs, skv, sout, esz, mb) -> int:
    """Shared-memory bytes of the first layout: ``make_layout``."""
    ldk = D + 8 if esz == 2 else D + 1
    lds = bs + (skv if skv < 32 else 0)
    lds += lds & 1
    ldo, ldf = D + 1, D + 4
    blk = 2 * _up16(bs * ldk * esz) + 4 * _up16(cs * D * esz)
    c_all = sum(_up16(n) for n in (16 * lds * 4, 2 * skv * ldf * 4,
                                   2 * bs * sout * 4, 16 * ldo * 4,
                                   16 * skv * 4, 2 * 16 * sout * 4,
                                   8 * 16 * 4))
    r_all = sum(_up16(n) for n in (16 * ldk * esz, 16 * ldo * 4,
                                   2 * 16 * sout * 4, 8 * 16 * 4))
    return (ST * G * blk + W * G * c_all + W * r_all + _up16(mb * 4)
            + _up16(_MAX_THREADS // 32 * 8 * 4))


def _fold_floats(D, sout) -> int:
    """Floats of the fold pass's output for one (request, KV head, block):
    ``make_pfold`` (the K-fold rows as 16 x D bf16, the V column checksums
    16 x ldv, max|V| padded to 16 bytes)."""
    return 8 * D + _PT_BS * ((2 * sout + 3) & ~3) + 4


def _tile_layout(ST, D, sout) -> int:
    """Shared-memory bytes of one CTA of the tile layout:
    ``make_ptile_layout``."""
    ldv = (2 * sout + 3) & ~3
    lds, ldo = _PT_G * _PT_BS + 4, D + 1
    slot = 48 * D * 2 + _PT_BS * ldv * 4
    parts = (ST * _PT_G * slot, _PT_ROWS * D * 2,
             4 * max(2 * _PT_ROWS * lds, _PT_ROWS * ldo),
             _PT_G * 2 * _PT_ROWS * _PT_SKV * 4,
             ((5 + 7 * _PT_G) * _PT_ROWS + 4) * 4, 2 * _PT_ROWS * sout * 4,
             16 * 8 * 4, 2 * ST * 8)
    return sum(_up16(n) for n in parts)


def _decode_layout(KG, R, D, cs, sout, esz, mb) -> int:
    """Shared-memory bytes of one CTA of the decode layout:
    ``make_pdecode_layout``."""
    ldk, ldo = (D + 8 if esz == 2 else D + 1), D + 4
    ru = min(R, _PD_ROWS)
    ro = -(-ru // _PD_CTAS)
    span = -(-mb // _PD_CTAS)
    rb = ro * span * _PD_CTAS          # owned rows x blocks a unit
    tile = _PT_BS * ldk * esz
    slot = sum(_up16(n) for n in (tile, ru * _PD_LDS * 4, ru * _PT_SKV * 4,
                                  ru * _PD_RN * 4))
    kslot = _up16(tile) + _up16(4 * cs * D * esz)
    parts = (mb * 4, _PD_ROWS * ldk * esz, span * slot,
             max(KG * kslot, _PD_WARPS * 2 * _PT_BS * sout * 4),
             rb * 16, rb * ldo * 4, rb * 2 * sout * 4,
             (ro * ldo + 2 * ro * sout + 4 * ro) * 4, _PD_CTAS * 4,
             _PD_WARPS * 8 * 4)
    return sum(_up16(n) for n in parts)


def _long_slot(R, D, sout) -> int:
    """Floats of the long-table layout's workspace slot of one (unit,
    running block): ``make_plong_slot`` (alpha and three row terms, the
    scores, the checksum products, P V, the block and group maxima and the
    O-checksum products of each row; K's site-6 flag; max|V|)."""
    ru = min(R, _PD_ROWS)
    return (ru * (4 + _PT_BS + _PT_SKV + D + 2 + 2 * sout) + 2 + 3) & ~3


def _long_layout(G, R, D, cs, sout, esz) -> Tuple[int, int]:
    """Shared bytes of one CTA of the long-table layout's score pass and of
    its EXP pass: ``make_plong_layout``."""
    ldk = D + 8 if esz == 2 else D + 1
    ru = min(R, _PD_ROWS)
    tile, planes = _PT_BS * ldk * esz, 2 * cs * D * esz
    kslot = _up16(tile) + _up16(planes)
    sslot = _up16(ru * _PD_LDS * 4) + _up16(ru * _PT_SKV * 4)
    score = sum(_up16(n) for n in (_PD_ROWS * ldk * esz, G * kslot,
                                   G * sslot, G * ru * 4, _PD_WARPS * 8 * 4))
    eslot = kslot + sslot + _up16(ru * _PL_RN * 4)
    exp = sum(_up16(n) for n in (G * eslot, _PD_ROWS * 4,
                                 _PD_WARPS * 2 * _PT_BS * sout * 4,
                                 _PD_WARPS * 8 * 4))
    return score, exp


def _decode_shapes(chunk, unified, R, D, bs, cs, s_kv, s_out, esz, mb):
    """The decode and long-table layouts' shapes: one chunk row,
    ``unified``, 16-key blocks at ABFT stride 4, D a multiple of 16 up to
    256, ``s_out`` up to 32, the check stride dividing the block."""
    return (chunk == 1 and unified and R > 0 and mb > 0 and bs == _PT_BS
            and s_kv == _PT_SKV and D > 0 and D % 16 == 0 and D <= 256
            and 0 < s_out <= 32 and D % s_out == 0 and cs > 0
            and bs % cs == 0 and cs * D * esz % 16 == 0)


def tiling(dtype_code: int, R: int, D: int, bs: int, cs: int, s_kv: int,
           s_out: int, mb: int, unified: bool = True, *, chunk: int
           ) -> Optional[PagedTiling]:
    """The kernel's tiling of these shapes (R = grp x ``chunk`` rows a
    (request, KV head)), or None where it takes none:
    ``efta_paged_tiling`` of ``csrc/efta_paged.cu`` in Python
    (``tests/test_torch_cuda.py`` holds the two equal on the card). The
    decode layout wherever it holds the shapes (one chunk row, ``unified``,
    bf16 or f32, 16-key blocks at ABFT stride 4, D a multiple of 16 up to
    256, ``s_out`` up to 32, the check stride dividing the block, a CTA's
    share of the table, ceil(mb / 8) blocks, within the SM's shared memory):
    the most blocks a phase-A step, at most 4, that leave room for two CTAs
    an SM, else the most that fit one. Else, on those shapes, the
    long-table layout: the most blocks a group, at most 8, whose score and
    EXP passes leave room for three CTAs an SM, else two, else one, and a
    CTA a group in those passes, at most 64 a unit. Else the tile layout
    wherever it holds the shapes (bf16, ``unified``, R >= 64, 16-key blocks
    at ABFT stride 4, D a multiple of 16 up to 128, ``s_out`` up to 32, the
    check stride dividing the block): three ring stages before two. Else
    :func:`_first_tiling`."""
    esz = 4 if dtype_code == 0 else 2
    if _decode_shapes(chunk, unified, R, D, bs, cs, s_kv, s_out, esz, mb):
        for cap in (_PD_SMEM_PAIR, _SMEM_LIMIT):
            for kg in range(min(-(-mb // _PD_CTAS), _PD_KG), 0, -1):
                smem = _decode_layout(kg, R, D, cs, s_out, esz, mb)
                if smem <= cap:
                    return PagedTiling(_PD_ROWS // 16, kg, 1, smem, 0, 0,
                                       _PD_CTAS)
        for cap in (_PL_SMEM_TRIPLE, _PD_SMEM_PAIR, _SMEM_LIMIT):
            for g in range(_PL_G, 0, -1):
                smem = max(_long_layout(g, R, D, cs, s_out, esz))
                if smem <= cap:
                    units = -(-R // _PD_ROWS)
                    return PagedTiling(_PD_ROWS // 16, g,
                                       min(-(-mb // g), _PL_GY), smem,
                                       units * _long_slot(R, D, s_out), 0,
                                       0, 1)
    if (esz == 2 and unified and R >= _PT_ROWS and bs == _PT_BS
            and s_kv == _PT_SKV and D % 16 == 0 and D <= 32 * _PT_NT2
            and 0 < s_out <= 32 and D % s_out == 0 and cs > 0
            and bs % cs == 0 and cs * D * esz % 16 == 0):
        for st in (3, 2):
            smem = _tile_layout(st, D, s_out)
            if smem <= _SMEM_LIMIT:
                return PagedTiling(_PT_ROWS // 16, _PT_G, st, smem,
                                   _fold_floats(D, s_out), 1)
    return _first_tiling(esz, R, D, bs, cs, s_kv, s_out, mb)


def _first_tiling(esz, R, D, bs, cs, s_kv, s_out, mb):
    """The first layout's tiling (``choose_tiles``), or None: the fewest
    16-row groups that cover R (at most 4), then the most blocks a step (at
    most 8, within 512 threads), then the deepest ring, within the SM's
    shared memory."""
    if (R <= 0 or D % 16 or bs % 16 or bs > 64 or not 2 <= s_kv <= 32
            or s_kv & (s_kv - 1) or bs % s_kv or bs // s_kv > _MAX_G
            or not 0 < s_out <= 32 or D % s_out or cs <= 0 or bs % cs
            or not _slice_of(D) or cs * D * esz % 16):
        return None
    for w in range(min(-(-R // 16), 4), 0, -1):
        for g in range(8, 0, -1):
            if (w * g + g) * 32 > _MAX_THREADS:
                continue
            for st in (3, 2):
                smem = _layout(w, g, st, D, bs, cs, s_kv, s_out, esz, mb)
                if smem <= _SMEM_LIMIT:
                    return PagedTiling(w, g, st, smem, 0, 0)
    return None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument and result types on a loaded
    ``efta_paged`` library."""
    if not getattr(lib, "_efta_bound", False):
        lib.efta_paged_launch.argtypes = _ARGTYPES
        lib.efta_paged_launch.restype = ctypes.c_int
        lib.efta_paged_tiling.argtypes = ([ctypes.c_int] * 10
                                          + [ctypes.POINTER(ctypes.c_int)])
        lib.efta_paged_tiling.restype = ctypes.c_int
        lib.efta_paged_error_string.argtypes = [ctypes.c_int]
        lib.efta_paged_error_string.restype = ctypes.c_char_p
        lib._efta_bound = True
    return lib


def _lib():
    return bind(_build.load("efta_paged"))


def kernel_tiling(dtype_code: int, R: int, D: int, bs: int, cs: int,
                  s_kv: int, s_out: int, mb: int, unified: bool = True, *,
                  chunk: int) -> Optional[PagedTiling]:
    """What the built kernel's C entry point ``efta_paged_tiling`` chooses
    for these shapes (None: no tiling); :func:`tiling` mirrors it. Builds
    the kernel on first use."""
    buf = (ctypes.c_int * 8)()
    n = _lib().efta_paged_tiling(dtype_code, R, D, bs, cs, s_kv, s_out, mb,
                                 int(unified), chunk, buf)
    return PagedTiling(*buf) if n > 0 else None


def fold_scratch(t: PagedTiling, B: int, hkv: int, mb: int, device):
    """The scratch of the tile layout (its fold pass's output) or of the
    long-table layout (its workspace), one slot of ``t.fold_floats`` f32
    for each (request, KV head, table block), uninitialised (a pass writes
    every running block's slot before a later pass reads it); None on the
    first and the decode layouts. Allocated a call, on the caller's stream:
    under CUDA graph capture it comes from the graph's own pool."""
    if not (t.tile or t.long):
        return None
    return torch.empty((B, hkv, mb, t.fold_floats), dtype=torch.float32,
                       device=device)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _paged_cuda(call: _Call, k_pool, v_pool, k_checks, v_checks,
                block_tables, kv_lens, cfg: EFTAConfig):
    qr = call.qr.contiguous()
    dev = qr.device
    dtype = qr.dtype
    if dtype not in DTYPES:
        raise TypeError(f"efta_paged kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    planes = (k_pool, v_pool, k_checks.c1, k_checks.c2, v_checks.c1,
              v_checks.c2)
    for t in planes:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("pools and checksum planes must share q's "
                             "device and dtype")
        if not t.is_contiguous():
            raise ValueError("pools and checksum planes must be contiguous")
    if k_checks.c1.shape[:2] != k_pool.shape[:2] \
            or v_pool.shape != k_pool.shape:
        raise ValueError("pool / checksum plane shapes disagree")
    if cfg.mode not in MODES:
        raise ValueError(f"unknown EFTA mode {cfg.mode!r}")
    B, hkv, R, D = qr.shape
    _, _, bs, _ = k_pool.shape
    cs = k_checks.c1.shape[-2]
    mb = block_tables.shape[1]
    ints = [t.to(device=dev, dtype=torch.int32).contiguous()
            for t in (block_tables, kv_lens, call.q_lens)]
    lib = _lib()
    buf = (ctypes.c_int * 8)()
    n_tiles = lib.efta_paged_tiling(DTYPES[dtype], R, D, bs, cs, call.s_kv,
                                    call.s_out, mb, int(cfg.unified),
                                    call.chunk, buf)
    if n_tiles <= 0:
        raise ValueError(f"efta_paged kernel: block {bs} (strides {cs}, "
                         f"{call.s_kv}) x head_dim {D} has no tiling that "
                         f"fits one thread block")
    t = PagedTiling(*buf)
    out = torch.empty_like(qr)
    rep = torch.empty((B, hkv, n_tiles, 6), dtype=torch.int32, device=dev)
    bad = torch.empty((B, hkv, mb), dtype=torch.int32, device=dev)
    ws = fold_scratch(t, B, hkv, mb, dev)
    eps1, eps2, eps3 = call.eps
    rc = lib.efta_paged_launch(
        DTYPES[dtype], qr.data_ptr(), *(t.data_ptr() for t in planes),
        *(t.data_ptr() for t in ints),
        out.data_ptr(), rep.data_ptr(), bad.data_ptr(),
        B, hkv, R, call.chunk, D, bs, cs, mb, call.s_kv, call.s_out,
        call.window, call.scale, call.kv_thr, eps1, eps2, eps3,
        MODES[cfg.mode], int(cfg.unified), int(cfg.shadow_rowsum),
        int(cfg.shadow_rowmax), *call.fault,
        None if ws is None else ws.data_ptr(), _stream(dev))
    if rc != 0:
        # no fallback: the layout the rule chose launches, or the call fails
        msg = lib.efta_paged_error_string(rc).decode()
        raise RuntimeError(f"efta_paged kernel ({t.layout} layout) launch "
                           f"failed: CUDA error {rc} ({msg})")
    efta_paged_attention.launches += 1
    efta_paged_attention.launches_by_layout[(t.layout, call.chunk)] += 1
    # per-row-tile (decode and long-table layouts: per-CTA) partial counts,
    # summed here: no atomics, deterministic
    return out, rep.sum(dim=(1, 2), dtype=torch.int32), bad.any(dim=1)


def paged_fault_descriptor(spec, grp: int, chunk: int = 1) -> np.ndarray:
    """Translate the serve engine's per-slot :class:`FaultSpec` batch (fields
    (n_slots, n_faults)) into the kernel's int32[8] descriptor. The first
    enabled entry wins (single-event-upset model); the query-head coordinate
    splits into (kv_head = head // grp, tile row = (head % grp) * chunk), so
    the SEU strikes chunk row 0 of its target slot."""
    site = np.asarray(spec.site).reshape(-1)
    nf = np.asarray(spec.site).shape[-1]
    enabled = site >= 0
    idx = int(np.argmax(enabled))
    on = int(enabled.any())

    def take(a):
        return int(np.asarray(a).reshape(-1)[idx])

    head = take(spec.head)
    return np.asarray([take(spec.site), take(spec.block), idx // nf,
                       head // grp, (head % grp) * chunk, take(spec.col),
                       take(spec.bit), on], np.int32)
