"""Fused contiguous EFTA flash attention (forward): the CUDA kernel's
wrapper and its plain PyTorch version.

One call attends q (B, H, Sq, D) to contiguous k, v (B, Hkv, Skv, D) and
runs the paper's five EFTA stages in the same pass: GEMM I under
stride-``s_kv`` tensor-checksum ABFT with locate-and-correct, the
checksum-reuse EXP check (linear product fold) with an exact recompute
backstop, a shadow rowmax, SNVR plus a shadow rowsum, and unified (or
per-step) output verification, with the output clamped to the running
max|V| before it is verified. Causal, sliding-window and static ragged
``kv_len`` masks skip whole KV blocks, per query tile of ``block_q`` rows;
GQA maps query head ``bh`` to kv head ``bh // (H // Hkv)``.

``efta_attention`` dispatches on the device of ``q``: a CPU tensor runs
:func:`efta_attention_torch`; a CUDA tensor launches the kernel of
``csrc/efta_attention.cu`` (built with ``nvcc`` on first use) or raises.
There is no fallback from one to the other. A meta tensor (the dry run,
``launch/dryrun.py``) computes nothing and returns what the CUDA route
returns, in shape and dtype. A launch, or its meta stand-in, is recorded
in an open :func:`~repro_torch.utils.opcount.opcount` context with
:func:`efta_attention_work`'s bytes and operations.

Fault descriptor (int32[8]): ``[site, kv_block, bh, row, col, bit, on, _]``
with ``bh = batch * H + head`` and ``row`` the absolute query row — one SEU
per call (:func:`fault_descriptor` builds it from a :class:`FaultSpec`).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.efta import MASK_VALUE, EFTAConfig
from repro_torch.core.fault import Site
from repro_torch.kernels import _build
from repro_torch.kernels._efta_common import (DTYPES, MODES, NO_WINDOW,
                                              _correct_strided, _flip,
                                              _fold_prod, _fold_slices,
                                              as_descriptor)
from repro_torch.utils.opcount import record_launch

# fault descriptor layout (int32[8]):
# [site, kv_block, bh, row, col, bit, enabled, _pad]
F_SITE, F_BLOCK, F_BH, F_ROW, F_COL, F_BIT, F_ON = range(7)


class _Call(NamedTuple):
    """Shapes, tiling, strides and thresholds of one call, shared by both
    paths."""

    b: int
    h: int
    grp: int
    sq: int
    d: int
    scale: float
    causal: bool
    window: int
    kv_len: int
    block_q: int
    block_kv: int
    n_q: int
    n_kv: int
    s_kv: int
    s_out: int
    g_kv: int
    cap: float
    eps: Tuple[float, float, float]
    fault: list


def _prepare(q, k, v, *, cfg, causal, window, kv_len, sm_scale, fault,
             block_q) -> _Call:
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match")
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    if kv_len is None:
        kv_len = skv
    kv_len = int(kv_len)
    if not 0 < kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} out of range (0, {skv}]")
    block_q = min(block_q, sq)
    block_kv = min(cfg.block_kv, skv)
    if sq % block_q or skv % block_kv:
        raise ValueError(f"seq lens ({sq},{skv}) must divide blocks "
                         f"({block_q},{block_kv})")
    s_kv = cfg.kv_stride(block_kv)
    g_kv = block_kv // s_kv
    return _Call(b=b, h=h, grp=h // hkv, sq=sq, d=d, scale=scale,
                 causal=bool(causal),
                 window=NO_WINDOW if window is None else int(window),
                 kv_len=kv_len, block_q=block_q, block_kv=block_kv,
                 n_q=sq // block_q, n_kv=skv // block_kv, s_kv=s_kv,
                 s_out=cfg.out_stride(d), g_kv=g_kv, cap=80.0 / g_kv,
                 eps=cfg.thresholds(q.dtype), fault=as_descriptor(fault))


def _tile_counts(q, k, v, *, cfg: EFTAConfig, causal=False, window=None,
                 kv_len=None, sm_scale=None, fault=None, block_q=128,
                 plain=False):
    """Output (B, H, Sq, D) and the per-(bh, query tile) counts (B·H, n_q,
    5), from the plain version (``plain`` or a CPU ``q``) or the kernel."""
    call = _prepare(q, k, v, cfg=cfg, causal=causal, window=window,
                    kv_len=kv_len, sm_scale=sm_scale, fault=fault,
                    block_q=block_q)
    if plain or q.device.type == "cpu":
        return _efta_torch(call, q, k, v, cfg)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"efta_attention runs on cpu, cuda or meta "
                         f"tensors; got {q.device}")
    out = _efta_device(call, q, k, v, cfg)
    record_launch("efta_attention",
                  lambda: efta_attention_work(q, k, causal=causal))
    return out


def efta_attention_work(q, k, *, causal: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one launch on q (B, H, Sq, D) and k (B, Hkv,
    Skv, D): q, k, v read once and the output written once; QK^T and PV
    over the visible (row, key) pairs (every pair non-causal, the lower
    triangle causal), 2 flops a multiply-add. The bound of the kernel's
    table in PERF.md and the dry run's count of a launch."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    return nbytes, B * H * pairs * 4 * D


def efta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   cfg: EFTAConfig, causal: bool = False,
                   window: Optional[int] = None,
                   kv_len: Optional[int] = None,
                   sm_scale: Optional[float] = None, fault=None,
                   block_q: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused EFTA attention. q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D).

    Same signature, tiling and ``ValueError``s as the JAX package's
    ``efta_attention_pallas``: ``block_q = min(block_q, Sq)`` and
    ``block_kv = min(cfg.block_kv, Skv)`` must divide the sequence lengths;
    ``kv_len`` (static int) masks a ragged KV tail and bounds the SNVR
    rowsum check. ``fault``: int32[8] descriptor or None. Returns (out (B,
    H, Sq, D) in q's dtype, detected (5,) int32 ``[gemm1, exp, rowmax,
    rowsum, gemm2]``).

    A CPU ``q`` runs the plain version; a CUDA ``q`` launches the kernel
    (``efta_attention.launches`` counts those launches, and
    ``.launches_by_layout`` them by (layout, Sq)).
    """
    out, rep = _tile_counts(q, k, v, cfg=cfg, causal=causal, window=window,
                            kv_len=kv_len, sm_scale=sm_scale, fault=fault,
                            block_q=block_q)
    return out, rep.sum(dim=(0, 1), dtype=torch.int32)


efta_attention.launches = 0
efta_attention.launches_by_layout = collections.Counter()


def efta_attention_rows(q, k, v, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`efta_attention` with the counts per batch row, (B, 5)."""
    out, rep = _tile_counts(q, k, v, **kw)
    return out, rep.reshape(q.shape[0], -1, 5).sum(dim=1, dtype=torch.int32)


def efta_attention_torch(q, k, v, *, cfg: EFTAConfig, causal=False,
                         window=None, kv_len=None, sm_scale=None, fault=None,
                         block_q=128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, on any device: the JAX package's
    ``_efta_kernel`` step for step, with the (bh, query tile) grid written
    out as batch dimensions and the sequential KV-block axis as a Python
    loop. Returns what :func:`efta_attention` returns."""
    out, rep = _tile_counts(q, k, v, cfg=cfg, causal=causal, window=window,
                            kv_len=kv_len, sm_scale=sm_scale, fault=fault,
                            block_q=block_q, plain=True)
    return out, rep.sum(dim=(0, 1), dtype=torch.int32)


def _efta_torch(c: _Call, q, k, v, cfg: EFTAConfig):
    dev = q.device
    f32 = torch.float32
    BH, nq, bq, bkv, D = c.b * c.h, c.n_q, c.block_q, c.block_kv, c.d
    s_kv, s_out, g_kv, cap = c.s_kv, c.s_out, c.g_kv, c.cap
    eps1, eps2, eps3 = c.eps
    ft = cfg.mode != "off"
    correct = cfg.mode == "correct"
    fd = c.fault
    f_on = fd[F_ON] == 1
    # the query row the SEU strikes, as (query tile, tile row)
    f_tile, f_r = divmod(fd[F_ROW], bq) if 0 <= fd[F_ROW] < c.sq else (-1, 0)

    def hit(site: Site, j: int) -> bool:
        return f_on and fd[F_SITE] == int(site) and fd[F_BLOCK] == j

    qt = q.reshape(BH, nq, bq, D).float()
    kr = k.reshape(-1, k.shape[2], D)
    vr = v.reshape(-1, k.shape[2], D)
    kidx = torch.arange(BH, device=dev) // c.grp
    q_start = torch.arange(nq, device=dev) * bq                 # (n_q,)
    rows = q_start[:, None] + torch.arange(bq, device=dev)      # (n_q, Bq)

    m = torch.full((BH, nq, bq, 1), MASK_VALUE, dtype=f32, device=dev)
    l = torch.zeros((BH, nq, bq, 1), dtype=f32, device=dev)
    lsh = torch.zeros_like(l)
    r = torch.zeros_like(l)
    acc = torch.zeros((BH, nq, bq, D), dtype=f32, device=dev)
    oc1 = torch.zeros((BH, nq, bq, s_out), dtype=f32, device=dev)
    oc2 = torch.zeros_like(oc1)
    det = torch.zeros((BH, nq, 5), dtype=torch.int32, device=dev)
    vmax = torch.zeros((BH, nq), dtype=f32, device=dev)

    def count(site: int, flags: torch.Tensor, run: torch.Tensor):
        n = flags.flatten(2).sum(-1, dtype=torch.int32)         # (BH, n_q)
        det[..., site] += torch.where(run[None, :], n, 0)

    for j in range(c.n_kv):
        kv_start = j * bkv
        # block skipping, decided per query tile as the reference grid does
        run = torch.ones((nq,), dtype=torch.bool, device=dev)
        if c.causal:
            run &= kv_start <= q_start + bq - 1
        run &= q_start - (kv_start + bkv - 1) < c.window
        run &= torch.tensor(kv_start < c.kv_len, device=dev)
        if not bool(run.any()):
            continue
        run4 = run[None, :, None, None]
        k_j = kr[kidx, kv_start:kv_start + bkv]                 # (BH, Bc, D)
        v_j = vr[kidx, kv_start:kv_start + bkv]
        if ft:
            vm = torch.maximum(vmax, v_j.float().abs().amax(dim=(1, 2))[:, None])
            vmax = torch.where(run[None, :], vm, vmax)

        # ---- GEMM I (f32 accumulate) + tensor-checksum ABFT ----
        s = torch.matmul(qt, k_j.float()[:, None].transpose(-1, -2)) * c.scale
        s = _flip(s, on=hit(Site.GEMM1, j),
                  index=(fd[F_BH], f_tile, f_r, fd[F_COL]), bit=fd[F_BIT])
        if ft:
            s = torch.where(torch.isfinite(s), s.clamp(-1e6, 1e6),
                            torch.zeros_like(s))
            kc1 = torch.zeros((BH, s_kv, D), dtype=f32, device=dev)
            kc2 = torch.zeros_like(kc1)
            for seg in range(g_kv):
                x = k_j[:, seg * s_kv:(seg + 1) * s_kv].float()
                kc1 = kc1 + x
                kc2 = kc2 + float(seg + 1) * x
            sc1 = torch.matmul(qt, kc1[:, None].transpose(-1, -2)) * c.scale
            sc2 = torch.matmul(qt, kc2[:, None].transpose(-1, -2)) * c.scale
            d1 = sc1 - _fold_slices(s, s_kv, weighted=False)
            d2 = sc2 - _fold_slices(s, s_kv, weighted=True)
            bad = d1.abs() > eps1
            count(0, bad, run)
            if correct:
                s = _correct_strided(s, d1, d2, bad, s_kv)

        # ---- mask, running max (+ shadow) ----
        cols = kv_start + torch.arange(bkv, device=dev)
        mask = (cols[None, None, :] < c.kv_len).expand(nq, bq, bkv)
        if c.causal:
            mask = mask & (cols[None, None, :] <= rows[:, :, None])
        mask = (mask & (rows[:, :, None] - cols[None, None, :] < c.window))[None]
        s_m = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        blockmax = s_m.amax(dim=-1, keepdim=True)
        m_prev = m
        m_new = torch.maximum(m_prev, blockmax)
        m_new = _flip(m_new, on=hit(Site.ROWMAX, j),
                      index=(fd[F_BH], f_tile, f_r, 0), bit=fd[F_BIT])
        if ft and cfg.shadow_rowmax:
            m_chk = torch.maximum(m_prev.clone(), blockmax)
            bad_m = m_new != m_chk
            count(2, bad_m, run)
            if correct:
                m_new = torch.where(bad_m, m_chk, m_new)
        alive = m_new > MASK_VALUE / 2
        m_sub = torch.where(alive, m_new, torch.zeros_like(m_new))

        # ---- EXP with checksum reuse (paper Case 2) ----
        p_raw = torch.exp(torch.clamp(s - m_sub, max=cap))
        p_raw = _flip(p_raw, on=hit(Site.EXP, j),
                      index=(fd[F_BH], f_tile, f_r, fd[F_COL]), bit=fd[F_BIT])
        if ft:
            pc1 = torch.exp(torch.clamp(sc1 - g_kv * m_sub, max=cap * g_kv))
            prod = _fold_prod(p_raw, s_kv)
            ref = torch.clamp(pc1.abs(), min=1e-20)
            bad_e = (prod - pc1).abs() > eps2 * ref + 1e-20
            capped = (s - m_sub) > (cap - 1e-3)
            for seg in range(g_kv):
                bad_e &= ~capped[..., seg * s_kv:(seg + 1) * s_kv]
            count(1, bad_e, run)
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
            count(1, slipped, run)
            p_raw = torch.where(slipped, recheck, p_raw)
        p = torch.where(mask, p_raw, torch.zeros_like(p_raw))

        # ---- rescale + rowsum (+ shadow), SNVR tracker ----
        alpha = torch.where(alive, torch.exp(m_prev - m_new),
                            torch.ones_like(m_new))
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        l_new = _flip(l_new, on=hit(Site.ROWSUM, j),
                      index=(fd[F_BH], f_tile, f_r, 0), bit=fd[F_BIT])
        lsh_new = lsh
        if ft and cfg.shadow_rowsum:
            lsh_new = alpha * lsh + p.clone().sum(dim=-1, keepdim=True)
        blk_alive = blockmax > MASK_VALUE / 2
        r_new = alpha * r + torch.where(blk_alive, torch.exp(blockmax - m_sub),
                                        torch.zeros_like(blockmax))

        # ---- GEMM II + rescale, checksums carried ----
        vf = v_j.float()[:, None]                             # (BH,1,Bc,D)
        pv = torch.matmul(p.to(v.dtype).float(), vf)
        acc_new = alpha * acc + pv
        acc_new = _flip(acc_new, on=hit(Site.GEMM2, j),
                        index=(fd[F_BH], f_tile, f_r, fd[F_COL]),
                        bit=fd[F_BIT])
        oc1_new, oc2_new = oc1, oc2
        if ft:
            vc1 = _fold_slices(vf, s_out, weighted=False)     # (BH,1,Bc,s)
            vc2 = _fold_slices(vf, s_out, weighted=True)
            oc1_new = alpha * oc1 + torch.matmul(p, vc1)
            oc2_new = alpha * oc2 + torch.matmul(p, vc2)
            if not cfg.unified:
                # per-step output check (EFTA without unified verification)
                d1o = oc1_new - _fold_slices(acc_new, s_out, weighted=False)
                count(4, d1o.abs() > eps3, run)

        m = torch.where(run4, m_new, m)
        l = torch.where(run4, l_new, l)
        lsh = torch.where(run4, lsh_new, lsh)
        r = torch.where(run4, r_new, r)
        acc = torch.where(run4, acc_new, acc)
        oc1 = torch.where(run4, oc1_new, oc1)
        oc2 = torch.where(run4, oc2_new, oc2)

    # ---- finalize: SNVR on l + unified output verification ----
    if ft:
        upper = float(c.kv_len) + 1e-3
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
            bound = (vmax * 1.001 + 1e-6)[..., None, None]
            o = torch.where(torch.isfinite(o) & (o.abs() <= bound), o,
                            torch.zeros_like(o))
        d1 = oc1 / l_safe - _fold_slices(o, s_out, weighted=False)
        d2 = oc2 / l_safe - _fold_slices(o, s_out, weighted=True)
        bad_o = ~(d1.abs() <= eps3)
        det[..., 4] += bad_o.flatten(2).sum(-1, dtype=torch.int32)
        if correct:
            o = _correct_strided(o, d1, d2, bad_o, s_out)
    return o.reshape(c.b, c.h, c.sq, D).to(q.dtype), det


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_int]                        # dtype code
             + [ctypes.c_void_p] * 5               # q k v out rep
             + [ctypes.c_int] * 14                 # BH grp Sq Skv D block_q
             #                                       block_kv n_q n_kv kv_len
             #                                       s_kv s_out causal window
             + [ctypes.c_float] * 8                # scale eps1-3 cap cap_g
             #                                       cap_m upper
             + [ctypes.c_int] * 5                  # mode unified shadows
             #                                       max_groups
             + [ctypes.c_int] * 8                  # fault descriptor
             + [ctypes.c_void_p, ctypes.c_int]     # workspace, its slots
             + [ctypes.c_void_p])                  # stream


# 16-row groups (of 4 warps) per thread block at most; the C entry point
# takes fewer where the query tile or shared memory is smaller
_MAX_GROUPS = 4
# the kernel's constants (csrc/efta_attention.cu): warps a 16-row group,
# groups a thread block of the narrow and workspace layouts and of the
# cluster layout, fold segments of the EXP pass's per-thread array, the
# GEMM II n-tiles a warp of the cluster layout (D <= 256), and the shared
# memory a thread block may take on Hopper (227 KB); the tile layout's
# groups a CTA, GEMM II n-tiles a warpgroup (D <= 128) and least scores of
# a query tile's KV block
_WPG, _KERNEL_GROUPS, _CL_GROUPS, _MAX_G, _CL_NT, _SMEM_LIMIT = (
    4, 2, 4, 32, 8, 232448)
_TL_GROUPS, _TL_NT, _TL_MIN_SCORES = 4, 4, 8192
# the decode layout's query rows a unit, keys a CTA at most, threads of the
# state pass (D <= twice this) and KV blocks it stages a step
_DC_ROWS, _DC_KEYS, _DC_STATE_THREADS, _DC_CHAIN = 8, 128, 128, 32
# streaming multiprocessors of an H100 SXM: the meta route sizes the wide
# path's persistent grid, and its workspace, as for that card
H100_SMS = 132


class Tiling(NamedTuple):
    """The kernel's choice for one call's shapes: 16-row groups a thread
    block, keys a streamed chunk, ring stages, thread blocks an SM, the
    workspace path (scores in a global workspace), the K-fold planes in the
    workspace too, shared-memory bytes, workspace floats a slot (the tile
    layout: the fold pass's floats a KV head and KV block; the decode
    layout: a unit and KV block), the thread blocks a cluster of the
    cluster layout (0: another layout), the tile layout, and the decode
    layout's residue parts a KV block (0: another layout; its ``KC`` is
    the keys a CTA, its ``smem`` its largest pass's)."""

    W: int
    KC: int
    ST: int
    per_sm: int
    wide: int
    g_kf: int
    smem: int
    slot_floats: int
    cluster: int
    tile: int
    decode: int = 0

    @property
    def layout(self) -> str:
        """"decode", "tile", "narrow", "cluster" or "workspace"."""
        return ("decode" if self.decode else "tile" if self.tile else
                "cluster" if self.cluster else
                "workspace" if self.wide else "narrow")


def _slice_of(d: int) -> int:
    return next((ds for ds in (64, 48, 32, 16) if d % ds == 0), 0)


def _layout(W, KC, ST, D, Bc, skv, sout, esz, wide, g_kf):
    """(shared-memory bytes, workspace floats a slot): ``make_layout``."""
    TR = 16 * W
    ldk = D + 8 if esz == 2 else D + 1
    lds = Bc if wide else Bc + (skv if skv < 32 else 0)
    lds += lds & 1
    ldo, ldf = D + 1, D + 4
    g_kf = bool(wide and g_kf)
    slot = (2 * TR * lds + (2 * skv * ldf if g_kf else 0)) if wide else 0
    parts = (ST * KC * ldk * esz, TR * ldk * esz,
             0 if g_kf else 2 * skv * ldf * 4, 0 if wide else TR * lds * 4,
             TR * ldo * 4, TR * skv * 4, 2 * KC * sout * 4,
             4 * TR * sout * 4, 8 * TR * 4, W * _WPG * 8 * 4)
    return sum((n + 15) & ~15 for n in parts), slot


def _cluster_layout(W, KC, ST, D, Bc, skv, sout, esz, n) -> int:
    """Shared-memory bytes of one CTA of the cluster layout:
    ``make_cluster_layout``."""
    TR, rc, kc = 16 * W, skv // n, Bc // n
    rpc = TR // n
    ldk = D if esz == 2 else D + 1  # bf16: 8 x 8 core matrices, unpadded
    lds = (kc + (rc if rc < 32 else 0) + 3) & ~3
    ldo, ldf = D + 1, D + 4
    parts = (ST * KC * ldk * esz, TR * ldk * esz, 2 * rc * ldf * 4,
             4 * max(TR * lds, rpc * ldo + 2 * rpc * sout), TR * ldo * 4,
             (2 if esz == 2 else 1) * TR * rc * 4,
             (2 * KC * (((2 * sout + 7) & ~7) + 8) * 2 if esz == 2
              else 2 * KC * sout * 4), 4 * TR * sout * 4, 8 * TR * 4,
             (3 * TR + 2) * 4, W * _WPG * 8 * 4, 2 * ST * 8)
    return sum((n + 15) & ~15 for n in parts)


def _fold_floats(D, Bc, skv, sout) -> int:
    """Floats of the tile layout's fold-pass output for one KV head and KV
    block: ``make_fold`` (the K folds, the V checksums as bf16 pairs, and
    max|V| of each of the blocks of 256 threads, one checksum entry a
    thread, that share it)."""
    ldc = ((2 * sout + 7) & ~7) + 8
    splits = -(-Bc * ldc // 256)
    return 2 * skv * D + Bc * ldc + ((splits + 3) & ~3)


def _tile_layout(KC, ST, D, Bc, skv, sout) -> int:
    """Shared-memory bytes of one CTA of the tile layout:
    ``make_tile_layout``."""
    TR = 16 * _TL_GROUPS
    ldc = ((2 * sout + 7) & ~7) + 8
    lds = (Bc + (skv if skv < 32 else 0) + 3) & ~3
    ldo, ldf = D + 1, D + 4
    parts = (ST * (KC * D * 2 + KC * ldc * 4), TR * D * 2, 2 * skv * ldf * 4,
             4 * max(TR * lds, TR * ldo), 2 * TR * skv * 4,
             2 * TR * sout * 4, (8 * TR + 4) * 4, _TL_GROUPS * _WPG * 8 * 4,
             2 * ST * 8)
    return sum((n + 15) & ~15 for n in parts)


def _decode_parts(Bc: int, skv: int) -> int:
    """The decode layout's residue parts a KV block: the fewest (a divisor
    of ``s_kv``) that leave at most 128 keys a CTA, a multiple of 16,
    else 0."""
    return next((p for p in range(1, skv + 1)
                 if skv % p == 0 and Bc % (16 * p) == 0
                 and Bc // p <= _DC_KEYS), 0)


def _decode_layout(D, Bc, skv, sout, esz, parts) -> Tuple[int, int]:
    """(shared bytes of the largest pass, workspace floats a unit and KV
    block) of the decode layout: ``make_decode_layout``."""
    keys, res, R = Bc // parts, skv // parts, _DC_ROWS
    ldk, ldf = (D + 8 if esz == 2 else D + 4), D + 4

    def up4(n):
        return (n + 3) & ~3

    # scores, checksum products and the parts' block maxima; then a part's
    # P V, O checksums, rowsum terms and max|V|
    head = up4(R * Bc) + up4(R * skv) + up4(parts * R)
    part_floats = R * D + 2 * up4(R * sout) + 2 * R + 4

    def total(*sizes):
        return sum((n + 15) & ~15 for n in sizes)

    strip, q, threads = keys * ldk * esz, 16 * ldk * esz, 32 * R
    score = total(strip, q, R * keys * 4, 2 * res * ldf * 4, R * res * 4)
    exp = total(strip, R * keys * 4, R * keys * 4, R * res * 4,
                2 * keys * sout * 4, 2 * max(R * sout, threads) * 4, R * 4,
                threads // 32 * 4, _DC_CHAIN * parts * R * 4)
    chain = max(_DC_CHAIN // parts, 1)
    state = total(chain * parts * 16, chain * parts * D * 4,
                  chain * parts * 2 * sout * 4, D * 4, chain * 4, chain * 4,
                  chain * 4, (2 + _DC_STATE_THREADS // 32) * 4)
    return max(score, exp, state), head + parts * part_floats


def tiling(dtype_code: int, block_q: int, block_kv: int, d: int, s_kv: int,
           s_out: int, max_groups: int = _MAX_GROUPS,
           unified: bool = True) -> Optional[Tiling]:
    """The kernel's tiling of these shapes, or None where it takes none:
    ``choose_tiles`` of ``csrc/efta_attention.cu``, in Python, so that the
    meta route needs no build. The decode layout first wherever it holds
    the shapes (``block_q`` 1, ``unified``, D <= 256, at most 128 keys a
    CTA for a divisor of ``s_kv``: g_kv <= 128; any dtype, mask and
    ``kv_len``). Then the tile layout wherever it holds the
    shapes (bf16, ``unified``, ``block_q`` >= 64 with ``block_q`` x
    ``block_kv`` >= 8,192 and 4 row groups allowed, ``block_kv`` <= 1,024,
    ``s_kv`` a power of two from 2 to 32, ``g_kv`` <= 32, D <= 128) and
    fits: the widest chunk (128, 64, 32 keys), then the deepest ring.
    Else the narrow layout (scores in shared memory) wherever it fits:
    two thread blocks an SM before one, then the most rows, the widest
    chunk, the deepest ring. Else the cluster layout
    where it holds the shapes (``unified``, ``s_kv`` a power of two over
    8, 4 or 2 CTAs with at most 32 residues a CTA, ``g_kv`` <= 32, D <=
    256): chunks of 128 or 64 keys before narrower ones, then the most
    rows, the widest chunk, the most CTAs, the deepest ring. Else the
    workspace path: the K-fold planes in shared memory before the
    workspace, then the widest chunk first."""
    Bc, D, skv, sout = block_kv, d, s_kv, s_out
    if (block_q <= 0 or Bc % 16 or D % 16 or skv < 1 or Bc % skv
            or sout <= 0 or D % sout or not _slice_of(D)):
        return None
    esz = 4 if dtype_code == 0 else 2
    if block_q == 1 and unified and D <= 2 * _DC_STATE_THREADS:
        parts = _decode_parts(Bc, skv)
        smem, floats = _decode_layout(D, Bc, skv, sout, esz, max(parts, 1))
        if parts and smem <= _SMEM_LIMIT:
            return Tiling(1, Bc // parts, 1, 1, 0, 0, smem, floats, 0, 0,
                          parts)
    if (esz == 2 and unified and block_q >= 16 * _TL_GROUPS
            and block_q * Bc >= _TL_MIN_SCORES
            and max_groups >= _TL_GROUPS and Bc <= 1024 and 2 <= skv <= 32
            and not skv & (skv - 1) and Bc // skv <= _MAX_G
            and D <= 32 * _TL_NT):
        for kc in (128, 64, 32):
            for st in (3, 2):
                if kc > Bc or Bc % kc:
                    continue
                smem = _tile_layout(kc, st, D, Bc, skv, sout)
                if smem <= _SMEM_LIMIT:
                    return Tiling(_TL_GROUPS, kc, st, 1, 0, 0, smem,
                                  _fold_floats(D, Bc, skv, sout), 0, 1)
    wmax = min(-(-block_q // 16), max_groups, _KERNEL_GROUPS)
    ws = range(wmax, 0, -1)
    if 2 <= skv <= 32 and not skv & (skv - 1) and Bc // skv <= _MAX_G:
        for w, kc, st, per_sm in [(w, kc, st, per_sm) for per_sm in (2, 1)
                                  for w in ws for kc in (64, 32, 16)
                                  for st in (3, 2)]:
            if Bc % kc:
                continue
            smem, _ = _layout(w, kc, st, D, Bc, skv, sout, esz, 0, 0)
            if smem <= _SMEM_LIMIT // per_sm:
                return Tiling(w, kc, st, per_sm, 0, 0, smem, 0, 0, 0)
    wcl = min(-(-block_q // 16), max_groups, _CL_GROUPS)
    if (unified and skv >= 2 and not skv & (skv - 1)
            and Bc // skv <= _MAX_G and D <= 32 * _CL_NT):
        for kcs in ((128, 64), (32, 16)):
            for w in range(wcl, 0, -1):
                for kc in kcs:
                    for n in (8, 4, 2):
                        for st in (3, 2):
                            if skv % n or skv // n > 32 or (Bc // n) % kc:
                                continue
                            smem = _cluster_layout(w, kc, st, D, Bc, skv,
                                                   sout, esz, n)
                            if smem <= _SMEM_LIMIT:
                                return Tiling(w, kc, st, 1, 0, 0, smem, 0,
                                              n, 0)
    for g_kf in (0, 1):
        for kc in (64, 32, 16):
            for per_sm in (2, 1):
                for w in ws:
                    for st in (3, 2):
                        if Bc % kc:
                            continue
                        smem, slot = _layout(w, kc, st, D, Bc, skv, sout,
                                             esz, 1, g_kf)
                        if smem <= _SMEM_LIMIT // per_sm:
                            return Tiling(w, kc, st, per_sm, 1, g_kf, smem,
                                          slot, 0, 0)
    return None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument and result types on a loaded
    ``efta_attention`` library."""
    if not getattr(lib, "_efta_bound", False):
        lib.efta_attention_launch.argtypes = _ARGTYPES
        lib.efta_attention_launch.restype = ctypes.c_int
        lib.efta_attention_tiles.argtypes = ([ctypes.c_int] * 8
                                             + [ctypes.POINTER(ctypes.c_int)])
        lib.efta_attention_tiles.restype = ctypes.c_int
        lib.efta_attention_error_string.argtypes = [ctypes.c_int]
        lib.efta_attention_error_string.restype = ctypes.c_char_p
        lib._efta_bound = True
    return lib


def _lib():
    return bind(_build.load("efta_attention"))


def kernel_tiling(dtype_code: int, block_q: int, block_kv: int, d: int,
                  s_kv: int, s_out: int, max_groups: int = _MAX_GROUPS,
                  unified: bool = True) -> Optional[Tiling]:
    """What the built kernel's C entry point ``efta_attention_tiles``
    chooses for these shapes (None: no tiling); :func:`tiling` mirrors
    it. Builds the kernel on first use."""
    buf = (ctypes.c_int * 11)()
    n_sub = _lib().efta_attention_tiles(dtype_code, block_q, block_kv, d,
                                        s_kv, s_out, max_groups,
                                        int(unified), buf)
    return Tiling(*buf) if n_sub > 0 else None


def _efta_device(c: _Call, q, k, v, cfg: EFTAConfig):
    """The kernel's route. A CUDA ``q`` launches the kernel. A meta ``q``
    takes the same checks, the same tiling (:func:`tiling`, the C rule in
    Python) and makes and sums the same tensors, the workspace path's
    workspace (a persistent grid as on an H100), the tile layout's
    fold-pass output (one slot a KV head and KV block) and the decode
    layout's workspace (one slot a unit and KV block) among them; the
    other layouts allocate none. It computes nothing, so a dry run counts
    what the card does and refuses what it refuses. A CUDA launch is
    counted where it launches: ``efta_attention.launches`` and
    ``.launches_by_layout`` (by layout and Sq)."""
    dtype = q.dtype
    if dtype not in DTYPES:
        raise TypeError(f"efta_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for t in (k, v):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError("q, k and v must share one device and dtype")
    if cfg.mode not in MODES:
        raise ValueError(f"unknown EFTA mode {cfg.mode!r}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    BH, D = c.b * c.h, c.d
    launch = q.device.type == "cuda"
    shapes = (DTYPES[dtype], c.block_q, c.block_kv, D, c.s_kv, c.s_out,
              _MAX_GROUPS, bool(cfg.unified))
    t = kernel_tiling(*shapes) if launch else tiling(*shapes)
    if t is None:
        raise ValueError(f"efta_attention kernel: block_kv {c.block_kv} "
                         f"(stride {c.s_kv}) x head_dim {D} has no "
                         f"tiling that fits one thread block")
    # thread blocks per query tile: one takes 16, 32 or 64 rows of one
    # reference tile; the cluster layout's tile rows take a cluster of them;
    # the decode layout: a count row for each part of each KV block and
    # one for its state pass
    n_sub = (c.n_kv * t.decode + 1 if t.decode else
             -(-c.block_q // (16 * t.W)) * max(t.cluster, 1))
    out = torch.empty_like(q)
    rep = torch.empty((BH, c.n_q * n_sub, 5), dtype=torch.int32,
                      device=q.device)
    ws, slots = None, 0
    if t.decode:
        # a unit: a KV head's query heads (8 at most) at one query tile
        slots = BH // c.grp * -(-c.grp // _DC_ROWS) * c.n_q * c.n_kv
        ws = torch.empty((slots, t.slot_floats), dtype=torch.float32,
                         device=q.device)
    elif t.tile:
        slots = c.b * c.h // c.grp * c.n_kv
        ws = torch.empty((slots, t.slot_floats), dtype=torch.float32,
                         device=q.device)
    elif t.wide:
        sms = (torch.cuda.get_device_properties(q.device)
               .multi_processor_count if launch else H100_SMS)
        slots = min(BH * c.n_q * n_sub, t.per_sm * sms)
        ws = torch.empty((slots, t.slot_floats), dtype=torch.float32,
                         device=q.device)
    if launch:
        lib = _lib()
        eps1, eps2, eps3 = c.eps
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.efta_attention_launch(
            DTYPES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), rep.data_ptr(),
            BH, c.grp, c.sq, k.shape[2], D, c.block_q, c.block_kv, c.n_q,
            c.n_kv, c.kv_len, c.s_kv, c.s_out, int(c.causal), c.window,
            c.scale, eps1, eps2, eps3, c.cap, c.cap * c.g_kv, c.cap - 1e-3,
            float(c.kv_len) + 1e-3,
            MODES[cfg.mode], int(cfg.unified), int(cfg.shadow_rowsum),
            int(cfg.shadow_rowmax), _MAX_GROUPS, *c.fault,
            None if ws is None else ws.data_ptr(), slots, stream)
        if rc != 0:
            msg = lib.efta_attention_error_string(rc).decode()
            raise RuntimeError(f"efta_attention kernel ({t.layout} layout) "
                               f"launch failed: CUDA error {rc} ({msg})")
        efta_attention.launches += 1
        efta_attention.launches_by_layout[(t.layout, c.sq)] += 1
    # per-thread-block partial counts, summed here: no atomics
    return out, rep.reshape(BH, c.n_q, n_sub, 5).sum(dim=2,
                                                    dtype=torch.int32)


def fault_descriptor(spec, heads: int) -> np.ndarray:
    """Translate a :class:`FaultSpec` of (n_faults,) entries into the
    kernel's int32[8] descriptor ``[site, kv_block, batch * heads + head,
    row, col, bit, on, 0]``. The kernel takes one SEU per call, so more
    than one enabled entry raises; none gives a disabled descriptor.
    Coordinates pass through unclamped: one outside the tile flips
    nothing."""
    site = np.asarray(spec.site).reshape(-1)
    if np.asarray(spec.site).ndim != 1:
        raise ValueError("fault_descriptor takes a (n_faults,) FaultSpec")
    on = np.flatnonzero(site >= 0)
    if on.size > 1:
        raise ValueError(f"the fused EFTA kernel takes one fault per call; "
                         f"got {on.size} enabled entries")
    if on.size == 0:
        return np.zeros((8,), np.int32)
    i = int(on[0])

    def at(a):
        return int(np.asarray(a).reshape(-1)[i])

    return np.asarray([at(spec.site), at(spec.block),
                       at(spec.batch) * heads + at(spec.head), at(spec.row),
                       at(spec.col), at(spec.bit), 1, 0], np.int32)
