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
There is no fallback from one to the other.

Fault descriptor (int32[8]): ``[site, kv_block, bh, row, col, bit, on, _]``
with ``bh = batch * H + head`` and ``row`` the absolute query row — one SEU
per call (:func:`fault_descriptor` builds it from a :class:`FaultSpec`).
"""
from __future__ import annotations

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
    if q.device.type == "cuda":
        out = _efta_cuda(call, q, k, v, cfg)
        efta_attention.launches += 1
        return out
    raise ValueError(f"efta_attention runs on cpu or cuda tensors; got "
                     f"{q.device}")


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
    (``efta_attention.launches`` counts those launches).
    """
    out, rep = _tile_counts(q, k, v, cfg=cfg, causal=causal, window=window,
                            kv_len=kv_len, sm_scale=sm_scale, fault=fault,
                            block_q=block_q)
    return out, rep.sum(dim=(0, 1), dtype=torch.int32)


efta_attention.launches = 0


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
             + [ctypes.c_int] * 4                  # mode unified shadows
             + [ctypes.c_int] * 8                  # fault descriptor
             + [ctypes.c_void_p])                  # stream


def _lib():
    lib = _build.load("efta_attention")
    if not getattr(lib, "_efta_bound", False):
        lib.efta_attention_launch.argtypes = _ARGTYPES
        lib.efta_attention_launch.restype = ctypes.c_int
        lib.efta_attention_tiles.argtypes = [ctypes.c_int] * 5
        lib.efta_attention_tiles.restype = ctypes.c_int
        lib.efta_attention_error_string.argtypes = [ctypes.c_int]
        lib.efta_attention_error_string.restype = ctypes.c_char_p
        lib._efta_bound = True
    return lib


def _efta_cuda(c: _Call, q, k, v, cfg: EFTAConfig):
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
    lib = _lib()
    # sub-tiles per query tile: the kernel gives each thread block a few
    # rows of one reference tile (0 = the shapes do not fit an SM)
    n_sub = lib.efta_attention_tiles(c.block_q, c.block_kv, D, c.s_kv,
                                     c.s_out)
    if n_sub <= 0:
        raise ValueError(f"efta_attention kernel: block_kv {c.block_kv} x "
                         f"head_dim {D} does not fit one thread block")
    out = torch.empty_like(q)
    rep = torch.empty((BH, c.n_q * n_sub, 5), dtype=torch.int32,
                      device=q.device)
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
        int(cfg.shadow_rowmax), *c.fault, stream)
    if rc != 0:
        msg = lib.efta_attention_error_string(rc).decode()
        raise RuntimeError(f"efta_attention kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
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
