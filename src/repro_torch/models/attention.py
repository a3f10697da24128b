"""Attention block: GQA/MQA + RoPE + sliding window + cross-attention,
with the paper's EFTA as the attention implementation, over three kinds of
KV:

  * none — the full sequence attends to itself (training forward, logits,
    the encoder);
  * a ring :class:`KVCache` per slot (``slot = position % cache_len``):
    prefill attends within the prompt, decode over the valid region of the
    ring, with each slot's absolute position reconstructed so causal and
    sliding-window masks stay exact after wraparound;
  * the paged, checksummed :class:`PagedKVCache` of the paged serve engine,
    through the fused paged kernel; :func:`paged_rollback` truncates the
    rows a speculative step scored and the acceptance stage rejected.

Contiguous attention dispatches through :func:`repro_torch.kernels.ops.
attention` on ``FTCfg.attn_impl``; ``efta_pallas`` (the fused contiguous
kernel) serves the full sequence and ring prefill, and ring decode sends it
to plain-PyTorch ``efta`` with the reconstructed ``kv_positions``, as the
JAX package does. :func:`cross_attn_apply` attends the decoder to the
encoder's memory (non-causal, ``attn_impl`` in every mode, decode included).
Every projection goes through ``layers.matmul`` with ``FTCfg.ff_abft``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import AttnCfg, FTCfg
from repro_torch.core import checksum as cks
from repro_torch.core.efta import EFTAConfig, FTReport
from repro_torch.kernels.efta_paged import efta_paged_attention
from repro_torch.kernels.ops import attention as attention_op
from repro_torch.models.layers import dense_init, matmul, rope


@dataclasses.dataclass
class KVCache:
    """Per-slot ring KV caches, stacked over layers: ``k``/``v`` (L, B,
    Hkv, cache_len, hd); ``pos`` (B,) int32 tokens seen so far by each row
    (every layer shares it). Keys are cached post-RoPE, so ring wraparound
    needs no re-rotation. :meth:`layer` gives one layer's view (4-D k/v).
    The forward writes K/V in place and returns the advanced ``pos`` in a
    new cache, so a step that is retried rewrites the same slots and
    commits nothing until the caller keeps its result.

    ``ck``/``cv`` (L, B, Hkv, M, hd) hold the cross-attention memory of the
    encoder-decoder families: the K/V projections of the encoder's M output
    rows, computed once at prefill and read by every decode step (None for
    the decoder-only families). The JAX package allocates a placeholder of
    ``max(frontend_tokens, 1)`` rows and swaps in the M rows at prefill;
    here the prefill's new cache holds new ``ck``/``cv`` tensors of M rows.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    ck: Optional[torch.Tensor] = None
    cv: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "KVCache":
        cross = {} if self.ck is None else dict(ck=self.ck[i], cv=self.cv[i])
        return dataclasses.replace(self, k=self.k[i], v=self.v[i], **cross)


def init_cache(batch: int, a: AttnCfg, *, cache_len: int, dtype, device,
               num_layers: int = 1, cross_len: int = 0) -> KVCache:
    """Zeroed ring caches; ``cross_len > 0`` adds the cross-attention
    memory placeholder of ``cross_len`` rows, which prefill replaces."""
    shape = (num_layers, batch, a.num_kv_heads, cache_len, a.head_dim)
    cross = {}
    if cross_len > 0:
        cshape = shape[:3] + (cross_len, a.head_dim)
        cross = dict(ck=torch.zeros(cshape, dtype=dtype, device=device),
                     cv=torch.zeros(cshape, dtype=dtype, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32,
                                   device=device), **cross)


@dataclasses.dataclass
class PagedKVCache:
    """The paged serve engine's checksummed block pool, as the model sees it
    for one unified step.

    Pools are stacked over layers, ``(L, num_blocks + 1, Hkv, block_size,
    hd)`` for K/V and ``(L, num_blocks + 1, Hkv, check_stride, hd)`` for the
    resident :func:`~repro_torch.core.checksum.encode_kv` planes; row 0 is
    the null block. :meth:`layer` gives one layer's view (4-D pools). The
    step is multi-token: request ``b`` feeds ``q_len[b]`` rows at positions
    ``pos[b] ..``; ``bad`` is the output plane of resident-checksum
    mismatches found this step, by table slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    kc1: torch.Tensor
    kc2: torch.Tensor
    vc1: torch.Tensor
    vc2: torch.Tensor
    bt: torch.Tensor      # (B, table_len) int32, 0-padded
    pos: torch.Tensor     # (B,) int32 tokens resident before this step
    q_len: torch.Tensor   # (B,) int32 valid chunk rows (0 = idle slot)
    bad: torch.Tensor     # (B, table_len) int32 mismatch flags

    def layer(self, i: int) -> "PagedKVCache":
        return dataclasses.replace(
            self, k=self.k[i], v=self.v[i], kc1=self.kc1[i],
            kc2=self.kc2[i], vc1=self.vc1[i], vc2=self.vc2[i])


def efta_cfg(ft: FTCfg) -> EFTAConfig:
    return EFTAConfig(mode=ft.mode, stride=ft.stride, block_kv=ft.block_kv,
                      unified=ft.unified, shadow_rowsum=ft.shadow_rowsum,
                      shadow_rowmax=ft.shadow_rowmax,
                      kv_stride_override=ft.kv_stride_override,
                      out_stride_override=ft.out_stride_override)


def attn_init(gen: torch.Generator, d_model: int, a: AttnCfg, dtype, device,
              out=None):
    out = out or {}
    hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    shapes = {"wq": (d_model, hq), "wk": (d_model, hkv),
              "wv": (d_model, hkv), "wo": (hq, d_model)}
    return {k: dense_init(gen, *io, dtype, device, out=out.get(k))
            for k, io in shapes.items()}


def _paged_chunk(q, k, v, cache: PagedKVCache, *, cfg: EFTAConfig, window,
                 sm_scale, fault):
    """One unified batched multi-token step against one layer's block pool.

    ``q``/``k``/``v``: this step's projected (+RoPE'd) (B, H|Hkv, C, hd)
    chunk tensors. Appends every valid row's K/V into its request's blocks
    (a chunk may straddle a block edge), regenerates the checksums of
    exactly the blocks the chunk touched, then launches the fused paged
    kernel over the block tables (append before attend, so each chunk row
    attends to itself and its predecessors).

    Laundering guard: refreshing a checksum over a corrupted row would make
    the corruption permanently consistent. Only the first touched block can
    hold earlier valid rows (``pos % bs > 0``), so it is verified against
    its pre-append checksums first and its flag joins the kernel's ``bad``
    plane.

    Unlike the JAX package's functional ``.at[].set``, the pools are updated
    IN PLACE. A step the engine retries re-appends the same rows at the same
    positions and restamps the same blocks, so the pool after a retry equals
    the pool of a clean run. A first block the guard flags is not restamped,
    so it stays flagged until the engine re-prefills it (which restamps it):
    if the repair does not hold, every retry sees the corruption again.
    Returns (out (B, H, C, hd), FTReport with (B, 5) counts,
    bad (B, table_len) int32).
    """
    bs = cache.k.shape[2]
    cs = cache.kc1.shape[2]
    thr = cks.kv_block_threshold(cache.k.dtype)
    dev = q.device
    bt = cache.bt.long()
    pos = cache.pos.long()
    q_len = cache.q_len.long()
    mb = bt.shape[1]
    c_width = k.shape[2]
    j0 = pos // bs
    off = pos % bs

    # -- laundering guard: pre-verify the first touched block's prior rows
    tgt0 = bt.gather(1, j0.clamp(max=mb - 1)[:, None])[:, 0]
    bad_tk, _ = cks.verify_block(
        cache.k[tgt0], cks.Checksums(cache.kc1[tgt0], cache.kc2[tgt0]), cs,
        threshold=thr)
    bad_tv, _ = cks.verify_block(
        cache.v[tgt0], cks.Checksums(cache.vc1[tgt0], cache.vc2[tgt0]), cs,
        threshold=thr)
    tail_bad = ((bad_tk | bad_tv).any(dim=-1) & (tgt0 > 0) & (off > 0)
                & (q_len > 0))                                 # (B,)

    # -- scatter the chunk's K/V rows into their blocks; padding rows
    # (c >= q_len) divert to the null scratch block
    c_idx = torch.arange(c_width, device=dev)
    p_abs = pos[:, None] + c_idx[None, :]                      # (B, C)
    valid = c_idx[None, :] < q_len[:, None]
    jrow = (p_abs // bs).clamp(0, mb - 1)
    tgt_rows = torch.where(valid, bt.gather(1, jrow), 0)
    offs = torch.where(valid, p_abs % bs, 0)
    cache.k[tgt_rows, :, offs, :] = k.transpose(1, 2).to(cache.k.dtype)
    cache.v[tgt_rows, :, offs, :] = v.transpose(1, 2).to(cache.v.dtype)

    # -- checksums for exactly the blocks the chunk touched (the first may
    # be partial, the rest start at row 0; untouched -> null block). A first
    # block the guard flagged keeps its old checksums: restamping it here,
    # in place, would make the corruption consistent for the retry.
    nt = (c_width + bs - 2) // bs + 1      # most blocks a C-row chunk spans
    jt = j0[:, None] + torch.arange(nt, device=dev)[None, :]   # (B, nt)
    last = (pos + q_len.clamp(min=1) - 1) // bs
    touched = ((jt <= last[:, None]) & (q_len[:, None] > 0)
               & ~((jt == j0[:, None]) & tail_bad[:, None]))
    tid = torch.where(touched, bt.gather(1, jt.clamp(0, mb - 1)), 0)
    kc = cks.encode_kv(cache.k[tid], cs)               # (B, nt, Hkv, cs, hd)
    vc = cks.encode_kv(cache.v[tid], cs)
    cache.kc1[tid] = kc.c1
    cache.kc2[tid] = kc.c2
    cache.vc1[tid] = vc.c1
    cache.vc2[tid] = vc.c2

    rep = efta_paged_attention(
        q, cache.k, cache.v,
        cks.Checksums(cache.kc1, cache.kc2), cks.Checksums(cache.vc1,
                                                           cache.vc2),
        cache.bt, (pos + q_len).to(torch.int32), cache.q_len, cfg=cfg,
        check_threshold=thr, window=window, sm_scale=sm_scale, fault=fault)

    tail_plane = ((torch.arange(mb, device=dev)[None, :] == j0[:, None])
                  & tail_bad[:, None])
    bad = (rep.bad_blocks | tail_plane).to(torch.int32)
    det = rep.detected[:, :5]
    report = FTReport(
        detected=det,
        corrected=det if cfg.mode == "correct" else torch.zeros_like(det),
        max_delta=torch.zeros((3,), dtype=torch.float32, device=dev))
    return rep.out, report, bad


def paged_rollback(k, v, kc1, kc2, vc1, vc2, bt, keep_pos, old_pos, *,
                   check_stride: int, threshold: float) -> torch.Tensor:
    """Fault-tolerant KV rollback: truncate rejected speculative rows, in
    place.

    The propose→score→accept step appends every scored chunk row's K/V into
    the paged block pool before the acceptance verdict exists (append
    before attend). When the target rejects a draft suffix, rows
    ``keep_pos[b] .. old_pos[b] - 1`` of request ``b`` are junk: this zeroes
    them (``kv_len`` truncation, the zero-padded partial block convention of
    the scatter path) and regenerates the touched tail blocks' checksums
    over the truncated content.

    Laundering guard: restamping a checksum from the current content of a
    block corrupted between the scoring step's verify and this rollback
    would make the corruption permanently undetectable. So every touched
    block is first verified against its **pre-rollback** checksums; the
    returned ``bad`` plane flags mismatches, and the engine re-prefills
    those blocks.

    ``k``/``v``: (L, num_blocks+1, Hkv, bs, hd) pools (row 0 = null block);
    ``kc1..vc2`` their resident checksum planes; ``bt`` (B, mb) block
    tables; ``keep_pos``/``old_pos`` (B,) with ``keep_pos <= old_pos``.
    Slots with ``keep_pos == old_pos`` are untouched. Touched blocks are
    private tail blocks (shared ones were copy-on-write split before the
    speculative append), so no two slots roll back the same block. The JAX
    package sizes the touched-block window by a static ``max_span``; here it
    is the largest span of this call, which gives the same result. Returns
    ``bad`` (B, mb) int32.
    """
    bs = k.shape[3]
    mb = bt.shape[1]
    cs = kc1.shape[3]
    dev = k.device
    bt = bt.long()
    keep = keep_pos.long()
    old = old_pos.long()
    bad = torch.zeros(bt.shape, dtype=torch.int32, device=dev)
    span = int((old - keep).max()) if keep.numel() else 0
    if span <= 0:
        return bad
    nt = (span + bs - 2) // bs + 1         # most blocks a rollback touches
    j0 = keep // bs
    jt = j0[:, None] + torch.arange(nt, device=dev)[None, :]       # (B, nt)
    last = (torch.maximum(old, keep + 1) - 1) // bs
    touched = (jt <= last[:, None]) & (old > keep)[:, None]
    jc = jt.clamp(0, mb - 1)
    tid = torch.where(touched, bt.gather(1, jc), 0)

    # -- laundering guard: verify against the PRE-rollback checksums first
    bad_k, _ = cks.verify_block(
        k[:, tid], cks.Checksums(kc1[:, tid], kc2[:, tid]), cs,
        threshold=threshold)
    bad_v, _ = cks.verify_block(
        v[:, tid], cks.Checksums(vc1[:, tid], vc2[:, tid]), cs,
        threshold=threshold)
    bad_t = (bad_k | bad_v).any(dim=0).any(dim=-1) & (tid > 0)    # (B, nt)
    b_idx = torch.arange(bt.shape[0], device=dev)[:, None].expand_as(jc)
    bad.index_put_((b_idx, jc), bad_t.to(torch.int32), accumulate=True)
    bad = (bad > 0).to(torch.int32)

    # -- truncate: zero exactly the rejected rows of the touched blocks
    rows_abs = jt[:, :, None] * bs + torch.arange(bs, device=dev)
    kill = ((rows_abs >= keep[:, None, None]) & (rows_abs < old[:, None, None])
            & touched[:, :, None])                                 # (B,nt,bs)
    kmask = kill[None, :, :, None, :, None]
    kb = torch.where(kmask, torch.zeros((), dtype=k.dtype, device=dev),
                     k[:, tid])
    vb = torch.where(kmask, torch.zeros((), dtype=v.dtype, device=dev),
                     v[:, tid])
    k[:, tid] = kb
    v[:, tid] = vb

    # -- restamp the touched blocks' checksums over the truncated content
    ck = cks.encode_kv(kb, check_stride)
    cv = cks.encode_kv(vb, check_stride)
    kc1[:, tid] = ck.c1
    kc2[:, tid] = ck.c2
    vc1[:, tid] = cv.c1
    vc2[:, tid] = cv.c2
    return bad


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _ring_decode(q, k, v, cache: KVCache, positions, *, impl, cfg, window,
                 sm_scale, fault):
    """Append rows at ``positions`` (B, S) into one layer's ring cache (in
    place) and attend over its valid region, each row from its own
    reconstructed absolute positions."""
    cache_len = cache.k.shape[2]
    dev = q.device
    slots = positions % cache_len                              # (B, S)
    rows = torch.arange(q.shape[0], device=dev)[:, None]
    cache.k[rows, :, slots, :] = k.transpose(1, 2).to(cache.k.dtype)
    cache.v[rows, :, slots, :] = v.transpose(1, 2).to(cache.v.dtype)
    new_pos = positions[:, -1:] + 1                            # (B, 1)
    slot_idx = torch.arange(cache_len, device=dev)[None, :]
    last_written = new_pos - 1 - ((new_pos - 1 - slot_idx) % cache_len)
    kv_positions = torch.where(last_written >= 0, last_written, -1)
    return attention_op(
        q, cache.k, cache.v, impl="efta" if impl == "efta_pallas" else impl,
        cfg=cfg, causal=True, window=window, q_offset=positions[:, 0],
        kv_positions=kv_positions, sm_scale=sm_scale, fault=fault)


def attn_apply(params, x: torch.Tensor, *, acfg: AttnCfg, ft: FTCfg,
               window: Optional[int], positions: torch.Tensor,
               cache=None, mode: str = "train", fault=None):
    """Self-attention of one layer. ``x``: (B, S, d_model); ``positions``:
    (B, S) absolute positions. ``cache``: None (full sequence), one layer's
    :class:`KVCache` (``mode`` "prefill" attends within the prompt and
    fills the ring; "decode" appends and attends over the ring) or one
    layer's :class:`PagedKVCache` (``mode`` "decode", the unified paged
    step). ``fault``: a :class:`~repro_torch.core.fault.FaultSpec` on the
    contiguous paths, the paged kernel's int32[8] descriptor on the paged
    one. Returns (y, FTReport with (B, 5) counts, bad plane or None)."""
    paged = isinstance(cache, PagedKVCache)
    if paged and mode != "decode":
        raise NotImplementedError(
            "PagedKVCache attention is the unified batched decode/extend "
            "step; prefill has no paged cache")
    hd, h, hkv = acfg.head_dim, acfg.num_heads, acfg.num_kv_heads
    ff = ft.ff_abft
    # the JAX package's _tp_heads / _tp_kv place the heads over 'model'
    # under a mesh: placements only, the values are one device's; on a
    # mesh here the rank computes every head of its batch block with
    # gathered weights
    q = _split_heads(matmul(x, params["wq"], ff_abft=ff), h, hd)
    k = _split_heads(matmul(x, params["wk"], ff_abft=ff), hkv, hd)
    v = _split_heads(matmul(x, params["wv"], ff_abft=ff), hkv, hd)
    if acfg.pos == "rope":
        q = rope(q.transpose(1, 2), positions, acfg.rope_theta).transpose(1, 2)
        k = rope(k.transpose(1, 2), positions, acfg.rope_theta).transpose(1, 2)
    cfg = efta_cfg(ft)
    bad = None
    if paged:
        out, rep, bad = _paged_chunk(q, k, v, cache, cfg=cfg, window=window,
                                     sm_scale=acfg.softmax_scale, fault=fault)
    elif cache is not None and mode == "decode":
        out, rep = _ring_decode(q, k, v, cache, positions, impl=ft.attn_impl,
                                cfg=cfg, window=window,
                                sm_scale=acfg.softmax_scale, fault=fault)
    else:
        if cache is not None:
            # prefill: fill the fresh ring, attend within the prompt itself
            slots = positions[0] % cache.k.shape[2]
            cache.k[:, :, slots, :] = k.to(cache.k.dtype)
            cache.v[:, :, slots, :] = v.to(cache.v.dtype)
        out, rep = attention_op(q, k, v, impl=ft.attn_impl, cfg=cfg,
                                causal=acfg.causal, window=window,
                                sm_scale=acfg.softmax_scale, fault=fault)
    return matmul(_merge_heads(out), params["wo"], ff_abft=ff), rep, bad


def cross_attn_apply(params, x: torch.Tensor, *, acfg: AttnCfg, ft: FTCfg,
                     positions: torch.Tensor, memory=None, cache=None,
                     mode: str = "train"):
    """Cross-attention of one decoder layer to the encoder's memory.

    ``x``: (B, S, d_model); ``positions``: (B, S) decoder positions (RoPE
    rotates q only; keys are encoder rows). K/V are projected from
    ``memory`` (B, M, d_model) with ``wk``/``wv`` in ``mode`` "train" and
    "prefill", and read from one layer's ``cache.ck``/``cache.cv`` in
    "decode". Non-causal, through ``ft.attn_impl`` in every mode (decode
    included: unlike self-attention, the cross branch does not send
    ``efta_pallas`` decode to ``efta``); no fault strikes it. Returns (y,
    FTReport with (B, 5) counts, (k, v) to keep in the cache, or None in
    decode)."""
    hd, h, hkv = acfg.head_dim, acfg.num_heads, acfg.num_kv_heads
    ff = ft.ff_abft
    q = _split_heads(matmul(x, params["wq"], ff_abft=ff), h, hd)
    if cache is not None and mode == "decode":
        k, v, kv = cache.ck, cache.cv, None
    else:
        k = _split_heads(matmul(memory, params["wk"], ff_abft=ff), hkv, hd)
        v = _split_heads(matmul(memory, params["wv"], ff_abft=ff), hkv, hd)
        kv = (k, v)
    if acfg.pos == "rope":
        q = rope(q.transpose(1, 2), positions, acfg.rope_theta).transpose(1, 2)
    out, rep = attention_op(q, k, v, impl=ft.attn_impl, cfg=efta_cfg(ft),
                            causal=False, sm_scale=acfg.softmax_scale)
    return matmul(_merge_heads(out), params["wo"], ff_abft=ff), rep, kv
