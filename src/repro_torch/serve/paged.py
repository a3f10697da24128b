"""Fault-tolerant paged KV-cache serve engine (vLLM-style block pool).

KV lives in a global block pool ``(num_layers, num_blocks + 1, Hkv,
block_size, head_dim)`` addressed through per-request block tables; identical
prompt prefixes are stored once (hash-chain prefix cache with refcounted
copy-on-write sharing, ``repro_torch.serve.blocks``) and a preempted request
frees exactly its blocks.

Two backends (``kernel=``):

  * ``"fused"`` runs one **unified batched step** per engine iteration: each
    slot feeds a chunk of up to ``chunk_size`` tokens — new prompts prefill
    chunk by chunk, repairs re-prefill a block, steady-state requests decode
    one token — all through the same multi-token fused paged-attention
    kernel (``repro_torch.kernels.efta_paged``, one launch per layer). Steps
    are either ``chunk_size`` wide or 1 wide; the engine records the widths
    it launched in ``chunk_widths``. A scheduler ``chunk_budget`` bounds the
    prompt tokens per step so long prompts never head-of-line-block other
    requests' decodes.
  * ``"gather"`` (the portable baseline, the JAX package's default)
    materializes each slot's table into the contiguous layout of a ring
    cache (``repro_torch.kernels.ops.gather_block_kv``) and decodes all
    slots with plain-PyTorch EFTA; prompt prefill, prefix extension and
    repair run through one fixed-width chunked ``Model.extend`` per request.

Both compute the same values at the same positions, so the two backends
give the same greedy tokens.

Fault story: every block carries a checksum pair (``encode_kv`` along the
token axis) written on append and **verified at every read** — on the
gathered blocks outside attention (``gather``), or in the kernel pass that
streams the block (``fused``) — so a resident bit flip is detected at read
time (telemetry site 6, ``kv``) and repaired by re-prefilling only the
poisoned block, then the step retries. EFTA compute-site SEUs are corrected
in place, or retried when only detected. ``kv_verify="stamped"`` amortizes
the gather backend's checksum folds over per-block generation stamps
(``serve.blocks``): steady-state decode folds about one tail block per slot
instead of the whole table, deferring the detection of flips that land in
verified, untouched blocks; ``scrub_interval`` bounds that deferral with a
background scrub that re-folds the ``scrub_batch`` oldest-verified live (then
parked) blocks every that many committed steps.

``speculate`` turns the step into **propose→score→accept**: each slot
proposes up to ``draft_len`` tokens (``repro_torch.serve.draft``: n-gram
prompt lookup or an EFTA-protected draft model), one chunked step scores the
pending token plus the drafts (``q_len = 1 + K`` rows), the host acceptance
stage (``repro_torch.serve.sampling.speculative_accept``) commits the longest
valid prefix, and the rejected rows already appended to blocks are rewound by
fault-tolerant truncation (``models.attention.paged_rollback``): touched tail
blocks re-verify against their PRE-rollback checksums before they are
restamped, so corruption landing mid-rollback is detected and repaired,
never laundered into a consistent state. Greedy speculation is token-
identical to plain decoding.

Unlike the JAX package's functional state, the pool is written in place: a
step that is retried re-appends the same rows at the same positions, and a
step is committed by advancing the host's positions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.fault import FaultSpec, flip_bit_at
from repro_torch.kernels.efta_paged import paged_fault_descriptor
from repro_torch.kernels.ops import gather_block_kv
from repro_torch.models.api import Model
from repro_torch.models.attention import KVCache, PagedKVCache, paged_rollback
from repro_torch.serve.blocks import NULL_BLOCK, BlockPool, PrefixCache
from repro_torch.serve.draft import build_proposer
from repro_torch.serve.engine import ServeEngine, StepReport
from repro_torch.serve.sampling import sample_tokens, speculative_accept
from repro_torch.serve.scheduler import Request


class PagedKVState(NamedTuple):
    """Device-resident block pool. Row 0 of every array is the null block
    (scratch for padded table entries — never verified, never read back).
    The tensors are updated in place."""

    k: torch.Tensor     # (L, num_blocks+1, Hkv, block_size, head_dim)
    v: torch.Tensor
    kc1: torch.Tensor   # (L, num_blocks+1, Hkv, check_stride, head_dim)
    kc2: torch.Tensor
    vc1: torch.Tensor
    vc2: torch.Tensor


@dataclasses.dataclass
class PagedCacheStats:
    kv_detected_blocks: int = 0    # block-checksum mismatches seen at read
    kv_repaired_blocks: int = 0    # blocks healed by re-prefill
    kv_verified_blocks: int = 0    # read-time fold verifications performed
    kv_verify_skips: int = 0       # verifies skipped by generation stamps
    kv_scrubbed_blocks: int = 0    # blocks re-folded by the background scrub
    preemptions: int = 0
    chunked_prefill_tokens: int = 0  # prompt tokens fed through mixed steps
    # speculative decoding (propose→score→accept)
    spec_steps: int = 0            # committed steps that scored >= 1 draft
    spec_proposed_tokens: int = 0  # draft tokens scored by the target
    spec_accepted_tokens: int = 0  # draft tokens committed
    spec_rolled_back_rows: int = 0  # rejected KV rows truncated by rollback
    rollback_detected_blocks: int = 0  # corruption caught by the rollback's
    #                                    pre-restamp (anti-laundering) guard


class PagedKVPool:
    """Device arrays + host allocators for the paged cache."""

    def __init__(self, model: Model, n_slots: int, cache_len: int,
                 block_size: int, num_blocks: int, check_stride: int):
        cfg = model.cfg
        a = cfg.attn
        if cache_len % block_size:
            raise ValueError("cache_len must be a multiple of block_size")
        dtype = getattr(torch, cfg.dtype)
        L = cfg.num_layers
        kv_shape = (L, num_blocks + 1, a.num_kv_heads, block_size, a.head_dim)
        ck_shape = (L, num_blocks + 1, a.num_kv_heads, check_stride,
                    a.head_dim)
        dev = model.device
        self.state = PagedKVState(
            *(torch.zeros(shape, dtype=dtype, device=dev)
              for shape in (kv_shape, kv_shape, ck_shape, ck_shape,
                            ck_shape, ck_shape)))
        self.blocks = BlockPool(num_blocks, block_size)
        self.prefix = PrefixCache(self.blocks)
        self._free_slots: List[int] = list(range(n_slots))

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def alloc(self) -> Optional[int]:
        return self._free_slots.pop(0) if self._free_slots else None

    def release(self, slot: int) -> None:
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} double-freed")
        self._free_slots.append(slot)
        self._free_slots.sort()


def _largest_divisor_leq(n: int, cap: int) -> int:
    s = min(cap, n)
    while n % s:
        s -= 1
    return s


class _Tally:
    """Per-slot detection counts of one engine step's attempts: EFTA sites
    (n_slots, 5) and resident KV (n_slots,), each also counted on retries
    (``redet``)."""

    def __init__(self, n_slots: int):
        self.det = np.zeros((n_slots, 5), np.int64)
        self.cor = np.zeros((n_slots, 5), np.int64)
        self.redet = np.zeros((n_slots, 5), np.int64)
        self.kv_det = np.zeros((n_slots,), np.int64)
        self.kv_cor = np.zeros((n_slots,), np.int64)
        self.kv_redet = np.zeros((n_slots,), np.int64)

    def six(self, slot: int):
        """(detected, corrected, redetected) 6-vectors of one slot."""
        return (np.concatenate([self.det[slot], self.kv_det[slot:slot + 1]]),
                np.concatenate([self.cor[slot], self.kv_cor[slot:slot + 1]]),
                np.concatenate([self.redet[slot],
                                self.kv_redet[slot:slot + 1]]))


class PagedServeEngine(ServeEngine):
    """Continuous-batching engine over a checksummed paged block pool.

    ``submit``/``step``/``run`` as in :class:`ServeEngine`, plus
    ``inject_kv_fault`` for resident-state SEU campaigns. ``num_blocks``
    defaults to ring-equivalent capacity (``n_slots * cache_len /
    block_size``). ``kernel``: ``"gather"`` (portable default) or
    ``"fused"`` (the paged kernel driving the unified mixed prefill/decode
    step). ``chunk_size`` is the multi-token step's chunk width (>=
    ``block_size`` so one chunk re-prefills one block; default ``2 *
    block_size``); ``chunk_budget`` caps prompt tokens per mixed step (None
    = unbounded). ``kv_verify``: ``"always"`` (full read-time coverage) or
    ``"stamped"`` (generation-stamped fold skipping on the gather backend),
    with ``scrub_interval > 0`` adding a background scrub of ``scrub_batch``
    blocks every that many committed steps. The fused kernel reads its
    checksum threshold from ``kv_block_threshold``; ``check_threshold``
    steers the gather-side verification and the rollback guard.

    ``speculate``: ``"ngram"`` self-drafts by prompt lookup, ``"draft"``
    decodes ``draft_model``/``draft_params`` through the same EFTA path; up
    to ``draft_len`` draft rows per slot ride the scored chunk (padded to
    the chunk width), the acceptance stage commits the longest valid
    prefix, and rejected rows roll back with checksum-verified truncation.
    The model's device is the engine's device.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 8,
                 cache_len: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 check_stride: Optional[int] = None,
                 check_threshold: Optional[float] = None,
                 max_retries: int = 2, retry_on_detect: bool = True,
                 chunk_size: Optional[int] = None,
                 chunk_budget: Optional[int] = None,
                 kernel: str = "gather", kv_verify: str = "always",
                 scrub_interval: int = 0, scrub_batch: int = 4,
                 speculate: str = "off", draft_len: int = 4,
                 draft_model: Optional[Model] = None, draft_params=None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kernel not in ("gather", "fused"):
            raise ValueError(f"kernel must be 'gather' or 'fused'; "
                             f"got {kernel!r}")
        if kv_verify not in ("always", "stamped"):
            raise ValueError(f"kv_verify must be 'always' or 'stamped'; "
                             f"got {kv_verify!r}")
        cl = cache_len or model.cfg.max_seq
        cl = -(-cl // block_size) * block_size     # round up to block grid
        self.block_size = block_size
        self.max_blocks = cl // block_size
        self.num_blocks = num_blocks or n_slots * self.max_blocks
        self.check_stride = check_stride or _largest_divisor_leq(block_size, 8)
        if block_size % self.check_stride:
            raise ValueError("check_stride must divide block_size")
        if check_threshold is None:
            check_threshold = cks.kv_block_threshold(
                getattr(torch, model.cfg.dtype))
        self.check_threshold = check_threshold
        self.kernel = kernel
        self.kv_verify = kv_verify
        self.chunk_size = min(chunk_size or 2 * block_size, cl)
        if self.chunk_size < block_size:
            raise ValueError(
                f"chunk_size ({self.chunk_size}) must be >= block_size "
                f"({block_size}): block repair re-prefills one block per "
                f"chunk")
        if scrub_interval and kernel == "fused":
            raise ValueError(
                "scrub_interval is a gather/stamped amortization: the fused "
                "kernel re-verifies every streamed block in-loop each step, "
                "so a background scrub would never run there")
        self.scrub_interval = scrub_interval
        self.scrub_batch = scrub_batch
        if speculate not in ("off", "ngram", "draft"):
            raise ValueError(f"speculate must be 'off', 'ngram' or 'draft'; "
                             f"got {speculate!r}")
        self.speculate = speculate
        if speculate == "off":
            self.draft_len = 0
            self._proposer = None
        else:
            if draft_len < 1:
                raise ValueError("speculation needs draft_len >= 1")
            # the scored chunk is the pending token + K drafts, padded to
            # the chunk width
            self.draft_len = min(draft_len, self.chunk_size - 1)
            if self.draft_len < 1:
                raise ValueError(
                    f"chunk_size ({self.chunk_size}) leaves no room for "
                    f"draft rows; speculation needs chunk_size >= 2")
            self._proposer = build_proposer(
                speculate, n_slots=n_slots, cache_len=cl,
                chunk_size=self.chunk_size, draft_model=draft_model,
                draft_params=draft_params)
        # fault-campaign hook: called after the scoring step committed and
        # before the KV rollback runs, on the pool as the step left it — lets
        # tests strike resident state mid-rollback
        self._pre_rollback_hook = None
        super().__init__(model, params, n_slots=n_slots, cache_len=cl,
                         max_retries=max_retries,
                         retry_on_detect=retry_on_detect)
        self.scheduler.chunk_budget = chunk_budget
        self.paged_stats = PagedCacheStats()
        # chunk widths the fused step launched: chunk_size and 1, whatever
        # the prompt lengths and draft counts
        self.chunk_widths: Set[int] = set()
        # host mirrors of the block tables / positions, plus the per-slot
        # feed queue (fused backend): tokens whose KV is not yet resident —
        # the prompt suffix while prefilling, exactly the pending token once
        # decoding.
        self._bt = np.zeros((n_slots, self.max_blocks), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)
        self._queue: List[List[int]] = [[] for _ in range(n_slots)]
        self._admit_seq = 0
        # consecutive steps abandoned because corruption outlived repair
        self._poisoned_steps = 0
        # read-time verification selector of the gather backend: "always"
        # folds every table entry; "stamped" folds just the entries whose
        # block generation moved since their last verified read, padded to a
        # small fixed width (full coverage when a step needs more)
        self._sel_all = np.broadcast_to(
            np.arange(self.max_blocks, dtype=np.int32),
            (n_slots, self.max_blocks)).copy()
        self._sel_width = min(4, self.max_blocks)

    def _make_pool(self) -> PagedKVPool:
        return PagedKVPool(self.model, self.n_slots, self.cache_len,
                           self.block_size, self.num_blocks,
                           self.check_stride)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- the fused step -----------------------------------------------------

    def _step_fused(self, tokens: np.ndarray, pos: np.ndarray,
                    q_lens: np.ndarray, faults: FaultSpec):
        """One unified batched step: every slot feeds ``q_lens[slot]`` rows
        of ``tokens`` (0 = idle, 1 = decode, more = chunked prefill, block
        repair, or a pending token plus draft rows) and each layer's
        attention consumes the block pool straight through the fused kernel,
        appending the chunk's K/V in place. The fault batch becomes the
        kernel's single-SEU descriptor. Returns (next tokens (n_slots,)
        sampled at each slot's row ``q_len - 1``, StepReport, bad (n_slots,
        table_len) bool) on the host, and the per-row logits (n_slots, C, V)
        f32 on the device, which the acceptance stage reads."""
        cfg = self.model.cfg
        dev = self.device
        ns = self.n_slots
        chunk = tokens.shape[1]
        self.chunk_widths.add(chunk)
        self.stats.forwards += 1
        grp = cfg.attn.num_heads // cfg.attn.num_kv_heads
        desc = paged_fault_descriptor(faults, grp, chunk=chunk)
        st = self.pool.state
        cache = PagedKVCache(
            k=st.k, v=st.v, kc1=st.kc1, kc2=st.kc2, vc1=st.vc1, vc2=st.vc2,
            bt=self._dev(self._bt), pos=self._dev(pos),
            q_len=self._dev(q_lens),
            bad=torch.zeros((ns, self.max_blocks), dtype=torch.int32,
                            device=dev))
        logits, rep, new_cache = self.model.score(
            self.params, self._dev(tokens), cache, fault=desc)
        idx = self._dev(np.clip(q_lens - 1, 0, chunk - 1)).long()
        last = logits[torch.arange(ns, device=dev), idx]
        next_tokens = sample_tokens(
            last, temperature=self._temps, top_k=self._topks,
            seeds=self._seeds, rids=self._rids, counters=self._counters)
        return (next_tokens, StepReport.of(rep),
                (new_cache.bad > 0).cpu().numpy(), logits)

    # -- the gather backend's computations ---------------------------------

    def _verify_gathered(self, bt: np.ndarray,
                         sel: Optional[np.ndarray] = None):
        """Gather K/V blocks for tables ``bt`` (n, mb) and verify blocks
        against their resident checksums. Returns (k, v, bad): the
        contiguous KV views attention consumes, (L, n, Hkv, mb*bs, hd), and
        ``bad`` (n, mb) bool flagging real (non-null) blocks with a mismatch
        in either operand's checksum pair.

        ``sel`` (n, K) optionally restricts the fold recomputation to K
        table entries per slot (-1 = none): the stamped policy folds only
        the blocks whose content could have moved since their last verified
        read."""
        st = self.pool.state
        btd = self._dev(bt).long()
        s = self.check_stride
        thr = self.check_threshold
        kraw, kg = gather_block_kv(st.k, btd)
        vraw, vg = gather_block_kv(st.v, btd)
        if sel is None:
            bad_k, _ = cks.verify_block(
                kraw, cks.Checksums(st.kc1[:, btd], st.kc2[:, btd]), s,
                threshold=thr)
            bad_v, _ = cks.verify_block(
                vraw, cks.Checksums(st.vc1[:, btd], st.vc2[:, btd]), s,
                threshold=thr)
            # reduce (L, n, mb, Hkv) over layers and heads -> (n, mb)
            bad = (bad_k | bad_v).any(dim=0).any(dim=-1) & (btd > NULL_BLOCK)
            return kg, vg, bad.cpu().numpy()
        del kraw, vraw
        seld = self._dev(sel).long()
        selc = seld.clamp(min=0)                            # (n, K)
        btv = btd.gather(1, selc)                           # (n, K)
        bad_k, _ = cks.verify_block(
            st.k[:, btv], cks.Checksums(st.kc1[:, btv], st.kc2[:, btv]), s,
            threshold=thr)
        bad_v, _ = cks.verify_block(
            st.v[:, btv], cks.Checksums(st.vc1[:, btv], st.vc2[:, btv]), s,
            threshold=thr)
        bad_sel = ((bad_k | bad_v).any(dim=0).any(dim=-1)
                   & (btv > NULL_BLOCK) & (seld >= 0))      # (n, K)
        bad = torch.zeros(btd.shape, dtype=torch.int32, device=self.device)
        rows = torch.arange(btd.shape[0], device=self.device)[:, None]
        bad.index_put_((rows.expand_as(selc), selc), bad_sel.to(torch.int32),
                       accumulate=True)
        return kg, vg, (bad > 0).cpu().numpy()

    def _ring_view(self, kg, vg, pos) -> KVCache:
        """The gathered tables as a ring cache at positions ``pos``."""
        return KVCache(k=kg, v=vg,
                       pos=self._dev(np.asarray(pos, np.int32)))

    def _gather_decode(self, faults: FaultSpec,
                       sel: Optional[np.ndarray]):
        """One batched paged decode step on the gather backend: gather by
        block table, read-time checksum verify, plain-EFTA decode of every
        slot over its gathered view. Returns (next tokens, StepReport, bad
        (n_slots, mb), append): ``append()`` writes the row each slot
        computed into its tail block and refreshes the tail's checksums
        (verified at the next read). The engine calls it only when it
        commits the attempt: restamping a block that this attempt found
        corrupted would make the corruption consistent."""
        dev = self.device
        ns, bs = self.n_slots, self.block_size
        self.stats.forwards += 1
        kg, vg, bad = self._verify_gathered(self._bt, sel)
        if not (np.asarray(faults.site) >= 0).any():
            faults = None
        tokens = self._dev(self._pending[:, None]).long()
        logits, rep, _ = self.model.decode_step(
            self.params, tokens, self._ring_view(kg, vg, self._pos),
            fault=faults, independent_rows=True)
        pos = self._dev(self._pos).long()
        rows = torch.arange(ns, device=dev)
        bt = self._dev(self._bt).long()

        def append():
            st = self.pool.state
            tgt = bt[rows, pos // bs]
            off = pos % bs
            st.k[:, tgt, :, off, :] = kg[:, rows, :, pos, :]  # (ns,L,Hkv,hd)
            st.v[:, tgt, :, off, :] = vg[:, rows, :, pos, :]
            self._restamp(tgt)

        next_tokens = sample_tokens(
            logits.float(), temperature=self._temps, top_k=self._topks,
            seeds=self._seeds, rids=self._rids, counters=self._counters)
        return next_tokens, StepReport.of(rep), bad, append

    def _restamp(self, bids: torch.Tensor) -> None:
        """Regenerate the resident checksums of pool blocks ``bids``."""
        st = self.pool.state
        ck = cks.encode_kv(st.k[:, bids], self.check_stride)
        cv = cks.encode_kv(st.v[:, bids], self.check_stride)
        st.kc1[:, bids] = ck.c1
        st.kc2[:, bids] = ck.c2
        st.vc1[:, bids] = cv.c1
        st.vc2[:, bids] = cv.c2

    def _gather_score(self, tokens: np.ndarray, q_lens: np.ndarray,
                      faults: FaultSpec, sel: Optional[np.ndarray]):
        """Multi-token batched scoring step on the gather backend — the
        *score* stage of propose→score→accept for ``kernel="gather"``.

        Like :meth:`_gather_decode` but each slot feeds ``q_lens[slot]``
        chunk rows (1 = plain decode riding along, more = a pending token
        plus draft rows; 0 = idle), causal within the chunk. Returns (next
        tokens sampled at row ``q_len - 1``, StepReport, bad, per-row logits
        (n_slots, C, V) f32 on the device, append): ``append()``, called on
        commit, writes every valid row's K/V back into its block and
        regenerates the touched blocks' checksums. Padding rows past
        ``q_len`` stay in the gathered view."""
        dev = self.device
        ns, bs, mb = self.n_slots, self.block_size, self.max_blocks
        C = tokens.shape[1]
        self.stats.forwards += 1
        kg, vg, bad = self._verify_gathered(self._bt, sel)
        if not (np.asarray(faults.site) >= 0).any():
            faults = None
        logits, rep, _ = self.model.score(
            self.params, self._dev(tokens).long(),
            self._ring_view(kg, vg, self._pos), fault=faults,
            independent_rows=True)
        pos = self._dev(self._pos).long()
        ql = self._dev(q_lens).long()
        bt = self._dev(self._bt).long()
        c_idx = torch.arange(C, device=dev)
        p_abs = pos[:, None] + c_idx[None, :]                # (ns, C)
        valid = c_idx[None, :] < ql[:, None]
        p_clip = p_abs.clamp(0, self.cache_len - 1)
        rows = torch.arange(ns, device=dev)[:, None]

        def append():
            st = self.pool.state
            tgt_rows = bt.gather(1, (p_abs // bs).clamp(0, mb - 1))[valid]
            offs = (p_abs % bs)[valid]
            # (n_valid, L, Hkv, hd) on both sides
            st.k[:, tgt_rows, :, offs, :] = kg[:, rows, :, p_clip, :][valid]
            st.v[:, tgt_rows, :, offs, :] = vg[:, rows, :, p_clip, :][valid]
            nt = (C + bs - 2) // bs + 1
            jt = (pos // bs)[:, None] + torch.arange(nt, device=dev)[None, :]
            last_j = (pos + ql.clamp(min=1) - 1) // bs
            touched = (jt <= last_j[:, None]) & (ql[:, None] > 0)
            self._restamp(bt.gather(1, jt.clamp(0, mb - 1))[touched])

        idx = (ql - 1).clamp(0, C - 1)
        last = logits[torch.arange(ns, device=dev), idx]
        next_tokens = sample_tokens(
            last.float(), temperature=self._temps, top_k=self._topks,
            seeds=self._seeds, rids=self._rids, counters=self._counters)
        return next_tokens, StepReport.of(rep), bad, logits, append

    def _gather_ctx(self, bids: Sequence[int], n_ctx: int):
        """A batch-1 contiguous ring cache of the blocks ``bids`` holding
        ``n_ctx`` tokens, verifying the blocks read. Returns (row cache, bad
        (mb,) bool over the blocks inside the context)."""
        kg, vg, bad = self._verify_gathered(self._pad_bids(bids)[None])
        in_ctx = np.arange(self.max_blocks) * self.block_size < n_ctx
        return self._ring_view(kg, vg, [n_ctx]), bad[0] & in_ctx

    def _extend(self, tokens: np.ndarray, row: KVCache, length: int,
                fault: FaultSpec):
        """``Model.extend`` of a batch-1 ring cache (written in place; the
        new cache carries the advanced position)."""
        self.stats.forwards += 1
        return self.model.extend(self.params, self._dev(tokens).long(), row,
                                 lengths=[length], fault=fault)

    def _scatter(self, row: KVCache, bids: Sequence[int],
                 length: int) -> None:
        """Write a batch-1 cache's rows into pool blocks. ``bids`` (mb,)
        names the destination of each block-sized row group (null entries
        discard that group); rows at positions >= ``length`` are zeroed, so
        a partial tail block is stored zero-padded and its checksums cover
        the padding deterministically."""
        st = self.pool.state
        mb, bs = self.max_blocks, self.block_size
        groups = [j for j, b in enumerate(bids) if b > NULL_BLOCK]
        if not groups:
            return
        mask = (torch.arange(mb * bs, device=self.device) < length)[
            None, None, :, None]

        def blocks_of(x):      # (L, 1, Hkv, cache_len, hd) -> (L,mb,Hkv,bs,hd)
            x = torch.where(mask, x[:, 0], torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
            L, hkv, _, hd = x.shape
            return x.reshape(L, hkv, mb, bs, hd).transpose(1, 2)

        sel = self._dev(groups).long()
        dst = self._dev([bids[j] for j in groups]).long()
        st.k[:, dst] = blocks_of(row.k)[:, sel]
        st.v[:, dst] = blocks_of(row.v)[:, sel]
        self._restamp(dst)

    def _scrub(self, bids: Sequence[int]) -> np.ndarray:
        """Background-scrub verify: re-fold the resident checksums of pool
        blocks ``bids`` straight off the pool (no gather, no attention).
        Returns bad (len(bids),) bool."""
        st = self.pool.state
        s = self.check_stride
        thr = self.check_threshold
        b = self._dev(bids).long()
        bad_k, _ = cks.verify_block(
            st.k[:, b], cks.Checksums(st.kc1[:, b], st.kc2[:, b]), s,
            threshold=thr)
        bad_v, _ = cks.verify_block(
            st.v[:, b], cks.Checksums(st.vc1[:, b], st.vc2[:, b]), s,
            threshold=thr)
        return ((bad_k | bad_v).any(dim=0).any(dim=-1)
                & (b > NULL_BLOCK)).cpu().numpy()

    # -- resident-state fault injection -------------------------------------

    def inject_kv_fault(self, *, layer: int = 0, block: int = 1,
                        head: int = 0, row: int = 0, col: int = 0,
                        bit: int = 27, into: str = "k") -> None:
        """Flip one bit of pool block ``block`` (``into``: "k" | "v"). The
        corruption stays until the block checksums catch it at the next
        read and the engine re-prefills the block."""
        if into not in ("k", "v"):
            raise ValueError("into must be 'k' or 'v'")
        arr = getattr(self.pool.state, into)
        L, nb, hkv, bs, hd = arr.shape
        layer = min(max(layer, 0), L - 1)
        block = min(max(block, 0), nb - 1)
        head = min(max(head, 0), hkv - 1)
        row = min(max(row, 0), bs - 1)
        col = min(max(col, 0), hd - 1)
        flat = (((layer * nb + block) * hkv + head) * bs + row) * hd + col
        flip_bit_at(arr, flat, bit)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write device copy: block ``src`` (data + checksums) into
        ``dst``."""
        for arr in self.pool.state:
            arr[:, dst] = arr[:, src]

    # -- admission ----------------------------------------------------------

    def _resident_tokens(self, req: Request) -> np.ndarray:
        """Tokens whose KV this request keeps resident at steady state: the
        prompt plus all generated tokens except the pending one."""
        gen = req.generated[:-1] if req.generated else []
        return np.concatenate([req.prompt,
                               np.asarray(gen, np.int32)]).astype(np.int32)

    def _feed_tokens(self, req: Request) -> np.ndarray:
        """Every token this request must feed through the model: the prompt
        plus all generated tokens (the last one is the pending input)."""
        return np.concatenate([req.prompt, np.asarray(req.generated,
                                                      np.int32)
                               ]).astype(np.int32)

    def _pad_bids(self, bids: Sequence[int]) -> np.ndarray:
        out = np.zeros((self.max_blocks,), np.int32)
        out[:len(bids)] = bids
        return out

    def _try_admit(self, req: Request) -> Optional[int]:
        """Reserve a slot + KV blocks (prefix-cache hits first). All-or-
        nothing: on failure everything is rolled back and the request keeps
        its place at the head of the queue."""
        if self.pool.free_slots == 0:
            return None
        seq = self._resident_tokens(req)
        t_ctx = len(seq)
        resumed = req.num_generated > 0
        # a fresh prompt must compute >= 1 token to produce logits; a resumed
        # request already knows its pending token and may be fully cached
        max_hit = t_ctx // self.block_size if resumed \
            else (t_ctx - 1) // self.block_size
        hits = self.pool.prefix.match(seq, max_blocks=max_hit)
        for b in hits:                      # claim before alloc can evict
            self.pool.blocks.ref_inc(b)
        n_needed = -(-t_ctx // self.block_size) - len(hits)
        new_bids: List[int] = []
        for _ in range(n_needed):
            b = self.pool.blocks.alloc()
            if b is None:
                for nb in new_bids:
                    self.pool.blocks.ref_dec(nb)
                for h in hits:
                    self.pool.blocks.ref_dec(h)
                return None
            new_bids.append(b)
        slot = self.pool.alloc()
        req.block_ids = list(hits) + new_bids
        req.n_prefix_hit = len(hits)
        return slot

    def _release_request(self, req: Request) -> None:
        slot = req.slot
        for b in req.block_ids:
            self.pool.blocks.ref_dec(b)
        req.block_ids = []
        self._bt[slot] = 0
        self._pos[slot] = 0
        self._queue[slot] = []
        if self._proposer is not None:
            self._proposer.release(slot)
        self.pool.release(slot)

    def _admit(self, req: Request) -> None:
        if self.kernel == "fused":
            self._admit_unified(req)
        else:
            self._admit_gather(req)

    def _admit_unified(self, req: Request) -> None:
        """Admission on the fused backend reserves state only — no compute.
        The prompt suffix past the prefix hit goes on the slot's feed queue;
        the mixed step prefills it chunk by chunk and samples the first
        token the moment the queue drains."""
        slot = req.slot
        t_hit = req.n_prefix_hit * self.block_size
        feed = self._feed_tokens(req)
        self._pos[slot] = t_hit
        self._bt[slot] = self._pad_bids(req.block_ids)
        self._queue[slot] = [int(t) for t in feed[t_hit:]]
        s = req.sampling
        self._temps[slot] = s.temperature
        self._topks[slot] = s.top_k
        self._seeds[slot] = s.seed
        self._rids[slot] = req.rid
        self._counters[slot] = req.num_generated
        req.admit_order = self._admit_seq
        self._admit_seq += 1
        self.stats.prefills += 1

    def _chunked_fill(self, row: KVCache, toks: np.ndarray, start_pos: int,
                      det_acc, cor_acc):
        """Feed ``toks`` into a batch-1 ring cache through the fixed-width
        chunked extend (chunks of ``chunk_size`` tokens; only the final chunk
        is padded, and only a prompt running into ``cache_len`` narrows the
        width). A retried chunk starts again from the old cache object and
        rewrites the same ring slots. Returns (last-chunk logits, row,
        retries)."""
        none = FaultSpec.none(1)
        C = self.chunk_size
        i, retries = 0, 0
        logits = None
        n = len(toks)
        while i < n:
            pos = start_pos + i
            w = min(C, self.cache_len - pos)
            fill = min(w, n - i)
            buf = np.zeros((1, w), np.int32)
            buf[0, :fill] = toks[i:i + fill]
            logits, rep, new_row = self._extend(buf, row, fill, none)
            rep = StepReport.of(rep)
            det_acc[:5] += rep.detected[0]
            cor_acc[:5] += rep.corrected[0]
            while self._needs_retry_rows(rep, rows=None) and \
                    retries < self.max_retries:
                retries += 1
                logits, rep, new_row = self._extend(buf, row, fill, none)
                rep = StepReport.of(rep)
                det_acc[:5] += rep.detected[0]
                cor_acc[:5] += rep.corrected[0]
            row = new_row
            i += fill
        return logits, row, retries

    def _admit_gather(self, req: Request) -> None:
        """Admission on the gather backend computes: the prompt (past any
        prefix hit, whose blocks are verified first and repaired if they
        rotted) is prefilled by the chunked extend and scattered into the
        request's blocks, and the first token is sampled."""
        seq = self._resident_tokens(req)
        t_ctx = len(seq)
        resumed = req.num_generated > 0
        n_hit = req.n_prefix_hit
        t_hit = n_hit * self.block_size
        slot = req.slot
        det_acc = np.zeros((6,), np.int64)
        cor_acc = np.zeros((6,), np.int64)
        retries = 0
        logits = None

        if t_hit < t_ctx:
            if n_hit == 0:
                row = self.model.init_cache(1, cache_len=self.cache_len)
            else:
                while True:
                    row, bad = self._gather_ctx(req.block_ids[:n_hit], t_hit)
                    bad_idx = np.flatnonzero(bad)
                    if bad_idx.size == 0:
                        break
                    # a shared prefix block rotted in HBM: repair before use
                    det_acc[5] += bad_idx.size
                    cor_acc[5] += bad_idx.size
                    self.paged_stats.kv_detected_blocks += int(bad_idx.size)
                    self._repair_blocks(req, bad_idx, resident=seq)
            logits, row, retries = self._chunked_fill(
                row, seq[t_hit:], t_hit, det_acc, cor_acc)
            self._scatter(row, [NULL_BLOCK] * n_hit + req.block_ids[n_hit:],
                          t_ctx)
            for wb in req.block_ids[n_hit:]:
                self.pool.blocks.note_write(wb)
        # else: resumed and fully cached, no math

        self.pool.prefix.insert(seq, req.block_ids)
        self.telemetry.observe_prefill(req.rid, det_acc, cor_acc,
                                       retries=retries)
        req.retries += retries
        req.admit_order = self._admit_seq
        self._admit_seq += 1
        self.stats.prefills += 1
        self.stats.retries += retries

        s = req.sampling
        if resumed:
            tok = req.generated[-1]
            self._counters[slot] = req.num_generated
        else:
            tok = int(sample_tokens(
                logits.float(), temperature=[s.temperature], top_k=[s.top_k],
                seeds=[s.seed], rids=[req.rid], counters=[0])[0])
            req.generated.append(tok)
            self._counters[slot] = 1
            self.stats.tokens += 1
        self._pending[slot] = tok
        self._temps[slot] = s.temperature
        self._topks[slot] = s.top_k
        self._seeds[slot] = s.seed
        self._rids[slot] = req.rid
        self._bt[slot] = self._pad_bids(req.block_ids)
        self._pos[slot] = t_ctx

    # -- pressure: tail blocks, COW, preemption -----------------------------

    def _preempt_for_blocks(self, needy: Request) -> bool:
        """Preempt the youngest other running request to free blocks."""
        victims = [r for r in self.scheduler.active_rows()
                   if r is not needy and not r.is_done()]
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.admit_order)
        self.scheduler.preempt(victim)
        self._release_request(victim)
        victim.slot = None
        self.paged_stats.preemptions += 1
        return True

    def _alloc_block_or_preempt(self, req: Request) -> int:
        while True:
            b = self.pool.blocks.alloc()
            if b is not None:
                return b
            if not self._preempt_for_blocks(req):
                raise RuntimeError(
                    "paged KV pool exhausted: a single request needs more "
                    "blocks than the pool holds; raise num_blocks")

    def _ensure_capacity(self, req: Request, n_new: int) -> None:
        """Back the next ``n_new`` KV rows of ``req`` with writable private
        blocks: allocate fresh tail blocks, copy-on-write-split shared ones,
        preempting the youngest other request under pool pressure."""
        slot = req.slot
        pos = int(self._pos[slot])
        bs = self.block_size
        for bi in range(pos // bs, (pos + max(n_new, 1) - 1) // bs + 1):
            if req.slot is None:
                return
            if bi >= len(req.block_ids):
                b = self._alloc_block_or_preempt(req)
                req.block_ids.append(b)
                self._bt[slot, bi] = b
            else:
                tail = req.block_ids[bi]
                if self.pool.blocks.is_shared(tail):
                    wb, needs_copy = self.pool.blocks.cow(tail)
                    if wb is None:
                        wb = self._alloc_block_or_preempt(req)
                        self.pool.blocks.ref_dec(tail)
                        needs_copy = True
                    if needs_copy:
                        self._copy_block(tail, wb)
                        self.pool.blocks.note_write(wb)
                    req.block_ids[bi] = wb
                    self._bt[slot, bi] = wb

    def _ensure_tail_blocks(self) -> None:
        """Before a gather decode step every active slot writes one KV row
        at its position — make sure a private tail block backs it."""
        for req in list(self.scheduler.active_rows()):
            if req.slot is None:
                continue        # preempted by an earlier request's alloc
            if req.is_done():
                # finished at admission; decodes garbage until evicted next
                # iteration — point its writes at the null block
                self._bt[req.slot] = 0
                self._pos[req.slot] = 0
                continue
            self._ensure_capacity(req, 1)

    def _register_full_blocks(self, req: Request, old_pos: int,
                              new_pos: int) -> None:
        """Register every newly completed block of ``req`` (prompt or
        decode-filled) in the token-hash-chain prefix cache."""
        bs = self.block_size
        if new_pos // bs <= old_pos // bs:
            return
        toks = self._feed_tokens(req)[:new_pos]
        self.pool.prefix.insert(toks, req.block_ids)

    def _note_writes(self, req: Request, old_pos: int, new_pos: int) -> None:
        """The blocks holding rows ``old_pos .. new_pos - 1`` were written:
        their generations move (stamps invalidate)."""
        bs = self.block_size
        for bi in range(old_pos // bs, min((new_pos - 1) // bs + 1,
                                           len(req.block_ids))):
            self.pool.blocks.note_write(req.block_ids[bi])

    # -- read-time verification policy --------------------------------------

    def _verify_selector(self):
        """Pick the table entries this gather attempt re-verifies.

        Returns ``(sel, folds, skips)``: ``sel`` is None for full coverage
        (the "always" policy), else an (n_slots, K) int32 selector (-1 =
        empty). Under the generation-stamped policy only blocks written
        since their last verified read need a fold — in steady-state decode
        one tail block per slot instead of the whole table. A step needing
        more than K folds per slot (e.g. right after an admission scattered
        a whole prompt) falls back to full coverage."""
        live = [r for r in self.scheduler.active_rows()
                if r.slot is not None and not r.is_done()]
        n_real = sum(len(r.block_ids) for r in live)
        if self.kv_verify == "always":
            return None, n_real, 0
        sel = np.full((self.n_slots, self._sel_width), -1, np.int32)
        need_total = 0
        for r in live:
            need = [j for j, bid in enumerate(r.block_ids)
                    if self.pool.blocks.needs_verify(bid)]
            if len(need) > self._sel_width:
                return self._sel_all, n_real, 0       # full-coverage fallback
            sel[r.slot, :len(need)] = need
            need_total += len(need)
        return sel, need_total, n_real - need_total

    def _mark_verified(self, active_reqs: Sequence[Request], sel) -> None:
        """Stamp what the committed gather attempt verified, before the
        step's appends are noted (a stamp covers the pre-write
        generation)."""
        for req in active_reqs:
            entries = (range(len(req.block_ids)) if sel is None
                       or sel is self._sel_all
                       else [int(j) for j in sel[req.slot] if j >= 0])
            for j in entries:
                if j < len(req.block_ids):
                    self.pool.blocks.mark_verified(req.block_ids[j])

    # -- background scrub (bounds the stamped policy's deferred window) -----

    def _scrub_pass(self) -> None:
        """Re-fold the ``scrub_batch`` oldest-verified live blocks against
        their resident checksums — including blocks the stamped selector
        skips as verified-and-untouched, which is exactly where a deferred
        flip hides. A mismatch is repaired at once through the normal block
        re-prefill; clean blocks refresh their verification clock so the
        scrub keeps rotating.

        Leftover batch capacity draws from the **parked prefix-cache
        blocks** (ref == 0, kept for future hits): no live table maps them,
        so read-time verification never reaches them. A corrupted parked
        block is discarded (its prefix-cache entry forgotten, the block
        freed): the next admission takes a clean miss and re-prefills."""
        live = {}
        for req in self.scheduler.active_rows():
            if req.slot is None or req.is_done():
                continue
            for j, bid in enumerate(req.block_ids):
                live.setdefault(bid, (req, j))
        order = sorted(live, key=self.pool.blocks.verified_at)
        batch = order[:self.scrub_batch]
        if len(batch) < self.scrub_batch:
            parked = sorted(self.pool.blocks.parked_blocks(),
                            key=self.pool.blocks.verified_at)
            batch = batch + parked[:self.scrub_batch - len(batch)]
        if not batch:
            return
        bad = self._scrub(batch)
        self.paged_stats.kv_scrubbed_blocks += len(batch)
        for bid, is_bad in zip(batch, bad):
            if bid in live:
                req, j = live[bid]
                if is_bad:
                    self.paged_stats.kv_detected_blocks += 1
                    six = np.zeros((6,), np.int64)
                    six[5] = 1
                    self.telemetry.observe_prefill(req.rid, six, six)
                    self._repair_blocks(req, [j])
                else:
                    self.pool.blocks.mark_verified(bid)
            else:                           # parked prefix-cache block
                if is_bad:
                    self.paged_stats.kv_detected_blocks += 1
                    self.telemetry.observe_scrub(1)
                    self.pool.blocks.discard_parked(bid)
                else:
                    self.pool.blocks.mark_verified(bid)

    # -- read-time repair ---------------------------------------------------

    def _repair_blocks(self, req: Request, bad_idx, *,
                       resident: Optional[np.ndarray] = None,
                       healed: Optional[set] = None) -> None:
        """Re-prefill the poisoned blocks of one request, left to right, so
        each repair runs against already-verified (or just-repaired)
        context. Shared blocks heal in place for every request mapping them
        (``healed`` dedupes a shared block flagged from several slots). The
        fused backend repairs through the unified step, the gather backend
        through the chunked extend."""
        bs = self.block_size
        if resident is None:
            resident = (self._feed_tokens(req)[:int(self._pos[req.slot])]
                        if self.kernel == "fused"
                        else self._resident_tokens(req))
        for j in sorted(int(i) for i in bad_idx):
            start = j * bs
            n_fill = min(bs, len(resident) - start)
            if n_fill <= 0:
                continue
            if healed is not None:
                if req.block_ids[j] in healed:
                    continue
                healed.add(req.block_ids[j])
            if self.kernel == "fused":
                self._repair_block_unified(req, resident, start, n_fill)
            else:
                self._repair_block_gather(req, j, resident, start, n_fill)
            self.pool.blocks.note_write(req.block_ids[j])
            self.paged_stats.kv_repaired_blocks += 1

    def _repair_block_unified(self, req: Request, resident: np.ndarray,
                              start: int, n_fill: int) -> None:
        """A single-slot chunk with the position rewound to the block start:
        the kernel recomputes exactly this block's rows against the
        (verified) preceding context, and the chunk append + checksum
        refresh rewrites only this block. Other slots ride along with q_len
        0."""
        slot = req.slot
        tokens = np.zeros((self.n_slots, self.chunk_size), np.int32)
        tokens[slot, :n_fill] = resident[start:start + n_fill]
        q_lens = np.zeros((self.n_slots,), np.int32)
        q_lens[slot] = n_fill
        pos_vec = self._pos.copy()
        pos_vec[slot] = start
        self._step_fused(tokens, pos_vec, q_lens, self._no_faults)

    def _repair_block_gather(self, req: Request, j: int,
                             resident: np.ndarray, start: int,
                             n_fill: int) -> None:
        row, _ = self._gather_ctx(req.block_ids[:j], start)
        w = min(self.chunk_size, self.cache_len - start)
        toks = np.zeros((1, w), np.int32)
        toks[0, :n_fill] = resident[start:start + n_fill]
        _, _, new_row = self._extend(toks, row, n_fill, FaultSpec.none(1))
        sc = [NULL_BLOCK] * self.max_blocks
        sc[j] = req.block_ids[j]
        self._scatter(new_row, sc, start + n_fill)

    # -- speculation: propose / accept / roll back --------------------------

    @property
    def acceptance_rate(self) -> float:
        """Fraction of scored draft tokens the target accepted."""
        ps = self.paged_stats
        return 0.0 if not ps.spec_proposed_tokens \
            else ps.spec_accepted_tokens / ps.spec_proposed_tokens

    def _spec_cap(self, req: Request) -> int:
        """Most draft rows this request may score this step: bounded by the
        configured draft length, the chunk width (the pending token takes
        one row), and the request's remaining token budget (a spec step
        commits at most K + 1 tokens, never past ``max_new_tokens``)."""
        return max(0, min(self.draft_len, self.chunk_size - 1,
                          req.max_new_tokens - req.num_generated - 1))

    def _propose_drafts(self, active_reqs: Sequence[Request],
                        draft_grants: Dict[int, int]
                        ) -> Dict[int, np.ndarray]:
        """Run the proposer for every slot granted draft budget. Returns
        slot -> draft tokens (slots with empty proposals are left out: they
        decode plainly). Draft-pass EFTA telemetry is folded into the
        per-request draft counters here."""
        spec: Dict[int, np.ndarray] = {}
        for r in active_reqs:
            kd = draft_grants.get(r.rid, 0)
            if kd <= 0 or r.slot is None:
                continue
            d = self._proposer.propose(r.slot, self._feed_tokens(r), kd)
            rep = self._proposer.drain_report()
            if rep is not None:
                det, cor, retries = rep
                six_d = np.concatenate([det, [0]]).astype(np.int64)
                six_c = np.concatenate([cor, [0]]).astype(np.int64)
                self.telemetry.observe_draft(r.rid, six_d, six_c,
                                             retries=retries)
            if len(d):
                spec[r.slot] = np.asarray(d, np.int32)
        return spec

    def _spec_rows(self, logits: torch.Tensor,
                   spec_tokens: Dict[int, np.ndarray]
                   ) -> Dict[int, np.ndarray]:
        """Copy to the host only what the acceptance stage reads: rows
        ``0..k`` of each speculating slot (k + 1, V) f32, not the whole
        (n_slots, C, V) plane."""
        slots = sorted(spec_tokens)
        kmax = max(len(spec_tokens[s]) for s in slots)
        rows = logits[self._dev(slots).long(), :kmax + 1].float().cpu(
        ).numpy()
        return {s: rows[i, :len(spec_tokens[s]) + 1]
                for i, s in enumerate(slots)}

    def _accept_slot(self, req: Request, rows: np.ndarray,
                     drafts: np.ndarray) -> Tuple[List[int], Optional[int]]:
        """Acceptance verdict for one slot's scored chunk. ``rows``: (k+1, V)
        target logits (row j scored draft j; row k feeds the bonus token).
        Returns ``(drafts_committed, bonus)`` — the accepted draft prefix
        (possibly EOS-truncated) and the follow-up token (``None`` when an
        accepted EOS ends the request before the bonus row)."""
        s = req.sampling
        rng = None
        if s.temperature > 0.0:
            # per-(request, step) deterministic stream (greedy never
            # consults it)
            rng = np.random.default_rng(
                (abs(int(s.seed)), int(req.rid), int(req.num_generated)))
        a, t_next = speculative_accept(
            rows, drafts, temperature=float(s.temperature),
            top_k=int(s.top_k), rng=rng)
        drafts_committed = [int(t) for t in drafts[:a]]
        bonus: Optional[int] = int(t_next)
        if req.eos_id is not None:
            for i, t in enumerate(drafts_committed):
                if t == req.eos_id:
                    drafts_committed = drafts_committed[:i + 1]
                    bonus = None
                    break
        return drafts_committed, bonus

    def _commit_spec(self, req: Request, rows: np.ndarray, d: np.ndarray,
                     old_pos: int, scored_pos: int,
                     rollback_plan: Dict[int, Tuple[int, int]]) -> None:
        """Accept one speculating slot's scored chunk: commit the longest
        valid draft prefix + the bonus/resample token and rewind the slot
        past the rejected rows (the KV rollback truncates them on the
        device). The bonus becomes the pending token."""
        slot = req.slot
        k = len(d)
        committed_drafts, bonus = self._accept_slot(req, rows, d)
        a = len(committed_drafts)
        keep_pos = old_pos + 1 + a         # pending row + accepted rows
        self._note_writes(req, old_pos, scored_pos)
        req.generated.extend(committed_drafts)
        if bonus is not None:
            req.generated.append(bonus)
            self._pending[slot] = bonus
        self._queue[slot] = [] if bonus is None else [bonus]
        self._counters[slot] = req.num_generated
        self._pos[slot] = keep_pos
        self.stats.tokens += a + (0 if bonus is None else 1)
        self.paged_stats.spec_proposed_tokens += k
        self.paged_stats.spec_accepted_tokens += a
        self.telemetry.observe_draft(
            req.rid, np.zeros(6, np.int64), np.zeros(6, np.int64),
            proposed=k, accepted=a)
        if keep_pos < scored_pos:
            rollback_plan[slot] = (keep_pos, scored_pos)
        self._register_full_blocks(req, old_pos, keep_pos)

    def _apply_rollback(self, rollback_plan: Dict[int, Tuple[int, int]],
                        by_slot: Dict[int, Request]) -> None:
        """Truncate the rejected draft rows of every speculating slot in one
        pass (``kv_len`` truncation + tail-block checksum regeneration),
        with the anti-laundering guard: blocks that fail their PRE-rollback
        checksums are flagged, counted as site-6 detections, and
        re-prefilled from committed tokens — corruption that struck between
        the scoring step's verify and this rollback is detected, never
        restamped into a consistent state."""
        if self._pre_rollback_hook is not None:
            self._pre_rollback_hook(self)
        keep = self._pos.copy()                 # already rewound to keep_pos
        oldp = self._pos.copy()
        for slot, (keep_pos, scored_pos) in rollback_plan.items():
            keep[slot] = keep_pos
            oldp[slot] = scored_pos
        if not (oldp > keep).any():
            return
        st = self.pool.state
        bad = paged_rollback(
            st.k, st.v, st.kc1, st.kc2, st.vc1, st.vc2, self._dev(self._bt),
            self._dev(keep), self._dev(oldp), check_stride=self.check_stride,
            threshold=self.check_threshold).cpu().numpy()
        bs = self.block_size
        for slot, (keep_pos, scored_pos) in rollback_plan.items():
            if scored_pos <= keep_pos:
                continue
            self.paged_stats.spec_rolled_back_rows += scored_pos - keep_pos
            self._note_writes(by_slot[slot], keep_pos, scored_pos)
        for slot in list(rollback_plan):
            idxs = np.flatnonzero(bad[slot])
            if idxs.size == 0:
                continue
            req = by_slot[slot]
            self.paged_stats.rollback_detected_blocks += int(idxs.size)
            self.paged_stats.kv_detected_blocks += int(idxs.size)
            six = np.zeros((6,), np.int64)
            six[5] = idxs.size
            self.telemetry.observe_prefill(req.rid, six, six)
            # blocks holding committed rows re-prefill from the committed
            # tokens (resident passed explicitly: after an accepted EOS
            # draft every generated token's KV row is resident). A flagged
            # block wholly past the committed prefix needs no re-prefill —
            # the rollback rewrote and restamped it and none of its rows are
            # reachable below kv_len — so the truncation IS its repair.
            keep_pos = int(self._pos[slot])
            resident = self._feed_tokens(req)[:keep_pos]
            trunc_only = sum(1 for j in idxs if j * bs >= keep_pos)
            self.paged_stats.kv_repaired_blocks += trunc_only
            self._repair_blocks(req, idxs, resident=resident)

    # -- stepping -----------------------------------------------------------

    @torch.no_grad()
    def step(self, faults: Optional[FaultSpec] = None) -> List[Request]:
        """One engine iteration. EFTA in-compute SEUs behave as in the ring
        engine; additionally every KV block read is checksum-verified, and a
        mismatch triggers block re-prefill + step retry before anything is
        committed. The fused backend runs the unified mixed prefill/decode
        step; the gather backend the decode (or scoring) step, its prompts
        prefilled at admission."""
        if self.kernel == "fused":
            return self._step_unified(faults)
        return self._step_gather(faults)

    def _attempt(self, run, active: List[int], by_slot: Dict[int, Request],
                 faults: Optional[FaultSpec]):
        """Run one step's attempts until one reads clean KV and leaves no
        fault it could not exactly fix, within the retry budgets.

        ``run(faults)`` performs one attempt and returns ``(result,
        StepReport, bad (n_slots, mb))``. A resident-KV hit repairs the
        flagged blocks and retries (a KV retry budget of its own, >= 1:
        committing an attempt that read poisoned KV would bake the
        corruption into refreshed checksums); an uncorrected EFTA detection
        retries clean. Returns (last result, _Tally, slots whose final
        attempt still read poisoned KV, retries)."""
        tally = _Tally(self.n_slots)
        efta_retries = kv_retries = 0
        attempt_faults = self._no_faults if faults is None else faults
        seen_bad: set = set()
        while True:
            is_retry = (efta_retries + kv_retries) > 0
            result, rep, bad = run(attempt_faults)
            tally.det += rep.detected
            tally.cor += rep.corrected
            if is_retry:
                tally.redet += rep.detected
            kv_hit_slots = [s for s in active if bad[s].any()]
            if kv_hit_slots:
                tally.kv_det[kv_hit_slots] += bad[kv_hit_slots].sum(-1)
                if is_retry:
                    tally.kv_redet[kv_hit_slots] += bad[kv_hit_slots].sum(-1)
                # pool-level stats count distinct blocks, once per step (a
                # shared prefix block flagged from several slots, or again
                # on a retry, is one corruption); per-request telemetry
                # stays per slot
                bad_bids = {by_slot[s].block_ids[j] for s in kv_hit_slots
                            for j in np.flatnonzero(bad[s])
                            if j < len(by_slot[s].block_ids)}
                self.paged_stats.kv_detected_blocks += \
                    len(bad_bids - seen_bad)
                seen_bad |= bad_bids
                healed: set = set()
                for s in kv_hit_slots:
                    idxs = np.flatnonzero(bad[s])
                    tally.kv_cor[s] += idxs.size
                    self._repair_blocks(by_slot[s], idxs, healed=healed)
                if kv_retries < max(1, self.max_retries):
                    kv_retries += 1
                    attempt_faults = self._no_faults
                    continue
            if self._needs_retry_rows(rep, rows=active) and \
                    efta_retries < self.max_retries:
                efta_retries += 1
                attempt_faults = self._no_faults
                continue
            break
        return result, tally, kv_hit_slots, efta_retries + kv_retries

    def _abandon_poisoned(self, active_reqs: Sequence[Request],
                          tally: _Tally, retries: int) -> None:
        """The FINAL attempt still read poisoned KV: a block that stays
        corrupted through repeated re-prefills is being re-corrupted
        underneath (failing memory, not a transient SEU). Commit nothing —
        repairs stay applied, the next iteration re-attempts, and the
        sustained detections drive the fault monitor toward "cordon"."""
        for r in active_reqs:
            r.retries += retries
        self.telemetry.observe_step({r.rid: tally.six(r.slot)
                                     for r in active_reqs}, retries=retries)
        self.stats.retries += retries
        self._poisoned_steps += 1
        if self._poisoned_steps > 3:
            raise RuntimeError(
                "resident KV corruption persists across block re-prefills "
                "on consecutive steps — failing memory, not a transient "
                "SEU; cordon this host and restart elsewhere")

    def _finish_step(self, per_request, retries: int, spec: bool) -> None:
        if spec:
            self.paged_stats.spec_steps += 1
        self.telemetry.observe_step(per_request, retries=retries)
        self.stats.steps += 1
        self.stats.retries += retries

    def _step_unified(self, faults: Optional[FaultSpec]) -> List[Request]:
        decision = self.scheduler.step(self._try_admit, self._release_request)
        for req in decision.admitted:
            self._admit(req)
        finished = list(decision.evicted)
        for r in self.scheduler.active_rows():
            if r.is_done() and r.slot is not None:
                # finished at admission; park its writes on the null block
                self._bt[r.slot] = 0
                self._pos[r.slot] = 0
                self._queue[r.slot] = []
        active_reqs = [r for r in self.scheduler.active_rows()
                       if not r.is_done()]
        if not active_reqs:
            return finished

        # chunk plan: one token per request unconditionally (decodes never
        # starve), prompt surplus FCFS within the scheduler's chunk budget;
        # with speculation on, steady-state decodes also propose up to
        # draft_len rows from the leftover budget (prompt chunks rank first)
        demands = [(r, len(self._queue[r.slot])) for r in active_reqs]
        spec_tokens: Dict[int, np.ndarray] = {}
        if self._proposer is not None:
            wants = {r.rid: self._spec_cap(r) for r in active_reqs}
            grants, draft_grants = self.scheduler.plan_chunks(
                demands, self.chunk_size, draft_wants=wants)
            spec_tokens = self._propose_drafts(active_reqs, draft_grants)
        else:
            grants = self.scheduler.plan_chunks(demands, self.chunk_size)
        for r in list(active_reqs):
            need = grants[r.rid] + len(spec_tokens.get(r.slot, ()))
            if r.slot is not None and need > 0:
                self._ensure_capacity(r, need)
        active_reqs = [r for r in active_reqs
                       if r.slot is not None and not r.is_done()]
        spec_tokens = {s: d for s, d in spec_tokens.items()
                       if any(r.slot == s for r in active_reqs)}
        if not active_reqs:
            return finished
        active = [r.slot for r in active_reqs]
        by_slot = {r.slot: r for r in active_reqs}

        # pure-decode steps run width 1; any prefill surplus or draft row
        # promotes the step to the chunk width (the only two widths)
        chunk = self.chunk_size if (spec_tokens or any(
            grants[r.rid] > 1 for r in active_reqs)) else 1
        tokens = np.zeros((self.n_slots, chunk), np.int32)
        q_lens = np.zeros((self.n_slots,), np.int32)
        for r in active_reqs:
            g = grants[r.rid]
            tokens[r.slot, :g] = self._queue[r.slot][:g]
            d = spec_tokens.get(r.slot)
            if d is not None:
                tokens[r.slot, g:g + len(d)] = d
                g += len(d)
            q_lens[r.slot] = g

        def run(f):
            next_np, rep, bad, logits = self._step_fused(tokens, self._pos,
                                                         q_lens, f)
            return (next_np, logits), rep, bad

        (next_np, logits), tally, kv_hit_slots, retries = self._attempt(
            run, active, by_slot, faults)
        if kv_hit_slots:
            self._abandon_poisoned(active_reqs, tally, retries)
            return finished

        # commit
        self._poisoned_steps = 0
        rows = self._spec_rows(logits, spec_tokens) if spec_tokens else {}
        per_request = {}
        rollback_plan: Dict[int, Tuple[int, int]] = {}
        for req in active_reqs:
            slot = req.slot
            g = int(q_lens[slot])
            old_pos = int(self._pos[slot])
            new_pos = old_pos + g
            req.retries += retries
            d = spec_tokens.get(slot)
            if d is not None:
                self._commit_spec(req, rows[slot], d, old_pos, new_pos,
                                  rollback_plan)
            elif g:
                if g > 1:
                    self.paged_stats.chunked_prefill_tokens += g
                self._note_writes(req, old_pos, new_pos)
                del self._queue[slot][:g]
                self._pos[slot] = new_pos
                if not self._queue[slot]:
                    # queue drained: this chunk's last row produced the next
                    # token (first sample of a prompt, or a decode sample)
                    tok = int(next_np[slot])
                    req.generated.append(tok)
                    self._queue[slot] = [tok]
                    self._counters[slot] = req.num_generated
                    self.stats.tokens += 1
                self._register_full_blocks(req, old_pos, new_pos)
            per_request[req.rid] = tally.six(slot)
        if rollback_plan:
            self._apply_rollback(rollback_plan, by_slot)
        self._finish_step(per_request, retries, bool(spec_tokens))
        return finished

    def _step_gather(self, faults: Optional[FaultSpec]) -> List[Request]:
        decision = self.scheduler.step(self._try_admit, self._release_request)
        for req in decision.admitted:
            self._admit(req)
        finished = list(decision.evicted)
        self._ensure_tail_blocks()
        active_reqs = [r for r in self.scheduler.active_rows()
                       if not r.is_done()]
        if not active_reqs:
            return finished

        # speculation: the chunk-wide scoring step writes C rows into each
        # slot's contiguous gathered view, so it needs ``pos + C <=
        # cache_len`` on every slot (a ring wrap would clobber context rows);
        # near the boundary the step falls back to the width-1 decode
        spec_tokens: Dict[int, np.ndarray] = {}
        if self._proposer is not None and all(
                int(self._pos[r.slot]) + self.chunk_size <= self.cache_len
                for r in active_reqs):
            wants = {r.rid: self._spec_cap(r) for r in active_reqs}
            _, draft_grants = self.scheduler.plan_chunks(
                [(r, 1) for r in active_reqs], self.chunk_size,
                draft_wants=wants)
            spec_tokens = self._propose_drafts(active_reqs, draft_grants)
            for r in list(active_reqs):
                d = spec_tokens.get(r.slot)
                if d is not None and r.slot is not None:
                    self._ensure_capacity(r, 1 + len(d))
            if spec_tokens:
                # capacity pressure may have preempted someone — refilter
                active_reqs = [r for r in self.scheduler.active_rows()
                               if not r.is_done() and r.slot is not None]
                spec_tokens = {s: d for s, d in spec_tokens.items()
                               if any(r.slot == s for r in active_reqs)}
                if not active_reqs:
                    return finished
        active = [r.slot for r in active_reqs]
        by_slot = {r.slot: r for r in active_reqs}
        verified = {}

        if spec_tokens:
            # at least one slot scored draft rows: the batch goes through the
            # chunk-wide scoring step (slots without drafts ride along with
            # q_len 1 — their row 0 is what the width-1 decode computes)
            C = self.chunk_size
            tokens = np.zeros((self.n_slots, C), np.int32)
            q_lens = np.zeros((self.n_slots,), np.int32)
            for r in active_reqs:
                tokens[r.slot, 0] = self._pending[r.slot]
                d = spec_tokens.get(r.slot, ())
                tokens[r.slot, 1:1 + len(d)] = d
                q_lens[r.slot] = 1 + len(d)

        def run(f):
            sel, folds, skips = self._verify_selector()
            self.paged_stats.kv_verified_blocks += folds
            self.paged_stats.kv_verify_skips += skips
            verified["sel"] = sel
            if spec_tokens:
                next_np, rep, bad, logits, append = self._gather_score(
                    tokens, q_lens, f, sel)
                return (next_np, logits, append), rep, bad
            next_np, rep, bad, append = self._gather_decode(f, sel)
            return (next_np, None, append), rep, bad

        (next_np, logits, append), tally, kv_hit_slots, retries = \
            self._attempt(run, active, by_slot, faults)
        if kv_hit_slots:
            self._abandon_poisoned(active_reqs, tally, retries)
            return finished

        # commit
        self._poisoned_steps = 0
        append()
        if self.kv_verify == "stamped":
            self._mark_verified(active_reqs, verified["sel"])
        rows = self._spec_rows(logits, spec_tokens) if spec_tokens else {}
        per_request = {}
        rollback_plan: Dict[int, Tuple[int, int]] = {}
        for req in active_reqs:
            slot = req.slot
            old_pos = int(self._pos[slot])
            req.retries += retries
            d = spec_tokens.get(slot)
            if d is None:
                tok = int(next_np[slot])
                req.generated.append(tok)
                self._pending[slot] = tok
                self._counters[slot] += 1
                # the decode appended one KV row into the tail block: its
                # generation moves, so the stamp invalidates
                self._note_writes(req, old_pos, old_pos + 1)
                self._pos[slot] = old_pos + 1
                self._register_full_blocks(req, old_pos, old_pos + 1)
                self.stats.tokens += 1
            else:
                self._commit_spec(req, rows[slot], d, old_pos,
                                  old_pos + 1 + len(d), rollback_plan)
            per_request[req.rid] = tally.six(slot)
        if rollback_plan:
            self._apply_rollback(rollback_plan, by_slot)
        self._finish_step(per_request, retries, bool(spec_tokens))
        if self.kv_verify == "stamped" and self.scrub_interval and \
                self.stats.steps % self.scrub_interval == 0:
            self._scrub_pass()
        return finished
