"""Fault-tolerant paged KV-cache serve engine over the fused EFTA kernel.

KV lives in a global block pool ``(num_layers, num_blocks + 1, Hkv,
block_size, head_dim)`` addressed through per-request block tables; identical
prompt prefixes are stored once (hash-chain prefix cache with refcounted
copy-on-write sharing, ``repro_torch.serve.blocks``) and a preempted request
frees exactly its blocks.

Every engine iteration is one **unified batched step**: each slot feeds a
chunk of up to ``chunk_size`` tokens — new prompts prefill chunk by chunk,
repairs re-prefill a block, steady-state requests decode one token — all
through the same multi-token fused paged-attention kernel
(``repro_torch.kernels.efta_paged``, one launch per layer). Steps are either
``chunk_size`` wide or 1 wide; the engine records the widths it launched in
``chunk_widths``. A scheduler ``chunk_budget`` bounds the prompt tokens per
step so long prompts never head-of-line-block other requests' decodes.

Fault story: every block carries a checksum pair (``encode_kv`` along the
token axis) written on append and **verified in the kernel pass that streams
the block**, so a resident bit flip is detected at read time (telemetry site
6, ``kv``) and repaired by re-prefilling only the poisoned block, through the
same unified step with the position rewound to the block start; then the
step retries. EFTA compute-site SEUs are corrected in the kernel, or retried
when only detected.

Only ``kernel="fused"`` with ``speculate="off"`` is ported so far; the
gather backend, ``kv_verify="stamped"``, the background scrub and
speculative decoding raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.core.fault import FaultSpec, flip_bit_at
from repro_torch.kernels.efta_paged import paged_fault_descriptor
from repro_torch.models.api import Model
from repro_torch.models.attention import PagedKVCache
from repro_torch.serve.blocks import BlockPool, PrefixCache
from repro_torch.serve.engine import ServeEngine, StepReport
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import Request


class PagedKVState(NamedTuple):
    """Device-resident block pool. Row 0 of every array is the null block
    (scratch for padded table entries — never verified, never read back).
    The tensors are updated in place by the step."""

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
    preemptions: int = 0
    chunked_prefill_tokens: int = 0  # prompt tokens fed through mixed steps


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


class PagedServeEngine(ServeEngine):
    """Continuous-batching engine over a checksummed paged block pool.

    ``submit``/``step``/``run`` as in :class:`ServeEngine`, plus
    ``inject_kv_fault`` for resident-state SEU campaigns. ``num_blocks``
    defaults to ring-equivalent capacity (``n_slots * cache_len /
    block_size``). ``chunk_size`` is the unified step's chunk width (>=
    ``block_size`` so one chunk re-prefills one block; default ``2 *
    block_size``); ``chunk_budget`` caps prompt tokens per mixed step (None
    = unbounded). The model's device is the engine's device.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 8,
                 cache_len: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 check_stride: Optional[int] = None,
                 max_retries: int = 2, retry_on_detect: bool = True,
                 chunk_size: Optional[int] = None,
                 chunk_budget: Optional[int] = None,
                 kernel: str = "fused", kv_verify: str = "always",
                 scrub_interval: int = 0, speculate: str = "off"):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kernel == "gather":
            raise NotImplementedError(
                "kernel='gather' (gather-by-table + pure EFTA) comes with the "
                "gather-backend slice; this port serves kernel='fused'")
        if kernel != "fused":
            raise ValueError(f"kernel must be 'fused'; got {kernel!r}")
        if kv_verify == "stamped" or scrub_interval:
            raise NotImplementedError(
                "kv_verify='stamped' and the background scrub belong to the "
                "gather backend, which comes in a later slice; the fused "
                "kernel verifies every streamed block in-loop")
        if kv_verify != "always":
            raise ValueError(f"kv_verify must be 'always'; got {kv_verify!r}")
        if speculate != "off":
            raise NotImplementedError(
                "speculative decoding (propose→score→accept with KV "
                "rollback) comes in the speculation slice")
        cl = cache_len or model.cfg.max_seq
        cl = -(-cl // block_size) * block_size     # round up to block grid
        self.block_size = block_size
        self.max_blocks = cl // block_size
        self.num_blocks = num_blocks or n_slots * self.max_blocks
        self.check_stride = check_stride or _largest_divisor_leq(block_size, 8)
        if block_size % self.check_stride:
            raise ValueError("check_stride must divide block_size")
        self.kernel = kernel
        self.chunk_size = min(chunk_size or 2 * block_size, cl)
        if self.chunk_size < block_size:
            raise ValueError(
                f"chunk_size ({self.chunk_size}) must be >= block_size "
                f"({block_size}): block repair re-prefills one block per "
                f"chunk")
        super().__init__(model, params, n_slots=n_slots, cache_len=cl,
                         max_retries=max_retries,
                         retry_on_detect=retry_on_detect)
        self.scheduler.chunk_budget = chunk_budget
        self.paged_stats = PagedCacheStats()
        # chunk widths launched so far: the unified step has two shapes,
        # chunk_size and 1, whatever the prompt lengths
        self.chunk_widths: Set[int] = set()
        # host mirrors of the block tables / positions, plus the per-slot
        # feed queue: tokens whose KV is not yet resident — the prompt
        # suffix while prefilling, exactly the pending token once decoding.
        self._bt = np.zeros((n_slots, self.max_blocks), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)
        self._queue: List[List[int]] = [[] for _ in range(n_slots)]
        self._admit_seq = 0
        # consecutive steps abandoned because corruption outlived repair
        self._poisoned_steps = 0

    def _make_pool(self) -> PagedKVPool:
        return PagedKVPool(self.model, self.n_slots, self.cache_len,
                           self.block_size, self.num_blocks,
                           self.check_stride)

    # -- the unified step -----------------------------------------------------

    def _step_fused(self, tokens: np.ndarray, pos: np.ndarray,
                    q_lens: np.ndarray, faults: FaultSpec):
        """One unified batched step: every slot feeds ``q_lens[slot]`` rows
        of ``tokens`` (0 = idle, 1 = decode, more = chunked prefill / block
        repair) and each layer's attention consumes the block pool straight
        through the fused kernel, appending the chunk's K/V in place. The
        fault batch becomes the kernel's single-SEU descriptor. Returns
        (next tokens (n_slots,) sampled at each slot's row ``q_len - 1``,
        StepReport, bad (n_slots, table_len) bool), all on the host."""
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
            bt=torch.as_tensor(self._bt, device=dev),
            pos=torch.as_tensor(pos, device=dev),
            q_len=torch.as_tensor(q_lens, device=dev),
            bad=torch.zeros((ns, self.max_blocks), dtype=torch.int32,
                            device=dev))
        logits, rep, new_cache = self.model.score(
            self.params, torch.as_tensor(tokens, device=dev), cache,
            fault=desc)
        idx = torch.as_tensor(np.clip(q_lens - 1, 0, chunk - 1), device=dev)
        last = logits[torch.arange(ns, device=dev), idx.long()]
        next_tokens = sample_tokens(
            last, temperature=self._temps, top_k=self._topks,
            seeds=self._seeds, rids=self._rids, counters=self._counters)
        report = StepReport.of(rep)
        return next_tokens, report, (new_cache.bad > 0).cpu().numpy()

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
        self.pool.release(slot)

    def _admit_unified(self, req: Request) -> None:
        """Admission reserves state only — no compute. The prompt suffix past
        the prefix hit goes on the slot's feed queue; the mixed step
        prefills it chunk by chunk and samples the first token the moment
        the queue drains."""
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

    def _register_full_blocks(self, req: Request, old_pos: int,
                              new_pos: int) -> None:
        """Register every newly completed block of ``req`` (prompt or
        decode-filled) in the token-hash-chain prefix cache."""
        bs = self.block_size
        if new_pos // bs <= old_pos // bs:
            return
        toks = self._feed_tokens(req)[:new_pos]
        self.pool.prefix.insert(toks, req.block_ids)

    # -- read-time repair ---------------------------------------------------

    def _repair_blocks_unified(self, req: Request, bad_idx, *,
                               healed: Optional[set] = None) -> None:
        """Re-prefill the poisoned blocks of one request, left to right,
        each as a single-slot chunk with the position rewound to the block
        start: the kernel recomputes exactly that block's rows against the
        (verified) preceding context and the chunk scatter + checksum
        refresh rewrites only block j. Other slots ride along with q_len 0.
        Shared blocks heal in place for every request mapping them."""
        slot = req.slot
        bs = self.block_size
        resident = self._feed_tokens(req)[:int(self._pos[slot])]
        for j in sorted(int(i) for i in bad_idx):
            start = j * bs
            n_fill = min(bs, len(resident) - start)
            if n_fill <= 0:
                continue
            if healed is not None:
                if req.block_ids[j] in healed:
                    continue
                healed.add(req.block_ids[j])
            tokens = np.zeros((self.n_slots, self.chunk_size), np.int32)
            tokens[slot, :n_fill] = resident[start:start + n_fill]
            q_lens = np.zeros((self.n_slots,), np.int32)
            q_lens[slot] = n_fill
            pos_vec = self._pos.copy()
            pos_vec[slot] = start
            self._step_fused(tokens, pos_vec, q_lens, self._no_faults)
            self.pool.blocks.note_write(req.block_ids[j])
            self.paged_stats.kv_repaired_blocks += 1

    # -- stepping -----------------------------------------------------------

    def step(self, faults: Optional[FaultSpec] = None) -> List[Request]:
        """One engine iteration: schedule, run the unified step (retrying on
        uncorrected detections, repairing poisoned blocks first), commit.
        Returns the requests that finished during this iteration."""
        return self._step_unified(faults)

    def _step_unified(self, faults: Optional[FaultSpec]) -> List[Request]:
        decision = self.scheduler.step(self._try_admit, self._release_request)
        for req in decision.admitted:
            self._admit_unified(req)
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
        # starve), prompt surplus FCFS within the scheduler's chunk budget
        demands = [(r, len(self._queue[r.slot])) for r in active_reqs]
        grants = self.scheduler.plan_chunks(demands, self.chunk_size)
        for r in list(active_reqs):
            if r.slot is not None and grants[r.rid] > 0:
                self._ensure_capacity(r, grants[r.rid])
        active_reqs = [r for r in active_reqs
                       if r.slot is not None and not r.is_done()]
        if not active_reqs:
            return finished
        active = [r.slot for r in active_reqs]
        by_slot = {r.slot: r for r in active_reqs}

        # pure-decode steps run width 1; any prefill surplus promotes the
        # step to the chunk width (the only two widths this engine launches)
        chunk = self.chunk_size if any(grants[r.rid] > 1
                                       for r in active_reqs) else 1
        tokens = np.zeros((self.n_slots, chunk), np.int32)
        q_lens = np.zeros((self.n_slots,), np.int32)
        for r in active_reqs:
            g = grants[r.rid]
            tokens[r.slot, :g] = self._queue[r.slot][:g]
            q_lens[r.slot] = g

        if faults is None:
            faults = self._no_faults
        kv_det = np.zeros((self.n_slots,), np.int64)
        kv_cor = np.zeros((self.n_slots,), np.int64)
        efta_retries = 0
        kv_retries = 0
        attempt_faults = faults
        det_acc = np.zeros((self.n_slots, 5), np.int64)
        cor_acc = np.zeros((self.n_slots, 5), np.int64)
        redet_acc = np.zeros((self.n_slots, 5), np.int64)
        kv_redet = np.zeros((self.n_slots,), np.int64)
        seen_bad: set = set()
        while True:
            is_retry = (efta_retries + kv_retries) > 0
            next_np, rep, bad_np = self._step_fused(tokens, self._pos,
                                                    q_lens, attempt_faults)
            det_acc += rep.detected
            cor_acc += rep.corrected
            if is_retry:
                redet_acc += rep.detected
            kv_hit_slots = [s for s in active if bad_np[s].any()]
            if kv_hit_slots:
                # resident corruption: the attempt read poisoned KV — repair
                # the blocks, drop the attempt (nothing committed), retry,
                # within a KV retry budget of its own (>= 1)
                kv_det[kv_hit_slots] += bad_np[kv_hit_slots].sum(-1)
                if is_retry:
                    kv_redet[kv_hit_slots] += bad_np[kv_hit_slots].sum(-1)
                bad_bids = {by_slot[s].block_ids[j] for s in kv_hit_slots
                            for j in np.flatnonzero(bad_np[s])
                            if j < len(by_slot[s].block_ids)}
                self.paged_stats.kv_detected_blocks += \
                    len(bad_bids - seen_bad)
                seen_bad |= bad_bids
                healed: set = set()
                for s in kv_hit_slots:
                    idxs = np.flatnonzero(bad_np[s])
                    kv_cor[s] += idxs.size
                    self._repair_blocks_unified(by_slot[s], idxs,
                                                healed=healed)
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
        retries = efta_retries + kv_retries

        def six(slot):
            return (np.concatenate([det_acc[slot], kv_det[slot:slot + 1]]),
                    np.concatenate([cor_acc[slot], kv_cor[slot:slot + 1]]),
                    np.concatenate([redet_acc[slot],
                                    kv_redet[slot:slot + 1]]))

        if kv_hit_slots:
            # the FINAL attempt still read poisoned KV: commit nothing, keep
            # the repairs, escalate if it persists
            for r in active_reqs:
                r.retries += retries
            self.telemetry.observe_step({r.rid: six(r.slot)
                                         for r in active_reqs},
                                        retries=retries)
            self.stats.retries += retries
            self._poisoned_steps += 1
            if self._poisoned_steps > 3:
                raise RuntimeError(
                    "resident KV corruption persists across block re-prefills "
                    "on consecutive steps — failing memory, not a transient "
                    "SEU; cordon this host and restart elsewhere")
            return finished

        # commit
        self._poisoned_steps = 0
        per_request = {}
        bs = self.block_size
        for req in active_reqs:
            slot = req.slot
            g = int(q_lens[slot])
            old_pos = int(self._pos[slot])
            new_pos = old_pos + g
            req.retries += retries
            if g:
                if g > 1:
                    self.paged_stats.chunked_prefill_tokens += g
                for bi in range(old_pos // bs,
                                min((new_pos - 1) // bs + 1,
                                    len(req.block_ids))):
                    self.pool.blocks.note_write(req.block_ids[bi])
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
            per_request[req.rid] = six(slot)
        self.telemetry.observe_step(per_request, retries=retries)
        self.stats.steps += 1
        self.stats.retries += retries
        return finished
