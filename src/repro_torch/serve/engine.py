"""Fault-tolerant continuous-batching serve engine over per-slot ring KV
caches.

``ServeEngine`` owns submission, the FCFS scheduler, the run loop, the
retry-on-detect rule and the fault telemetry, and serves from a fixed pool
of ring-cache slots (``repro_torch.serve.cache``): an admitted prompt is
prefilled alone, padded to a power-of-two bucket (with
``attn_impl="efta_pallas"`` its attention is the fused contiguous EFTA
kernel, one launch per layer), and every step then decodes one token for
all ``n_slots`` slots in one batched forward (idle slots compute values
that are ignored). Each slot keeps its own position, ring and causal mask,
so the batch equals the slots' independent sequential decodes:
``greedy_generate`` per request is the engine's exactness oracle.

Fault handling: EFTA's counts come back per slot. In ``mode="correct"``
detected SEUs are fixed in place and only counted. Whenever a step reports
faults it could not exactly fix — ``mode="detect"``, or the SNVR analytic
rowsum fallback (``shadow_rowsum=False``) — the engine retries the step
(SEUs are transient; the re-execution is clean) before it commits. The
paged engine (``repro_torch.serve.paged``) subclasses this one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fault import FaultSpec
from repro_torch.ft_runtime.monitor import ServeFaultTelemetry
from repro_torch.models.api import Model
from repro_torch.serve.cache import KVCachePool
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

MIN_PREFILL_BUCKET = 8   # the smallest prompt bucket a prefill is padded to


def batch_faults(n_slots: int,
                 per_slot: Optional[Dict[int, FaultSpec]] = None) -> FaultSpec:
    """Stack per-slot fault specs into the (n_slots, n_faults) layout the
    engine's step takes. Slots without an entry get a disabled spec."""
    per_slot = per_slot or {}
    nf = max([s.site.shape[0] for s in per_slot.values()] or [1])
    rows = []
    for i in range(n_slots):
        spec = per_slot.get(i, FaultSpec.none(nf))
        if spec.site.shape[0] != nf:
            pad = FaultSpec.none(nf - spec.site.shape[0])
            spec = FaultSpec(*(np.concatenate([a, b])
                               for a, b in zip(spec, pad)))
        rows.append(spec)
    return FaultSpec(*(np.stack(col) for col in zip(*rows)))


class StepReport(NamedTuple):
    """Host copy of one forward's per-slot EFTA counts, (n_slots, 5) each."""

    detected: np.ndarray
    corrected: np.ndarray

    @staticmethod
    def of(rep) -> "StepReport":
        """From a device FTReport with per-row counts."""
        return StepReport(
            rep.detected.cpu().numpy().astype(np.int64).reshape(-1, 5),
            rep.corrected.cpu().numpy().astype(np.int64).reshape(-1, 5))


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    retries: int = 0
    tokens: int = 0
    prefills: int = 0
    forwards: int = 0      # model forward passes, retries and repairs included
    prefill_forwards: int = 0   # the ring engine's prompt forwards, retries
    #                             included


class ServeEngine:
    """Continuous-batching engine over a fixed pool of ring KV-cache slots
    (the decoder-only attention families, dense and moe). Prompts are padded to power-of-two
    buckets from ``MIN_PREFILL_BUCKET`` up to ``cache_len``; decode is one
    batched forward over all ``n_slots`` slots."""

    def __init__(self, model: Model, params, *, n_slots: int = 8,
                 cache_len: Optional[int] = None, max_retries: int = 2,
                 retry_on_detect: bool = True):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"serve engine supports decoder-only attention families "
                f"(dense, moe); got {cfg.family!r}")
        self.model = model
        self.params = params
        self.device = model.device
        self.cache_len = cache_len or cfg.max_seq
        self.n_slots = n_slots
        self.max_retries = max_retries
        self.retry_on_detect = retry_on_detect
        # SNVR analytic rowsum fallback (paper Case 3) bounds the error but
        # is not exact — treat such "corrections" as retry-worthy.
        self._exact_rowsum = cfg.ft.shadow_rowsum
        self.pool = self._make_pool()
        self.scheduler = ContinuousBatchingScheduler(n_slots)
        self.telemetry = ServeFaultTelemetry()
        self.stats = EngineStats()
        self._rid = 0
        # per-slot host mirrors of the sampling state
        self._pending = np.zeros((n_slots,), np.int32)
        self._temps = np.zeros((n_slots,), np.float32)
        self._topks = np.zeros((n_slots,), np.int32)
        self._seeds = np.zeros((n_slots,), np.int32)
        self._rids = np.zeros((n_slots,), np.int32)
        self._counters = np.zeros((n_slots,), np.int32)
        self._no_faults = batch_faults(n_slots)  # reused every clean step

    def _make_pool(self):
        """Cache-pool factory; the paged engine overrides this."""
        return KVCachePool(self.model, self.n_slots, self.cache_len)

    def _try_admit(self, req: Request) -> Optional[int]:
        """Reserve resources for one admission; None = cannot run yet."""
        return self.pool.alloc()

    def _release_request(self, req: Request) -> None:
        self.pool.release(req.slot)

    # -- the two computations ------------------------------------------------

    def _prefill(self, tokens: np.ndarray, length: int, fault: FaultSpec):
        """One prompt forward into a fresh batch-1 ring. Returns (last
        logits (1, V), host counts (1, 5), row cache)."""
        self.stats.forwards += 1
        self.stats.prefill_forwards += 1
        row = self.model.init_cache(1, cache_len=self.cache_len)
        logits, rep, row = self.model.prefill(
            self.params, torch.as_tensor(tokens, device=self.device).long(),
            row, lengths=[length], fault=fault)
        return logits, StepReport.of(rep), row

    def _decode(self, faults: Optional[FaultSpec]):
        """One batched decode step over every slot, writing each slot's new
        K/V row in place. Returns (next tokens (n_slots,) on the host, host
        counts (n_slots, 5), the cache with positions advanced — to be
        committed by the caller)."""
        self.stats.forwards += 1
        if faults is not None and not (np.asarray(faults.site) >= 0).any():
            faults = None
        tokens = torch.as_tensor(self._pending[:, None],
                                 device=self.device).long()
        # each slot its own MoE routing group: the JAX package vmaps a
        # batch-1 decode over the slots
        logits, rep, new_state = self.model.decode_step(
            self.params, tokens, self.pool.state, fault=faults,
            independent_rows=True)
        next_tokens = sample_tokens(
            logits.float(), temperature=self._temps, top_k=self._topks,
            seeds=self._seeds, rids=self._rids, counters=self._counters)
        return next_tokens, StepReport.of(rep), new_state

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > self.cache_len:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"{self.cache_len}-slot KV cache")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds cache_len ({self.cache_len}); raise cache_len")
        rid = self._rid
        self._rid += 1
        self.scheduler.add(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=max_new_tokens,
                                   sampling=sampling or SamplingParams(),
                                   eos_id=eos_id))
        return rid

    def _bucket(self, n: int) -> int:
        b = MIN_PREFILL_BUCKET
        while b < n:
            b *= 2
        return min(b, self.cache_len)

    def _admit(self, req: Request) -> None:
        t = req.prompt_len
        lp = max(self._bucket(t), t)
        padded = np.zeros((1, lp), np.int32)
        padded[0, :t] = req.prompt
        fault = FaultSpec.none(1)
        logits, rep, row = self._prefill(padded, t, fault)
        det_acc, cor_acc = rep.detected[0].copy(), rep.corrected[0].copy()
        retries = 0
        while self._needs_retry_rows(rep, rows=None) and \
                retries < self.max_retries:
            retries += 1
            logits, rep, row = self._prefill(padded, t, fault)
            det_acc += rep.detected[0]
            cor_acc += rep.corrected[0]
        self.telemetry.observe_prefill(req.rid, det_acc, cor_acc,
                                       retries=retries)
        req.retries += retries
        self.stats.prefills += 1
        self.stats.retries += retries

        slot = req.slot
        self.pool.write_row(slot, row, t)
        s = req.sampling
        tok = int(sample_tokens(
            logits.float(), temperature=[s.temperature], top_k=[s.top_k],
            seeds=[s.seed], rids=[req.rid], counters=[0])[0])
        req.generated.append(tok)
        self._pending[slot] = tok
        self._temps[slot] = s.temperature
        self._topks[slot] = s.top_k
        self._seeds[slot] = s.seed
        self._rids[slot] = req.rid
        self._counters[slot] = 1
        self.stats.tokens += 1

    # -- stepping -----------------------------------------------------------

    def _needs_retry_rows(self, rep, rows: Optional[Sequence[int]]) -> bool:
        """Whether a step's report holds faults it could not exactly fix
        (restricted to ``rows``). ``rep.detected``/``rep.corrected``: (n, 5)
        or (5,) counts."""
        if not self.retry_on_detect:
            return False
        det = np.asarray(rep.detected).reshape(-1, 5)
        cor = np.asarray(rep.corrected).reshape(det.shape)
        uncorrected = det.sum(-1) - cor.sum(-1)
        approx = np.zeros_like(uncorrected) if self._exact_rowsum \
            else cor[:, 3]
        need = (uncorrected > 0) | (approx > 0)
        if rows is not None:
            need = need[list(rows)]
        return bool(need.any())

    @torch.no_grad()
    def step(self, faults: Optional[FaultSpec] = None) -> List[Request]:
        """One engine iteration: schedule, (re)decode, commit. Returns the
        requests that finished during this iteration. ``faults`` is an
        optional (n_slots, n_faults) SEU batch (:func:`batch_faults`, slot
        ``i``'s coordinates relative to its own row) injected into this
        step's first decode attempt; retries re-execute clean."""
        decision = self.scheduler.step(self._try_admit, self._release_request)
        for req in decision.admitted:
            self._admit(req)
        finished = list(decision.evicted)
        active = [r.slot for r in self.scheduler.active_rows()]
        if not active:
            return finished

        next_tokens, rep, new_state = self._decode(faults)
        det_acc, cor_acc = rep.detected.copy(), rep.corrected.copy()
        retries = 0
        while self._needs_retry_rows(rep, rows=active) and \
                retries < self.max_retries:
            retries += 1
            next_tokens, rep, new_state = self._decode(None)
            det_acc += rep.detected
            cor_acc += rep.corrected

        # commit
        self.pool.state = new_state
        per_request = {}
        for req in self.scheduler.active_rows():
            if req.is_done():
                continue  # finished at admission; evicted next iteration
            slot = req.slot
            tok = int(next_tokens[slot])
            req.generated.append(tok)
            req.retries += retries
            self._pending[slot] = tok
            self._counters[slot] += 1
            per_request[req.rid] = (det_acc[slot], cor_acc[slot])
            self.stats.tokens += 1
        self.telemetry.observe_step(per_request, retries=retries)
        self.stats.steps += 1
        self.stats.retries += retries
        return finished

    def run(self, faults_by_step: Optional[Dict[int, FaultSpec]] = None
            ) -> Dict[int, np.ndarray]:
        """Drive until every submitted request finishes. ``faults_by_step``
        optionally injects a per-slot SEU batch at given step indices.
        Returns rid -> generated tokens."""
        faults_by_step = faults_by_step or {}
        i = 0
        while self.scheduler.has_work:
            self.step(faults=faults_by_step.get(i))
            i += 1
        return {r.rid: np.asarray(r.generated, np.int32)
                for r in self.scheduler.finished}
