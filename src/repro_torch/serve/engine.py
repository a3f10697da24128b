"""Continuous-batching serve engine: the request lifecycle shared by the
serve backends.

``ServeEngine`` owns submission, the FCFS scheduler, the run loop, the
retry-on-detect rule and the fault telemetry. Whenever a step reports
faults it could not exactly fix — ``mode="detect"``, or the SNVR analytic
rowsum fallback (``shadow_rowsum=False``) — the engine retries the step
(SEUs are transient; the re-execution is clean) before it commits. The
subclass supplies the cache pool and ``step``; the paged engine
(``repro_torch.serve.paged``) is the one ported so far, and the ring-cache
decode path of the JAX package comes in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.fault import FaultSpec
from repro_torch.ft_runtime.monitor import ServeFaultTelemetry
from repro_torch.models.api import Model
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request


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


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    retries: int = 0
    tokens: int = 0
    prefills: int = 0
    forwards: int = 0      # model forward passes, retries and repairs included


class ServeEngine:
    """Continuous-batching engine over a fixed slot pool (decoder-only
    attention families). Subclasses implement ``_make_pool`` and ``step``."""

    def __init__(self, model: Model, params, *, n_slots: int = 8,
                 cache_len: Optional[int] = None, max_retries: int = 2,
                 retry_on_detect: bool = True):
        cfg = model.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"repro_torch serves the dense decoder family so far; got "
                f"{cfg.family!r}")
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
        self._temps = np.zeros((n_slots,), np.float32)
        self._topks = np.zeros((n_slots,), np.int32)
        self._seeds = np.zeros((n_slots,), np.int32)
        self._rids = np.zeros((n_slots,), np.int32)
        self._counters = np.zeros((n_slots,), np.int32)
        self._no_faults = batch_faults(n_slots)  # reused every clean step

    def _make_pool(self):
        raise NotImplementedError(
            "the ring-cache ServeEngine comes in a later slice; use "
            "repro_torch.serve.PagedServeEngine")

    def step(self, faults: Optional[FaultSpec] = None) -> List[Request]:
        raise NotImplementedError(
            "the ring-cache ServeEngine comes in a later slice; use "
            "repro_torch.serve.PagedServeEngine")

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
