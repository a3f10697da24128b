"""Straggler and fault monitoring for the training loop and serve engine.

On a real pod this wraps per-host heartbeats; the detection logic (which is
what we can exercise here) is host-agnostic: robust step-time outliers via
median + MAD, plus an EFTA fault-rate monitor that escalates when the
attention layer reports a sustained detection rate (a symptom of a failing
chip rather than transient SEUs — the launcher should then cordon the host
and trigger an elastic restart from the last checkpoint).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional


@dataclasses.dataclass
class StragglerVerdict:
    is_straggler: bool
    step_time: float
    median: float
    threshold: float


class StragglerMonitor:
    """Flags steps slower than median + k*MAD over a sliding window."""

    def __init__(self, window: int = 50, k: float = 6.0, warmup: int = 5):
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.k = k
        self.warmup = warmup
        self._t0: Optional[float] = None
        self.flagged = 0

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self) -> StragglerVerdict:
        dt = time.perf_counter() - self._t0
        verdict = self.observe(dt)
        return verdict

    def observe(self, dt: float) -> StragglerVerdict:
        if len(self.times) < self.warmup:
            self.times.append(dt)
            return StragglerVerdict(False, dt, dt, float("inf"))
        ts = sorted(self.times)
        med = ts[len(ts) // 2]
        mad = sorted(abs(t - med) for t in ts)[len(ts) // 2]
        thr = med + self.k * max(mad, 0.05 * med)
        is_slow = dt > thr
        self.times.append(dt)
        if is_slow:
            self.flagged += 1
        return StragglerVerdict(is_slow, dt, med, thr)


N_FAULT_SITES = 6
SITE_LABELS = ("gemm1", "exp", "rowmax", "rowsum", "gemm2", "kv")


@dataclasses.dataclass
class RequestFaultStats:
    """Per-request fault telemetry aggregated over every decode step the
    request participated in. Site layout extends FTReport's 5-vector with a
    6th memory site: [gemm1, exp, rowmax, rowsum, gemm2, kv] — ``kv`` counts
    resident KV-block checksum mismatches caught at gather time by the paged
    cache (detected) and blocks healed by re-prefill (corrected). Engines
    that predate the paged cache report 5-vectors; the kv slot stays zero."""

    steps: int = 0
    # ``kv`` is fed by whichever verification caught the flip: the gather
    # backend's fold over gathered blocks, the fused kernel's in-loop verify
    # (report-tile word 6), the append-time tail check, or the speculative
    # rollback's pre-restamp guard — all share one fold/threshold definition
    # in ``repro_torch.core.checksum``.
    detected: list = dataclasses.field(
        default_factory=lambda: [0] * N_FAULT_SITES)
    corrected: list = dataclasses.field(
        default_factory=lambda: [0] * N_FAULT_SITES)
    retries: int = 0
    # ``detected`` aggregates across every attempt of a step (a detection on
    # the first attempt AND on its retry counts twice). ``redetected``
    # splits out the retry attempts' detections, so campaign assertions can
    # distinguish "detected once, then retried clean" (detected == 1,
    # retries == 1, redetected == 0) from "detected twice" (redetected > 0
    # — the fault survived or restruck the re-execution).
    redetected: list = dataclasses.field(
        default_factory=lambda: [0] * N_FAULT_SITES)
    # speculative decoding: the *draft* pass is EFTA-protected too — its
    # detections/corrections are tracked separately from the target pass
    # (the ``detected``/``corrected`` vectors above), so a campaign can
    # attribute a strike to the pass it hit.
    draft_detected: list = dataclasses.field(
        default_factory=lambda: [0] * N_FAULT_SITES)
    draft_corrected: list = dataclasses.field(
        default_factory=lambda: [0] * N_FAULT_SITES)
    draft_retries: int = 0
    # acceptance telemetry: drafts this request scored vs drafts committed
    draft_proposed: int = 0
    draft_accepted: int = 0

    @property
    def total_detected(self) -> int:
        return sum(self.detected)

    @property
    def total_corrected(self) -> int:
        return sum(self.corrected)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of this request's scored draft tokens that the target
        accepted (0.0 when the request never speculated)."""
        return 0.0 if not self.draft_proposed \
            else self.draft_accepted / self.draft_proposed

    @property
    def detection_rate(self) -> float:
        """Fraction of this request's steps that saw >= 1 detection."""
        return 0.0 if not self.steps else self._steps_with_detection / self.steps

    _steps_with_detection: int = 0


def _pad_sites(v) -> list:
    """Normalize a 5- or 6-vector of per-site counts to N_FAULT_SITES."""
    v = [int(x) for x in v]
    return v + [0] * (N_FAULT_SITES - len(v))


class ServeFaultTelemetry:
    """Aggregates per-request and per-step FTReports for the serve engine.

    The engine calls ``observe_step`` once per *committed* decode step with
    the (rid -> (detected[5], corrected[5])) mapping of the rows that were
    active, plus how many retries the step took before committing. Feeds the
    same ``FaultRateMonitor`` escalation logic used by the training loop, so
    sustained detections (failing chip, not transient SEUs) surface as a
    "cordon" status for the launcher.
    """

    def __init__(self, monitor: Optional["FaultRateMonitor"] = None):
        self.requests: dict = {}
        self.step_log: list = []
        self.monitor = monitor or FaultRateMonitor()
        self.status = "ok"

    def _stats(self, rid: int) -> RequestFaultStats:
        return self.requests.setdefault(rid, RequestFaultStats())

    def observe_step(self, per_request: dict, *, retries: int = 0) -> str:
        step_detected = 0
        for rid, entry in per_request.items():
            det, cor = entry[0], entry[1]
            redet = entry[2] if len(entry) > 2 else None
            st = self._stats(rid)
            st.steps += 1
            st.retries += retries
            det = _pad_sites(det)
            cor = _pad_sites(cor)
            st.detected = [a + b for a, b in zip(st.detected, det)]
            st.corrected = [a + b for a, b in zip(st.corrected, cor)]
            if redet is not None:
                redet = _pad_sites(redet)
                st.redetected = [a + b for a, b in zip(st.redetected, redet)]
            if sum(det):
                st._steps_with_detection += 1
            step_detected += sum(det)
        self.step_log.append({"requests": len(per_request),
                              "detected": step_detected,
                              "retries": retries})
        self.status = self.monitor.observe(step_detected)
        return self.status

    def observe_draft(self, rid: int, det, cor, *, retries: int = 0,
                      proposed: int = 0, accepted: int = 0) -> str:
        """Record one request's *draft-pass* activity: the EFTA report of
        its draft-model forward (if any) plus the propose/accept tally of
        the step. Draft detections feed the same sustained-fault escalation
        as target-pass detections — a failing chip corrupts both."""
        st = self._stats(rid)
        det = _pad_sites(det)
        cor = _pad_sites(cor)
        st.draft_detected = [a + b for a, b in zip(st.draft_detected, det)]
        st.draft_corrected = [a + b for a, b in zip(st.draft_corrected, cor)]
        st.draft_retries += retries
        st.draft_proposed += proposed
        st.draft_accepted += accepted
        if sum(det) or retries:
            self.step_log.append({"requests": 1, "detected": sum(det),
                                  "retries": retries, "draft": True})
            self.status = self.monitor.observe(sum(det))
        return self.status

    def observe_scrub(self, detected: int) -> str:
        """Record a background-scrub detection with no owning request (a
        parked prefix-cache block rotted while unmapped). Counts toward the
        step log and the sustained-fault escalation like any other
        resident-state detection."""
        self.step_log.append({"requests": 0, "detected": int(detected),
                              "retries": 0, "scrub": True})
        self.status = self.monitor.observe(int(detected))
        return self.status

    def observe_prefill(self, rid: int, det, cor, *, retries: int = 0) -> str:
        st = self._stats(rid)
        det = _pad_sites(det)
        cor = _pad_sites(cor)
        st.detected = [a + b for a, b in zip(st.detected, det)]
        st.corrected = [a + b for a, b in zip(st.corrected, cor)]
        st.retries += retries
        # prefill detections count toward the step log and the sustained-
        # fault escalation just like decode steps: a failing chip corrupts
        # prefills too, and summary() must not under-report them
        self.step_log.append({"requests": 1, "detected": sum(det),
                              "retries": retries, "prefill": True})
        self.status = self.monitor.observe(sum(det))
        return self.status

    def summary(self) -> dict:
        steps = len(self.step_log)
        return {
            "steps": steps,
            "requests": len(self.requests),
            "detected": sum(s["detected"] for s in self.step_log),
            "retries": sum(s["retries"] for s in self.step_log),
            "status": self.status,
        }


class FaultRateMonitor:
    """Escalates when EFTA detections persist (suspect bad hardware)."""

    def __init__(self, window: int = 100, sustained_threshold: float = 0.2):
        self.history: Deque[int] = collections.deque(maxlen=window)
        self.sustained_threshold = sustained_threshold

    def observe(self, detected_this_step: int) -> str:
        self.history.append(int(detected_this_step))
        if not self.history:
            return "ok"
        rate = sum(1 for d in self.history if d > 0) / len(self.history)
        if len(self.history) >= 20 and rate >= self.sustained_threshold:
            return "cordon"      # sustained faults: cordon host, elastic restart
        if detected_this_step > 0:
            return "corrected"   # transient SEU handled in-kernel by EFTA
        return "ok"
