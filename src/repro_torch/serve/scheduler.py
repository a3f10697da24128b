"""Continuous-batching request scheduler (FCFS, iteration-level).

Orca-style iteration scheduling: at *every* decode step the scheduler first
evicts finished requests (EOS or token budget), then admits waiting requests
into freed cache slots. Admission and eviction are host-side decisions made
between jitted decode steps; the decode computation itself always runs at the
full fixed slot count with finished/empty slots masked out.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.sampling import SamplingParams


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request and its lifetime bookkeeping."""

    rid: int
    prompt: np.ndarray                    # (T,) int32
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_id: Optional[int] = None

    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    # number of engine decode-step retries this request sat through
    retries: int = 0
    # paged engine: pool block ids backing this request's KV, table order
    block_ids: List[int] = dataclasses.field(default_factory=list)
    # paged engine: leading block_ids that came from the prefix cache
    n_prefix_hit: int = 0
    # paged engine: monotone admission sequence (preemption picks the
    # youngest victim; -1 = never admitted)
    admit_order: int = -1

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    def is_done(self) -> bool:
        if self.num_generated >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.generated
                and self.generated[-1] == self.eos_id)


@dataclasses.dataclass
class ScheduleDecision:
    admitted: List[Request]
    evicted: List[Request]


class ContinuousBatchingScheduler:
    """FCFS admission over a fixed slot budget.

    ``chunk_budget`` caps the *prompt* tokens the unified chunked step may
    process per iteration (None = unbounded): the paged engine's mixed
    batches interleave prefill chunks with decodes, and without a budget a
    long prompt monopolizes the step and head-of-line-blocks every decoding
    request's next token. See :meth:`plan_chunks`.
    """

    def __init__(self, n_slots: int, chunk_budget: Optional[int] = None):
        self.n_slots = n_slots
        self.chunk_budget = chunk_budget
        self.waiting: Deque[Request] = collections.deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self.finished: List[Request] = []

    def add(self, req: Request) -> None:
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.rid} already scheduled")
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self, try_admit, release) -> ScheduleDecision:
        """One scheduling iteration.

        ``try_admit(req) -> Optional[slot]`` attempts to reserve every
        resource the request needs (cache slot, and for the paged engine its
        KV blocks); None means the request cannot run *yet*. A failed
        admission leaves the request at the **head** of the queue and stops
        admitting — FCFS means head-of-line blocking, never queue-jumping: a
        request that repeatedly fails allocation keeps its position, and a
        smaller request behind it must wait its turn. ``release(req)`` frees
        a finished request's resources (called while ``req.slot`` is still
        set).
        """
        evicted: List[Request] = []
        for slot in sorted(self.running):
            req = self.running[slot]
            if req.is_done():
                req.state = RequestState.FINISHED
                del self.running[slot]
                release(req)
                req.slot = None
                self.finished.append(req)
                evicted.append(req)

        admitted: List[Request] = []
        while self.waiting:
            req = self.waiting[0]
            slot = try_admit(req)
            if slot is None:
                break       # head keeps its FCFS position for the next step
            self.waiting.popleft()
            req.slot = slot
            req.state = RequestState.RUNNING
            self.running[slot] = req
            admitted.append(req)
        return ScheduleDecision(admitted=admitted, evicted=evicted)

    def preempt(self, req: Request) -> None:
        """Push a running request back to the *front* of the waiting queue
        (pool pressure). Its resources are the caller's to release; it keeps
        its generated tokens and resumes from them on re-admission, and it is
        first in line — preemption must not cost a request its FCFS turn."""
        if req.state is not RequestState.RUNNING:
            raise ValueError(f"request {req.rid} is not running")
        del self.running[req.slot]
        req.state = RequestState.WAITING
        self.waiting.appendleft(req)

    def active_rows(self) -> Sequence[Request]:
        return [self.running[s] for s in sorted(self.running)]

    def plan_chunks(self, demands: Sequence[tuple],
                    chunk_size: int,
                    draft_wants: Optional[Dict[int, int]] = None):
        """Split one unified step's token budget across the active requests.

        ``demands``: ``(request, n_remaining)`` pairs — how many feed tokens
        (prompt suffix + the pending decode token) each active request still
        owes. Returns ``rid -> tokens granted this step``.

        Fairness contract: every request with work is granted its first
        token unconditionally — a decoding request's next token is never
        starved by prefill traffic. Only the *surplus* (prompt chunk rows
        beyond the first, up to ``chunk_size`` per request) draws from
        ``chunk_budget``, handed out FCFS by admission order so an early
        long prompt still finishes before a later one accelerates.

        ``draft_wants`` (rid -> K) adds the speculative-decoding demand:
        how many *draft* rows each steady-state request would like to score
        this step. Draft rows ride the SAME ``chunk_budget`` as prompt
        surplus but rank strictly *after* it (prompt chunks are what queued
        admissions are waiting on — speculation must never starve decodes
        or admissions, only spend leftover budget), FCFS by admission order,
        capped at ``chunk_size - 1`` per slot (the scored chunk is the
        pending token plus the drafts). When given, returns
        ``(grants, draft_grants)``.
        """
        grants = {req.rid: min(1, rem) for req, rem in demands}
        budget = self.chunk_budget
        for req, rem in sorted(demands, key=lambda d: d[0].admit_order):
            extra = min(rem, chunk_size) - grants[req.rid]
            if extra <= 0:
                continue
            if budget is not None:
                extra = min(extra, budget)
                budget -= extra
            grants[req.rid] += extra
        if draft_wants is None:
            return grants
        draft_grants: Dict[int, int] = {}
        for req, rem in sorted(demands, key=lambda d: d[0].admit_order):
            want = min(draft_wants.get(req.rid, 0),
                       chunk_size - grants[req.rid])
            if want <= 0 or rem > 1:
                draft_grants[req.rid] = 0
                continue       # drafts extend steady-state decodes only
            if budget is not None:
                want = min(want, budget)
                budget -= want
            draft_grants[req.rid] = want
        return grants, draft_grants
