"""Draft-token proposers: the *propose* stage of propose→score→accept.

The paged engine's unified step (``repro_torch.serve.paged``) is one
contract: each slot proposes K candidate tokens (K = 0 is plain decode), the
chunked step scores them in one EFTA-protected forward, and the acceptance
stage (``repro_torch.serve.sampling.speculative_accept``) commits the
longest valid prefix. This module supplies the proposers:

  * :class:`NGramProposer` — self-drafting prompt lookup: match the tail
    n-gram of the request's committed tokens against an earlier occurrence
    in its own context and propose the continuation that followed it. No
    model cost, deterministic, strongest on repetitive suffixes.
  * :class:`DraftModelProposer` — a small draft model decoded greedily
    through the same EFTA-protected path as the target (``Model.extend`` on
    a ring cache, plain-PyTorch EFTA): a compute SEU in the draft forward is
    detected by the draft's own EFTA checks and the attempt retries clean.
    Even an undetected draft corruption can only mis-propose: the target's
    scoring pass validates every committed token.

Proposers are host-driven between steps and per-slot stateful. The draft
model keeps one batch-1 ring KV cache per slot and rolls back to the
committed context by position rewind: the longest-common-prefix rule in
:meth:`DraftModelProposer.propose` rewinds the cache position to the last
token both the cache and the new committed context agree on (stale ring
entries past it are masked by the ring's position reconstruction and
overwritten on the next feed).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.fault import FaultSpec


@dataclasses.dataclass
class DraftStats:
    """Host-side proposer telemetry (the engine folds the per-proposal
    detect/correct vectors into the per-request draft-pass counters)."""

    proposals: int = 0          # propose() calls that returned >= 1 token
    proposed_tokens: int = 0
    detected: int = 0           # draft-pass EFTA detections (all sites)
    retries: int = 0            # draft forward attempts retried on detect


class NGramProposer:
    """Self-drafting prompt-lookup proposer (no draft model).

    Finds the most recent earlier occurrence of the context's tail n-gram
    (longest n first) and proposes the tokens that followed it. Returns an
    empty proposal when nothing matches — the slot then decodes plainly.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.stats = DraftStats()

    def propose(self, slot: int, tokens: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``tokens`` (the request's
        prompt + committed generation, pending token included)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        t = tokens.size
        if k <= 0 or t < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, t - 1), self.min_ngram - 1, -1):
            pat = tokens[t - n:]
            # rightmost earlier occurrence: windows [i, i+n) for i < t - n
            wins = np.lib.stride_tricks.sliding_window_view(tokens[:-1], n)
            hits = np.flatnonzero((wins[:t - n] == pat).all(axis=1))
            if hits.size == 0:
                continue
            i = int(hits[-1])
            cont = tokens[i + n:i + n + k]
            if cont.size:
                self.stats.proposals += 1
                self.stats.proposed_tokens += int(cont.size)
                return cont.astype(np.int32)
        return np.zeros((0,), np.int32)

    def release(self, slot: int) -> None:
        pass

    def drain_report(self):
        """No model forward, nothing to report (the
        :class:`DraftModelProposer` interface)."""
        return None


class DraftModelProposer:
    """Greedy draft-model proposer over per-slot batch-1 ring KV caches.

    The draft forward runs through the EFTA path the target uses
    (``Model.extend``): per-attempt reports are accumulated, and an attempt
    whose detections could not be exactly corrected is retried clean (SEUs
    are transient), as the serve engine retries. ``fault_next`` lets fault
    campaigns strike the *draft* pass: the spec is consumed by the first
    attempt of the next draft forward.

    ``Model.extend`` writes the chunk's K/V into the ring in place and
    returns the advanced position in a new cache; a retry starts again from
    the old cache object, whose position is unchanged, and rewrites the same
    ring slots. Prompt feeds are fixed-width (``chunk_size``), so the feed
    shapes stay two (feed width and 1) however contexts grow or rewind.
    """

    def __init__(self, model, params, *, n_slots: int, cache_len: int,
                 chunk_size: int = 16, max_retries: int = 2):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.chunk_size = min(chunk_size, cache_len)
        self.max_retries = max_retries
        self._exact_rowsum = model.cfg.ft.shadow_rowsum
        self._fed: List[List[int]] = [[] for _ in range(n_slots)]
        self._cache: List[Optional[object]] = [None] * n_slots
        self.stats = DraftStats()
        self.fault_next: Optional[FaultSpec] = None
        # pending (det[5], cor[5], retries) for the engine's draft telemetry
        self._report = None
        self.forwards = 0               # draft forwards, retries included

    # -- EFTA plumbing ------------------------------------------------------

    def _needs_retry(self, rep) -> bool:
        det = rep.detected.reshape(-1)[:5].cpu().numpy().astype(np.int64)
        cor = rep.corrected.reshape(-1)[:5].cpu().numpy().astype(np.int64)
        uncorrected = det.sum() - cor.sum()
        approx = 0 if self._exact_rowsum else cor[3]
        return bool(uncorrected > 0 or approx > 0)

    def _extend(self, toks, cache, length, fault):
        self.forwards += 1
        return self.model.extend(self.params, toks, cache, lengths=length,
                                 fault=fault)

    def _guarded_extend(self, tokens: np.ndarray, cache, length: int,
                        det_acc, cor_acc):
        """One EFTA-protected draft forward with retry-on-detect. The first
        attempt consumes ``fault_next``; retries run clean from the same
        (old) cache."""
        fault = self.fault_next if self.fault_next is not None \
            else FaultSpec.none(1)
        self.fault_next = None
        toks = torch.as_tensor(tokens, device=self.model.device).long()
        logits, rep, new_cache = self._extend(toks, cache, [length], fault)
        det_acc += rep.detected.reshape(-1)[:5].cpu().numpy().astype(np.int64)
        cor_acc += rep.corrected.reshape(-1)[:5].cpu().numpy().astype(
            np.int64)
        retries = 0
        while self._needs_retry(rep) and retries < self.max_retries:
            retries += 1
            logits, rep, new_cache = self._extend(toks, cache, [length],
                                                  FaultSpec.none(1))
            det_acc += rep.detected.reshape(-1)[:5].cpu().numpy().astype(
                np.int64)
            cor_acc += rep.corrected.reshape(-1)[:5].cpu().numpy().astype(
                np.int64)
        return logits, new_cache, retries

    # -- cache lifecycle ----------------------------------------------------

    def _rewind(self, slot: int, n: int) -> None:
        """Roll the slot's draft cache back to its first ``n`` fed tokens
        (position rewind; stale ring entries are masked + overwritten)."""
        self._fed[slot] = self._fed[slot][:n]
        cache = self._cache[slot]
        if cache is None:
            return
        self._cache[slot] = dataclasses.replace(
            cache, pos=torch.full_like(cache.pos, n))

    def release(self, slot: int) -> None:
        self._fed[slot] = []
        self._cache[slot] = None

    def drain_report(self):
        """Hand the engine the (det[5], cor[5], retries) accumulated by the
        last :meth:`propose` call (draft-pass telemetry), then clear it."""
        r, self._report = self._report, None
        return r

    # -- proposing ----------------------------------------------------------

    def propose(self, slot: int, tokens: np.ndarray, k: int) -> np.ndarray:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        k = min(int(k), self.cache_len - int(tokens.size))
        if k <= 0:
            return np.zeros((0,), np.int32)
        if tokens.size > self.cache_len - self.chunk_size:
            # near draft-cache capacity a feed chunk would have to narrow
            # (a ring wrap would clobber context): fall back to K = 0, as
            # the serve engine does near its boundary
            return np.zeros((0,), np.int32)
        det_acc = np.zeros((5,), np.int64)
        cor_acc = np.zeros((5,), np.int64)
        retries = 0

        fed = self._fed[slot]
        common = 0
        limit = min(len(fed), tokens.size)
        while common < limit and fed[common] == int(tokens[common]):
            common += 1
        if self._cache[slot] is None:
            self._cache[slot] = self.model.init_cache(
                1, cache_len=self.cache_len)
            common = 0
            self._fed[slot] = []
        if common < len(fed):
            self._rewind(slot, common)      # target rejected a draft suffix
        fed = self._fed[slot]

        # feed the committed tokens the draft cache has not seen, in fixed-
        # width chunks; the final chunk's logits seed the greedy draft loop.
        # A padded chunk advances the ring position by its full width and
        # writes junk rows past the fill — rewind to the true fed length so
        # the padding is masked out of every later attention.
        delta = tokens[len(fed):]
        logits = None
        i = 0
        while i < delta.size:
            w = self.chunk_size
            fill = min(w, delta.size - i)
            buf = np.zeros((1, w), np.int32)
            buf[0, :fill] = delta[i:i + fill]
            logits, self._cache[slot], r = self._guarded_extend(
                buf, self._cache[slot], fill, det_acc, cor_acc)
            retries += r
            fed_now = self._fed[slot] + [int(x) for x in delta[i:i + fill]]
            self._fed[slot] = fed_now
            if fill < w:
                self._rewind(slot, len(fed_now))
            i += fill
        if logits is None:
            # cache already holds the full context (pure rewind): re-score
            # the last committed token to recover its next-token logits
            self._rewind(slot, tokens.size - 1)
            buf = np.asarray(tokens[-1:][None], np.int32)
            logits, self._cache[slot], r = self._guarded_extend(
                buf, self._cache[slot], 1, det_acc, cor_acc)
            retries += r
            self._fed[slot].append(int(tokens[-1]))

        # greedy autoregressive drafting (one-hot q): k tokens, k-1 feeds
        drafts: List[int] = []
        for j in range(k):
            d = int(torch.argmax(logits.reshape(-1)))
            drafts.append(d)
            if j == k - 1:
                break
            buf = np.asarray([[d]], np.int32)
            logits, self._cache[slot], r = self._guarded_extend(
                buf, self._cache[slot], 1, det_acc, cor_acc)
            retries += r
            self._fed[slot].append(d)

        self.stats.proposals += 1
        self.stats.proposed_tokens += len(drafts)
        self.stats.detected += int(det_acc.sum())
        self.stats.retries += retries
        self._report = (det_acc, cor_acc, retries)
        return np.asarray(drafts, np.int32)


def build_proposer(kind: str, *, n_slots: int, cache_len: int,
                   chunk_size: int, draft_model=None, draft_params=None,
                   max_ngram: int = 3):
    """Proposer factory for ``PagedServeEngine(speculate=...)``."""
    if kind == "ngram":
        return NGramProposer(max_ngram=max_ngram)
    if kind == "draft":
        if draft_model is None or draft_params is None:
            raise ValueError(
                "speculate='draft' needs draft_model and draft_params")
        return DraftModelProposer(draft_model, draft_params, n_slots=n_slots,
                                  cache_len=cache_len, chunk_size=chunk_size)
    raise ValueError(f"unknown proposer kind {kind!r} "
                     "(expected 'ngram' or 'draft')")
