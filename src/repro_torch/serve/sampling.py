"""Per-request token sampling for the serve engine.

Per-request sampling parameters ride along as host arrays, so one call
serves an arbitrary mix of greedy and stochastic requests. ``temperature ==
0`` rows take the exact argmax (first maximal index on ties, like the JAX
package). Stochastic rows draw Gumbel noise from a ``torch.Generator``
seeded from ``(seed, rid, counter)``: a per-request stream that does not
depend on which other requests share the batch. The draws differ from the
JAX package's (another generator), so only distributions compare.

:func:`speculative_accept` is the *accept* stage of the paged engine's
propose→score→accept step: speculative rejection sampling over the target's
per-row logits, on the host in numpy, with the JAX package's arithmetic and
its per-(request, step) ``np.random`` stream, so it decides as the
reference does on equal rows. Greedy requests take the exact-argmax path,
which keeps greedy speculation token-identical to plain decoding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side)."""

    temperature: float = 0.0   # 0 => greedy (exact argmax)
    top_k: int = 0             # 0 => no truncation
    seed: int = 0              # per-request PRNG stream

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


def request_generator(seed: int, rid: int, counter: int,
                      device) -> torch.Generator:
    """The generator for one draw of one request: seeded from (seed, rid,
    counter), so two requests sharing a seed still get independent
    streams."""
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(rid), int(counter)]).generate_state(1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def sample_tokens(logits: torch.Tensor, *, temperature, top_k, seeds, rids,
                  counters) -> np.ndarray:
    """Sample one token per row. ``logits`` (B, V) f32; the other arguments
    are (B,) host arrays. Returns (B,) int32 numpy. Stochastic rows use the
    Gumbel-max trick over the top-k-truncated, temperature-scaled logits."""
    temperature = np.asarray(temperature, np.float32)
    out = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    vocab = logits.shape[-1]
    for i in np.flatnonzero(temperature > 0.0):
        row = logits[i]
        k = int(top_k[i])
        if k > 0:
            kth = torch.topk(row, min(k, vocab)).values[-1]
            row = torch.where(row >= kth, row,
                              torch.full_like(row, float("-inf")))
        gen = request_generator(seeds[i], rids[i], counters[i], row.device)
        u = torch.rand((vocab,), generator=gen, device=row.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        z = row / max(float(temperature[i]), 1e-6) + gumbel
        out[i] = int(torch.argmax(z))
    return out


# ---------------------------------------------------------------------------
# speculative decoding: the accept stage (host-side, numpy)
# ---------------------------------------------------------------------------

def target_probs(row: np.ndarray, *, temperature: float,
                 top_k: int) -> np.ndarray:
    """The target distribution one logits row samples from: top-k truncation
    then temperature-scaled softmax, in float64."""
    row = np.asarray(row, np.float64)
    if top_k > 0:
        kth = np.sort(row)[-min(top_k, row.size)]
        row = np.where(row >= kth, row, -np.inf)
    t = max(float(temperature), 1e-6)
    z = row / t
    z = z - np.max(z)
    p = np.exp(z)
    return p / p.sum()


def speculative_accept(
    rows: np.ndarray,
    draft: np.ndarray,
    *,
    temperature: float,
    top_k: int,
    rng: Optional[np.random.Generator] = None,
    q_probs: Optional[np.ndarray] = None,
) -> Tuple[int, int]:
    """Standard speculative rejection sampling against the target logits.

    ``rows``: (k+1, V) target logits for the scored chunk — row ``j`` is
    ``p(. | context, accepted rows 0..j-1)``, the distribution draft token
    ``draft[j]`` was proposed for; row ``k`` conditions on all k drafts and
    supplies the bonus token when every draft is accepted. ``q_probs`` (k,)
    optionally gives the proposer's probability of each draft token (default
    1.0: a one-hot proposer — prompt lookup or a greedy draft model). The
    residual distribution assumes the proposer's mass sits on the proposed
    token (exact for the one-hot proposers shipped here).

    Returns ``(n_accepted, next_token)``: the longest accepted draft prefix
    and the token sampled after it (the bonus token from row
    ``n_accepted`` when all drafts were accepted, else the residual-
    distribution resample at the rejection row). Each committed token is
    distributed as a non-speculative sample from the target.

    ``temperature <= 0`` is the exact greedy path: accept ``draft[j]`` iff
    it equals ``argmax(rows[j])``, bonus/resample by argmax.
    """
    rows = np.asarray(rows, np.float32)
    draft = np.asarray(draft, np.int64).reshape(-1)
    k = draft.size
    if rows.shape[0] < k + 1:
        raise ValueError(f"{rows.shape[0]} scored rows for {k} drafts; "
                         f"need k + 1")

    if temperature <= 0.0:
        n = 0
        while n < k and int(np.argmax(rows[n])) == int(draft[n]):
            n += 1
        return n, int(np.argmax(rows[n]))

    if rng is None:
        raise ValueError("stochastic acceptance needs a PRNG")
    n = 0
    while n < k:
        p = target_probs(rows[n], temperature=temperature, top_k=top_k)
        q = 1.0 if q_probs is None else float(q_probs[n])
        if rng.uniform() < p[draft[n]] / max(q, 1e-20):
            n += 1
            continue
        # rejected: resample from the residual max(p - q, 0) renormalized.
        # For a one-hot proposal this is p with the draft token zeroed.
        res = p.copy()
        if q_probs is None:
            res[draft[n]] = 0.0
        else:
            res[draft[n]] = max(res[draft[n]] - q, 0.0)
        s = res.sum()
        if s <= 0.0:          # proposal == target mass; degenerate residual
            return n, int(draft[n])
        return n, int(rng.choice(res.size, p=res / s))
    p = target_probs(rows[k], temperature=temperature, top_k=top_k)
    return k, int(rng.choice(p.size, p=p))
