"""Per-request token sampling for the serve engine.

Per-request sampling parameters ride along as host arrays, so one call
serves an arbitrary mix of greedy and stochastic requests. ``temperature ==
0`` rows take the exact argmax (first maximal index on ties, like the JAX
package). Stochastic rows draw Gumbel noise from a ``torch.Generator``
seeded from ``(seed, rid, counter)``: a per-request stream that does not
depend on which other requests share the batch. The draws differ from the
JAX package's (another generator), so only distributions compare.
"""
from __future__ import annotations

import dataclasses

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
