"""The per-request greedy decoder that is the ring serve engine's
exactness oracle."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model


@torch.no_grad()
def greedy_generate(model: Model, params, tokens: torch.Tensor, *,
                    steps: int, cache_len: Optional[int] = None,
                    **prefill_kw):
    """Per-token Python-loop greedy decoder: prefill ``tokens`` (B, S),
    then ``steps`` decode steps, each taking the argmax. Returns (tokens
    (B, steps), the merged FTReport). Kept as the exactness oracle for
    :class:`repro_torch.serve.ServeEngine`, which must emit the same tokens
    per request; production serving goes through the engine."""
    b = tokens.shape[0]
    cache = model.init_cache(b, cache_len=cache_len or
                             (tokens.shape[1] + steps + 1))
    logits, rep, cache = model.prefill(params, tokens, cache, **prefill_kw)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(steps):
        out.append(tok)
        logits, rep_i, cache = model.decode_step(params, tok, cache)
        rep = rep.merge(rep_i)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(out, dim=1), rep
