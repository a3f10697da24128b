"""Serving step factories (prefill and decode, with the mesh threaded as
the JAX package threads it) and the per-request greedy decoder that is the
ring serve engine's exactness oracle."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model


def make_prefill_step(model: Model, *, mesh=None):
    def prefill(params, tokens, cache, frontend=None, enc_tokens=None):
        return model.prefill(params, tokens, cache, frontend=frontend,
                             enc_tokens=enc_tokens, mesh=mesh)
    return prefill


def make_decode_step(model: Model, *, mesh=None):
    def decode(params, token, cache):
        return model.decode_step(params, token, cache, mesh=mesh)
    return decode


@torch.no_grad()
def greedy_generate(model: Model, params, tokens: torch.Tensor, *,
                    steps: int, cache_len: Optional[int] = None, mesh=None,
                    **prefill_kw):
    """Per-token Python-loop greedy decoder: prefill ``tokens`` (B, S),
    then ``steps`` decode steps, each taking the argmax. ``prefill_kw`` go
    to :meth:`Model.prefill`: ``frontend`` or ``enc_tokens`` for the
    encoder-decoder families, ``lengths``, ``fault``. Returns (tokens (B,
    steps), the merged FTReport). Kept as the exactness oracle for
    :class:`repro_torch.serve.ServeEngine`, which must emit the same tokens
    per request, and as the serving path of the families the engines do
    not serve (the CLI's static batch)."""
    b = tokens.shape[0]
    cache = model.init_cache(b, cache_len=cache_len or
                             (tokens.shape[1] + steps + 1))
    logits, rep, cache = model.prefill(params, tokens, cache, mesh=mesh,
                                       **prefill_kw)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(steps):
        out.append(tok)
        logits, rep_i, cache = model.decode_step(params, tok, cache,
                                                 mesh=mesh)
        rep = rep.merge(rep_i)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(out, dim=1), rep
