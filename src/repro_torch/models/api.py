"""Public model API: build a model on a device, draw or convert its
parameters, and run it — full-sequence logits, ring-cache prefill and
decode, and the unified serving step over a paged cache."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import init_cache as init_attn_cache
from repro_torch.models.transformer import forward, init_params


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default everywhere)
    requires a card and raises without one; the CPU runs only when asked
    for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def _last_logits(logits, lengths):
    if lengths is None:
        return logits[:, -1, :]
    idx = (torch.as_tensor(lengths, device=logits.device).long() - 1).clamp(
        0, logits.shape[1] - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), idx]


class Model:
    """Thin handle over a config and a device; the methods are functions of
    the parameters passed in."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Any:
        return init_params(generator, self.cfg, self.device)

    def logits(self, params, batch):
        """Full-sequence causal forward of ``batch["tokens"]`` (B, S).
        Returns (logits f32 (B, S, V), FTReport)."""
        out, rep, _ = forward(params, self.cfg, batch["tokens"], mode="train")
        return out, rep

    def init_cache(self, batch: int, *, cache_len: Optional[int] = None):
        """Empty ring KV caches for ``batch`` rows, stacked over layers."""
        cfg = self.cfg
        return init_attn_cache(batch, cfg.attn,
                               cache_len=cache_len or cfg.max_seq,
                               dtype=getattr(torch, cfg.dtype),
                               device=self.device,
                               num_layers=cfg.num_layers)

    def prefill(self, params, tokens: torch.Tensor, cache, *,
                lengths=None, fault=None):
        """Process the prompt (B, S) into a fresh ring ``cache``. Returns
        (logits (B, V) at each row's last token ``lengths - 1`` (None = the
        last column), FTReport, cache). Causality keeps the gathered logits
        free of the padding; the serve engine rewinds each slot's position
        to its true length. ``fault``: a FaultSpec."""
        logits, rep, new_cache = forward(params, self.cfg, tokens,
                                         cache=cache, mode="prefill",
                                         fault=fault)
        return _last_logits(logits, lengths), rep, new_cache

    def decode_step(self, params, token: torch.Tensor, cache, *,
                    fault=None):
        """token: (B, 1), each row at its own cache position. Returns
        (logits (B, V), FTReport with (B, 5) counts, cache). ``fault``: a
        FaultSpec, per row as (B, n_faults) entries."""
        logits, rep, new_cache = forward(params, self.cfg, token,
                                         cache=cache, mode="decode",
                                         fault=fault)
        return logits[:, -1, :], rep, new_cache

    def score(self, params, tokens: torch.Tensor, cache, *, fault=None):
        """The unified chunked step returning FULL per-row logits (B, S, V)
        f32: row ``c`` conditions on the cached context plus rows ``0..c``.
        Returns (logits, FTReport, new cache)."""
        return forward(params, self.cfg, tokens, cache=cache, mode="decode",
                       fault=fault)

    def extend(self, params, tokens: torch.Tensor, cache, *,
               lengths: Optional[torch.Tensor] = None, fault=None):
        """:meth:`score` returning only each row's logits at its true last
        token ``lengths - 1`` (None = last column)."""
        logits, rep, new_cache = self.score(params, tokens, cache,
                                            fault=fault)
        return _last_logits(logits, lengths), rep, new_cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device=device)
