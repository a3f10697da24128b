"""Public model API: build a model on a device, draw or convert its
parameters, and run it — full-sequence logits, ring-cache prefill and
decode, and the unified serving step over a paged cache."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import init_cache as init_attn_cache
from repro_torch.models.transformer import (ENC_DEC, HybridCache, forward,
                                            init_params)


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
        """Full-sequence forward of ``batch["tokens"]`` (B, S), causal
        except in the ``encoder`` family; ``batch["frontend"]`` or
        ``batch["enc_tokens"]`` feed the encoder of the encoder-decoder
        families. Returns (logits f32 (B, S, V), FTReport)."""
        out, rep, _ = forward(params, self.cfg, batch["tokens"], mode="train",
                              frontend=batch.get("frontend"),
                              enc_tokens=batch.get("enc_tokens"))
        return out, rep

    def init_cache(self, batch: int, *, cache_len: Optional[int] = None):
        """Empty serving state for ``batch`` rows, stacked over layers: ring
        KV caches (the encoder-decoder families also get a cross-memory
        placeholder of ``max(frontend_tokens, 1)`` rows, which prefill
        replaces); for the ``ssm`` family zeroed rwkv6 states, for
        ``hybrid`` a :class:`HybridCache` of both."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        L = cfg.num_layers
        if cfg.family == "ssm":
            return ssm_lib.rwkv_state_init(batch, cfg.d_model, cfg.ssm, dtype,
                                           self.device, num_layers=L)
        attn = init_attn_cache(
            batch, cfg.attn, cache_len=cache_len or cfg.max_seq,
            dtype=dtype, device=self.device, num_layers=L,
            cross_len=max(cfg.frontend_tokens, 1)
            if cfg.family in ENC_DEC else 0)
        if cfg.family == "hybrid":
            return HybridCache(attn=attn, mamba=ssm_lib.mamba_state_init(
                batch, cfg.d_model, cfg.ssm, dtype, self.device,
                num_layers=L))
        return attn

    def prefill(self, params, tokens: torch.Tensor, cache, *,
                frontend=None, enc_tokens=None, lengths=None, fault=None):
        """Process the prompt (B, S) into a fresh ring ``cache`` (and, for
        the encoder-decoder families, encode ``frontend`` or
        ``enc_tokens`` into the cache's cross memory). Returns (logits (B,
        V) at each row's last token ``lengths - 1`` (None = the last
        column), FTReport, cache). Causality keeps the gathered logits free
        of the padding; the serve engine rewinds each slot's position to
        its true length. ``fault``: a FaultSpec."""
        logits, rep, new_cache = forward(params, self.cfg, tokens,
                                         cache=cache, mode="prefill",
                                         fault=fault, frontend=frontend,
                                         enc_tokens=enc_tokens)
        return _last_logits(logits, lengths), rep, new_cache

    def decode_step(self, params, token: torch.Tensor, cache, *,
                    fault=None, independent_rows: bool = False):
        """token: (B, 1), each row at its own cache position. Returns
        (logits (B, V), FTReport with (B, 5) counts, cache). ``fault``: a
        FaultSpec, per row as (B, n_faults) entries. ``independent_rows``:
        each row is its own MoE routing group, as a batch-1 call per row
        (the serve slots of the JAX package's vmapped decode) would be."""
        logits, rep, new_cache = forward(params, self.cfg, token,
                                         cache=cache, mode="decode",
                                         fault=fault,
                                         independent_rows=independent_rows)
        return logits[:, -1, :], rep, new_cache

    def score(self, params, tokens: torch.Tensor, cache, *, fault=None,
              independent_rows: bool = False):
        """The unified chunked step returning FULL per-row logits (B, S, V)
        f32: row ``c`` conditions on the cached context plus rows ``0..c``.
        Returns (logits, FTReport, new cache)."""
        return forward(params, self.cfg, tokens, cache=cache, mode="decode",
                       fault=fault, independent_rows=independent_rows)

    def extend(self, params, tokens: torch.Tensor, cache, *,
               lengths: Optional[torch.Tensor] = None, fault=None):
        """:meth:`score` returning only each row's logits at its true last
        token ``lengths - 1`` (None = last column)."""
        logits, rep, new_cache = self.score(params, tokens, cache,
                                            fault=fault)
        return _last_logits(logits, lengths), rep, new_cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device=device)
