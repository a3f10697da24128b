"""Public model API: build a model on a device, draw or convert its
parameters, and run it — the training loss, full-sequence logits,
ring-cache prefill and decode, and the unified serving step over a paged
cache. The serving entry points run with gradients off and build no
autograd graph; the loss and the logits are differentiable."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import dp_axes
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.attention import init_cache as init_attn_cache
from repro_torch.models.transformer import (ENC_DEC, HybridCache, VLMCache,
                                            forward, init_params, n_super)

Z_LOSS = 1e-4


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

    def loss(self, params, batch, *, mesh=None):
        """The training loss of ``batch`` (``tokens`` and ``targets`` (B, S)
        int, optional ``loss_mask`` (B, S), and ``frontend`` or
        ``enc_tokens`` as :meth:`logits` takes them): mean cross-entropy
        over the masked positions, plus 1e-4 x the mean squared
        log-partition (z-loss), plus ``router_aux_weight`` x the MoE aux
        loss. Returns (total f32 scalar, metrics) with the JAX package's
        keys: ``loss``, ``ce``, ``z_loss``, ``aux``, and ``ft_detected`` /
        ``ft_corrected`` (5,) summed over the batch. Differentiable.

        On a ``mesh`` the batch is the calling rank's block over the
        data-parallel axes (see :func:`forward`) and the means are the
        global batch's, as GSPMD computes them: the masked sums and the
        count are summed over the data-parallel ranks before they are
        divided (a mean of the ranks' means is not that under an uneven
        mask), and so are the fault counts. Each rank's gradients are then
        its share of the global loss's; the sum of the shares over the
        data-parallel ranks is the gradient."""
        logits, rep, aux, _ = forward(
            params, self.cfg, batch["tokens"], mode="train",
            frontend=batch.get("frontend"),
            enc_tokens=batch.get("enc_tokens"), return_aux=True, mesh=mesh)
        targets = batch["targets"].long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, targets[..., None])[..., 0] - logz
        mask = batch.get("loss_mask")
        mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
        sums = torch.stack([-(ll * mask).sum(), (logz.square() * mask).sum()])
        count = mask.sum()
        detected = rep.detected.sum(dim=0)
        corrected = rep.corrected.sum(dim=0)
        dp = dp_axes(mesh) if mesh is not None else ()
        if mesh is not None and mesh.size(dp) > 1:
            grp = mesh.group(dp)
            sums = coll.psum(sums, grp)
            count = coll.all_reduce(count, grp)
            detected = coll.all_reduce(detected, grp)
            corrected = coll.all_reduce(corrected, grp)
        denom = count.clamp(min=1.0)
        ce = sums[0] / denom
        zl = Z_LOSS * sums[1] / denom
        total = ce + zl
        if self.cfg.moe is not None:
            total = total + self.cfg.moe.router_aux_weight * aux
        metrics = {"loss": total, "ce": ce, "z_loss": zl, "aux": aux,
                   "ft_detected": detected, "ft_corrected": corrected}
        return total, metrics

    def logits(self, params, batch, *, mesh=None):
        """Full-sequence forward of ``batch["tokens"]`` (B, S), causal
        except in the ``encoder`` family; ``batch["frontend"]`` or
        ``batch["enc_tokens"]`` feed the encoder of the encoder-decoder
        families or the VLM's cross-attention. Returns (logits f32 (B, S,
        V), FTReport); on a ``mesh``, those of the rank's batch block."""
        out, rep, _ = forward(params, self.cfg, batch["tokens"], mode="train",
                              frontend=batch.get("frontend"),
                              enc_tokens=batch.get("enc_tokens"), mesh=mesh)
        return out, rep

    def init_cache(self, batch: int, *, cache_len: Optional[int] = None):
        """Empty serving state for ``batch`` rows, stacked over layers: ring
        KV caches (the encoder-decoder families also get a cross-memory
        placeholder of ``max(frontend_tokens, 1)`` rows, which prefill
        replaces); for the ``ssm`` family zeroed rwkv6 states, for
        ``hybrid`` a :class:`HybridCache` of both, for ``vlm`` a
        :class:`VLMCache` (the cross blocks' memory placeholder has
        ``frontend_tokens`` rows)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        L = cfg.num_layers
        cache_len = cache_len or cfg.max_seq
        if cfg.family == "ssm":
            return ssm_lib.rwkv_state_init(batch, cfg.d_model, cfg.ssm, dtype,
                                           self.device, num_layers=L)
        if cfg.family == "vlm":
            ns, ce = n_super(cfg), cfg.cross_attn_every
            dense = init_attn_cache(batch, cfg.attn, cache_len=cache_len,
                                    dtype=dtype, device=self.device,
                                    num_layers=ns * (ce - 1))
            shape = (ns, ce - 1) + tuple(dense.k.shape[1:])
            return VLMCache(
                dense=KVCache(k=dense.k.view(shape), v=dense.v.view(shape),
                              pos=dense.pos),
                cross_blk=init_attn_cache(
                    batch, cfg.attn, cache_len=cache_len, dtype=dtype,
                    device=self.device, num_layers=ns,
                    cross_len=cfg.frontend_tokens))
        attn = init_attn_cache(
            batch, cfg.attn, cache_len=cache_len,
            dtype=dtype, device=self.device, num_layers=L,
            cross_len=max(cfg.frontend_tokens, 1)
            if cfg.family in ENC_DEC else 0)
        if cfg.family == "hybrid":
            return HybridCache(attn=attn, mamba=ssm_lib.mamba_state_init(
                batch, cfg.d_model, cfg.ssm, dtype, self.device,
                num_layers=L))
        return attn

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache, *,
                frontend=None, enc_tokens=None, lengths=None, fault=None,
                mesh=None):
        """Process the prompt (B, S) into a fresh ring ``cache`` (and, for
        the encoder-decoder families, encode ``frontend`` or
        ``enc_tokens`` into the cache's cross memory; for the VLM, project
        ``frontend`` into it). Returns (logits (B, V) at each row's last
        token ``lengths - 1`` (None = the last column), FTReport, cache).
        Causality keeps the gathered logits free of the padding; the serve
        engine rewinds each slot's position to its true length. ``fault``:
        a FaultSpec. ``mesh``: as :func:`forward` takes it."""
        logits, rep, new_cache = forward(params, self.cfg, tokens,
                                         cache=cache, mode="prefill",
                                         fault=fault, frontend=frontend,
                                         enc_tokens=enc_tokens, mesh=mesh)
        return _last_logits(logits, lengths), rep, new_cache

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, *,
                    fault=None, independent_rows: bool = False, mesh=None):
        """token: (B, 1), each row at its own cache position. Returns
        (logits (B, V), FTReport with (B, 5) counts, cache). ``fault``: a
        FaultSpec, per row as (B, n_faults) entries. ``independent_rows``:
        each row is its own MoE routing group, as a batch-1 call per row
        (the serve slots of the JAX package's vmapped decode) would be.
        ``mesh``: as :func:`forward` takes it (the MoE's decode layout)."""
        logits, rep, new_cache = forward(params, self.cfg, token,
                                         cache=cache, mode="decode",
                                         fault=fault,
                                         independent_rows=independent_rows,
                                         mesh=mesh)
        return logits[:, -1, :], rep, new_cache

    @torch.no_grad()
    def score(self, params, tokens: torch.Tensor, cache, *, fault=None,
              independent_rows: bool = False):
        """The unified chunked step returning FULL per-row logits (B, S, V)
        f32: row ``c`` conditions on the cached context plus rows ``0..c``.
        Returns (logits, FTReport, new cache)."""
        return forward(params, self.cfg, tokens, cache=cache, mode="decode",
                       fault=fault, independent_rows=independent_rows)

    @torch.no_grad()
    def extend(self, params, tokens: torch.Tensor, cache, *,
               lengths: Optional[torch.Tensor] = None, fault=None):
        """:meth:`score` returning only each row's logits at its true last
        token ``lengths - 1`` (None = last column)."""
        logits, rep, new_cache = self.score(params, tokens, cache,
                                            fault=fault)
        return _last_logits(logits, lengths), rep, new_cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device=device)
