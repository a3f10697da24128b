"""Model assembly: parameters, per-layer flags and the forward pass, as a
Python loop over layers: the full-sequence forward (``mode="train"``,
logits only, no gradient), ring-cache prefill and decode, and the unified
serving step over a paged cache.

Families ported: ``dense`` (decoder only), ``encoder`` (BERT: the same
blocks, non-causal) and the encoder-decoder ``encdec`` (T5: a token
encoder) and ``audio`` (Whisper: precomputed frontend frames), whose
decoder blocks cross-attend to the encoder's memory. ``moe``, ``ssm``,
``hybrid`` and ``vlm`` are not ported yet.

Parameters keep the JAX package's pytree layout — ``blocks`` (and
``encoder``) hold every layer's tensors stacked on a leading layer axis —
so weights convert across unchanged (``repro_torch.models.convert``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.efta import FTReport
from repro_torch.kernels.efta_paged import NO_WINDOW
from repro_torch.models.attention import (KVCache, PagedKVCache, attn_apply,
                                          attn_init, cross_attn_apply)
from repro_torch.models.layers import (embed_apply, embed_init,
                                       learned_pos_init, mlp_apply, mlp_init,
                                       norm_apply, norm_init, unembed)


def layer_flags(cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Static per-layer arrays: is_global (full attention) and rope theta."""
    n = cfg.num_layers
    a = cfg.attn
    is_global = np.ones((n,), np.bool_)
    theta = np.full((n,), a.rope_theta if a else 1e4, np.float32)
    if a is not None and a.sliding_window is not None:
        if a.global_every:
            is_global = (np.arange(n) % a.global_every) == (a.global_every - 1)
        else:
            is_global = np.zeros((n,), np.bool_)
        theta = np.where(is_global, 1e6 if a.global_every else a.rope_theta,
                         a.rope_theta).astype(np.float32)
    return {"is_global": is_global, "theta": theta}


FAMILIES = ("dense", "encoder", "encdec", "audio")
ENC_DEC = ("encdec", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.attn is None:
        raise NotImplementedError(
            f"repro_torch ports the {'/'.join(FAMILIES)} families so far "
            f"(moe, ssm, hybrid and vlm are not ported); {cfg.name} is "
            f"{cfg.family!r}")


def _block_init(gen: torch.Generator, cfg: ModelConfig, device, *,
                cross: bool = False):
    """One block's parameters; ``cross`` adds the decoder's cross-attention
    (``norm_x``, ``cross``) of the encoder-decoder families."""
    d, dtype = cfg.d_model, getattr(torch, cfg.dtype)
    p = {"norm1": norm_init(cfg.norm, d, dtype, device),
         "attn": attn_init(gen, d, cfg.attn, dtype, device)}
    if cross:
        p["norm_x"] = norm_init(cfg.norm, d, dtype, device)
        p["cross"] = attn_init(gen, d, cfg.attn, dtype, device)
    p["norm2"] = norm_init(cfg.norm, d, dtype, device)
    p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, device, glu=cfg.glu)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(gen: torch.Generator, cfg: ModelConfig, device
                ) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` (on the generator's device),
    placed on ``device``."""
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    gd = gen.device
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, gd),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dtype, gd),
    }
    if cfg.attn.pos == "learned":
        params["pos"] = learned_pos_init(gen, max(cfg.max_seq, 64),
                                         cfg.d_model, dtype, gd)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, gd)
    enc_dec = cfg.family in ENC_DEC
    if enc_dec:
        params["encoder"] = _stack([_block_init(gen, cfg, gd)
                                    for _ in range(cfg.encoder_layers)])
        params["enc_norm"] = norm_init(cfg.norm, cfg.d_model, dtype, gd)
    params["blocks"] = _stack([_block_init(gen, cfg, gd, cross=enc_dec)
                               for _ in range(cfg.num_layers)])
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _block_apply(params, x, *, cfg: ModelConfig, is_global: bool,
                 theta: float, cache, mode: str, positions, fault,
                 causal: bool = True, memory=None):
    """One pre-norm transformer block: self-attention (``causal`` or not),
    then, in a decoder block of the encoder-decoder families, cross-
    attention to ``memory`` (or to the cache's ``ck``/``cv`` in decode),
    then the MLP. Returns (x, FTReport, bad plane or None, the cross K/V to
    keep in the cache or None)."""
    a = dataclasses.replace(cfg.attn, causal=causal)
    window = None
    if a.sliding_window is not None:
        window = NO_WINDOW if is_global else a.sliding_window
    h_in = norm_apply(cfg.norm, params["norm1"], x)
    h, rep, bad = attn_apply(
        params["attn"], h_in, acfg=dataclasses.replace(a, rope_theta=theta),
        ft=cfg.ft, window=window, positions=positions, cache=cache,
        mode=mode, fault=fault)
    x = x + h
    kv = None
    if "cross" in params:
        hx = norm_apply(cfg.norm, params["norm_x"], x)
        hx, rep_x, kv = cross_attn_apply(
            params["cross"], hx, acfg=dataclasses.replace(a, causal=False),
            ft=cfg.ft, positions=positions, memory=memory, cache=cache,
            mode=mode)
        rep = rep.merge(rep_x)
        x = x + hx
    h2 = norm_apply(cfg.norm, params["norm2"], x)
    x = x + mlp_apply(params["mlp"], h2, act=cfg.act, glu=cfg.glu,
                      ff_abft=cfg.ft.ff_abft)
    return x, rep, bad, kv


def _encode(params, cfg: ModelConfig, *, frontend, enc_tokens, dtype):
    """The encoder pass of the encoder-decoder families: ``frontend``
    frames (B, M, d_model) or embedded ``enc_tokens`` (B, M), every layer
    global at the config's rope theta, non-causal, no fault; then
    ``enc_norm``. Returns (memory (B, M, d_model), FTReport)."""
    if frontend is not None:
        enc_x = frontend.to(dtype)
    else:
        enc_x = embed_apply(params["embed"], enc_tokens)
    b, m = enc_x.shape[:2]
    enc_pos = torch.arange(m, device=enc_x.device)[None, :].expand(b, m)
    rep = FTReport.zero(b, device=enc_x.device)
    for i in range(cfg.encoder_layers):
        enc_x, rep_i, _, _ = _block_apply(
            _index(params["encoder"], i), enc_x, cfg=cfg, is_global=True,
            theta=cfg.attn.rope_theta, cache=None, mode="train",
            positions=enc_pos, fault=None, causal=False)
        rep = rep.merge(rep_i)
    return norm_apply(cfg.norm, params["enc_norm"], enc_x), rep


@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            mode: str = "train", fault=None, frontend=None, enc_tokens=None):
    """The model forward. ``tokens`` (B, S) are the decoder's (or, for the
    ``encoder`` family, the encoder's) tokens; ``frontend`` (B, M,
    d_model) frames (``audio``) or ``enc_tokens`` (B, M) (``encdec``) feed
    the encoder of the encoder-decoder families in ``mode`` "train" and
    "prefill" — the keys of the JAX package's ``batch`` dict. Decode reads
    the cross memory from the cache instead.

    * ``mode="train"``, no cache: the full sequence (logits only; the port
      has no training step yet), causally except in the ``encoder``
      family.
    * ``mode="prefill"``, a fresh :class:`KVCache`: the prompt at positions
      ``0..S-1``, filling every layer's ring.
    * ``mode="decode"``: row ``c`` of request ``b`` at position
      ``cache.pos[b] + c``, over a :class:`KVCache` ring (per-slot decode)
      or a :class:`PagedKVCache` (the unified serving step; pools updated
      in place, ``fault`` the paged kernel's int32[8] descriptor).

    Returns (logits f32 (B, S, V), FTReport with (B, 5) per-row counts, new
    cache or None). A new cache has ``pos`` advanced (by ``q_len`` on the
    paged path, to ``S`` after prefill) and, paged, the step's ``bad``
    plane. ``fault`` strikes every layer's attention (a superset of the
    single-layer SEU)."""
    _check_family(cfg)
    paged = isinstance(cache, PagedKVCache)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if (cache is None) != (mode == "train") or (
            paged and mode != "decode") or (
            cache is not None and not paged and not isinstance(cache,
                                                              KVCache)):
        raise ValueError(f"mode {mode!r} does not go with cache "
                         f"{type(cache).__name__}")
    b, s = tokens.shape
    dev = tokens.device
    causal = cfg.family != "encoder"
    x = embed_apply(params["embed"], tokens)
    steps = torch.arange(s, device=dev)
    if mode == "decode":
        # ring and paged caches both carry one position per row
        positions = cache.pos.long()[:, None] + steps
    else:
        positions = steps[None, :].expand(b, s)
    if "pos" in params:
        table = params["pos"]["pos"]
        x = x + table[positions.clamp(max=table.shape[0] - 1)].to(x.dtype)
    flags = layer_flags(cfg)
    rep = FTReport.zero(b, device=dev)
    memory = None
    if cfg.family in ENC_DEC and mode != "decode":
        memory, rep = _encode(params, cfg, frontend=frontend,
                              enc_tokens=enc_tokens, dtype=x.dtype)
    bad = torch.zeros_like(cache.bad) if paged else None
    cross_kv = []
    for i in range(cfg.num_layers):
        x, rep_i, bad_i, kv = _block_apply(
            _index(params["blocks"], i), x, cfg=cfg,
            is_global=bool(flags["is_global"][i]),
            theta=float(flags["theta"][i]),
            cache=None if cache is None else cache.layer(i), mode=mode,
            positions=positions, fault=fault, causal=causal, memory=memory)
        rep = rep.merge(rep_i)
        if paged:
            bad = torch.maximum(bad, bad_i)
        if kv is not None:
            cross_kv.append(kv)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    table = params.get("lm_head", params["embed"])["table"]
    logits = unembed(x, table)
    if cache is None:
        new_cache = None
    elif paged:
        new_cache = dataclasses.replace(
            cache, pos=cache.pos + cache.q_len,
            bad=torch.maximum(cache.bad, bad))
    else:
        cross = {}
        if mode == "prefill" and cross_kv:
            cross = dict(ck=torch.stack([k for k, _ in cross_kv]),
                         cv=torch.stack([v for _, v in cross_kv]))
        new_cache = dataclasses.replace(
            cache, pos=(positions[:, -1] + 1).to(torch.int32), **cross)
    return logits, rep, new_cache
