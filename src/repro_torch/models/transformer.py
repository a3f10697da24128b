"""Model assembly: parameters, per-layer flags and the forward pass, as a
Python loop over layers: the full-sequence forward (``mode="train"``,
logits only, no gradient), ring-cache prefill and decode, and the unified
serving step over a paged cache.

Families ported: ``dense`` (decoder only), ``encoder`` (BERT: the same
blocks, non-causal), the encoder-decoder ``encdec`` (T5: a token encoder)
and ``audio`` (Whisper: precomputed frontend frames), whose decoder blocks
cross-attend to the encoder's memory, ``moe`` (the MLP replaced by a routed
mixture of experts, plus kimi's shared expert or arctic's dense residual
MLP), ``ssm`` (RWKV6: time mix and channel mix, no attention) and
``hybrid`` (Hymba: attention and mamba heads in parallel on the same
input, averaged). ``vlm`` is not ported yet.

Parameters keep the JAX package's pytree layout — ``blocks`` (and
``encoder``) hold every layer's tensors stacked on a leading layer axis —
so weights convert across unchanged (``repro_torch.models.convert``). They
are drawn layer by layer straight into the stacked tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.efta import FTReport
from repro_torch.kernels.efta_paged import NO_WINDOW
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (KVCache, PagedKVCache, attn_apply,
                                          attn_init, cross_attn_apply)
from repro_torch.models.layers import (embed_apply, embed_init,
                                       learned_pos_init, mlp_apply, mlp_init,
                                       norm_apply, norm_init, unembed)
from repro_torch.models.moe import moe_apply, moe_init


def layer_flags(cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Static per-layer arrays: is_global (full attention) and rope theta."""
    n = cfg.num_layers
    a = cfg.attn
    is_global = np.ones((n,), np.bool_)
    theta = np.full((n,), a.rope_theta if a else 1e4, np.float32)
    if a is not None and a.sliding_window is not None:
        if a.global_every:
            is_global = (np.arange(n) % a.global_every) == (a.global_every - 1)
        elif cfg.family == "hybrid":
            # hymba: full attention at the first, middle and last layers
            is_global = np.zeros((n,), np.bool_)
            for i in (0, n // 2, n - 1):
                is_global[i] = True
        else:
            is_global = np.zeros((n,), np.bool_)
        theta = np.where(is_global, 1e6 if a.global_every else a.rope_theta,
                         a.rope_theta).astype(np.float32)
    return {"is_global": is_global, "theta": theta}


FAMILIES = ("dense", "encoder", "encdec", "audio", "moe", "ssm", "hybrid")
ENC_DEC = ("encdec", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or (cfg.attn is None) != (
            cfg.family == "ssm"):
        raise NotImplementedError(
            f"repro_torch ports the {'/'.join(FAMILIES)} families so far "
            f"(vlm is not ported); {cfg.name} is {cfg.family!r}")


@dataclasses.dataclass
class HybridCache:
    """The ``hybrid`` family's serving state: the attention heads' ring
    :class:`KVCache` and the mamba heads' :class:`~repro_torch.models.ssm.
    MambaState`, both stacked over layers (the JAX package's ``{"attn",
    "mamba"}`` cache)."""

    attn: KVCache
    mamba: ssm_lib.MambaState

    @property
    def pos(self) -> torch.Tensor:
        return self.attn.pos


def _block_init(gen: torch.Generator, cfg: ModelConfig, device, *,
                out=None, cross: bool = False):
    """One block's parameters, drawn into the tensors of ``out`` where given
    (one layer's slices of the stacked tree); ``cross`` adds the decoder's
    cross-attention (``norm_x``, ``cross``) of the encoder-decoder
    families."""
    kind = cfg.family
    o = out or {}
    d, dtype = cfg.d_model, getattr(torch, cfg.dtype)

    def norm(name):
        return norm_init(cfg.norm, d, dtype, device, out=o.get(name))

    p = {"norm1": norm("norm1")}
    if kind == "ssm":  # rwkv6: time mix (with the channel mix's weights)
        p["time_mix"] = ssm_lib.rwkv6_init(gen, d, cfg.ssm, dtype, device,
                                           out=o.get("time_mix"))
        p["norm2"] = norm("norm2")
        return p
    p["attn"] = attn_init(gen, d, cfg.attn, dtype, device, out=o.get("attn"))
    if kind == "hybrid":
        p["mamba"] = ssm_lib.mamba_init(gen, d, cfg.ssm, dtype, device,
                                        out=o.get("mamba"))
    if cross:
        p["norm_x"] = norm("norm_x")
        p["cross"] = attn_init(gen, d, cfg.attn, dtype, device,
                               out=o.get("cross"))
    p["norm2"] = norm("norm2")
    if kind == "moe":
        m = cfg.moe
        p["moe"] = moe_init(gen, d, m, dtype, device, out=o.get("moe"))
        if m.num_shared_experts:
            p["shared"] = mlp_init(gen, d, m.shared_d_ff, dtype, device,
                                   glu=cfg.glu, out=o.get("shared"))
        if m.dense_d_ff:
            p["dense_res"] = mlp_init(gen, d, m.dense_d_ff, dtype, device,
                                      glu=cfg.glu, out=o.get("dense_res"))
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, device, glu=cfg.glu,
                            out=o.get("mlp"))
    return p


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stacked_init(gen: torch.Generator, cfg: ModelConfig, device, n: int,
                  **kw):
    """``n`` blocks stacked on a leading layer axis: the tensors allocated
    first (their shapes from a pass on the meta device, which draws
    nothing), then drawn layer by layer in place, each layer's in the order
    one block draws them. Nothing but the stacked tree and one slice of f32
    scratch is ever held."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=device)

    stacked = alloc(_block_init(gen, cfg, "meta", **kw))
    for i in range(n):
        _block_init(gen, cfg, device, out=_index(stacked, i), **kw)
    return stacked


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
    if cfg.attn is not None and cfg.attn.pos == "learned":
        params["pos"] = learned_pos_init(gen, max(cfg.max_seq, 64),
                                         cfg.d_model, dtype, gd)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, gd)
    enc_dec = cfg.family in ENC_DEC
    if enc_dec:
        params["encoder"] = _stacked_init(gen, cfg, gd, cfg.encoder_layers)
        params["enc_norm"] = norm_init(cfg.norm, cfg.d_model, dtype, gd)
    params["blocks"] = _stacked_init(gen, cfg, gd, cfg.num_layers,
                                     cross=enc_dec)
    return _to(params, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


class BlockOut(NamedTuple):
    x: torch.Tensor
    rep: FTReport
    bad: Optional[torch.Tensor]       # the paged step's bad plane
    cross_kv: Optional[tuple]         # the cross K/V to keep in the cache
    aux: torch.Tensor                 # the MoE aux loss (0 elsewhere)
    state: Any                        # the block's new SSM state, or None


def _block_apply(params, x, *, cfg: ModelConfig, is_global: bool,
                 theta: float, cache, mode: str, positions, fault,
                 causal: bool = True, memory=None, state=None,
                 independent_rows: bool = False) -> BlockOut:
    """One pre-norm block of the config's family.

    ``ssm``: the rwkv6 time mix then channel mix, from ``state`` (a fresh
    one without). Otherwise self-attention (``causal`` or not), in the
    ``hybrid`` family averaged with the mamba heads on the same input (from
    ``state``); then, in a decoder block of the encoder-decoder families,
    cross-attention to ``memory`` (or to the cache's ``ck``/``cv`` in
    decode); then the MLP, or in the ``moe`` family the routed experts plus
    the shared expert or dense residual MLP (``ff_abft`` covers those two
    and not the experts, as in the JAX package). ``independent_rows``
    routes each row of ``x`` on its own (see :mod:`~repro_torch.models.
    moe`)."""
    kind = cfg.family
    b = x.shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        st = state if state is not None else ssm_lib.rwkv_state_init(
            b, cfg.d_model, cfg.ssm, x.dtype, x.device)
        h, st = ssm_lib.rwkv6_time_mix(
            params["time_mix"], norm_apply(cfg.norm, params["norm1"], x),
            cfg.ssm, state=st)
        x = x + h
        h, st = ssm_lib.rwkv6_channel_mix(
            params["time_mix"], norm_apply(cfg.norm, params["norm2"], x),
            state=st)
        return BlockOut(x + h, FTReport.zero(b, device=x.device), None, None,
                        aux, st)
    a = dataclasses.replace(cfg.attn, causal=causal)
    window = None
    if a.sliding_window is not None:
        window = NO_WINDOW if is_global else a.sliding_window
    h_in = norm_apply(cfg.norm, params["norm1"], x)
    h, rep, bad = attn_apply(
        params["attn"], h_in, acfg=dataclasses.replace(a, rope_theta=theta),
        ft=cfg.ft, window=window, positions=positions, cache=cache,
        mode=mode, fault=fault)
    new_state = None
    if kind == "hybrid":
        hm, new_state = ssm_lib.mamba_apply(params["mamba"], h_in, cfg.ssm,
                                            state=state)
        h = 0.5 * (h + hm)
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
    ff = cfg.ft.ff_abft
    if kind == "moe":
        y, aux = moe_apply(params["moe"], h2, cfg.moe, act=cfg.act,
                           independent_rows=independent_rows)
        for name in ("shared", "dense_res"):
            if name in params:
                y = y + mlp_apply(params[name], h2, act=cfg.act, glu=cfg.glu,
                                  ff_abft=ff)
    else:
        y = mlp_apply(params["mlp"], h2, act=cfg.act, glu=cfg.glu,
                      ff_abft=ff)
    return BlockOut(x + y, rep, bad, kv, aux, new_state)


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
        out = _block_apply(
            _index(params["encoder"], i), enc_x, cfg=cfg, is_global=True,
            theta=cfg.attn.rope_theta, cache=None, mode="train",
            positions=enc_pos, fault=None, causal=False)
        enc_x = out.x
        rep = rep.merge(out.rep)
    return norm_apply(cfg.norm, params["enc_norm"], enc_x), rep


def _check_cache(cfg: ModelConfig, cache, mode: str) -> None:
    ring = {"ssm": ssm_lib.RWKVState, "hybrid": HybridCache}.get(
        cfg.family, KVCache)
    paged = isinstance(cache, PagedKVCache)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if (cache is None) != (mode == "train") or (
            paged and (mode != "decode" or ring is not KVCache)) or (
            cache is not None and not paged and not isinstance(cache, ring)):
        raise ValueError(f"mode {mode!r} does not go with cache "
                         f"{type(cache).__name__} ({cfg.family!r} family)")


def _layer_cache(cache, i: int):
    """Layer ``i``'s (attention cache, SSM state) of a stacked cache."""
    if cache is None:
        return None, None
    if isinstance(cache, ssm_lib.RWKVState):
        return None, ssm_lib.state_layer(cache, i)
    if isinstance(cache, HybridCache):
        return cache.attn.layer(i), ssm_lib.state_layer(cache.mamba, i)
    return cache.layer(i), None


@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            mode: str = "train", fault=None, frontend=None, enc_tokens=None,
            independent_rows: bool = False, return_aux: bool = False):
    """The model forward. ``tokens`` (B, S) are the decoder's (or, for the
    ``encoder`` family, the encoder's) tokens; ``frontend`` (B, M,
    d_model) frames (``audio``) or ``enc_tokens`` (B, M) (``encdec``) feed
    the encoder of the encoder-decoder families in ``mode`` "train" and
    "prefill" — the keys of the JAX package's ``batch`` dict. Decode reads
    the cross memory from the cache instead.

    * ``mode="train"``, no cache: the full sequence (logits only; the port
      has no training step yet), causally except in the ``encoder``
      family.
    * ``mode="prefill"``, a fresh cache: the prompt at positions
      ``0..S-1``, filling every layer's ring (and SSM state).
    * ``mode="decode"``: row ``c`` of request ``b`` at position
      ``cache.pos[b] + c``, over a :class:`KVCache` ring (per-slot decode)
      or a :class:`PagedKVCache` (the unified serving step; pools updated
      in place, ``fault`` the paged kernel's int32[8] descriptor).

    The cache is a :class:`KVCache` (or :class:`PagedKVCache`); for the
    ``ssm`` family a stacked :class:`~repro_torch.models.ssm.RWKVState`,
    for ``hybrid`` a :class:`HybridCache`. ``independent_rows`` routes the
    MoE of each row on its own, as a batch-1 call per row would.

    Returns (logits f32 (B, S, V), FTReport with (B, 5) per-row counts, new
    cache or None); with ``return_aux`` (logits, FTReport, the MoE aux loss
    summed over layers (f32 scalar, 0 outside ``moe``), new cache), the
    JAX package's order. A new cache has ``pos`` advanced (by ``q_len`` on
    the paged path, to ``S`` after prefill) and, paged, the step's ``bad``
    plane; SSM states are new tensors. ``fault`` strikes every layer's
    attention (a superset of the single-layer SEU)."""
    _check_family(cfg)
    _check_cache(cfg, cache, mode)
    paged = isinstance(cache, PagedKVCache)
    fam = cfg.family
    b, s = tokens.shape
    dev = tokens.device
    causal = fam != "encoder"
    x = embed_apply(params["embed"], tokens)
    steps = torch.arange(s, device=dev)
    if mode == "decode" and fam != "ssm":
        # ring and paged caches both carry one position per row
        positions = cache.pos.long()[:, None] + steps
    else:
        positions = steps[None, :].expand(b, s)
    if "pos" in params:
        table = params["pos"]["pos"]
        x = x + table[positions.clamp(max=table.shape[0] - 1)].to(x.dtype)
    flags = layer_flags(cfg)
    rep = FTReport.zero(b, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    memory = None
    if fam in ENC_DEC and mode != "decode":
        memory, rep = _encode(params, cfg, frontend=frontend,
                              enc_tokens=enc_tokens, dtype=x.dtype)
    bad = torch.zeros_like(cache.bad) if paged else None
    cross_kv, states = [], []
    for i in range(cfg.num_layers):
        layer_cache, state = _layer_cache(cache, i)
        out = _block_apply(
            _index(params["blocks"], i), x, cfg=cfg,
            is_global=bool(flags["is_global"][i]),
            theta=float(flags["theta"][i]), cache=layer_cache, mode=mode,
            positions=positions, fault=fault, causal=causal, memory=memory,
            state=state, independent_rows=independent_rows)
        x = out.x
        rep = rep.merge(out.rep)
        aux = aux + out.aux
        if paged:
            bad = torch.maximum(bad, out.bad)
        if out.cross_kv is not None:
            cross_kv.append(out.cross_kv)
        states.append(out.state)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    table = params.get("lm_head", params["embed"])["table"]
    logits = unembed(x, table)
    new_pos = (positions[:, -1] + 1).to(torch.int32)
    if cache is None:
        new_cache = None
    elif paged:
        new_cache = dataclasses.replace(
            cache, pos=cache.pos + cache.q_len,
            bad=torch.maximum(cache.bad, bad))
    elif fam == "ssm":
        new_cache = ssm_lib.stack_states(states)
    elif fam == "hybrid":
        new_cache = HybridCache(
            attn=dataclasses.replace(cache.attn, pos=new_pos),
            mamba=ssm_lib.stack_states(states))
    else:
        cross = {}
        if mode == "prefill" and cross_kv:
            cross = dict(ck=torch.stack([k for k, _ in cross_kv]),
                         cv=torch.stack([v for _, v in cross_kv]))
        new_cache = dataclasses.replace(cache, pos=new_pos, **cross)
    if return_aux:
        return logits, rep, aux, new_cache
    return logits, rep, new_cache
