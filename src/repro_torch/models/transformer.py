"""Model assembly: parameters, per-layer flags and the forward pass, as a
Python loop over layers: the full-sequence forward (``mode="train"``:
logits and, under autograd, the training loss's gradients), ring-cache
prefill and decode, and the unified serving step over a paged cache.

Families ported: ``dense`` (decoder only), ``encoder`` (BERT: the same
blocks, non-causal), the encoder-decoder ``encdec`` (T5: a token encoder)
and ``audio`` (Whisper: precomputed frontend frames), whose decoder blocks
cross-attend to the encoder's memory, ``moe`` (the MLP replaced by a routed
mixture of experts, plus kimi's shared expert or arctic's dense residual
MLP), ``ssm`` (RWKV6: time mix and channel mix, no attention), ``hybrid``
(Hymba: attention and mamba heads in parallel on the same input, averaged)
and ``vlm`` (Llama 3.2 Vision: superblocks of ``cross_attn_every - 1``
dense blocks and one block that also cross-attends to the frontend's
precomputed patch embeddings).

Parameters keep the JAX package's pytree layout — ``blocks`` (and
``encoder``) hold every layer's tensors stacked on a leading layer axis,
the VLM's ``blocks`` a ``dense`` stack (n_super, cross_attn_every - 1, ...)
and a ``cross_blk`` stack (n_super, ...) — so weights convert across
unchanged (``repro_torch.models.convert``). They are drawn layer by layer
straight into the stacked tensors.

Under autograd (``mode="train"`` with gradients on) each block, and each
VLM superblock, is rematerialised as ``cfg.remat`` says, as the JAX
package's ``_maybe_remat`` does: ``"full"`` recomputes it in the backward
pass, ``"dots"`` keeps the outputs of its projection products (2-D weight
matmuls) and recomputes the rest, ``"none"`` keeps everything.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
from repro_torch.utils.tree import tree_leaves, tree_map


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


FAMILIES = ("dense", "encoder", "encdec", "audio", "moe", "ssm", "hybrid",
            "vlm")
ENC_DEC = ("encdec", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or (cfg.attn is None) != (
            cfg.family == "ssm"):
        raise NotImplementedError(
            f"repro_torch ports the {'/'.join(FAMILIES)} families; "
            f"{cfg.name} is {cfg.family!r}")
    if cfg.family == "vlm" and (cfg.cross_attn_every < 1 or
                                cfg.num_layers % cfg.cross_attn_every):
        raise NotImplementedError(
            f"{cfg.name}: the vlm superblocks need cross_attn_every >= 1 "
            f"dividing num_layers ({cfg.cross_attn_every}, "
            f"{cfg.num_layers})")


def n_super(cfg: ModelConfig) -> int:
    """The VLM's superblocks: ``cross_attn_every - 1`` dense blocks and one
    cross block each."""
    return cfg.num_layers // cfg.cross_attn_every


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


@dataclasses.dataclass
class VLMCache:
    """The ``vlm`` family's serving state, in the JAX package's layout:
    ``dense`` the ring :class:`KVCache` of the dense blocks, k/v (n_super,
    cross_attn_every - 1, B, Hkv, T, hd); ``cross_blk`` that of the cross
    blocks, k/v (n_super, B, Hkv, T, hd), with the cross memory ``ck``/
    ``cv`` (n_super, B, Hkv, M, hd) that prefill projects from the
    frontend and decode reads. Both carry the same ``pos``."""

    dense: KVCache
    cross_blk: KVCache

    @property
    def pos(self) -> torch.Tensor:
        return self.cross_blk.pos


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
    placed on ``device``; on the meta device, their shapes and dtypes
    only (nothing is drawn)."""
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    gd = device if torch.device(device).type == "meta" else gen.device
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
    if cfg.family == "vlm":
        ns, ce = n_super(cfg), cfg.cross_attn_every
        dense = _stacked_init(gen, cfg, gd, ns * (ce - 1))
        params["blocks"] = {
            "dense": tree_map(lambda t: t.view((ns, ce - 1) + t.shape[1:]),
                              dense),
            "cross_blk": _stacked_init(gen, cfg, gd, ns, cross=True)}
    else:
        params["blocks"] = _stacked_init(gen, cfg, gd, cfg.num_layers,
                                         cross=enc_dec)
    return _to(params, device)


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


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
                 independent_rows: bool = False, mesh=None) -> BlockOut:
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
    moe`); ``mesh`` takes the MoE to its paths on a mesh."""
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
                           independent_rows=independent_rows, mesh=mesh,
                           mode=mode)
        for name in ("shared", "dense_res"):
            if name in params:
                y = y + mlp_apply(params[name], h2, act=cfg.act, glu=cfg.glu,
                                  ff_abft=ff)
    else:
        y = mlp_apply(params["mlp"], h2, act=cfg.act, glu=cfg.glu,
                      ff_abft=ff)
    return BlockOut(x + y, rep, bad, kv, aux, new_state)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the 2-D weight products (the
    JAX package's ``checkpoint_dots_with_no_batch_dims``: the projections
    and MLPs; the attention's batched products are recomputed)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_call(remat: str, mode: str, fn, /, *args, **kw):
    """``fn(*args, **kw)``, rematerialised as ``remat`` (``cfg.remat``)
    says when it runs under autograd (``mode="train"``, gradients on, a
    tensor of ``args`` requiring them); as it is otherwise."""
    if remat == "none" or mode != "train" or not torch.is_grad_enabled() \
            or not any(t.requires_grad for t in tree_leaves(args)):
        return fn(*args, **kw)
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, **extra, **kw)


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
        out = _remat_call(
            cfg.remat, "train", _block_apply, _index(params["encoder"], i),
            enc_x, cfg=cfg, is_global=True, theta=cfg.attn.rope_theta,
            cache=None, mode="train", positions=enc_pos, fault=None,
            causal=False)
        enc_x = out.x
        rep = rep.merge(out.rep)
    return norm_apply(cfg.norm, params["enc_norm"], enc_x), rep


def _check_cache(cfg: ModelConfig, cache, mode: str) -> None:
    ring = {"ssm": ssm_lib.RWKVState, "hybrid": HybridCache,
            "vlm": VLMCache}.get(cfg.family, KVCache)
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


def _vlm_superblock(sp, x, *, cfg: ModelConfig, cache, mode, positions,
                    fault, memory):
    """One VLM superblock: ``cross_attn_every - 1`` dense blocks, which the
    SEU ``fault`` strikes, then the cross block (self-attention,
    cross-attention to ``memory`` or, in decode, to the cache's ``ck``/
    ``cv``, then the MLP), which it does not, as in the JAX package. Every
    layer is global at the config's rope theta. ``cache``: the superblock's
    (dense KVCache (ce-1, ...), cross KVCache) or None. Returns (x,
    FTReport, the cross K/V to keep, or None)."""
    theta = cfg.attn.rope_theta
    rep = FTReport.zero(x.shape[0], device=x.device)
    for i in range(cfg.cross_attn_every - 1):
        out = _block_apply(
            _index(sp["dense"], i), x, cfg=cfg, is_global=True, theta=theta,
            cache=None if cache is None else cache[0].layer(i), mode=mode,
            positions=positions, fault=fault)
        x = out.x
        rep = rep.merge(out.rep)
    out = _block_apply(
        sp["cross_blk"], x, cfg=cfg, is_global=True, theta=theta,
        cache=None if cache is None else cache[1], mode=mode,
        positions=positions, fault=None, memory=memory)
    return out.x, rep.merge(out.rep), out.cross_kv


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, cache=None,
            mode: str = "train", fault=None, frontend=None, enc_tokens=None,
            independent_rows: bool = False, return_aux: bool = False,
            mesh=None):
    """The model forward. ``tokens`` (B, S) are the decoder's (or, for the
    ``encoder`` family, the encoder's) tokens; ``frontend`` (B, M,
    d_model) frames (``audio``), patch embeddings (``vlm``) or
    ``enc_tokens`` (B, M) (``encdec``) feed the encoder of the
    encoder-decoder families, or the VLM's cross-attention, in ``mode``
    "train" and "prefill" — the keys of the JAX package's ``batch`` dict.
    Decode reads the cross memory from the cache instead.

    * ``mode="train"``, no cache: the full sequence, causally except in
      the ``encoder`` family; differentiable, rematerialised as
      ``cfg.remat`` says when gradients are on.
    * ``mode="prefill"``, a fresh cache: the prompt at positions
      ``0..S-1``, filling every layer's ring (and SSM state).
    * ``mode="decode"``: row ``c`` of request ``b`` at position
      ``cache.pos[b] + c``, over a :class:`KVCache` ring (per-slot decode)
      or a :class:`PagedKVCache` (the unified serving step; pools updated
      in place, ``fault`` the paged kernel's int32[8] descriptor).

    The cache is a :class:`KVCache` (or :class:`PagedKVCache`); for the
    ``ssm`` family a stacked :class:`~repro_torch.models.ssm.RWKVState`,
    for ``hybrid`` a :class:`HybridCache`, for ``vlm`` a
    :class:`VLMCache`. ``independent_rows`` routes the MoE of each row on
    its own, as a batch-1 call per row would.

    On a ``mesh`` (:class:`~repro_torch.distributed.mesh.Mesh`) the
    tensors are the calling rank's block of the batch over the
    data-parallel axes and the parameters are whole, but for the MoE
    experts, which hold the rank's block of
    :func:`~repro_torch.models.moe.expert_spec`; only the MoE layer talks
    to other ranks. The JAX package's activation placements under a mesh
    (``shard_act``, ``seq_parallel``, the logits spec) change no value:
    they are this batch split and the gathered weights.

    Returns (logits f32 (B, S, V), FTReport with (B, 5) per-row counts, new
    cache or None); with ``return_aux`` (logits, FTReport, the MoE aux loss
    summed over layers (f32 scalar, 0 outside ``moe``), new cache), the
    JAX package's order. A new cache has ``pos`` advanced (by ``q_len`` on
    the paged path, to ``S`` after prefill) and, paged, the step's ``bad``
    plane; SSM states are new tensors. ``fault`` strikes every layer's
    self-attention (a superset of the single-layer SEU), the VLM's cross
    blocks excepted."""
    _check_family(cfg)
    _check_cache(cfg, cache, mode)
    paged = isinstance(cache, PagedKVCache)
    fam = cfg.family
    b, s = tokens.shape
    dev = tokens.device
    causal = fam != "encoder"
    # shard_act(x, mesh) in the JAX package: a placement (the batch split)
    x = embed_apply(params["embed"], tokens)
    steps = torch.arange(s, device=dev)
    if mode == "decode" and fam != "ssm":
        # ring and paged caches both carry one position per row
        positions = cache.pos.long()[:, None] + steps
    else:
        positions = steps[None, :].expand(b, s)
    if "pos" in params:
        table = params["pos"]["pos"]
        x = x + embed_apply({"table": table},
                            positions.clamp(max=table.shape[0] - 1)
                            ).to(x.dtype)
    flags = layer_flags(cfg)
    rep = FTReport.zero(b, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    memory = None
    if fam in ENC_DEC and mode != "decode":
        memory, rep = _encode(params, cfg, frontend=frontend,
                              enc_tokens=enc_tokens, dtype=x.dtype)
    if fam == "vlm" and mode != "decode":
        if frontend is None:
            raise ValueError(f"{cfg.name}: the vlm family's {mode} needs "
                             f"the frontend's patch embeddings")
        memory = frontend.to(x.dtype)
    bad = torch.zeros_like(cache.bad) if paged else None
    cross_kv, states = [], []
    if fam == "vlm":
        for i in range(n_super(cfg)):
            sc = None if cache is None else (cache.dense.layer(i),
                                             cache.cross_blk.layer(i))
            x, rep_i, kv = _remat_call(
                cfg.remat, mode, _vlm_superblock,
                _index(params["blocks"], i), x, cfg=cfg, cache=sc,
                mode=mode, positions=positions, fault=fault, memory=memory)
            rep = rep.merge(rep_i)
            cross_kv.append(kv)
    else:
        # each block's shard_act / seq_parallel spec: placements
        for i in range(cfg.num_layers):
            layer_cache, state = _layer_cache(cache, i)
            out = _remat_call(
                cfg.remat, mode, _block_apply, _index(params["blocks"], i), x,
                cfg=cfg, is_global=bool(flags["is_global"][i]),
                theta=float(flags["theta"][i]), cache=layer_cache,
                mode=mode, positions=positions, fault=fault, causal=causal,
                memory=memory, state=state,
                independent_rows=independent_rows, mesh=mesh)
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
    logits = unembed(x, table)      # the logits spec: a placement
    new_pos = (positions[:, -1] + 1).to(torch.int32)
    cross = {}
    if mode == "prefill" and cross_kv:
        cross = dict(ck=torch.stack([k for k, _ in cross_kv]),
                     cv=torch.stack([v for _, v in cross_kv]))
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
    elif fam == "vlm":
        new_cache = VLMCache(
            dense=dataclasses.replace(cache.dense, pos=new_pos),
            cross_blk=dataclasses.replace(cache.cross_blk, pos=new_pos,
                                          **cross))
    else:
        new_cache = dataclasses.replace(cache, pos=new_pos, **cross)
    if return_aux:
        return logits, rep, aux, new_cache
    return logits, rep, new_cache
