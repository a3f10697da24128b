"""Mixture-of-Experts FFN on one device.

Routing as the JAX package's single-device path: a softmax router in f32,
top-k renormalised, the Switch load-balancing aux loss, and capacity
dispatch through one stable sort: assignments are grouped by expert, ranked
by position within their expert, and scattered into a static (E, capacity,
d) buffer; assignments ranked past the capacity are dropped. Every expert
runs over its whole capacity buffer, as in the JAX package (an expert that
received nothing contributes exact zeros); the expert products are batched
matrix products over the expert axis.

The capacity counts the tokens of one model call, padding rows included:
``max(4, ceil(N * top_k / E * capacity_factor))``. Where the JAX package
vmaps a batch-1 model call over serve slots (its ring engine's decode, the
gather backend's decode and scoring), each slot is such a call: with
``independent_rows`` every row of ``x`` is routed as its own group, with
its own capacity, and the groups share one pass over the expert weights.

The combine sums each token's k contributions in a fixed order (by expert
id, as the JAX package's scatter-add visits them), with no atomic adds, so
a step that is retried reproduces its values bit for bit.

The expert-parallel paths of the JAX package (``shard_map`` over a mesh)
are not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.models.layers import ACTS, dense_init, normal_init


def moe_init(gen: torch.Generator, d: int, m: MoECfg, dtype, device,
             out=None):
    """``router`` (d, E) in f32 whatever ``dtype`` (the JAX package keeps
    it so), ``wg``/``wu`` (E, d, f) and ``wd`` (E, f, d) in ``dtype``, each
    expert drawn on its own; into the tensors of ``out`` where given."""
    out = out or {}
    e, f = m.num_experts, m.expert_d_ff
    return {
        "router": dense_init(gen, d, e, torch.float32, device,
                             scale=1.0 / math.sqrt(d), out=out.get("router")),
        "wg": normal_init(gen, (e, d, f), dtype, device, 1.0 / math.sqrt(d),
                          out.get("wg")),
        "wu": normal_init(gen, (e, d, f), dtype, device, 1.0 / math.sqrt(d),
                          out.get("wu")),
        "wd": normal_init(gen, (e, f, d), dtype, device, 1.0 / math.sqrt(f),
                          out.get("wd")),
    }


def capacity(n_tokens: int, m: MoECfg) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    return max(4, math.ceil(n_tokens * m.top_k / m.num_experts
                            * m.capacity_factor))


def route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router probabilities (N, E) f32, and the top-k experts (N, k) of each
    token with their renormalised weights. Ties go to the lower expert id,
    as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    logits = torch.matmul(x2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return probs, vals / vals.sum(dim=-1, keepdim=True), idx


def _moe_groups(x3: torch.Tensor, params, *, top_k: int, cap: int,
                act: str):
    """Route + dispatch + compute + combine for G independent groups of n
    tokens each, ``x3`` (G, n, d). Returns (y (G, n, d), aux per group
    (G,) f32)."""
    g, n, d = x3.shape
    dtype, dev = x3.dtype, x3.device
    e = params["router"].shape[-1]
    a = ACTS[act]
    x2 = x3.reshape(g * n, d)
    probs, w, idx = route(x2, params["router"], top_k)

    # Switch aux loss per group: E * sum_e f_e * p_e
    top1 = torch.nn.functional.one_hot(idx[:, 0], e).float()
    f_e = top1.view(g, n, e).mean(dim=1)
    p_e = probs.view(g, n, e).mean(dim=1)
    aux = e * (f_e * p_e).sum(dim=-1)

    # assignment a = token * k + j; group by (group, expert), stably
    nk = n * top_k
    key = (torch.arange(g, device=dev)[:, None] * e
           + idx.reshape(g, nk)).reshape(-1)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    starts = torch.searchsorted(key_s, torch.arange(g * e + 1, device=dev))
    rank = torch.arange(g * nk, device=dev) - starts[key_s]
    keep = rank < cap
    e_s, g_s = key_s % e, key_s // e
    dump = e * g * cap
    slot = torch.where(keep, (e_s * g + g_s) * cap + rank, dump)
    tid = order // top_k

    buf = torch.zeros((dump + 1, d), dtype=dtype, device=dev)
    buf[slot] = x2[tid]                        # dropped ones land on `dump`
    h = buf[:dump].view(e, g * cap, d)
    hidden = a(torch.bmm(h, params["wg"].to(dtype)))
    hidden = hidden * torch.bmm(h, params["wu"].to(dtype))
    y_buf = torch.bmm(hidden, params["wd"].to(dtype)).reshape(dump, d)
    y_buf = torch.cat([y_buf, torch.zeros((1, d), dtype=dtype, device=dev)])
    w_s = torch.where(keep, w.reshape(-1)[order], 0.0).to(dtype)
    contrib = y_buf[slot] * w_s[:, None]

    # back to assignment order; each token's k contributions summed in
    # ascending expert id
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    per_tok = per_tok.view(g * n, top_k, d)
    by_eid = idx.argsort(dim=-1)
    per_tok = per_tok.gather(1, by_eid[:, :, None].expand(-1, -1, d))
    y = per_tok[:, 0]
    for j in range(1, top_k):
        y = y + per_tok[:, j]
    return y.view(g, n, d), aux


def moe_apply(params, x: torch.Tensor, m: MoECfg, *, act: str = "silu",
              independent_rows: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux loss f32 scalar). One routing group
    of B * S tokens, or with ``independent_rows`` B groups of S tokens (the
    aux loss is then the mean of the groups')."""
    b, s, d = x.shape
    groups, n = (b, s) if independent_rows else (1, b * s)
    y, aux = _moe_groups(x.reshape(groups, n, d), params, top_k=m.top_k,
                         cap=capacity(n, m), act=act)
    return y.reshape(b, s, d), aux.mean()
