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

On a mesh (:class:`~repro_torch.distributed.mesh.Mesh`), ``x`` holds the
calling rank's block of the batch over the data-parallel axes, and the
expert weights the rank's block of the spec that :func:`expert_spec`
gives; the reference's ``shard_map`` paths become collectives:

* expert parallelism (``_moe_apply_ep``, training and prefill): each
  ``model`` rank holds ``E / msize`` experts (gathered over ``data`` when
  FSDP stores them split), routes its own tokens, computes its experts'
  share and one all-reduce over ``model`` sums the shares; the capacity
  counts the rank's tokens, and the aux loss is averaged over the
  data-parallel axes, as in the reference (so the drops differ from one
  device wherever the capacity binds);
* decode with ``inference_ep`` (``_moe_inference_ep``): experts split over
  ``data`` and the FF dimension over ``model``, the tokens gathered from
  every data-parallel rank, one all-reduce over (data, model);
* a mesh without an expert-parallel axis: the tokens are gathered over the
  data-parallel axes and routed as one group, as GSPMD computes the
  single-device path on the global batch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoECfg
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import gather_for_compute
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


def count_dropped(x2d: torch.Tensor, router: torch.Tensor, m: MoECfg,
                  cap: int) -> int:
    """Assignments of the tokens ``x2d`` (N, d), routed as one group, that
    rank past ``cap`` within their expert."""
    _, _, idx = route(x2d, router, m.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
    return int((counts - cap).clamp(min=0).sum())


def _moe_groups(x3: torch.Tensor, params, *, top_k: int, cap: int,
                act: str, e_start: int = 0, enter=None):
    """Route + dispatch + compute + combine for G independent groups of n
    tokens each, ``x3`` (G, n, d), through the experts ``[e_start, e_start
    + E_local)`` that ``params["wg"]`` holds (all of them by default); the
    other experts' assignments contribute nothing. ``enter``, where given,
    is applied to the tokens and the routing weights after the router and
    the aux loss (the start of a per-rank partial computation). Returns (y
    (G, n, d), aux per group (G,) f32)."""
    g, n, d = x3.shape
    dtype, dev = x3.dtype, x3.device
    e = params["router"].shape[-1]
    e_count = params["wg"].shape[0]
    a = ACTS[act]
    x2 = x3.reshape(g * n, d)
    probs, w, idx = route(x2, params["router"], top_k)

    # Switch aux loss per group: E * sum_e f_e * p_e
    top1 = torch.nn.functional.one_hot(idx[:, 0], e).float()
    f_e = top1.view(g, n, e).mean(dim=1)
    p_e = probs.view(g, n, e).mean(dim=1)
    aux = e * (f_e * p_e).sum(dim=-1)
    if enter is not None:
        x2, w = enter(x2), enter(w)

    # assignment a = token * k + j; group by (group, expert), stably
    nk = n * top_k
    key = (torch.arange(g, device=dev)[:, None] * e
           + idx.reshape(g, nk)).reshape(-1)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    starts = torch.searchsorted(key_s, torch.arange(g * e + 1, device=dev))
    rank = torch.arange(g * nk, device=dev) - starts[key_s]
    e_s, g_s = key_s % e - e_start, key_s // e
    keep = (rank < cap) & (e_s >= 0) & (e_s < e_count)
    dump = e_count * g * cap
    slot = torch.where(keep, (e_s * g + g_s) * cap + rank, dump)
    tid = order // top_k

    buf = torch.zeros((dump + 1, d), dtype=dtype, device=dev)
    buf[slot] = x2[tid]                        # dropped ones land on `dump`
    h = buf[:dump].view(e_count, g * cap, d)
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


def _present(mesh, axes) -> tuple:
    return tuple(a for a in axes if a in mesh.shape)


def expert_spec(mesh, m: MoECfg, *, mode: str = "train",
                ep_axis: str = "model") -> dict:
    """The spec of ``wg``, ``wu`` and ``wd`` whose blocks :func:`moe_apply`
    takes on ``mesh`` in ``mode`` (the reference's ``shard_map`` in_specs;
    whole without an expert-parallel axis)."""
    if _inference_ep(mesh, m, mode, ep_axis):
        return {"wg": ("data", None, "model"), "wu": ("data", None, "model"),
                "wd": ("data", "model", None)}
    if _ep(mesh, ep_axis):
        fsdp = "data" if mesh.shape.get("data", 1) > 1 else None
        return dict.fromkeys(("wg", "wu", "wd"), (ep_axis, fsdp, None))
    return dict.fromkeys(("wg", "wu", "wd"), (None, None, None))


def _ep(mesh, ep_axis) -> bool:
    return (mesh is not None and ep_axis in mesh.shape
            and mesh.shape[ep_axis] > 1)


def _inference_ep(mesh, m: MoECfg, mode: str, ep_axis: str) -> bool:
    return (_ep(mesh, ep_axis) and m.inference_ep and mode == "decode"
            and "data" in mesh.shape
            and m.num_experts % mesh.shape["data"] == 0)


def moe_apply(params, x: torch.Tensor, m: MoECfg, *, act: str = "silu",
              independent_rows: bool = False, mesh=None,
              ep_axis: str = "model", dp_axes: tuple = ("pod", "data"),
              mode: str = "train"):
    """x (B, S, d) -> (y (B, S, d), aux loss f32 scalar). One routing group
    of B * S tokens, or with ``independent_rows`` B groups of S tokens (the
    aux loss is then the mean of the groups'). On a ``mesh``, the paths of
    the module docstring (``mode`` selects the decode layout)."""
    b, s, d = x.shape
    if mesh is not None:
        if independent_rows:
            raise ValueError("independent_rows routes one device's serve "
                             "slots; it takes no mesh")
        if _inference_ep(mesh, m, mode, ep_axis):
            return _moe_inference_ep(params, x, m, mesh=mesh, act=act,
                                     dp_axes=dp_axes)
        if _ep(mesh, ep_axis):
            return _moe_apply_ep(params, x, m, mesh=mesh, act=act,
                                 ep_axis=ep_axis, dp_axes=dp_axes)
        dp = _present(mesh, dp_axes)
        if mesh.size(dp) > 1:
            return _moe_gathered(params, x, m, mesh=mesh, act=act, dp=dp)
    groups, n = (b, s) if independent_rows else (1, b * s)
    y, aux = _moe_groups(x.reshape(groups, n, d), params, top_k=m.top_k,
                         cap=capacity(n, m), act=act)
    return y.reshape(b, s, d), aux.mean()


def _moe_apply_ep(params, x, m: MoECfg, *, mesh, act, ep_axis, dp_axes):
    """Expert parallelism over ``ep_axis``: this rank's ``E / msize``
    experts on its own tokens (the capacity counts them), one all-reduce
    over ``ep_axis``, the aux loss averaged over the data-parallel axes."""
    b, s, d = x.shape
    e_count = m.num_experts // mesh.shape[ep_axis]
    w = {k: params[k] for k in ("wg", "wu", "wd")}
    if mesh.shape.get("data", 1) > 1:
        # ZeRO-3 just-in-time gather of this rank's expert shard along the
        # FSDP axis (weights stored ("model", "data", None))
        w = {k: gather_for_compute(v, 1, ("data",), mesh)
             for k, v in w.items()}
    grp = mesh.group(ep_axis)
    y, aux = _moe_groups(
        x.reshape(1, b * s, d), dict(w, router=params["router"]),
        top_k=m.top_k, cap=capacity(b * s, m), act=act,
        e_start=mesh.index(ep_axis) * e_count,
        enter=lambda t: coll.pcopy(t, grp))
    y = coll.psum(y, grp)
    aux = aux[0]
    dp = _present(mesh, dp_axes)
    if mesh.size(dp) > 1:
        aux = coll.pmean(aux, mesh.group(dp))
    return y.reshape(b, s, d), aux


def _moe_inference_ep(params, x, m: MoECfg, *, mesh, act,
                      dp_axes=("pod", "data")):
    """Decode MoE: experts split E over 'data' and ff over 'model'; the
    tokens of every data-parallel rank gathered (KBs, where the training
    layout would gather GBs of weights), the capacity counting them all;
    one all-reduce over (data, model) sums the expert shards and the ff
    partial products; this rank's rows of y returned."""
    b, s, d = x.shape
    dp = _present(mesh, dp_axes)
    x2 = x.reshape(b * s, d)
    if mesh.size(dp) > 1:
        x2 = gather_for_compute(x2, 0, dp, mesh)
    n = x2.shape[0]
    e_count = m.num_experts // mesh.shape["data"]
    y, aux = _moe_groups(
        x2[None], params, top_k=m.top_k, cap=capacity(n, m), act=act,
        e_start=mesh.index("data") * e_count)
    y = coll.psum(y[0], mesh.group(_present(mesh, ("data", "model"))))
    if mesh.size(dp) > 1:
        y = y.narrow(0, mesh.index(dp) * b * s, b * s)
    return y.reshape(b, s, d), aux[0]


def _moe_gathered(params, x, m: MoECfg, *, mesh, act, dp):
    """No expert-parallel axis: the tokens of the data-parallel ranks
    gathered and routed as one group (the capacity counting them all), as
    GSPMD runs the single-device path on the global batch; this rank's
    rows of y, and the aux loss that every rank computed alike."""
    b, s, d = x.shape
    grp = mesh.group(dp)
    x2 = gather_for_compute(x.reshape(b * s, d), 0, dp, mesh)
    n = x2.shape[0]
    y, aux = _moe_groups(x2[None], params, top_k=m.top_k,
                         cap=capacity(n, m), act=act)
    y = y[0].narrow(0, mesh.index(dp) * b * s, b * s)
    return y.reshape(b, s, d), coll.replicated(aux[0], grp)
