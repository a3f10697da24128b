"""Collectives of the port on ``torch.distributed`` process groups.

``compressed_psum``: int8-quantized all-reduce with error feedback, the
train step's ``pod_sync="int8_ef"`` across pods, in the JAX package's
steps. The int8 payloads are summed as int32, so the all-reduce itself
moves four bytes an element: the reference's saving is on the wire of an
int8 transport, which a sum of int32 does not have.

Where tensors go: on an ``nccl`` group a tensor stays on its CUDA device
(a CPU tensor raises). On a ``gloo`` group a CUDA tensor is copied to the
host, reduced or gathered there, and copied back: the rule is the group's
backend, not a retry. ``gloo`` is what ranks sharing one card use, since
``nccl`` refuses two ranks on one device. A collective that fails raises.

``traffic`` counts, per kind of collective, the calls of this process and
the bytes of the tensors it reduced (all-reduce) or received (all-gather).

The autograd functions give the model's collectives their gradients, for a
train step that sums every rank's gradients over the data-parallel axes
afterwards (each rank's gradients are its share of the global loss's):

* :func:`psum`  — all-reduce sum; backward passes the gradient through
  (the value downstream is replicated, the gradient of each addend is it);
* :func:`pmean` — all-reduce mean; backward scales by 1 / n;
* :func:`pcopy` — identity; backward sums the gradient over the group (a
  replicated input to per-rank partial computations, Megatron's ``f``);
* :func:`replicated` — identity on a value every member computed alike
  from the same inputs; backward scales by 1 / n, so the sum over the
  group counts it once.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

traffic: Dict[str, Dict[str, int]] = {}


def reset_traffic() -> None:
    traffic.clear()


def _count(kind: str, nbytes: int) -> None:
    c = traffic.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += nbytes


def _host_staged(t: torch.Tensor, group) -> bool:
    backend = dist.get_backend(group)
    if backend == "nccl" and not t.is_cuda:
        raise ValueError("an nccl group reduces CUDA tensors only")
    return backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over ``group`` in a new tensor."""
    staged = _host_staged(t, group)
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _count("all_reduce", buf.numel() * buf.element_size())
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``t`` (equal shapes), in the group's rank order."""
    staged = _host_staged(t, group)
    src = t.detach().contiguous()
    src = src.cpu() if staged else src
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    _count("all_gather", sum(p.numel() * p.element_size() for p in parts))
    return [p.to(t.device) for p in parts] if staged else parts


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _PCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return _PMean.apply(x, group)


def pcopy(x: torch.Tensor, group) -> torch.Tensor:
    return _PCopy.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _Replicated.apply(x, group)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group, err=None):
    """int8 mean over ``group`` with error feedback. A *global* scale is
    agreed first (one scalar max-reduce), so the int8 sums commute exactly
    with dequantization. Returns (mean in ``x``'s dtype, new_err in
    ``err``'s dtype, f32 without): the local quantization residual, carried
    to the next step. ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    xf = x.float()
    if err is not None:
        xf = xf + err.float()
    amax = all_reduce(xf.abs().max(), group, "max")    # scalar on the wire
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = (xf - q.float() * scale).to(
        err.dtype if err is not None else torch.float32)
    total = all_reduce(q.to(torch.int32), group)        # i32: no overflow
    mean = total.float() * scale / float(dist.get_world_size(group))
    return mean.to(x.dtype), new_err
