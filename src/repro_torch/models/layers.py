"""Shared neural-net layers as plain functions on tensors; parameters are
dictionaries of tensors with the JAX package's names and layouts (a dense
weight is (d_in, d_out))."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.abft_gemm import tensor_abft_matmul


def normal_init(gen: torch.Generator, shape, dtype, device, scale: float,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0, scale^2) draws made in f32 and rounded to ``dtype``, into ``out``
    where given (else a new tensor of ``shape``), drawn one trailing 2-D
    slice at a time: the f32 scratch never exceeds one slice (one expert's
    weight), whatever the leading axes. Draws nothing on the meta device."""
    shape = tuple(shape)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    piece = shape[-2:]
    for p in out.view((-1,) + piece):
        p.copy_(torch.randn(piece, generator=gen, dtype=torch.float32,
                            device=out.device) * scale)
    return out


def const_init(shape, dtype, device, value: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ``shape`` tensor of ``value``, in ``out`` where given."""
    if out is None:
        return torch.full(tuple(shape), value, dtype=dtype, device=device)
    return out.fill_(value)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(gen, (d_in, d_out), dtype, device, scale, out)


def matmul(x: torch.Tensor, w: torch.Tensor, *, ff_abft: bool = False
           ) -> torch.Tensor:
    """Linear projection with f32 accumulation, one rounding to x's dtype
    (the JAX package's ``preferred_element_type=f32`` then ``astype``);
    with ``ff_abft`` protected by tensor-checksum ABFT, whose detection
    count is dropped here, as the JAX package drops it."""
    if ff_abft:
        return tensor_abft_matmul(x, w)[0]
    if x.dtype == torch.float32:
        return torch.matmul(x, w.float())
    # cuBLAS accumulates 16-bit products in f32 and rounds once on output
    return torch.matmul(x, w.to(x.dtype))


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["w"].float()).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["w"].float() + params["b"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype, device, out=None):
    out = out or {}
    p = {"w": const_init((d,), dtype, device, 1.0, out.get("w"))}
    if kind != "rmsnorm":
        p["b"] = const_init((d,), dtype, device, 0.0, out.get("b"))
    return p


def norm_apply(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype, device, *,
             glu: bool, out=None):
    out = out or {}
    p = {}
    if glu:
        p["gate"] = dense_init(gen, d, ff, dtype, device, out=out.get("gate"))
    p["up"] = dense_init(gen, d, ff, dtype, device, out=out.get("up"))
    p["down"] = dense_init(gen, ff, d, dtype, device, out=out.get("down"))
    return p


def mlp_apply(params, x: torch.Tensor, *, act: str, glu: bool,
              ff_abft: bool = False) -> torch.Tensor:
    a = ACTS[act]
    if glu:
        h = a(matmul(x, params["gate"], ff_abft=ff_abft)) * matmul(
            x, params["up"], ff_abft=ff_abft)
    else:
        h = a(matmul(x, params["up"], ff_abft=ff_abft))
    return matmul(h, params["down"], ff_abft=ff_abft)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    return {"table": normal_init(gen, (vocab, d), dtype, device, 0.02)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``params["table"]`` by token id, through ``F.embedding``,
    whose backward PyTorch does not list among its nondeterministic CUDA
    operations (the backward of plain indexing accumulates with atomics
    unless deterministic algorithms are forced)."""
    return F.embedding(tokens, params["table"])


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: f32 logits (B, S, V)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, table.float().t())
    return torch.matmul(x, table.to(x.dtype).t()).float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding. ``x``: (..., S, H, D) or (..., S, D); ``positions``:
    the matching (..., S) — per request (B, S) on the paged path."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.tensor(float(theta), dtype=torch.float32) ** (
        -torch.arange(0, half, dtype=torch.float32) / half)
    ang = positions[..., None].float() * freq.to(positions.device)
    if x.dim() > ang.dim():                 # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def learned_pos_init(gen: torch.Generator, max_seq: int, d: int, dtype,
                     device):
    return {"pos": normal_init(gen, (max_seq, d), dtype, device, 0.02)}
