"""Shared neural-net layers as plain functions on tensors; parameters are
dictionaries of tensors with the JAX package's names and layouts (a dense
weight is (d_in, d_out))."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return w.to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Linear projection with f32 accumulation, one rounding to x's dtype
    (the JAX package's ``preferred_element_type=f32`` then ``astype``)."""
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


def norm_init(kind: str, d: int, dtype, device):
    w = torch.ones((d,), dtype=dtype, device=device)
    if kind == "rmsnorm":
        return {"w": w}
    return {"w": w, "b": torch.zeros((d,), dtype=dtype, device=device)}


def norm_apply(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype, device, *,
             glu: bool):
    p = {}
    if glu:
        p["gate"] = dense_init(gen, d, ff, dtype, device)
    p["up"] = dense_init(gen, d, ff, dtype, device)
    p["down"] = dense_init(gen, ff, d, dtype, device)
    return p


def mlp_apply(params, x: torch.Tensor, *, act: str, glu: bool
              ) -> torch.Tensor:
    a = ACTS[act]
    if glu:
        h = a(matmul(x, params["gate"])) * matmul(x, params["up"])
    else:
        h = a(matmul(x, params["up"]))
    return matmul(h, params["down"])


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  dtype=torch.float32, device=device)
                      * 0.02).to(dtype)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


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
    return {"pos": (torch.randn((max_seq, d), generator=gen,
                                dtype=torch.float32, device=device)
                    * 0.02).to(dtype)}
