"""Plain-tensor oracles for the fused EFTA kernels: the strided folds in
one f32 reduction each, and naive softmax attention."""
from __future__ import annotations

import torch

from repro_torch.core.efta import reference_attention  # noqa: F401


def fold1_ref(x: torch.Tensor, stride: int) -> torch.Tensor:
    g = x.shape[-1] // stride
    return x.reshape(*x.shape[:-1], g, stride).float().sum(-2)


def fold2_ref(x: torch.Tensor, stride: int) -> torch.Tensor:
    g = x.shape[-1] // stride
    w = torch.arange(1, g + 1, dtype=torch.float32, device=x.device)
    xr = x.reshape(*x.shape[:-1], g, stride).float()
    return (xr * w[:, None]).sum(-2)


def foldprod_ref(x: torch.Tensor, stride: int) -> torch.Tensor:
    g = x.shape[-1] // stride
    return x.reshape(*x.shape[:-1], g, stride).float().prod(-2)


def attention_ref(q, k, v, *, causal=False, window=None, sm_scale=None):
    """Oracle for the kernel: naive softmax attention (GQA aware)."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)
