"""Carry parameters over from the JAX package.

``from_reference_params`` takes the JAX package's ``Model.init`` pytree,
already converted to numpy arrays by the caller (this package does not
import JAX), and returns the same tree of torch tensors. The layouts are
the reference's — blocks stacked on a leading layer axis, dense weights
(d_in, d_out), heads contiguous within a projection — so both packages
compute the same function of the same numbers. The tensors land on the
card unless the caller asks for the CPU (``device="cpu"``), as every entry
point of the port does.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import resolve_device


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes storage: same bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def from_reference_params(params_np, cfg: ModelConfig, device="cuda"
                          ) -> Any:
    dtype = getattr(torch, cfg.dtype)
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, dtype, device)

    return conv(params_np)
