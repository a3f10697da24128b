"""Carry parameters over from the JAX package.

``from_reference_params`` takes the JAX package's ``Model.init`` pytree,
already converted to numpy arrays by the caller (this package does not
import JAX), and returns the same tree of torch tensors. The layouts are
the reference's — blocks stacked on a leading layer axis, dense weights
(d_in, d_out), heads contiguous within a projection — so both packages
compute the same function of the same numbers. Each leaf keeps the dtype
the reference stores it in: the model's dtype, or f32 for the leaves the
reference keeps in f32 whatever the model's dtype (the MoE router, mamba's
``A_log`` and ``D``, rwkv6's ``w_base``, ``u`` and ``ln_x``). The tensors
land on the card unless the caller asks for the CPU (``device="cpu"``), as
every entry point of the port does.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes storage: same bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device)


def from_reference_params(params_np, cfg: ModelConfig, device="cuda"
                          ) -> Any:
    """The reference's tree as torch tensors of the same dtypes. A leaf in
    neither ``cfg.dtype`` nor f32 raises ValueError."""
    allowed = {getattr(torch, cfg.dtype), torch.float32}
    device = resolve_device(device)

    def conv(tree, path):
        if isinstance(tree, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in tree.items()}
        t = _tensor(tree, device)
        if t.dtype not in allowed:
            raise ValueError(f"{path}: {t.dtype} is neither {cfg.dtype} nor "
                             f"float32")
        return t

    return conv(params_np, "")
