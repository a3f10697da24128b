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

``from_reference_train_state`` carries a whole training state across: the
reference's ``TrainState`` (params, ``AdamWState(m, v, count)``, step) with
numpy leaves becomes the port's, moments in the dtype they were stored in
(the parameter's, or the optimizer's ``state_dtype``).
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


def from_reference_train_state(state_np, cfg: ModelConfig, device="cuda"):
    """The reference's ``TrainState`` with numpy leaves (read by attribute:
    ``params``, ``opt.m``, ``opt.v``, ``opt.count``, ``step``) as the
    port's :class:`~repro_torch.train.state.TrainState`. The compressed
    sync's ``ef`` residuals are not carried (the port runs
    ``pod_sync="dense"``)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState
    device = resolve_device(device)

    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        return _tensor(tree, device)

    def scalar(x):
        return torch.as_tensor(np.array(x), dtype=torch.int32,
                               device=device)

    opt = state_np.opt
    return TrainState(
        params=from_reference_params(state_np.params, cfg, device=device),
        opt=AdamWState(m=moments(opt.m), v=moments(opt.v),
                       count=scalar(opt.count)),
        step=scalar(state_np.step))
