"""AdamW written out, as the JAX package's: functional (``update`` returns
new parameters and a new state), with the update in f32 rounded once to
each parameter's dtype and optional low-precision moment storage
(``state_dtype="bfloat16"``).

``torch.optim.AdamW`` is not used: it updates 16-bit parameters in their
own dtype, step by step, and so rounds differently from the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.utils.tree import (global_norm, tree_leaves, tree_map,
                                    tree_unflatten_like)


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor     # int32 scalar: updates applied so far


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None   # None = the parameter's; "bfloat16"

    def _sdtype(self, p: torch.Tensor) -> torch.dtype:
        return getattr(torch, self.state_dtype) if self.state_dtype \
            else p.dtype

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self._sdtype(p),
                               device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamWState(m=tree_map(zeros, params),
                          v=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: the schedule sees the 1-based count; gradients are
        scaled by ``min(1, clip_norm / global_norm)``; returns (new params,
        new state)."""
        count = state.count + 1
        f32 = torch.float32
        cf = count.to(f32)
        lr = self.lr(count) if callable(self.lr) else self.lr
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
        b1 = torch.tensor(self.b1, dtype=f32, device=cf.device)
        b2 = torch.tensor(self.b2, dtype=f32, device=cf.device)
        b1c = 1 - b1 ** cf
        b2c = 1 - b2 ** cf

        def upd(g, m, v, p):
            gf = g.float() if scale is None else g.float() * scale
            mf = self.b1 * m.float() + (1 - self.b1) * gf
            vf = self.b2 * v.float() + (1 - self.b2) * gf.square()
            step = (mf / b1c) / (torch.sqrt(vf / b2c) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.float()
            new_p = (p.float() - lr * step).to(p.dtype)
            return new_p, mf.to(m.dtype), vf.to(v.dtype)

        new = [upd(*t) for t in zip(tree_leaves(grads),
                                    tree_leaves(state.m),
                                    tree_leaves(state.v),
                                    tree_leaves(params))]
        return (tree_unflatten_like(params, [t[0] for t in new]),
                AdamWState(tree_unflatten_like(params, [t[1] for t in new]),
                           tree_unflatten_like(params, [t[2] for t in new]),
                           count))


def warmup_cosine(peak: float, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``; f32 arithmetic on the step tensor,
    as the reference's schedule."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        stepf = torch.as_tensor(step).to(torch.float32)
        warm = stepf / max(warmup, 1)
        prog = torch.clamp((stepf - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(stepf < warmup, warm, cos)
    return schedule
