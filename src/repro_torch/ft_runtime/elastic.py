"""Elastic re-meshing: plan a new mesh when the healthy device set changes.

A real deployment feeds this from the cluster manager's health service; the
planning logic is pure and tested here. Policy: keep the ``model`` axis at
its configured size (TP degree is baked into weight shards), shrink the
``data``(/``pod``) axes to the largest supported DP degree, and resume from
the latest checkpoint (restore() reshards onto the new mesh; the stateless
data pipeline needs only the step counter).
"""
from __future__ import annotations

import dataclasses
from typing import Optional



@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    dropped_devices: int
    world: int

    @property
    def dp_degree(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("pod", "data"):
                n *= s
        return n


def plan_mesh(n_healthy: int, *, model_parallel: int = 16,
              prefer_pods: bool = True) -> Optional[MeshPlan]:
    """Largest mesh with a fixed TP degree that fits the healthy devices."""
    if n_healthy < model_parallel:
        return None
    dp = n_healthy // model_parallel
    if prefer_pods and dp >= 32 and dp % 16 == 0:
        pods = dp // 16
        return MeshPlan((pods, 16, model_parallel), ("pod", "data", "model"),
                        n_healthy - pods * 16 * model_parallel,
                        pods * 16 * model_parallel)
    return MeshPlan((dp, model_parallel), ("data", "model"),
                    n_healthy - dp * model_parallel, dp * model_parallel)


def build_mesh(plan: MeshPlan, ranks=None):
    """A :class:`~repro_torch.distributed.mesh.Mesh` of ``plan.shape`` and
    ``plan.axes`` over the first ``plan.world`` of ``ranks`` (the world's
    ranks by default); every rank of the world calls it."""
    from repro_torch.distributed.mesh import Mesh
    ranks = list(ranks) if ranks is not None else None
    return Mesh(plan.shape, plan.axes,
                ranks=None if ranks is None else ranks[: plan.world])
