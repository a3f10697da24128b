"""A named mesh of ``torch.distributed`` ranks: the port's counterpart of
``jax.sharding.Mesh``.

Rank ``r`` of the mesh's rank list sits at ``np.unravel_index(r, shape)``,
as ``np.asarray(devices).reshape(shape)`` places devices in the JAX
package. ``mesh.shape`` maps each axis name to its size, as the
reference's does, so the sharding rules read either mesh alike.

The constructor builds the process group of every subset of the axes
(``("data",)``, ``("pod", "data")``, ...), and every rank of the world
builds every group, in the same order, including groups it is not in:
``torch.distributed.new_group`` is collective over the whole world, and
ranks that build different groups, or the same ones in another order,
wait on each other for ever. A group's ranks are its members' global
ranks in ascending order (``new_group`` sorts them), which is row-major
order over its axes taken in the mesh's order.

The groups' backend is the caller's choice, or the default group's.
``nccl`` refuses two ranks on one device ("Duplicate GPU detected"), so
ranks that share a card use ``gloo`` (see :mod:`~repro_torch.distributed.
collectives` for how CUDA tensors cross a gloo group).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

Axes = Union[str, Tuple[str, ...]]


class Mesh:
    """``shape`` sizes over ``axes`` names, on global ``ranks`` (the first
    ``prod(shape)`` of the world by default) of the initialised default
    process group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 ranks: Optional[Sequence[int]] = None,
                 backend: Optional[str] = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes {axes}")
        n = math.prod(shape)
        world = dist.get_world_size()
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != n or len(set(ranks)) != n or \
                not all(0 <= r < world for r in ranks):
            raise ValueError(f"mesh {shape} needs {n} distinct ranks of a "
                             f"world of {world}, got {ranks}")
        self.axes = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.ranks = np.asarray(ranks).reshape(shape)
        self.backend = backend or dist.get_backend()
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        # this rank's coordinate on each axis; None outside the mesh
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(axes, (int(c) for c in where[0]))) if len(where)
            else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                # one group per coordinate of the other axes; every rank
                # builds all of them, in this order
                moved = np.moveaxis(self.ranks, [axes.index(a) for a in sub],
                                    list(range(len(sub))))
                members = moved.reshape(math.prod(self.shape[a]
                                                  for a in sub), -1).T
                for m in members:
                    g = dist.new_group(sorted(int(r) for r in m),
                                       backend=self.backend)
                    if self.coords is not None and me in m:
                        self._groups[sub] = g

    def _norm(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or not axes:
            raise ValueError(f"axes {axes} not in mesh {self.axes}")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes: Axes):
        """The process group of the calling rank over one axis or a tuple
        of axes."""
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
        return self._groups[self._norm(axes)]

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        if axes is None or axes == ():
            return 1
        return math.prod(self.shape[a] for a in self._norm(axes))

    def index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """Row-major index of ``rank`` (the calling rank by default) over
        ``axes`` taken in the order given: the block of a dimension that a
        spec entry of these axes splits."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if rank is None:
            coords = self.coords
            if coords is None:
                raise RuntimeError(f"rank {dist.get_rank()} is not in the "
                                   f"mesh")
        else:
            at = np.argwhere(self.ranks == rank)[0]
            coords = dict(zip(self.axes, (int(c) for c in at)))
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r})"
