"""Logical-axis sharding rules (FSDP x TP x EP), MaxText-style but by name,
and the ZeRO-3 storage that takes the place of GSPMD's placement.

The rules are the JAX package's, applied to the same parameter paths
(``blocks/attn/wq``, ...): parameters are sharded over BOTH the ``data``
axis (FSDP/ZeRO-3 storage) and the ``model`` axis. A spec is a plain tuple
with one entry per dimension: ``None``, an axis name, or a tuple of axis
names (the dimension split row-major over them, major axis first, as a
``PartitionSpec`` splits it).

In the JAX package GSPMD inserts the just-in-time all-gathers for the
dense layers and the values are those of one device. The port does that by
hand: a rank stores the block of each leaf that its spec gives it
(:func:`shard_tree`), and gathers full leaves (:func:`gather_tree`) for the
dense layers before it computes; the MoE layer gathers its experts itself,
as the reference's ``shard_map`` does.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from repro_torch.distributed import collectives
from repro_torch.utils.tree import (path_str, tree_flatten_with_path,
                                    tree_leaves, tree_map,
                                    tree_unflatten_like)

# name-pattern -> spec for the *trailing* dims of the parameter
_RULES: list[tuple[str, tuple]] = [
    # vocab-parallel embedding (Megatron-style)
    (r"(embed|lm_head)/table$", ("model", None)),
    (r"pos/pos$", (None, None)),
    # attention / dense projections: column-parallel in, row-parallel out
    (r"(wq|wk|wv)$", ("data", "model")),
    (r"wo$", ("model", "data")),
    (r"(gate|up)$", ("data", "model")),
    (r"down$", ("model", "data")),
    # MoE experts: E over model, dim-1 over data (FSDP); router replicated
    (r"moe/(wg|wu|wd)$", ("model", "data", None)),
    (r"moe/router$", (None, None)),
    # SSM projections
    (r"(in_proj|x_proj|dt_proj|wr|wg|wk|wv|wk_c|wr_c|w_lora_a)$",
     ("data", "model")),
    (r"(out_proj|wv_c|w_lora_b)$", ("model", "data")),
    (r"A_log$", (None, None)),
]


# Inference layout: dense weights pure-TP; expert weights shard E over
# 'data' and the ff dim over 'model' so the expert matmul needs no weight
# gather (tokens are gathered instead).
_INFERENCE_RULES: list[tuple[str, tuple]] = [
    (r"(embed|lm_head)/table$", ("model", None)),
    (r"pos/pos$", (None, None)),
    (r"(wq|wk|wv)$", (None, "model")),
    (r"wo$", ("model", None)),
    (r"(gate|up)$", (None, "model")),
    (r"down$", ("model", None)),
    (r"moe/(wg|wu)$", ("data", None, "model")),
    (r"moe/wd$", ("data", "model", None)),
    (r"moe/router$", (None, None)),
    (r"(in_proj|x_proj|dt_proj|wr|wg|wk|wv|wk_c|wr_c|w_lora_a)$",
     (None, "model")),
    (r"(out_proj|wv_c|w_lora_b)$", ("model", None)),
    (r"A_log$", (None, None)),
]


def spec_for_param(path: str, ndim: int, *, inference: bool = False
                   ) -> tuple:
    rules = _INFERENCE_RULES if inference else _RULES
    for pat, spec in rules:
        if re.search(pat, path):
            spec = tuple(spec)
            if len(spec) > ndim:
                spec = spec[-ndim:]
            pad = (None,) * (ndim - len(spec))
            return pad + spec
    return (None,) * ndim


def _mesh_filter(spec: tuple, mesh) -> tuple:
    """Drop axes not present in the mesh (e.g. 'pod' on single-pod)."""
    def ok(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x in mesh.shape)
            return kept if kept else None
        return a if a in mesh.shape else None
    return tuple(ok(a) for a in spec)


def _axes(entry) -> tuple:
    """The axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Optional[tuple]) -> tuple:
    """Every axis a spec splits over."""
    return tuple(a for entry in (spec or ()) for a in _axes(entry))


def _drop_tiny(spec: tuple, shape, mesh) -> tuple:
    # a dimension the axes do not divide stays whole (whisper's 51865
    # vocab stays replicated; the big 128k-262k vocabs shard cleanly)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        size = 1
        for a in _axes(ax):
            size *= mesh.shape[a]
        fixed.append(ax if (dim >= size and dim % size == 0) else None)
    return tuple(fixed)


def param_shardings(params_shape, mesh, *, inference: bool = False):
    """The spec of every leaf of a parameter tree (tensors, or anything
    with a ``.shape``), by path rules, in the tree's structure."""
    leaves = []
    for path, leaf in tree_flatten_with_path(params_shape):
        spec = _mesh_filter(spec_for_param(path_str(path), len(leaf.shape),
                                           inference=inference), mesh)
        leaves.append(_drop_tiny(spec, leaf.shape, mesh))
    return tree_unflatten_like(params_shape, leaves)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_sharding(mesh, ndim: int) -> tuple:
    dp = dp_axes(mesh)
    return (dp if dp else None,) + (None,) * (ndim - 1)


def _cache_leaves(cache, path=""):
    """(name, tensor) of a serving cache (dataclasses and NamedTuples of
    tensors), named by field path: ``k``, ``attn/k``, ``cross_blk/ck``."""
    if cache is None:
        return
    if dataclasses.is_dataclass(cache):
        fields = [f.name for f in dataclasses.fields(cache)]
    elif isinstance(cache, tuple) and hasattr(cache, "_fields"):
        fields = list(cache._fields)
    else:
        yield path, cache
        return
    for f in fields:
        yield from _cache_leaves(getattr(cache, f),
                                 f"{path}/{f}" if path else f)


def cache_shardings(cache, mesh, *, batch: int) -> Dict[str, tuple]:
    """KV caches: batch over dp when divisible, else shard the sequence axis
    over 'data' (context parallelism for long decode). Returns the spec of
    every tensor of ``cache`` by its field path (see ``_cache_leaves``)."""
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]

    def one(name, shape):
        nd = len(shape)
        if shape and shape[-1] == 0:
            return (None,) * nd
        if "ck" in name or "cv" in name or nd < 3:
            return (None,) * nd
        # stacked (L, B, H, S, D) attention caches / (L, B, ...) ssm states;
        # the VLM's superblock nesting adds leading dims, so locate the batch
        # dim by size (first match from the left past the stack dim).
        bidx = next((i for i in range(1, nd) if shape[i] == batch), None)
        if (batch >= dp_size and bidx is not None
                and shape[bidx] % dp_size == 0 and dp):
            spec = [None] * nd
            spec[bidx] = dp
            return tuple(spec)
        if (nd >= 4 and "data" in mesh.shape
                and shape[-2] % mesh.shape["data"] == 0):
            # (L, B, Hkv, S, D): context-parallel over the seq axis
            spec = [None] * nd
            spec[-2] = "data"
            return tuple(spec)
        return (None,) * nd

    return {name: one(name, tuple(t.shape))
            for name, t in _cache_leaves(cache)}


# ---------------------------------------------------------------------------
# ZeRO-3 storage: blocks, gathers, reshards
# ---------------------------------------------------------------------------

def local_block(t: torch.Tensor, spec: Optional[tuple], mesh
                ) -> torch.Tensor:
    """The calling rank's block of the full tensor ``t`` under ``spec``:
    a contiguous copy where the spec cuts ``t`` (a view would keep the
    full tensor's storage alive), ``t`` itself (made contiguous) where it
    does not."""
    cut = False
    for dim, entry in enumerate(spec or ()):
        axes = _axes(entry)
        if not axes:
            continue
        n = mesh.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways over {axes}")
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axes) * step, step)
        cut = True
    if cut:
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def gather_leaf(t: torch.Tensor, spec: Optional[tuple], mesh
                ) -> torch.Tensor:
    """The full tensor from the calling rank's block ``t`` under ``spec``:
    one all-gather over the axes of each split dimension."""
    for dim, entry in enumerate(spec or ()):
        axes = _axes(entry)
        if axes:
            t = gather_dim(t, dim, axes, mesh)
    return t


def gather_dim(t: torch.Tensor, dim: int, axes: tuple, mesh
               ) -> torch.Tensor:
    """All-gather ``t`` over ``axes`` and concatenate the blocks along
    ``dim`` in the row-major order of ``axes``."""
    group = mesh.group(axes)
    parts = collectives.all_gather(t, group)
    members = torch.distributed.get_process_group_ranks(group)
    order = sorted(range(len(members)),
                   key=lambda j: mesh.index(axes, members[j]))
    return torch.cat([parts[j] for j in order], dim=dim)


class _GatherForCompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axes, mesh):
        ctx.args = (dim, axes, mesh)
        return gather_dim(t, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        dim, axes, mesh = ctx.args
        g = collectives.all_reduce(g, mesh.group(axes))
        cut = [None] * g.dim()
        cut[dim] = axes
        return local_block(g, tuple(cut), mesh), None, None, None


def gather_for_compute(t: torch.Tensor, dim: int, axes: tuple, mesh
                       ) -> torch.Tensor:
    """:func:`gather_dim` under autograd: the backward is a reduce-scatter
    (the gradient summed over ``axes``, this rank's block kept), as JAX
    transposes an all-gather."""
    return _GatherForCompute.apply(t, dim, tuple(axes), mesh)


def reshard(t: torch.Tensor, src: Optional[tuple], dst: Optional[tuple],
            mesh) -> torch.Tensor:
    """The calling rank's block under ``dst`` from its block under
    ``src``: each dimension whose axes differ is gathered over ``src``'s
    axes and cut by ``dst``'s."""
    nd = t.dim()
    src = tuple(src or ()) + (None,) * (nd - len(src or ()))
    dst = tuple(dst or ()) + (None,) * (nd - len(dst or ()))
    for dim in range(nd):
        a, b = _axes(src[dim]), _axes(dst[dim])
        if a == b:
            continue
        if a:
            t = gather_dim(t, dim, a, mesh)
        if b:
            cut = [None] * nd
            cut[dim] = b
            t = local_block(t, tuple(cut), mesh)
    return t


def shard_tree(tree, specs, mesh):
    """Each leaf's block on the calling rank: ``specs`` has ``tree``'s
    structure, a spec (or None: whole) at each leaf."""
    return tree_map(lambda t, s: local_block(t, s, mesh), tree, specs)


def gather_tree(shards, specs, mesh):
    """The full leaves from each rank's blocks, gathered just in time."""
    return tree_map(lambda t, s: gather_leaf(t, s, mesh), shards, specs)


class _Leaf:
    def __init__(self, spec):
        self.spec = spec


def spec_leaves(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in flatten order (a spec tree
    has ``tree``'s structure with a tuple at each leaf)."""
    return [b.spec for b in tree_leaves(
        tree_map(lambda _, s: _Leaf(s), tree, specs))]


_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of the raw bits (int64, wrapping): odd
    weights below 2^18 on values below 2^33 in magnitude, so a single
    element that differs always changes it."""
    bits = t.detach().reshape(-1).contiguous().view(
        _INT[t.element_size()]).long()
    w = torch.arange(bits.numel(), device=t.device) % 65521 * 2 + 1
    return (bits * w).sum()


def replicas_disagree(tree, specs, mesh) -> list:
    """Paths of the leaves whose blocks differ, bit for bit, between ranks
    that the spec replicates (the mesh axes the leaf is not split over):
    each rank's checksums (:func:`_checksum`) are all-gathered."""
    by_axes = {}
    for (path, t), spec in zip(tree_flatten_with_path(tree),
                               spec_leaves(tree, specs)):
        axes = tuple(a for a in mesh.axes if a not in spec_axes(spec))
        if mesh.size(axes) > 1:
            by_axes.setdefault(axes, []).append(
                (path_str(path, attr_prefix="."), _checksum(t)))
    bad = []
    for axes, items in by_axes.items():
        mine = torch.stack([c for _, c in items])
        parts = collectives.all_gather(mine, mesh.group(axes))
        same = torch.stack([p == parts[0] for p in parts]).all(dim=0)
        bad += [name for (name, _), ok in zip(items, same.tolist())
                if not ok]
    return bad


def full_shape(shape, spec: Optional[tuple], mesh) -> tuple:
    """The shape of the full tensor whose block under ``spec`` is of
    ``shape``."""
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    return tuple(n * mesh.size(_axes(e)) for n, e in zip(shape, spec))
