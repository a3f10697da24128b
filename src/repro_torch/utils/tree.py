"""Helpers over the port's trees: nested dicts, NamedTuples, lists and
tuples with tensors (or numpy arrays, or numbers) at the leaves.

Leaves come in the JAX package's flatten order: dict keys sorted,
NamedTuple fields in declaration order, sequences by index; a ``None``
holds no leaf. So the ``i``-th leaf of a port tree is the ``i``-th leaf of
the same JAX tree, and a path names the same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch

# a path step: ("key", dict key) | ("attr", NamedTuple field) | ("idx", i)
Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree, path: Path = ()) -> Iterator[
        Tuple[Path, Any]]:
    """(path, leaf) pairs in the JAX package's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], path + (("key", k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from tree_flatten_with_path(getattr(tree, f),
                                              path + (("attr", f),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, path + (("idx", i),))
    else:
        yield path, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in flatten
    order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def path_str(path: Path, *, attr_prefix: str = "") -> str:
    """A path as "/"-joined steps; NamedTuple fields get ``attr_prefix``
    ("." is how the JAX package's checkpoints spell them)."""
    return "/".join(f"{attr_prefix}{k}" if kind == "attr" else str(k)
                    for kind, k in path)


def tree_flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs, names "/"-joined as the JAX package's."""
    return [(path_str(p), leaf) for p, leaf in tree_flatten_with_path(tree)]


def param_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * _itemsize(x) for x in tree_leaves(tree))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(getattr(x, "dtype", np.float32)).itemsize


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating-point tensors of a tree to ``dtype``."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (f32
    scalar), summed in leaf order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
