"""Fault-tolerant checkpointing in the JAX package's on-disk format: a
``manifest.json`` mapping each leaf's path to a ``leaf_*.npy`` file, its
shape and its dtype, so a checkpoint written by either package restores
into the other.

  * leaves are flattened in the JAX package's order and named by its path
    strings (dict keys, NamedTuple fields as ``.field``: ``.params/blocks/
    attn/wq``, ``.opt/.m/...``, ``.opt/.count``, ``.step``);
  * numpy cannot store bfloat16: its leaves are written as the uint16 bits
    (through torch's ``view``) with the logical dtype in the manifest;
  * writes go to ``<dir>.tmp``, then ``os.replace``: a crash mid-save never
    corrupts the latest good checkpoint;
  * :class:`AsyncCheckpointer` copies the tree to the host, then writes it
    on a worker thread while training steps on;
  * on a mesh (``mesh`` and ``shardings``, a spec tree of the tree's
    structure) a save gathers each leaf to its full shape, rank 0 of the
    mesh writes, and every rank of the mesh passes a barrier once the
    files are in place; a restore loads the full leaves and keeps each
    rank's block. A checkpoint so crosses meshes, and crosses between a
    mesh and one process, bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (full_shape, gather_tree,
                                              local_block, spec_leaves)
from repro_torch.utils.tree import (path_str, tree_flatten_with_path,
                                    tree_unflatten_like)

MANIFEST = "manifest.json"



def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """Host numpy array and logical dtype name of a leaf; bfloat16, which
    numpy cannot store, as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _key(path) -> str:
    return path_str(path, attr_prefix=".")


def _host(tree):
    """The tree's leaves as host numpy arrays with their dtype names."""
    return [(_key(p), _to_storable(leaf))
            for p, leaf in tree_flatten_with_path(tree)]


def _write(ckpt_dir: Path, leaves, *, step: int, extra) -> Path:
    tmp = ckpt_dir.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, (arr, dtype_name)) in enumerate(leaves):
        name = f"leaf_{i:05d}.npy"
        np.save(tmp / name, arr)
        manifest["leaves"][key] = {"file": name, "shape": list(arr.shape),
                                   "dtype": dtype_name}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    os.replace(tmp, ckpt_dir)
    return ckpt_dir


def _gathered(tree, mesh, shardings):
    return tree if mesh is None else gather_tree(tree, shardings, mesh)


def _writes(mesh) -> bool:
    return mesh is None or mesh.index(mesh.axes) == 0


def _barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group(mesh.axes))


def save(ckpt_dir: Union[str, Path], tree: Any, *, step: int,
         extra: Optional[dict] = None, mesh=None, shardings=None) -> Path:
    """Write ``tree`` (on a mesh: every rank calls, with its blocks)."""
    full = _gathered(tree, mesh, shardings)
    if _writes(mesh):
        _write(Path(ckpt_dir), _host(full), step=step, extra=extra)
    _barrier(mesh)
    return Path(ckpt_dir)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight). On a mesh
    the gather is synchronous and rank 0 writes on the thread; every rank
    calls :meth:`wait`, which ends in the mesh's barrier."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._mesh = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, ckpt_dir, tree, *, step, extra=None, mesh=None,
                   shardings=None):
        self.wait()
        full = _gathered(tree, mesh, shardings)
        self._mesh = mesh
        if not _writes(mesh):
            return
        leaves = _host(full)          # the copy to the host, synchronous

        def work():
            try:
                _write(Path(ckpt_dir), leaves, step=step, extra=extra)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        _barrier(mesh)
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def restore(ckpt_dir: Union[str, Path], target: Any, *, mesh=None,
            shardings: Any = None) -> tuple[Any, int, dict]:
    """Load a checkpoint into ``target``'s structure: each leaf as a tensor
    of the target leaf's dtype on its device; on a ``mesh``, the calling
    rank's block under ``shardings`` (``target`` holds blocks). A leaf
    missing from the checkpoint raises KeyError, a shape that differs
    ValueError. Returns (tree, step, extra)."""
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / MANIFEST).read_text())
    flat = list(tree_flatten_with_path(target))
    specs = (spec_leaves(target, shardings) if mesh is not None
             else [None] * len(flat))
    leaves = []
    for (path, leaf), spec in zip(flat, specs):
        key = _key(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        info = manifest["leaves"][key]
        t = _from_storable(np.load(ckpt_dir / info["file"]), info["dtype"])
        want = tuple(getattr(leaf, "shape", t.shape))
        if mesh is not None:
            want = full_shape(want, spec, mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"{want}")
        if mesh is not None:
            t = local_block(t, spec, mesh)
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        leaves.append(t)
    tree = tree_unflatten_like(target, leaves)
    return tree, int(manifest["step"]), manifest.get("extra", {})


def latest_step(root: Union[str, Path]) -> Optional[Path]:
    """The checkpoint directory under ``root`` with the highest step, or
    None."""
    root = Path(root)
    if not root.exists():
        return None
    cands = [p for p in root.iterdir()
             if p.is_dir() and (p / MANIFEST).exists()]
    if not cands:
        return None
    return max(cands, key=lambda p: json.loads(
        (p / MANIFEST).read_text())["step"])
