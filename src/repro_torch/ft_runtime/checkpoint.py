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
    on a worker thread while training steps on.
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


def save(ckpt_dir: Union[str, Path], tree: Any, *, step: int,
         extra: Optional[dict] = None) -> Path:
    return _write(Path(ckpt_dir), _host(tree), step=step, extra=extra)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, ckpt_dir, tree, *, step, extra=None):
        self.wait()
        leaves = _host(tree)          # the copy to the host, synchronous

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
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def restore(ckpt_dir: Union[str, Path], target: Any
            ) -> tuple[Any, int, dict]:
    """Load a checkpoint into ``target``'s structure: each leaf as a tensor
    of the target leaf's dtype on its device. A leaf missing from the
    checkpoint raises KeyError, a shape that differs ValueError. Returns
    (tree, step, extra)."""
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / MANIFEST).read_text())
    leaves = []
    for path, leaf in tree_flatten_with_path(target):
        key = _key(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        info = manifest["leaves"][key]
        t = _from_storable(np.load(ckpt_dir / info["file"]), info["dtype"])
        want = tuple(getattr(leaf, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"{want}")
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
