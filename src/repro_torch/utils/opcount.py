"""Op, FLOP, byte, collective and live-memory counts of eager PyTorch code:
the port's counterpart of the JAX package's ``utils/hlo.py``.

The port has no HLO. What the reference reads from a compiled module, the
port counts while the code runs, under one context manager::

    with opcount(arguments=(state, batch)) as c:
        step(state, batch)
    c.flops, c.bytes, c.count_ops(), c.collective_bytes(), c.peak_bytes

The code runs on any device: on the meta device nothing is computed and
the counts are those of the same call on the card, since eager PyTorch
dispatches the same aten ops for a meta tensor as for a CUDA one.

* **Ops** (:meth:`OpCount.count_ops`) by the reference's classes: ``dot``
  the aten matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``matmul``), ``convolution`` aten's convolutions, ``custom-call`` the
  launches of the port's kernels (B1, B2; each wrapper calls
  :func:`record_launch`), and ``fusion`` every other aten op, views
  included. Eager PyTorch does not fuse: a ``fusion`` here is one aten op,
  where the reference's is one fused XLA computation. ``while`` stays 0:
  the port's loops run in Python, and every trip counts.
* **FLOPs**: ``torch.utils.flop_counter``'s formulas for aten ops, plus
  each kernel launch's own FLOPs as its wrapper records them (B2 by
  :func:`~repro_torch.kernels.efta_attention.efta_attention_work`; B1's
  launches count as calls only, since its work depends on the contents of
  its block tables).
* **Bytes**: each op's input and output tensor bytes (an op that returns a
  view of its input moves none), plus each launch's recorded bytes. This
  is the port's eager traffic, an upper bound against a fused program.
* **Collectives** (:meth:`OpCount.collective_bytes`): bytes per kind, by
  the reference's names, read from :data:`repro_torch.distributed.
  collectives.traffic` (reset when the context opens): the result bytes,
  so an all-gather counts what it received, as ``hlo.py`` counts it.
* **Peak live bytes a device** (:attr:`OpCount.peak_bytes`): the
  ``arguments``' bytes plus the most bytes that storages made under the
  context held at once, meta included. Sizes round up to 512 bytes, as
  the CUDA caching allocator rounds a block, so the count reads like
  ``torch.cuda.max_memory_allocated`` taken over the same call.

Ops outside ``aten`` (the ``c10d`` collectives among them) are not
counted as ops: the collectives count in ``traffic``. Nor is
``lift_fresh``, which wraps host data in a tensor and does no work on any
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives

OP_CLASSES = ("fusion", "custom-call", "while", "dot", "convolution")

# the port's traffic kinds by the reference's names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "collective_permute": "collective-permute"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}
# wrapping host data in a tensor: no work of any device (on the card,
# torch.utils.checkpoint's copies of the CUDA RNG state are such)
_HOST = {"lift_fresh", "lift"}
BLOCK = 512          # the CUDA caching allocator's rounding of a block


def block_bytes(nbytes: int) -> int:
    """``nbytes`` rounded up to the allocator's 512-byte blocks."""
    return -(-int(nbytes) // BLOCK) * BLOCK


def _tensors(x):
    """The tensors of an op's arguments or outputs."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def tree_tensors(tree):
    """The tensors of a tree of dicts, sequences, NamedTuples and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)


def tree_bytes(*trees) -> Dict[str, int]:
    """Bytes of the distinct storages of ``trees``' tensors, in 512-byte
    blocks, by device."""
    seen, out = set(), defaultdict(int)
    for tree in trees:
        for t in tree_tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                out[str(t.device)] += block_bytes(st.nbytes())
    return dict(out)


@dataclasses.dataclass
class OpCount:
    """The counts of one :func:`opcount` context (read them after it
    closes)."""

    ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(OP_CLASSES, 0))
    aten: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    aten_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    flops: int = 0
    bytes: int = 0
    launches: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    argument_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def count_ops(self) -> Dict[str, int]:
        return dict(self.ops)

    def collective_bytes(self) -> Dict[str, int]:
        """Result bytes per collective kind, by the reference's names."""
        return {_KINDS.get(k, k): v["bytes"]
                for k, v in self.collectives.items()}


_ACTIVE: List[OpCount] = []


def record_launch(name: str,
                  work: Callable[[], Tuple[int, int]] = lambda: (0, 0)
                  ) -> None:
    """One launch of kernel ``name`` in every open :func:`opcount` context
    (a kernel wrapper calls this where it launches, or stands in for a
    launch on meta). ``work()`` gives the launch's (bytes, flops); it is
    called only when a context is open, so an uncounted launch pays for
    nothing but this test."""
    if not _ACTIVE:
        return
    nbytes, flops = work()
    for c in _ACTIVE:
        c.ops["custom-call"] += 1
        c.flops += int(flops)
        c.bytes += int(nbytes)
        e = c.launches.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0})
        e["calls"] += 1
        e["bytes"] += int(nbytes)
        e["flops"] += int(flops)


class _Mode(TorchDispatchMode):
    """Counts each aten op and tracks the storages its outputs made."""

    def __init__(self, count: OpCount):
        super().__init__()
        self.c = count
        self.lock = threading.RLock()
        self.live: Dict[int, tuple] = {}
        self.now: Dict[str, int] = defaultdict(int)

    def _free(self, key):
        with self.lock:
            dev, n = self.live.pop(key)
            self.now[dev] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace != "aten" or name in _HOST:
            return out
        c = self.c
        cls = ("dot" if name in _DOTS else
               "convolution" if name in _CONVS else "fusion")
        with self.lock:
            c.ops[cls] += 1
            c.aten[name] += 1
            if func.overloadpacket in flop_registry:
                c.flops += int(flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out))
            ins = list(_tensors((args, kwargs)))
            outs = list(_tensors(out))
            if not func.is_view:
                n = sum(t.numel() * t.element_size() for t in ins + outs)
                c.bytes += n
                c.aten_bytes[name] += n
            given = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in given or key in self.live:
                    continue
                dev, n = str(t.device), block_bytes(st.nbytes())
                self.live[key] = (dev, n)
                self.now[dev] += n
                top = self.now[dev] + c.argument_bytes.get(dev, 0)
                if top > c.peak_bytes.get(dev, 0):
                    c.peak_bytes[dev] = top
                weakref.finalize(st, self._free, key)
        return out


@contextlib.contextmanager
def opcount(*, arguments=()):
    """Count what runs in the context (see the module docstring).
    ``arguments``: trees whose tensors the call takes and which live
    through it (the state, cache and batch); their bytes start the peak."""
    c = OpCount(argument_bytes=tree_bytes(*arguments))
    c.peak_bytes = dict(c.argument_bytes)
    collectives.reset_traffic()
    _ACTIVE.append(c)
    try:
        with _Mode(c):
            yield c
    finally:
        _ACTIVE.remove(c)
        c.collectives = {k: dict(v) for k, v in collectives.traffic.items()}
        c.aten, c.aten_bytes = dict(c.aten), dict(c.aten_bytes)
