"""Runtime distribution context (mesh + axis roles), threaded implicitly.

Avoids plumbing mesh handles through every layer signature: the train/serve
step factories set the context; attention/MoE read it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Optional[object] = None
    cp_axis: Optional[str] = None     # context-parallel axis for long decode
    ep_axis: str = "model"


_CURRENT = DistContext()


def current() -> DistContext:
    return _CURRENT


@contextlib.contextmanager
def use_context(**kw):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = dataclasses.replace(prev, **kw)
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev
