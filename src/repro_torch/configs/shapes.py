"""The assigned input-shape suite (4 shapes x 10 archs = 40 cells).

``long_500k`` lowers ``serve_step`` with a 524288-token KV context and needs
sub-quadratic attention: it runs for ssm/hybrid/sliding-window archs and is
skipped (with the reason recorded) for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# Archs with sub-quadratic sequence handling (SSM state, hybrid, or
# sliding-window-dominated attention) run long_500k; pure full-attention
# archs skip it (recorded in DESIGN.md §Arch-applicability).
SUBQUADRATIC = {"rwkv6-7b", "hymba-1.5b", "gemma3-1b"}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (per assignment note)"
    return True, ""
