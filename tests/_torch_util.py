"""Helpers shared by the ``test_torch_*`` parity tests: numpy <-> torch
conversion and the check for tests that need an NVIDIA card (decided inside
the test, never at import or collection time)."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cuda_or_skip() -> torch.device:
    """The card for a ``cuda``-marked test; skips with a reason without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); run on the card with python3 chip_smoke.py")
    return torch.device("cuda")
