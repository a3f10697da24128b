"""Training state: the JAX package's ``TrainState`` tree (parameters, the
AdamW state, the step counter), so a checkpoint of one package restores
into the other."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor      # int32 scalar
    # error-feedback residuals of the compressed cross-pod gradient sync
    # (pod_sync="int8_ef"); None (no leaf) under pod_sync="dense"
    ef: Any = None
