"""The train step: the loss's gradients (through plain-PyTorch EFTA and the
remat policy of ``cfg.remat``), microbatch gradient accumulation, and the
AdamW update, as the JAX package's ``make_train_step`` on one device.

With ``microbatches`` > 1 the batch is split on its leading axis, each
slice's gradients are added into f32 buffers and divided by the count at
the end; the loss is the mean of the slices' and the metrics are the last
slice's, as in the reference. ``pod_sync="int8_ef"`` (the compressed
cross-pod sync) needs the distributed slice of the port and raises.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)


def _check_sync(pod_sync: str) -> None:
    if pod_sync == "int8_ef":
        raise NotImplementedError(
            "pod_sync='int8_ef' needs distributed/collectives.py::"
            "compressed_psum, which waits for the port's distributed slice "
            "(ROADMAP, Queue A, item 4)")
    if pod_sync != "dense":
        raise ValueError(f"unknown pod_sync {pod_sync!r}")


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               *, pod_sync: str = "dense") -> TrainState:
    """Parameters drawn from ``generator`` on the model's device, zeroed
    moments, step 0."""
    _check_sync(pod_sync)
    params = model.init(generator)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads in the parameters' dtypes) of one batch."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten_like(params, leaves),
                                   batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (a table row past the sequence) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten_like(params, grads)


def make_train_step(model: Model, optimizer: AdamW, *,
                    microbatches: int = 1, pod_sync: str = "dense"):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    (global_batch, ...) tensors on the model's device."""
    _check_sync(pod_sync)

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(model, params, batch)
        split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=model.device)
        for i in range(microbatches):
            loss, metrics, g = value_and_grad(
                model, params, {k: v[i] for k, v in split.items()})
            acc = tree_map(lambda a, gi: a + gi, acc, g)
            loss_acc = loss_acc + loss
        grads = tree_map(lambda a: a / microbatches, acc)
        return loss_acc / microbatches, metrics, grads

    def step(state: TrainState, batch):
        _, metrics, grads = grads_of(state.params, batch)
        new_params, new_opt = optimizer.update(grads, state.opt,
                                               state.params)
        return TrainState(new_params, new_opt, state.step + 1,
                          state.ef), metrics
    return step
