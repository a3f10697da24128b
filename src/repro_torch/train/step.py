"""The train step: the loss's gradients (through plain-PyTorch EFTA and the
remat policy of ``cfg.remat``), microbatch gradient accumulation, and the
AdamW update, as the JAX package's ``make_train_step``.

With ``microbatches`` > 1 the batch is split on its leading axis, each
slice's gradients are added into f32 buffers and divided by the count at
the end; the loss is the mean of the slices' and the metrics are the last
slice's, as in the reference.

On a ``mesh`` (:class:`~repro_torch.distributed.mesh.Mesh`) every rank is
given the global batch and the state holds each rank's blocks of the
leaves under :func:`state_specs`. ``pod_sync``:

* ``"dense"`` — ZeRO-3 storage and data parallelism: a rank takes its
  block of the batch over the data-parallel axes (``batch_sharding``),
  gathers the parameters (whole, but for the MoE experts, which keep the
  block that :func:`~repro_torch.models.moe.expert_spec` gives), and
  computes the loss, which is the global batch's (sums and counts summed
  over the ranks, as GSPMD's one-device step computes it), and its share
  of the gradients. The shares are summed in f32 over the data-parallel
  axes that do not split the leaf, the gradient is clipped by its global
  norm, and each rank updates the blocks of parameters and moments that
  its spec gives it. The ``model`` axis computes the dense layers alike on
  every rank (the reference's tensor parallelism is a placement).
* ``"int8_ef"`` with a ``pod`` axis of size above 1 — the compressed
  cross-pod sync: the state is whole on every rank, each pod computes the
  mean loss and gradients of its block of the batch (every rank of a pod
  alike, the model whole: the reference's ``shard_map`` has every axis
  manual), each gradient leaf goes through ``compressed_psum`` over
  ``pod`` with its ``ef`` residual, and the update is replicated. The loss
  is the mean of the pods' means (with an uneven mask, not the global
  mean: a difference from ``"dense"`` that the reference has too). Each
  pod keeps its own residual, as error feedback needs; a checkpoint keeps
  rank 0's (pod 0's). Two differences from the reference, whose
  ``shard_map`` returns pod-varying values through ``out_specs=P()``
  unchecked (``check_vma=False``): it carries device 0's residual to
  every pod into the next step, and it computes the mean loss but returns
  the metrics of device 0's pod; here ``metrics["loss"]`` is the mean.
  Without a pod axis of size above 1, ``int8_ef`` takes the dense path, as
  the reference's condition does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (dp_axes, local_block,
                                              param_shardings, reshard,
                                              spec_axes)
from repro_torch.models.api import Model
from repro_torch.models.moe import expert_spec
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import (path_str, tree_flatten_with_path,
                                    tree_leaves, tree_map,
                                    tree_unflatten_like)


def _check_sync(pod_sync: str) -> None:
    if pod_sync not in ("dense", "int8_ef"):
        raise ValueError(f"unknown pod_sync {pod_sync!r}")


def _compressed(mesh, pod_sync: str) -> bool:
    return (pod_sync == "int8_ef" and mesh is not None
            and mesh.shape.get("pod", 1) > 1)


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               *, pod_sync: str = "dense") -> TrainState:
    """Parameters drawn from ``generator`` on the model's device, zeroed
    moments, step 0; under ``int8_ef`` bf16 zeros of the parameters' shapes
    as the error-feedback residuals. Whole: on a mesh, cut each rank's
    blocks with ``shard_tree(state, state_specs(...), mesh)``."""
    _check_sync(pod_sync)
    params = model.init(generator)
    ef = None
    if pod_sync == "int8_ef":
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                            device=p.device), params)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device), ef=ef)


def state_specs(model: Model, mesh, *, pod_sync: str = "dense"
                ) -> TrainState:
    """The spec of every leaf of the train state on ``mesh``: the
    parameters', and the moments and residuals alike, by the sharding
    rules (whole under the compressed sync); the count and the step
    whole."""
    _check_sync(pod_sync)
    shapes = init_params(torch.Generator(), model.cfg, "meta")
    if _compressed(mesh, pod_sync):
        ps = tree_map(lambda p: (None,) * p.dim(), shapes)
    else:
        ps = param_shardings(shapes, mesh)
    return TrainState(params=ps, opt=AdamWState(m=ps, v=ps, count=()),
                      step=(), ef=ps if pod_sync == "int8_ef" else None)


def compute_specs(model: Model, mesh, *, mode: str = "train"):
    """The layout the model computes with on ``mesh`` in ``mode`` (the
    forward's): every parameter whole, but the MoE experts, in the block
    :func:`~repro_torch.models.moe.expert_spec` gives."""
    shapes = init_params(torch.Generator(), model.cfg, "meta")
    experts = (expert_spec(mesh, model.cfg.moe, mode=mode)
               if model.cfg.moe is not None else {})
    flat = []
    for path, p in tree_flatten_with_path(shapes):
        name = path_str(path)
        leaf = name.rsplit("/", 1)[-1]
        spec = (None,) * p.dim()
        if "moe/" in name and leaf in experts:
            spec = (None,) * (p.dim() - 3) + experts[leaf]
        flat.append(spec)
    return tree_unflatten_like(shapes, flat)


def value_and_grad(model: Model, params, batch, *, mesh=None):
    """(loss, metrics, grads in the parameters' dtypes) of one batch."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten_like(params, leaves),
                                   batch, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (a table row past the sequence) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten_like(params, grads)


def _clipped_update(optimizer: AdamW, grads, state: TrainState, sq):
    """The AdamW update of blocks: ``sq`` is the global gradient's sum of
    squares (the blocks cannot give it); the clip scale is applied to the
    f32 gradients as the update applies it, the rest is the update's."""
    if optimizer.clip_norm is not None:
        gn = torch.sqrt(sq)
        scale = torch.clamp(optimizer.clip_norm / torch.clamp(gn, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
        optimizer = dataclasses.replace(optimizer, clip_norm=None)
    return optimizer.update(grads, state.opt, state.params)


def make_train_step(model: Model, optimizer: AdamW, *, mesh=None,
                    microbatches: int = 1, pod_sync: str = "dense"):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    the (global_batch, ...) tensors on the model's device."""
    _check_sync(pod_sync)
    compressed = _compressed(mesh, pod_sync)
    loss_mesh = None if compressed else mesh
    split_axes = ()
    if mesh is not None:
        split_axes = ("pod",) if compressed else dp_axes(mesh)

    def cut(batch):
        if mesh is None or mesh.size(split_axes) == 1:
            return batch
        return {k: local_block(v, (split_axes,) + (None,) * (v.dim() - 1),
                               mesh) for k, v in batch.items()}

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(model, params, cut(batch), mesh=loss_mesh)
        split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=model.device)
        for i in range(microbatches):
            loss, metrics, g = value_and_grad(
                model, params, cut({k: v[i] for k, v in split.items()}),
                mesh=loss_mesh)
            acc = tree_map(lambda a, gi: a + gi, acc, g)
            loss_acc = loss_acc + loss
        grads = tree_map(lambda a: a / microbatches, acc)
        return loss_acc / microbatches, metrics, grads

    if mesh is None:
        def step(state: TrainState, batch):
            _, metrics, grads = grads_of(state.params, batch)
            new_params, new_opt = optimizer.update(grads, state.opt,
                                                   state.params)
            return TrainState(new_params, new_opt, state.step + 1,
                              state.ef), metrics
        return step

    if compressed:
        pod = mesh.group("pod")

        def step(state: TrainState, batch):
            loss, metrics, grads = grads_of(state.params, batch)
            pairs = [coll.compressed_psum(g, pod, e) for g, e in
                     zip(tree_leaves(grads), tree_leaves(state.ef))]
            grads = tree_unflatten_like(grads, [g for g, _ in pairs])
            new_ef = tree_unflatten_like(state.ef, [e for _, e in pairs])
            metrics = dict(metrics, loss=coll.all_reduce(loss, pod)
                           / mesh.shape["pod"])
            new_params, new_opt = optimizer.update(grads, state.opt,
                                                   state.params)
            return TrainState(new_params, new_opt, state.step + 1,
                              new_ef), metrics
        return step

    pspecs = state_specs(model, mesh, pod_sync=pod_sync).params
    cspecs = compute_specs(model, mesh)
    dp = dp_axes(mesh)

    def reduce(g, cspec):
        """This leaf's share summed (f32) over the data-parallel axes
        that do not split it."""
        axes = tuple(a for a in dp if a not in spec_axes(cspec))
        g = g.float()
        return coll.all_reduce(g, mesh.group(axes)) \
            if mesh.size(axes) > 1 else g

    def sq_sum(g, cspec):
        """The global leaf's sum of squares from this rank's block."""
        axes = spec_axes(cspec)
        sq = g.float().square().sum()
        return coll.all_reduce(sq, mesh.group(axes)) \
            if mesh.size(axes) > 1 else sq

    def step(state: TrainState, batch):
        params = tree_map(lambda t, s, c: reshard(t, s, c, mesh),
                          state.params, pspecs, cspecs)
        _, metrics, grads = grads_of(params, batch)
        grads = tree_map(reduce, grads, cspecs)
        sq = 0
        for g in tree_leaves(tree_map(sq_sum, grads, cspecs)):
            sq = sq + g
        grads = tree_map(lambda g, c, s: reshard(g, c, s, mesh),
                         grads, cspecs, pspecs)
        new_params, new_opt = _clipped_update(optimizer, grads, state, sq)
        return TrainState(new_params, new_opt, state.step + 1,
                          state.ef), metrics
    return step
