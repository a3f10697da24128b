"""Training launcher of ``repro_torch``: EFTA-protected LM training with the
FT runtime (async checkpoints, straggler monitor, fault-rate escalation,
resume), the JAX package's ``launch/train.py`` on one device.

  python -m repro_torch.launch.train --arch gpt2 --steps 100 --batch 8 \\
      --seq 1024
  python -m repro_torch.launch.train --arch gpt2-smoke --device cpu \\
      --steps 60 --batch 8 --seq 64 --ckpt-dir ckpt --ckpt-every 20
  python -m repro_torch.launch.train --arch gpt2-smoke --device cpu \\
      --steps 80 --ckpt-dir ckpt --resume

Weights are random, drawn from ``--seed``; the data is the synthetic
pipeline of the same seed. Runs on the GPU unless ``--device cpu`` is
given.

``--mesh pod|multipod`` trains on the production mesh (16 x 16 ranks, or 2
x 16 x 16) under torchrun: the process group comes from its environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; on the GPU
each rank takes ``cuda:LOCAL_RANK``), its backend from ``--device``
(``nccl`` for cuda, ``gloo`` for cpu), and too few ranks raise
RuntimeError. Every rank draws the whole state from the seed and keeps
its blocks; checkpoints are written whole by rank 0 and restore onto any
mesh.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import as_tensors, make_pipeline
from repro_torch.distributed.sharding import shard_tree
from repro_torch.ft_runtime import (AsyncCheckpointer, FaultRateMonitor,
                                    StragglerMonitor, latest_step, restore)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import init_state, make_train_step, state_specs
from repro_torch.utils import get_logger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["none", "pod", "multipod"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    log = get_logger("repro_torch.train")
    if args.mesh == "none":
        return _train(args, log, mesh=None)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    try:
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        return _train(args, log, mesh=mesh, device=device)
    finally:
        dist.destroy_process_group()


def _train(args, log, *, mesh, device=None):
    cfg = get_config(args.arch)
    model = build_model(cfg, device=device or args.device)
    opt = AdamW(lr=warmup_cosine(args.lr, warmup=10, total=args.steps))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    state = init_state(model, opt, gen)
    specs = None
    if mesh is not None:
        specs = state_specs(model, mesh)
        state = shard_tree(state, specs, mesh)
    start_step = 0
    if args.resume and args.ckpt_dir:
        ck = latest_step(args.ckpt_dir)
        if ck is not None:
            state, start_step, _ = restore(ck, state, mesh=mesh,
                                           shardings=specs)
            log.info("resumed from %s at step %d", ck, start_step)

    step_fn = make_train_step(model, opt, mesh=mesh,
                              microbatches=args.microbatches)
    data = make_pipeline(cfg, global_batch=args.batch, seq_len=args.seq,
                         seed=args.seed)
    ckpt = AsyncCheckpointer()
    straggler = StragglerMonitor()
    faults = FaultRateMonitor()
    metrics = None
    for step in range(start_step, args.steps):
        straggler.step_start()
        batch = as_tensors(data.batch(step), model.device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        v = straggler.step_end()
        detected = metrics["ft_detected"].tolist()
        if faults.observe(int(sum(detected))) == "cordon":
            log.warning("sustained EFTA fault rate: cordon + elastic restart "
                        "advised (see ft_runtime.elastic)")
        if v.is_straggler:
            log.warning("straggler step %d: %.3fs (median %.3fs)", step,
                        v.step_time, v.median)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %4d loss %.4f ce %.4f ft=%s %.3fs/step", step,
                     loss, float(metrics["ce"]), detected, v.step_time)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(os.path.join(args.ckpt_dir, f"step_{step+1}"),
                            state, step=step + 1, mesh=mesh,
                            shardings=specs)
    ckpt.wait()
    log.info("done: %d steps on %s", args.steps - start_step, model.device)
    return state, metrics


if __name__ == "__main__":
    main()
