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
given. ``--mesh pod|multipod`` waits for the port's distributed slice.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data import as_tensors, make_pipeline
from repro_torch.ft_runtime import (AsyncCheckpointer, FaultRateMonitor,
                                    StragglerMonitor, latest_step, restore)
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import init_state, make_train_step
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
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh} waits for the distributed slice of "
            f"repro_torch (ROADMAP, Queue A, item 4)")

    cfg = get_config(args.arch)
    model = build_model(cfg, device=args.device)
    opt = AdamW(lr=warmup_cosine(args.lr, warmup=10, total=args.steps))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    state = init_state(model, opt, gen)
    start_step = 0
    if args.resume and args.ckpt_dir:
        ck = latest_step(args.ckpt_dir)
        if ck is not None:
            state, start_step, _ = restore(ck, state)
            log.info("resumed from %s at step %d", ck, start_step)

    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
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
                            state, step=step + 1)
    ckpt.wait()
    log.info("done: %d steps on %s", args.steps - start_step, model.device)
    return state, metrics


if __name__ == "__main__":
    main()
