"""Fault-tolerant training example on the port: train, snapshot
asynchronously, simulate a node crash, resume from the latest checkpoint,
verify the trajectory is identical (stateless data pipeline +
deterministic resume).

  PYTHONPATH=src python examples_torch/train_with_restart.py \\
      [--arch gpt2-smoke] [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import as_tensors, make_pipeline
from repro_torch.ft_runtime import (AsyncCheckpointer, StragglerMonitor,
                                    latest_step, restore)
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import init_state, make_train_step


def main(argv=None, *, params=None) -> dict:
    """``params``: the initial weights (drawn from seed 0 by default).
    Returns both runs' final losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt2-smoke")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    model = build_model(cfg, device=args.device)
    opt = AdamW(lr=warmup_cosine(5e-3, warmup=5, total=40))
    data = make_pipeline(cfg, global_batch=8, seq_len=32, seed=0)
    step_fn = make_train_step(model, opt)
    ckpt = AsyncCheckpointer()
    mon = StragglerMonitor()

    def fresh_state():
        state = init_state(model, opt,
                           torch.Generator(model.device).manual_seed(0))
        return state if params is None else state._replace(params=params)

    def batch(i):
        return as_tensors(data.batch(i), model.device)

    with tempfile.TemporaryDirectory(prefix="efta_ckpt_") as tmp:
        root = Path(tmp)
        state = fresh_state()
        print("run A: training 20 steps, async checkpoint at step 10")
        for i in range(20):
            mon.step_start()
            state, metrics = step_fn(state, batch(i))
            v = mon.step_end()
            if i + 1 == 10:
                ckpt.save_async(root / f"step_{i + 1}", state, step=i + 1)
                print(f"  step {i + 1}: loss {float(metrics['loss']):.4f} "
                      f"(snapshot in flight, {v.step_time:.3f}s/step)")
        ckpt.wait()
        loss_a = float(metrics["loss"])

        print("simulated crash. run B: resume from latest checkpoint")
        state_b, step0, _ = restore(latest_step(root), fresh_state())
        print(f"  resumed at step {step0}")
        for i in range(step0, 20):
            state_b, metrics_b = step_fn(state_b, batch(i))
        loss_b = float(metrics_b["loss"])
    print(f"run A final loss {loss_a:.6f} | run B final loss {loss_b:.6f}")
    np.testing.assert_allclose(loss_a, loss_b, rtol=1e-5)
    print("OK: crash-resume reproduced the exact training trajectory.")
    return {"loss_a": loss_a, "loss_b": loss_b, "resumed_at": step0}


if __name__ == "__main__":
    main()
