"""Serving launcher of ``repro_torch``: the ring-cache serve engine by
default, the checksummed paged engine with ``--paged``.

  python -m repro_torch.launch.serve --arch gpt2 --attn-impl efta_pallas
  python -m repro_torch.launch.serve --arch gpt2-smoke --device cpu \\
      --requests 4 --slots 2 --gen 6 --inject-faults 2 --ft-mode detect
  python -m repro_torch.launch.serve --arch gpt2 --paged --kernel fused
  python -m repro_torch.launch.serve --arch gpt2-smoke --paged --kernel fused \\
      --device cpu --requests 4 --slots 2 --gen 6 --inject-faults 2 --kv-flips 1

Weights are random, drawn from ``--seed``. Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.fault import FaultSpec, Site
from repro_torch.models import build_model
from repro_torch.kernels.ops import IMPLS
from repro_torch.serve import (PagedServeEngine, SamplingParams, ServeEngine,
                               batch_faults)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--paged", action="store_true",
                    help="serve from the checksummed paged KV block pool "
                         "(default: per-slot ring KV caches)")
    ap.add_argument("--attn-impl", choices=IMPLS, default=None,
                    help="override the config's attention implementation "
                         "(ring engine; efta_pallas = the fused kernel)")
    ap.add_argument("--kernel", choices=("fused",), default="fused")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="KV slots per request (0 = model max_seq)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="unified step chunk width (0 = 2 * block_size)")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="max prompt tokens per mixed step (0 = unbounded)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--inject-faults", type=int, default=0,
                    help="number of steps hit by a random compute-site SEU")
    ap.add_argument("--kv-flips", type=int, default=0,
                    help="random resident KV-block bit flips injected "
                         "between steps (paged engine)")
    ap.add_argument("--ft-mode", default=None,
                    help="override the config's EFTA mode (off/detect/correct)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.kv_flips and not args.paged:
        ap.error("--kv-flips strikes the paged block pool; add --paged")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("repro_torch.serve")

    cfg = get_config(args.arch)
    if args.ft_mode:
        cfg = dataclasses.replace(
            cfg, ft=dataclasses.replace(cfg.ft, mode=args.ft_mode))
    if args.attn_impl:
        cfg = dataclasses.replace(
            cfg, ft=dataclasses.replace(cfg.ft, attn_impl=args.attn_impl))
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    rng = np.random.default_rng(args.seed)
    if args.paged:
        eng = PagedServeEngine(model, params, n_slots=args.slots,
                               cache_len=args.cache_len or None,
                               block_size=args.block_size,
                               num_blocks=args.num_blocks or None,
                               chunk_size=args.chunk_size or None,
                               chunk_budget=args.chunk_budget or None,
                               kernel=args.kernel)
    else:
        eng = ServeEngine(model, params, n_slots=args.slots,
                          cache_len=args.cache_len or None)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed)
    for _ in range(args.requests):
        t = int(rng.integers(2, args.max_prompt + 1))
        eng.submit(rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32),
                   max_new_tokens=args.gen, sampling=sampling)

    faults_by_step = {}
    n_faults = min(args.inject_faults, args.gen)
    for step in rng.choice(args.gen, size=n_faults, replace=False):
        slot = int(rng.integers(0, args.slots))
        spec = FaultSpec.single(
            Site(int(rng.choice([0, 2, 3, 4]))),
            block=0, batch=0,
            head=int(rng.integers(0, cfg.attn.num_heads)),
            row=0, col=int(rng.integers(0, min(16, cfg.attn.head_dim))),
            bit=int(rng.integers(22, 30)))
        faults_by_step[int(step)] = batch_faults(args.slots, {slot: spec})

    t0 = time.perf_counter()
    i, flips_left = 0, args.kv_flips
    while eng.scheduler.has_work:
        live = [r for r in eng.scheduler.active_rows()
                if args.paged and not r.is_done() and eng._pos[r.slot] > 0]
        if live and flips_left and rng.integers(0, 2):
            req = live[int(rng.integers(0, len(live)))]
            j = int(rng.integers(0, len(req.block_ids)))
            eng.inject_kv_fault(
                layer=int(rng.integers(0, cfg.num_layers)),
                block=req.block_ids[j],
                head=int(rng.integers(0, cfg.attn.num_kv_heads)),
                row=int(rng.integers(0, args.block_size)),
                col=int(rng.integers(0, cfg.attn.head_dim)),
                bit=int(rng.integers(24, 31)),
                into="k" if rng.integers(0, 2) else "v")
            flips_left -= 1
        eng.step(faults=faults_by_step.get(i))
        i += 1
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs = {r.rid: np.asarray(r.generated, np.int32)
            for r in eng.scheduler.finished}
    log.info("served %d requests (%d tokens) in %.2fs (%.1f tok/s) on %s "
             "over %d slots in %d engine steps", len(outs), eng.stats.tokens,
             dt, eng.stats.tokens / dt, model.device, args.slots,
             eng.stats.steps)
    summ = eng.telemetry.summary()
    log.info("EFTA telemetry: detected=%d retries=%d status=%s",
             summ["detected"], summ["retries"], summ["status"])
    if args.paged:
        ps, xs = eng.paged_stats, eng.pool.prefix.stats
        log.info("paged cache: prefix hits=%d/%d tokens, kv detected=%d "
                 "repaired=%d preemptions=%d chunked-prefill tokens=%d "
                 "chunk widths=%s", xs.hit_tokens, xs.lookup_tokens,
                 ps.kv_detected_blocks, ps.kv_repaired_blocks,
                 ps.preemptions, ps.chunked_prefill_tokens,
                 sorted(eng.chunk_widths))
    else:
        log.info("ring cache: %d prefills (%d prompt forwards), attention "
                 "%s", eng.stats.prefills, eng.stats.prefill_forwards,
                 cfg.ft.attn_impl)
    print({rid: outs[rid].tolist() for rid in sorted(outs)})


if __name__ == "__main__":
    main()
