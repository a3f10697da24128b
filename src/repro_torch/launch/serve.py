"""Serving launcher of ``repro_torch``: the ring-cache serve engine by
default, the checksummed paged engine with ``--paged``.

  python -m repro_torch.launch.serve --arch gpt2 --attn-impl efta_pallas
  python -m repro_torch.launch.serve --arch gpt2-smoke --device cpu \\
      --requests 4 --slots 2 --gen 6 --inject-faults 2 --ft-mode detect
  python -m repro_torch.launch.serve --arch gpt2 --paged --kernel fused
  python -m repro_torch.launch.serve --arch gpt2-smoke --paged --kernel fused \\
      --device cpu --requests 4 --slots 2 --gen 6 --inject-faults 2 --kv-flips 1
  python -m repro_torch.launch.serve --arch gpt2 --speculate ngram --kernel fused
  python -m repro_torch.launch.serve --arch gpt2-smoke --device cpu \\
      --speculate draft --draft-len 4 --kernel gather
  python -m repro_torch.launch.serve --arch gpt2 --paged --kernel gather \\
      --kv-verify stamped --scrub-interval 4 --kv-flips 2
  python -m repro_torch.launch.serve --arch t5-small-smoke --device cpu \\
      --requests 2 --gen 4
  python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b-smoke --device cpu \\
      --paged --kernel fused
  python -m repro_torch.launch.serve --arch rwkv6-7b-smoke --device cpu
  python -m repro_torch.launch.serve --arch llama-3.2-vision-11b-smoke \
      --device cpu --attn-impl efta_pallas

Weights are random, drawn from ``--seed``. Runs on the GPU unless
``--device cpu`` is given. ``--speculate`` implies ``--paged``; the paged
backend defaults to ``gather``, as in the JAX package. The engines serve
the decoder-only attention families (dense, moe); the encoder,
encoder-decoder, ssm, hybrid and vlm families go through the static-batch
greedy loop (``greedy_generate``).
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
                               batch_faults, greedy_generate)


def _static_batch_serve(cfg, model, params, rng, args, log):
    """The families the continuous-batching engines do not serve (the
    encoder, encoder-decoder, ssm, hybrid and vlm ones): one static batch
    of ``--requests`` prompts of ``--max-prompt`` random tokens through
    ``greedy_generate``, with random frontend frames (audio) or patch
    embeddings (vlm), or encoder tokens of ones (enc-dec, 8 per
    request)."""
    dev = model.device
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.max_prompt)),
        device=dev).long()
    kw = {}
    if cfg.family in ("vlm", "audio"):
        kw["frontend"] = torch.as_tensor(rng.standard_normal(
            (args.requests, cfg.frontend_tokens, cfg.d_model)) * 0.1,
            dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        kw["enc_tokens"] = torch.ones((args.requests, 8), dtype=torch.long,
                                      device=dev)
    t0 = time.perf_counter()
    out, rep = greedy_generate(model, params, tokens, steps=args.gen, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log.info("static-batch served %s tokens in %.2fs (%.1f tok/s) on %s; "
             "EFTA detected=%s", tuple(out.shape), dt, out.numel() / dt, dev,
             rep.detected.sum(dim=0).tolist())
    print(out.cpu().numpy())


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
    ap.add_argument("--kernel", choices=("gather", "fused"), default=None,
                    help="paged backend: 'gather' materializes each table as "
                         "a contiguous view and verifies checksums outside "
                         "attention (default); 'fused' consumes block tables "
                         "in the paged EFTA kernel with in-loop verification")
    ap.add_argument("--kv-verify", choices=("always", "stamped"),
                    default="always",
                    help="gather-backend read-time verify policy: 'stamped' "
                         "skips blocks untouched since their last verified "
                         "read (detection of a flip there waits for the "
                         "block's next write or the next scrub pass)")
    ap.add_argument("--scrub-interval", type=int, default=0,
                    help="with --kv-verify stamped: re-fold the oldest-"
                         "verified blocks every N committed steps (0 = off)")
    ap.add_argument("--scrub-batch", type=int, default=4,
                    help="blocks re-folded per scrub pass")
    ap.add_argument("--speculate", choices=("off", "ngram", "draft"),
                    default="off",
                    help="speculative decoding through the propose→score→"
                         "accept step (implies --paged): 'ngram' self-drafts "
                         "by prompt lookup, 'draft' decodes a draft model "
                         "(--draft-model) through the same EFTA path; "
                         "rejected rows roll back with checksum-verified "
                         "truncation")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="max draft tokens proposed per request per step")
    ap.add_argument("--draft-model", default="",
                    help="arch of the draft model for --speculate draft "
                         "(default: the serving arch with its weights — "
                         "self-drafting, acceptance ~1)")
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
    if args.speculate != "off":
        args.paged = True              # the propose→score→accept step is
        #                                the paged engine's contract
    if not args.paged and (args.kernel is not None
                           or args.kv_verify != "always"
                           or args.chunk_size or args.chunk_budget
                           or args.scrub_interval or args.kv_flips):
        ap.error("--kernel/--kv-verify/--chunk-size/--chunk-budget/"
                 "--scrub-interval/--kv-flips configure the paged engine; "
                 "add --paged")
    args.kernel = args.kernel or "gather"
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
    if cfg.family not in ("dense", "moe"):
        if args.paged:
            ap.error(f"the paged engine serves the dense and moe families; "
                     f"{cfg.name} is {cfg.family!r}")
        _static_batch_serve(cfg, model, params, rng, args, log)
        return
    if args.paged:
        draft_model = draft_params = None
        if args.speculate == "draft":
            dcfg = get_config(args.draft_model or args.arch)
            if args.ft_mode:
                dcfg = dataclasses.replace(
                    dcfg, ft=dataclasses.replace(dcfg.ft, mode=args.ft_mode))
            draft_model = build_model(dcfg, device=args.device)
            if not args.draft_model or args.draft_model == args.arch:
                draft_params = params      # self-drafting: share weights
            else:
                dgen = torch.Generator(device=draft_model.device)
                dgen.manual_seed(args.seed + 1)
                draft_params = draft_model.init(dgen)
        eng = PagedServeEngine(model, params, n_slots=args.slots,
                               cache_len=args.cache_len or None,
                               block_size=args.block_size,
                               num_blocks=args.num_blocks or None,
                               chunk_size=args.chunk_size or None,
                               chunk_budget=args.chunk_budget or None,
                               kernel=args.kernel, kv_verify=args.kv_verify,
                               scrub_interval=args.scrub_interval,
                               scrub_batch=args.scrub_batch,
                               speculate=args.speculate,
                               draft_len=args.draft_len,
                               draft_model=draft_model,
                               draft_params=draft_params)
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
        log.info("paged cache (%s): prefix hits=%d/%d tokens, kv "
                 "detected=%d repaired=%d verified=%d verify-skips=%d "
                 "scrubbed=%d preemptions=%d chunked-prefill tokens=%d "
                 "chunk widths=%s", args.kernel, xs.hit_tokens,
                 xs.lookup_tokens, ps.kv_detected_blocks,
                 ps.kv_repaired_blocks, ps.kv_verified_blocks,
                 ps.kv_verify_skips, ps.kv_scrubbed_blocks, ps.preemptions,
                 ps.chunked_prefill_tokens, sorted(eng.chunk_widths))
        if args.speculate != "off":
            log.info("speculation (%s): acceptance=%.2f (%d/%d drafts), "
                     "spec steps=%d, tokens/step=%.2f, rolled-back rows=%d, "
                     "rollback-guard detections=%d",
                     args.speculate, eng.acceptance_rate,
                     ps.spec_accepted_tokens, ps.spec_proposed_tokens,
                     ps.spec_steps,
                     eng.stats.tokens / max(eng.stats.steps, 1),
                     ps.spec_rolled_back_rows, ps.rollback_detected_blocks)
    else:
        log.info("ring cache: %d prefills (%d prompt forwards), attention "
                 "%s", eng.stats.prefills, eng.stats.prefill_forwards,
                 cfg.ft.attn_impl)
    print({rid: outs[rid].tolist() for rid in sorted(outs)})


if __name__ == "__main__":
    main()
