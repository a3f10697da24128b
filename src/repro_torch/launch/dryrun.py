"""Multi-pod dry run of the port: every (arch x shape x mesh) cell traced
once on the meta device, as one rank of the production mesh.

Each cell runs its real call (the distributed train step, ``Model.prefill``
or ``Model.decode_step``) at full depth and the production shapes, on meta
tensors, as rank 0 of a fake process group of 256 or 512 ranks, under
:func:`~repro_torch.utils.opcount.opcount`. Nothing is computed and
nothing is allocated; what is counted is what the same call would do on
rank 0's card:

  1. MEMORY - rank 0's arguments (its blocks of the train state or the
     parameters, the cache and the batch, by the JAX package's sharding
     rules) plus the most bytes its call held at once: does the cell fit
     one 80 GB card?
  2. ROOFLINE TERMS - the call's FLOPs, bytes and collective bytes on rank
     0, over the card's peak rate, memory rate and network rate.

No probes. The JAX package compiles two shallow unrolled probes a cell
(``probe_plan``, ``probe_config``, ``_extrapolate``) because XLA's
``cost_analysis`` counts a while body once; an eager pass runs every layer
and every loop trip, so it counts them all and needs no extrapolation.

What the port does differs from GSPMD's placement, and the counts are the
port's: the train step reshards every parameter to
:func:`~repro_torch.train.step.compute_specs` (each dense leaf whole on
every rank, the MoE experts blocked), so the serve calls here do the same
first, inside the count; a cache leaf that the rules split along a
non-batch axis (the context-parallel long-decode cache) is gathered whole,
since the port has no context parallelism; each rank runs its rows of the
batch with their own cache positions and cross memory; the train step
takes the global batch and cuts its block itself.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k [--multi-pod] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # resumable
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeCfg, cell_applicable
from repro_torch.distributed.sharding import (_cache_leaves, batch_sharding,
                                              cache_shardings, local_block,
                                              param_shardings, reshard,
                                              shard_tree)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.train.step import (compute_specs, init_state,
                                    make_train_step, state_specs)
from repro_torch.utils.opcount import opcount, tree_bytes, tree_tensors
from repro_torch.utils.tree import tree_map

# NVIDIA H100 SXM5 80GB HBM3, 700 W: the NVIDIA H100 Tensor Core GPU data
# sheet's dense figures (without sparsity), per card
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
PEAK_FLOPS_BY_DTYPE = {"torch.bfloat16": PEAK_FLOPS,
                       "torch.float32": 67e12}      # f32 FLOP/s (no TF32)
HBM_BW = 3.35e12             # HBM3 bytes/s
# one 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7, as in NVIDIA's DGX
# H100): the one link of the collective term, as the reference has one
NET_BW = 50e9                # bytes/s
HBM_BYTES = 80e9             # the card's memory, as "fits" reads it


def cell_config(arch: str, shape_name: str):
    """The cell's model config (with dry-run-appropriate FT block size)."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        cfg = dataclasses.replace(
            cfg, ft=dataclasses.replace(cfg.ft, block_kv=32768))
    if shape_name in ("prefill_32k", "decode_32k"):
        cfg = dataclasses.replace(
            cfg, ft=dataclasses.replace(cfg.ft, block_kv=2048))
    return cfg


def model_flops_estimate(cfg, shape) -> float:
    n_active = cfg.active_param_count_estimate()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


def _shape(shape) -> ShapeCfg:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _block(t, spec, mesh):
    return t if mesh is None else local_block(t, spec, mesh)


def _map_cache(cache, fn, path=""):
    """``cache`` (dataclasses and NamedTuples of tensors) with each tensor
    replaced by ``fn(name, tensor)``, names as ``_cache_leaves`` gives
    them."""
    if cache is None:
        return None
    if dataclasses.is_dataclass(cache):
        names = [f.name for f in dataclasses.fields(cache)]
        return dataclasses.replace(cache, **{
            n: _map_cache(getattr(cache, n), fn, f"{path}/{n}" if path
                          else n) for n in names})
    if isinstance(cache, tuple) and hasattr(cache, "_fields"):
        return cache._replace(**{
            n: _map_cache(getattr(cache, n), fn, f"{path}/{n}" if path
                          else n) for n in cache._fields})
    return fn(path, cache)


def _tokens(shape, vocab, *, device, generator):
    if device.type == "meta":
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return torch.randint(vocab, shape, dtype=torch.int32, device=device,
                         generator=generator)


def _frontend(shape, dtype, *, device, generator):
    if device.type == "meta":
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator).to(dtype)


def input_specs(arch_or_cfg, shape, mesh, *, inference_layout: bool = False,
                device="meta", seed: int = 0):
    """Rank 0's blocks of every input of this cell on ``device`` (meta: no
    allocation; elsewhere random from ``seed``), with their specs.
    ``mesh`` None: one rank, every leaf whole. ``shape``: a name of
    :data:`SHAPES` or a :class:`ShapeCfg`.

    Train: ``state`` (TrainState of blocks) with ``state_specs``, ``batch``
    (blocks) with ``batch_specs``, ``opt``. Serve: ``params`` with
    ``param_specs``, ``cache`` with ``cache_specs`` (by field path),
    ``tokens`` with ``token_spec``, ``extra`` (the frontend) with
    ``extra_specs``. Both: ``model``, ``cfg``, ``shape``."""
    shape = _shape(shape)
    cfg = (arch_or_cfg if not isinstance(arch_or_cfg, str)
           else cell_config(arch_or_cfg, shape.name))
    device = torch.device(device)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = AdamW(lr=warmup_cosine(3e-4),
                    state_dtype="bfloat16" if cfg.dtype == "bfloat16"
                    else None)
        state = init_state(model, opt, gen)
        if mesh is None:
            specs = tree_map(lambda t: (None,) * t.dim(), state)
        else:
            specs = state_specs(model, mesh)
            state = shard_tree(state, specs, mesh)
        batch = {"tokens": _tokens((b, s), cfg.vocab_size, device=device,
                                   generator=gen),
                 "targets": _tokens((b, s), cfg.vocab_size, device=device,
                                    generator=gen)}
        if cfg.family in ("vlm", "audio"):
            batch["frontend"] = _frontend((b, cfg.frontend_tokens,
                                           cfg.d_model), dtype,
                                          device=device, generator=gen)
        bspecs = {k: (None,) * v.dim() if mesh is None else
                  batch_sharding(mesh, v.dim()) for k, v in batch.items()}
        return {"state": state, "state_specs": specs,
                "batch": {k: _block(v, bspecs[k], mesh)
                          for k, v in batch.items()},
                "batch_specs": bspecs, "global_batch": batch, "opt": opt,
                "model": model, "cfg": cfg, "shape": shape}

    params = model.init(gen)
    if mesh is None:
        pspecs = tree_map(lambda t: (None,) * t.dim(), params)
    else:
        pspecs = param_shardings(params, mesh, inference=inference_layout)
        params = shard_tree(params, pspecs, mesh)
    cache = model.init_cache(b, cache_len=s)
    cspecs = ({n: (None,) * t.dim() for n, t in _cache_leaves(cache)}
              if mesh is None else cache_shardings(cache, mesh, batch=b))
    cache = _map_cache(cache, lambda n, t: _block(t, cspecs[n], mesh))
    split = mesh is not None and b >= 8
    tspec = batch_sharding(mesh, 2) if split else (None, None)
    tokens = _tokens((b, s if shape.kind == "prefill" else 1),
                     cfg.vocab_size, device=device, generator=gen)
    extra, especs = {}, {}
    if cfg.family in ("vlm", "audio"):
        especs["frontend"] = (batch_sharding(mesh, 3) if split
                              else (None, None, None))
        extra["frontend"] = _block(
            _frontend((b, cfg.frontend_tokens, cfg.d_model), dtype,
                      device=device, generator=gen), especs["frontend"],
            mesh)
    return {"params": params, "param_specs": pspecs, "cache": cache,
            "cache_specs": cspecs, "tokens": _block(tokens, tspec, mesh),
            "token_spec": tspec, "extra": extra, "extra_specs": especs,
            "model": model, "cfg": cfg, "shape": shape}


def _serve_layout(spec, mesh):
    """The port's run layout of a serve cell's cache: (spec by leaf, the
    leaves cut before the call). A leaf split over the batch keeps its
    block; one the rules leave whole that has a batch axis (``pos``, the
    cross memory) takes the rank's rows, cut before the call (the rank
    runs its rows only); one split along another axis is held whole,
    gathered in the call (the port has no context parallelism)."""
    rows = spec["token_spec"][0]
    b = spec["shape"].global_batch
    run, precut = {}, set()
    for name, t in _cache_leaves(spec["cache"]):
        s = spec["cache_specs"][name]
        if any(isinstance(e, tuple) for e in s):
            run[name] = s
            continue
        run[name] = (None,) * len(s)
        at = 0 if name.endswith("pos") else next(
            (i for i in range(1, t.dim()) if t.shape[i] == b), None)
        if rows is not None and at is not None and not any(s):
            run[name] = tuple(rows if i == at else None
                              for i in range(len(s)))
            precut.add(name)
    return run, precut


def trace_call(spec, mesh, *, microbatches: int = 1):
    """Run the cell of ``spec`` (:func:`input_specs`) once under
    :func:`opcount`. Returns (OpCount, outputs, seconds)."""
    model, shape = spec["model"], spec["shape"]
    if shape.kind == "train":
        step = make_train_step(model, spec["opt"], mesh=mesh,
                               microbatches=microbatches)
        args = (spec["state"], spec["global_batch"])
        t0 = time.perf_counter()
        with opcount(arguments=args) as c:
            out = step(*args)
        return c, out, time.perf_counter() - t0

    cache = spec["cache"]
    if mesh is not None:
        run, precut = _serve_layout(spec, mesh)
        cache = _map_cache(cache, lambda n, t: local_block(t, run[n], mesh)
                           if n in precut else t)
        # outside the count: specs are read off meta stand-ins
        cspecs = compute_specs(model, mesh, mode=shape.kind)
    args = (spec["params"], spec["tokens"], cache, spec["extra"])
    t0 = time.perf_counter()
    with opcount(arguments=args) as c:
        params, cache = spec["params"], args[2]
        if mesh is not None:
            params = tree_map(lambda t, s, d: reshard(t, s, d, mesh),
                              params, spec["param_specs"], cspecs)
            cache = _map_cache(
                cache, lambda n, t: t if n in precut else
                reshard(t, spec["cache_specs"][n], run[n], mesh))
        if shape.kind == "prefill":
            out = model.prefill(params, spec["tokens"], cache, mesh=mesh,
                                **spec["extra"])
        else:
            out = model.decode_step(params, spec["tokens"], cache, mesh=mesh)
    return c, out, time.perf_counter() - t0


def _bytes_without(out, args, dev) -> int:
    """Bytes of the storages of ``out`` that none of ``args`` holds."""
    have = {t.untyped_storage()._cdata for t in tree_tensors(args)}
    fresh = [t for t in tree_tensors(out)
             if t.untyped_storage()._cdata not in have]
    return tree_bytes(fresh).get(dev, 0)


def open_fake_world(world: int) -> None:
    """Rank 0 of a fake process group of ``world`` ranks (no other process,
    no network: every collective returns at once), unless a group is open
    already."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch, shape_name, *, multi_pod, out_dir: Optional[Path],
             cfg_override=None, tag="", inference_layout=False,
             microbatches=1, mesh=None):
    """One cell: rank 0's inputs on meta, its call traced once under
    :func:`opcount`, the roofline terms. The default process group must
    hold the production mesh's ranks (:func:`open_fake_world`), or those
    of ``mesh`` where one is given (a test's small mesh). Writes the JSON
    into ``out_dir`` (unless None) and returns it."""
    shape = _shape(shape_name)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = cfg_override or cell_config(arch, shape.name)
    spec = input_specs(cfg, shape, mesh, inference_layout=inference_layout)
    c, out, trace_s = trace_call(spec, mesh, microbatches=microbatches)
    dev = "meta"
    n_dev = int(mesh.ranks.size)
    flops_dev, bytes_dev = float(c.flops), float(c.bytes)
    coll = c.collective_bytes()
    coll_total = float(sum(coll.values()))
    mf = model_flops_estimate(cfg, shape)
    args = c.argument_bytes.get(dev, 0)
    peak = c.peak_bytes.get(dev, 0)
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": coll_total / NET_BW,
    }
    arg_trees = ((spec["state"], spec["global_batch"])
                 if shape.kind == "train" else
                 (spec["params"], spec["tokens"], spec["cache"],
                  spec["extra"]))
    result = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.ranks.shape),
        "n_devices": n_dev, "kind": shape.kind, "tag": tag,
        "trace_s": round(trace_s, 1),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "collective_total_per_device": coll_total,
        "ops": c.count_ops(),
        "launches": c.launches,
        "memory": {
            "argument_bytes": args,
            "output_bytes": _bytes_without(out, arg_trees, dev),
            "temp_bytes": peak - args,
            "peak_bytes": peak,
            "fits_80gb": bool(peak <= HBM_BYTES),
        },
        "model_flops": mf,
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "useful_flops_ratio": (mf / (flops_dev * n_dev) if flops_dev
                               else None),
        "roofline_fraction": (
            mf / PEAK_FLOPS / n_dev / max(terms.values())
            if max(terms.values()) > 0 else None),
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = "__" + tag if tag else ""
        name = "{}__{}__{}{}.json".format(arch, shape.name, result["mesh"],
                                          suffix)
        (out_dir / name).write_text(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    cells = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                ok, why = cell_applicable(arch, shape)
                if not ok:
                    print("SKIP {} x {}: {}".format(arch, shape, why),
                          flush=True)
                    continue
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
    open_fake_world(512 if any(mp for _, _, mp in cells) else 256)

    failures = 0
    for arch, shape, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        path = out_dir / "{}__{}__{}.json".format(arch, shape, mesh_name)
        if path.exists() and not args.force:
            print("CACHED {} x {} x {}".format(arch, shape, mesh_name),
                  flush=True)
            continue
        try:
            t0 = time.time()
            r = run_cell(arch, shape, multi_pod=mp, out_dir=out_dir)
            print("OK {} x {} x {}: dom={} c={:.2e} m={:.2e} x={:.2e} "
                  "peak={:.2f}GB fits={} rf={} [{:.0f}s]".format(
                      arch, shape, mesh_name, r["dominant"][:-2],
                      r["roofline"]["compute_s"], r["roofline"]["memory_s"],
                      r["roofline"]["collective_s"],
                      r["memory"]["peak_bytes"] / 1e9,
                      r["memory"]["fits_80gb"],
                      r["roofline_fraction"] and round(r["roofline_fraction"],
                                                       3),
                      time.time() - t0), flush=True)
        except Exception as e:
            failures += 1
            print("FAIL {} x {} x {}: {}: {}".format(
                arch, shape, mesh_name, type(e).__name__, str(e)[:300]),
                flush=True)
            traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
