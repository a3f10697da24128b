"""Hillclimb of three dry-run cells on the port: each iteration traces one
change of a cell on the meta device and records its roofline terms and
peak beside the cell's baseline (the counterpart of
``experiments/hillclimb.py``). Every trace is
``repro_torch.launch.dryrun.run_cell``: rank 0 of a fake process group
of the mesh's ranks, its real call counted by ``opcount``. No card.

  PYTHONPATH=src python experiments_torch/hillclimb.py [cellA|cellB|cellC ...]
      [--out build/experiments_torch] [--mesh 16x16] [--force]

Cells (the reference's choice):
  A. kimi-k2-1t-a32b x decode_32k      - the most collective-bound cell
  B. arctic-480b x train_4k            - the worst memory pressure
  C. deepseek-coder-33b x prefill_32k  - the paper's case: EFTA protecting
     long-sequence inference attention, here under the fused kernel B2

Each cell function takes its arch, shape and mesh (the reference's by
default), so that a test can run it small. A baseline already in ``out``
is reused unless ``force``. Render the results with
``experiments_torch/render_experiments.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

OUT = Path("build/experiments_torch")
B2_BLOCK_KV = 2048   # the dry run's prefill block, which B2 now tiles


def mesh_of(name: str):
    """The production meshes by name (16x16, 2x16x16), else a mesh of
    that shape over ("data", "model") or ("pod", "data", "model")."""
    shape = tuple(int(x) for x in name.split("x"))
    if shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(shape) == 3)
    from repro_torch.distributed.mesh import Mesh
    return Mesh(shape, ("data", "model") if len(shape) == 2
                else ("pod", "data", "model"))


def _name(mesh) -> str:
    return "x".join(str(n) for n in mesh.ranks.shape)


def _save(out, r):
    """``r`` into ``out`` under the dry run's file name for its cell."""
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{r['arch']}__{r['shape']}__{r['mesh']}__{r['tag']}.json"
     ).write_text(json.dumps(r, indent=2))


def log(r, note):
    t = r["roofline"]
    print(f"  -> {r['tag'] or 'baseline'}: c={t['compute_s']:.2e} "
          f"m={t['memory_s']:.2e} x={t['collective_s']:.2e} "
          f"peak={r['memory']['peak_bytes'] / 1e9:.1f}GB "
          f"rf={r['roofline_fraction'] and round(r['roofline_fraction'], 4)}"
          f" | {note}", flush=True)


def _run(arch, shape, mesh, out, **kw):
    return dryrun.run_cell(arch, shape, multi_pod=len(mesh.ranks.shape) == 3,
                           mesh=mesh, out_dir=out, **kw)


def baseline(arch, shape, mesh, out, force=False):
    """The cell as the dry run's sweep traces it (cached in ``out``)."""
    shape = dryrun._shape(shape)
    path = out / f"{arch}__{shape.name}__{_name(mesh)}.json"
    if path.exists() and not force:
        r = json.loads(path.read_text())
    else:
        r = _run(arch, shape, mesh, out)
    log(r, "baseline")
    return r


def cell_a(out=OUT, *, arch="kimi-k2-1t-a32b", shape="decode_32k",
           mesh="16x16", force=False):
    """kimi decode: the per-step gathers of FSDP-sharded weights should
    dominate the collective term; the inference layout (dense weights
    pure-TP, experts sharded, tokens gathered instead of weights) removes
    them."""
    mesh = mesh_of(mesh) if isinstance(mesh, str) else mesh
    shape = dryrun._shape(shape)
    base = baseline(arch, shape, mesh, out, force)
    cfg = dryrun.cell_config(arch, shape.name)
    cfg1 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, inference_ep=True))
    r = _run(arch, shape, mesh, out, cfg_override=cfg1, tag="infer_layout",
             inference_layout=True)
    log(r, "inference layout: no per-step weight gathers")
    return [base, r]


def _same_counts(a, b) -> bool:
    return (a["flops_per_device"] == b["flops_per_device"]
            and a["bytes_per_device"] == b["bytes_per_device"]
            and a["collective_bytes_per_device"]
            == b["collective_bytes_per_device"]
            and a["memory"]["peak_bytes"] == b["memory"]["peak_bytes"])


def cell_b(out=OUT, *, arch="arctic-480b", shape="train_4k", mesh="16x16",
           force=False):
    """arctic train: memory-bound. 1: four microbatches (the activation
    peak); 2: sequence parallelism on top; 3: the checksum stride at the
    paper's 8 and at 128."""
    mesh = mesh_of(mesh) if isinstance(mesh, str) else mesh
    shape = dryrun._shape(shape)
    base = baseline(arch, shape, mesh, out, force)
    cfg = dryrun.cell_config(arch, shape.name)
    res = [base]
    r = _run(arch, shape, mesh, out, cfg_override=cfg, tag="mb4",
             microbatches=4)
    log(r, "microbatch=4: activation liveness / peak")
    res.append(r)
    mb4 = r
    r = _run(arch, shape, mesh, None, tag="seqpar", microbatches=4,
             cfg_override=dataclasses.replace(cfg, seq_parallel=True))
    r["note"] = ("seq_parallel is a placement in the port (shard_act specs "
                 "change no value and no count): counts "
                 + ("equal" if _same_counts(r, mb4) else "DIFFER from")
                 + " mb4's")
    _save(out, r)
    log(r, r["note"])
    res.append(r)
    for stride, tag in ((8, "s8_paper"), (128, "s128_lane")):
        cfgs = dataclasses.replace(cfg, ft=dataclasses.replace(
            cfg.ft, stride=stride, scan_unroll=False))
        r = _run(arch, shape, mesh, out, cfg_override=cfgs, tag=tag,
                 microbatches=4)
        log(r, f"checksum stride {stride}: fold width against GEMM work")
        res.append(r)
    return res


def cell_c(out=OUT, *, arch="deepseek-coder-33b", shape="prefill_32k",
           mesh="16x16", force=False):
    """deepseek prefill: plain EFTA keeps every KV block's scores and
    probabilities (B, H, Sq, block_kv) in device memory between its eager
    ops; the fused kernel B2 (``kernels/efta_attention.py``) keeps them on
    chip. Traced both ways: the baseline (plain ``efta``) and ``efta_pallas``
    at ``block_kv`` 2,048, whose meta branch counts the kernel's own bytes
    and FLOPs (``efta_attention_work``) and allocates what the card does,
    its wide path's workspace among them. ``tile_bytes``: the eager bytes
    that the fused call no longer moves."""
    mesh = mesh_of(mesh) if isinstance(mesh, str) else mesh
    shape = dryrun._shape(shape)
    base = baseline(arch, shape, mesh, out, force)
    cfg = dryrun.cell_config(arch, shape.name)
    kcfg = dataclasses.replace(cfg, ft=dataclasses.replace(
        cfg.ft, attn_impl="efta_pallas", block_kv=B2_BLOCK_KV))
    k = _run(arch, shape, mesh, None, cfg_override=kcfg, tag="kernelized")
    tile = base["bytes_per_device"] - k["bytes_per_device"]
    r = {"arch": arch, "shape": shape.name, "mesh": _name(mesh),
         "tag": "kernelized",
         "memory_s_baseline": base["roofline"]["memory_s"],
         "memory_s_fused": k["roofline"]["memory_s"],
         "tile_bytes": tile,
         "flops_per_device": k["flops_per_device"],
         "compute_s": k["roofline"]["compute_s"],
         "collective_s": k["roofline"]["collective_s"],
         "dominant_fused": k["dominant"],
         "peak_bytes_baseline": base["memory"]["peak_bytes"],
         "peak_bytes_fused": k["memory"]["peak_bytes"],
         "fits_80gb": k["memory"]["fits_80gb"],
         "b2_launches": k["launches"].get("efta_attention", {}).get("calls",
                                                                    0),
         "trace_s": k["trace_s"]}
    _save(out, r)
    print(f"  -> kernelized: {r['b2_launches']} B2 launches; eager bytes "
          f"{tile / 1e9:.1f} GB/device fewer; memory term "
          f"{r['memory_s_baseline']:.2e}s -> {r['memory_s_fused']:.2e}s "
          f"(compute {r['compute_s']:.2e}s); peak "
          f"{r['peak_bytes_baseline'] / 1e9:.1f} -> "
          f"{r['peak_bytes_fused'] / 1e9:.1f} GB, fits 80 GB: "
          f"{r['fits_80gb']}", flush=True)
    return [base, r]


CELLS = {"cellA": cell_a, "cellB": cell_b, "cellC": cell_c}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*", metavar="{cellA,cellB,cellC}",
                    help="the cells to run (default: all three)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--force", action="store_true",
                    help="trace the baselines again")
    args = ap.parse_args(argv)
    dryrun.open_fake_world(math.prod(int(x) for x in args.mesh.split("x")))
    bad = sorted(set(args.cells) - set(CELLS))
    if bad:
        ap.error(f"unknown cells {bad}; choose from {list(CELLS)}")
    results = {}
    for name in args.cells or list(CELLS):
        print(f"== hillclimb {name} ==", flush=True)
        results[name] = CELLS[name](Path(args.out), mesh=args.mesh,
                                    force=args.force)
    return results


if __name__ == "__main__":
    main()
