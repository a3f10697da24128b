"""Where kernel B1 spends its time at a chunk-path or a decode regime, phase
by phase, on the card: arctic-480b's and kimi-k2's C 64 steps with decode
rows (phase 19's bf16 inputs) and a gpt2 prefill step (``B1_CHUNK`` of
``chip_smoke.py``), the C 1 decode step at gpt2's, kimi's and arctic's
heads in bf16 and f32 (``B1_DECODE``), or the C 1 step over wide tables
(``B1_LONG``); correct mode.

    PYTHONPATH=src python tools/b1_phase_split.py [--regime NAME[,NAME..]]
        [--layout tile|decode|long|narrow] [--out FILE]

Builds ``csrc/efta_paged.cu`` with its phase clocks on (``phase_clocks.py``)
and launches B1 on the regime's inputs on the layout its rule takes
(``--layout tile``, the default, ``decode`` or ``long``), or with
``-DEFTA_PAGED_FIRST_LAYOUT`` on the first layout for the same shapes
(``--layout narrow``: the kernel as it ran before the tile, decode and
long-table layouts). ``--layout long`` builds with
``-DEFTA_PAGED_NO_DECODE_LAYOUT``, so the long-table layout takes the
decode layout's shapes too (``B1_DECODE``'s regimes: the two C 1 layouts
side by side, each run with ``--layout decode`` and ``--layout long`` in
one call). One JSON line a regime: the tiling (W, G, ST, shared bytes,
layout), the cycles and share of each phase of that layout, and the
launch's CUDA-event time with the clocks on (the tile layout's fold pass,
a kernel of its own without marks, included). Thread 0 sits in the first
row group (the first layout), the first warpgroup (the tile layout) or the
warp of each CTA's first block (the decode layout; every CTA of a cluster
adds its clocks; the long-table layout: every CTA of its three passes, the
score and EXP passes' marks once a group), so a row phase's share is its
rows', and waits for the other warps land in the barrier that follows.
Needs the card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import phase_clocks

ROOT = Path(__file__).resolve().parents[1]

PHASES = {
    "narrow": ("setup", "load waits", "A: K/V folds, GEMM I, ABFT, block max",
               "block barriers", "B: running max, EXP, rowsum, GEMM II, "
               "O-checksum products", "C: running state",
               "max|V|, finalize", "counts"),
    "tile": ("setup", "K/V waits", "GEMM I and checksum products",
             "barrier after GEMM I", "fold check, block max",
             "running max, EXP, rowsum terms", "running state, O checksums",
             "barriers before GEMM II and the finalize", "GEMM II, rescale",
             "finalize"),
    "decode": ("setup", "K/V waits",
               "A: site 6, GEMM I, fold check, block max",
               "cluster barrier 1", "exchange 1: running max, alpha",
               "B: EXP, rowsum terms, P V, O-checksum products, max|V|",
               "cluster barrier 2", "exchange 2: running state",
               "finalize, counts"),
    "long": ("score: setup", "score: K waits, group maxima",
             "score: site 6 (K), GEMM I, fold check, block max",
             "score: counts", "EXP: setup",
             "EXP: V and slot waits, entering max",
             "EXP: running max through the group",
             "EXP: site 6 (V), EXP, rowsum terms, P V, O-checksum products",
             "EXP: counts", "state: setup",
             "state: running state in block order", "state: finalize",
             "state: counts"),
}


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    regimes = [*cs.B1_CHUNK, *cs.B1_DECODE, *cs.B1_LONG]
    ap.add_argument("--regime", default=",".join(cs.B1_CHUNK),
                    help="one or more of " + ", ".join(regimes) +
                    ", comma-separated")
    ap.add_argument("--layout", default="tile", choices=sorted(PHASES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="", help="append the JSON lines here")
    args = ap.parse_args(argv)
    names = args.regime.split(",")
    unknown = [n for n in names if n not in regimes]
    if unknown:
        ap.error(f"unknown regime(s) {unknown}; choose from {regimes}")
    import torch
    if not torch.cuda.is_available():
        print("b1_phase_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import efta_paged as ep

    defines = {"narrow": ["-DEFTA_PAGED_FIRST_LAYOUT"],
               "long": ["-DEFTA_PAGED_NO_DECODE_LAYOUT"]}.get(args.layout, [])
    try:
        clocks = phase_clocks.build("efta_paged", ep.bind, defines)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for name in names:
        case, cfg = cs.b1_chunk_case(torch, name)
        t = cs.b1_chunk_tiling(case, cfg)
        if t.layout != args.layout:
            print(f"b1_phase_split: {name} takes the {t.layout} layout, not "
                  f"{args.layout}", file=sys.stderr)
            return 1
        phase_clocks.split(
            torch, "b1_phase_split", name,
            lambda: cs.call(ep.efta_paged_attention, case, cfg), clocks,
            PHASES[args.layout], args.reps, t, args.out)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
