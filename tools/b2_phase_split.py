"""Where kernel B2 spends its time in one regime, phase by phase, on the
card: by default deepseek-coder-33b's 32k prefill launch (56 query heads
of 128 on 8 KV heads, 32,768 tokens, causal, block_kv 2,048), or any of
the narrow-path and decode regimes of ``REGIMES``; bf16, correct mode.

    PYTHONPATH=src python tools/b2_phase_split.py [--regime NAME[,NAME..]]
        [--out FILE]

Builds ``csrc/efta_attention.cu`` with its phase clocks on
(``phase_clocks.py``; each layout carries the same marks; the tile
layout's "fold check" mark closes its checksum products, and its "max"
phase holds the fold check and the block max, which it takes in one
pass; the decode layout's three kernels, the score, EXP and state
passes, carry marks of their own, ``DECODE_PHASES``). Then it launches B2
on random inputs (seed 0) and prints one JSON line a regime: the tiling
and layout, the cycles and share of each phase, and the launch's
CUDA-event time with the clocks on (the tile layout's fold pass, a kernel
of its own, included). Thread 0 sits in the first row group (the decode
layout: in warp 0, which holds the first query row), so a row phase's
share is that group's, and waits for the other groups land in the next
phase that ends in a barrier. Needs the card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys

import phase_clocks

# the marks of the narrow, tile, cluster and workspace layouts; the decode
# layout's three kernels have marks of their own
PHASES = ("setup", "K pass: GEMM I, K folds", "fold check", "max",
          "EXP, rowsum", "V pass: GEMM II, V and O checksums", "block tail",
          "finalize", "cluster waits", "K-chunk waits", "V-chunk waits",
          "V checksums", "O-checksum products")
DECODE_PHASES = ("score pass: K and q loads", "score pass: GEMM I, K folds",
                 "score pass: checksum products, fold check",
                 "score pass: block max, stores",
                 "EXP pass: V and workspace loads, running-max replay",
                 "EXP pass: EXP, checks, rowsum terms",
                 "EXP pass: barrier after the row phases",
                 "EXP pass: V checksums, GEMM II, O-checksum products",
                 "state pass: running state", "state pass: finalize")
# (B, H, Hkv, Sq, Skv, D, causal, block_kv, launches a timing)
REGIMES = {
    "deepseek": (1, 56, 8, 32768, 32768, 128, True, 2048, 2),
    "kimi_512": (1, 64, 8, 512, 512, 112, True, 512, 20),
    "arctic_512": (1, 56, 8, 512, 512, 128, True, 512, 20),
    "bert": (8, 16, 16, 512, 512, 64, False, 512, 20),
    "vlm_self": (8, 32, 8, 512, 512, 128, True, 64, 20),
    "vlm_cross": (8, 32, 8, 512, 1600, 128, False, 64, 10),
    "t5_cross_decode": (8, 8, 8, 1, 512, 64, False, 512, 20),
    "vlm_cross_decode": (8, 32, 8, 1, 1600, 128, False, 64, 20),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regime", default="deepseek",
                    help="one or more of " + ", ".join(REGIMES) +
                    ", comma-separated")
    ap.add_argument("--out", default="", help="append the JSON lines here")
    args = ap.parse_args(argv)
    names = args.regime.split(",")
    unknown = [n for n in names if n not in REGIMES]
    if unknown:
        ap.error(f"unknown regime(s) {unknown}; choose from {list(REGIMES)}")
    import torch
    if not torch.cuda.is_available():
        print("b2_phase_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.kernels import efta_attention as ea

    try:
        clocks = phase_clocks.build("efta_attention", ea.bind)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for name in names:
        B, H, Hkv, Sq, Skv, D, causal, bkv, reps = REGIMES[name]
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((B, h, s, D), generator=g)
                   .to("cuda", torch.bfloat16)
                   for h, s in ((H, Sq), (Hkv, Skv), (Hkv, Skv)))
        cfg = EFTAConfig(mode="correct", block_kv=bkv)
        t = ea.kernel_tiling(1, min(128, Sq), bkv, D, cfg.kv_stride(bkv),
                             cfg.out_stride(D))
        phase_clocks.split(
            torch, "b2_phase_split", name,
            lambda: ea.efta_attention(q, k, v, cfg=cfg, causal=causal),
            clocks, DECODE_PHASES if t.layout == "decode" else PHASES,
            reps, t, args.out)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
