"""Quickstart on the port: end-to-end fault tolerant attention in PyTorch.

Runs EFTA on random Q/K/V, injects a single-event upset into the P.V
accumulator mid-computation, and shows detection + exact correction. The
JAX package's ``examples/quickstart.py`` draws Q/K/V with ``jax.random``;
here they come from a numpy generator of a fixed seed. No model runs, so
there is no ``--arch``.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (EFTAConfig, FaultSpec, Site, efta_attention,
                              reference_attention)
from repro_torch.models import resolve_device

B, H, S, D = 2, 4, 256, 64
SEED = 0


def make_qkv(seed: int = SEED):
    """The example's q, k, v: (B, H, S, D) f32 standard normals."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, D), dtype=np.float32)
                 for _ in range(3))


def main(argv=None, *, params=None) -> dict:
    """``params``: the (q, k, v) numpy arrays (by default
    :func:`make_qkv`'s). Returns the printed numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    q, k, v = (torch.from_numpy(np.asarray(a)).to(dev)
               for a in (params or make_qkv()))

    cfg = EFTAConfig(mode="correct", stride=64, block_kv=128)
    clean = reference_attention(q, k, v, causal=True)
    # a soft error: the top exponent bit of one f32 accumulator element
    # flips at KV block 1 (the classic silent-corruption catastrophe)
    fault = FaultSpec.single(Site.GEMM2, block=1, batch=0, head=2, row=100,
                             col=17, bit=28)
    protected, report = efta_attention(q, k, v, cfg=cfg, causal=True,
                                       fault=fault)
    unprotected, _ = efta_attention(
        q, k, v, cfg=EFTAConfig(mode="off", stride=64, block_kv=128),
        causal=True, fault=fault)

    err_p = float((protected.float() - clean.float()).abs().max())
    err_u = float((unprotected.float() - clean.float()).abs().max())
    # the port counts per batch row; summed, as the JAX package reports
    detected = report.detected.sum(dim=0).tolist()
    corrected = report.corrected.sum(dim=0).tolist()
    print(f"max error WITH EFTA   : {err_p:.2e}")
    print(f"max error WITHOUT FT  : {err_u:.2e}")
    print(f"detected  [gemm1, exp, rowmax, rowsum, gemm2]: {detected}")
    print(f"corrected [gemm1, exp, rowmax, rowsum, gemm2]: {corrected}")
    # unprotected: visible corruption (~1e-3 for this bit/row after softmax
    # normalization); protected: numerical noise, >3 orders of magnitude
    # better
    assert err_p < 1e-4 and err_u > 1e-3 and err_u > 1000 * err_p
    print("OK: the SEU was detected and corrected inside the fused "
          "attention.")
    return {"err_protected": err_p, "err_unprotected": err_u,
            "detected": detected, "corrected": corrected}


if __name__ == "__main__":
    main()
