"""Kernel B2 at wide KV blocks: the dry run's ``block_kv`` 2,048 (fold
stride 64) and 4,096 (stride 128), past the 1,024 keys and stride 32 of
the kernel's first layout.

* The kernel's plain version (what the wrapper runs for CPU tensors, and
  what ``chip_smoke.py`` holds the CUDA kernel to) against the JAX
  package's ``efta_attention_pallas`` in interpret mode on the same numpy
  inputs: two KV blocks, f32 and bf16, causal and not, clean and one SEU
  at each compute site in correct mode. Detection vectors exactly equal;
  f32 outputs within 1e-5, bf16 within one bf16 ulp of the largest output
  (both round the f32 result once). Non-causal, the SEU strikes the
  second block, after the cross-block rescale; causal at 32 rows, the
  second block is skipped and the SEU strikes the first.
* The meta route's tiling: ``tiling`` mirrors the C rule (``choose_tiles``
  of ``csrc/efta_attention.cu``; ``tests/test_torch_cuda.py`` compares the
  two on the card), takes 2,048 and 4,096 at D 64-256 on the cluster layout
  (a cluster of thread blocks shares a tile's rows, each its fold
  residues), 32,768 and the per-step output check on the workspace layout,
  and refuses what the kernel refuses, with the CUDA route's message; the
  meta route allocates as the card does: no workspace on the cluster
  layout, a persistent grid's workspace on the other.
* ``block_kv`` 32,768 (stride 128, 256 fold segments): the plain version
  against plain softmax attention, and an EXP SEU corrected.
"""
import functools
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.efta import EFTAConfig as JConfig  # noqa: E402
from repro.kernels.efta_attention import efta_attention_pallas  # noqa: E402
from repro_torch.core.efta import EFTAConfig, reference_attention  # noqa: E402
from repro_torch.core.fault import Site  # noqa: E402
from repro_torch.kernels import efta_attention as b2  # noqa: E402
from repro_torch.utils.opcount import opcount  # noqa: E402

torch.set_num_threads(1)

SITES = [None, Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM, Site.GEMM2]
SQ, D = 32, 64


@functools.lru_cache(maxsize=None)
def _reference(block_kv, dtype, causal):
    """The reference kernel jitted once per configuration (the fault
    descriptor is an argument): interpret mode retraces every call
    otherwise."""
    return jax.jit(functools.partial(
        efta_attention_pallas, cfg=JConfig(mode="correct", block_kv=block_kv),
        causal=causal, interpret=True))


@functools.lru_cache(maxsize=None)
def _inputs(block_kv):
    rng = np.random.default_rng(block_kv)
    return (rng.standard_normal((1, 2, SQ, D)).astype(np.float32),
            rng.standard_normal((1, 1, 2 * block_kv, D)).astype(np.float32),
            rng.standard_normal((1, 1, 2 * block_kv, D)).astype(np.float32))


@pytest.mark.parametrize("site", SITES, ids=lambda s: "clean" if s is None
                         else s.name)
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block_kv", [2048, 4096])
def test_plain_version_matches_pallas_at_wide_blocks(block_kv, dtype, causal,
                                                     site):
    assert EFTAConfig(block_kv=block_kv).kv_stride(block_kv) == block_kv // 32
    q, k, v = _inputs(block_kv)
    fault = None
    if site is not None:
        fault = np.asarray([int(site), 0 if causal else 1, 1, SQ - 1, 3, 30,
                            1, 0], np.int32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jo, jdet = _reference(block_kv, dtype, causal)(
        *(jnp.asarray(x, jd) for x in (q, k, v)),
        fault=jnp.asarray(np.zeros(8, np.int32) if fault is None else fault))
    to, tdet = b2.efta_attention_torch(
        *(to_torch(x, td) for x in (q, k, v)),
        cfg=EFTAConfig(mode="correct", block_kv=block_kv), fault=fault,
        causal=causal)
    ref = np.asarray(jo, np.float32)
    np.testing.assert_array_equal(to_np(tdet), np.asarray(jdet))
    if site is None:
        assert int(tdet.sum()) == 0
    atol = 1e-5 if dtype == "f32" else 2.0 ** -8 * float(np.abs(ref).max())
    np.testing.assert_allclose(to_np(to.float()), ref, atol=atol, rtol=0)


def test_tiling_mirror_takes_the_dry_runs_blocks():
    cfg = EFTAConfig(block_kv=2048)
    for bkv, skv in ((2048, 64), (4096, 128), (32768, 128)):
        assert cfg.kv_stride(bkv) == skv
        for code in (0, 1):
            for d in (64, 112, 128, 160, 256):
                t = b2.tiling(code, 128, bkv, d, skv, cfg.out_stride(d))
                assert t is not None, (bkv, d, code)
                assert t.smem <= b2._SMEM_LIMIT // t.per_sm
                if bkv < 32768:
                    # 8 CTAs of skv / 8 fold residues each, no workspace
                    assert t.layout == "cluster" and t.cluster == 8, t
                    assert t.wide == 0 and t.slot_floats == 0
                else:
                    # 256 fold segments: scores and raw probabilities of
                    # each 16-row group in the workspace
                    assert t.layout == "workspace" and t.cluster == 0, t
                    assert t.slot_floats >= 2 * 16 * t.W * bkv
    # every tiling the first layout took keeps it, but where the tile
    # layout takes the shapes (bf16, four row groups allowed)
    t = b2.tiling(1, 128, 512, 64, 16, 4, max_groups=2)
    assert t.layout == "narrow" and (t.W, t.KC, t.ST) == (2, 64, 2)
    assert b2.tiling(1, 128, 512, 64, 16, 4).layout == "tile"
    # deepseek's prefill: 64 rows a cluster (bf16), 32 at D 256
    t = b2.tiling(1, 128, 2048, 128, 64, 8)
    assert (t.W, t.KC, t.ST, t.per_sm, t.cluster) == (4, 128, 2, 1, 8)
    assert b2.tiling(1, 128, 2048, 256, 64, 16).W == 2
    # the per-step output check stays on the workspace layout; D 256 at
    # stride 128 puts the K-fold planes (266 KB) in the workspace too
    t = b2.tiling(1, 128, 2048, 128, 64, 8, unified=False)
    assert (t.layout, t.W, t.KC, t.ST, t.per_sm, t.g_kf) == (
        "workspace", 2, 64, 3, 1, 0)
    assert b2.tiling(1, 128, 4096, 256, 128, 16, unified=False).g_kf == 1


@pytest.mark.parametrize("d,block_kv", [(72, 64), (128, 40)])
def test_meta_route_refuses_what_the_kernel_refuses(d, block_kv):
    """Head dims and blocks off the 16-multiple rule: the C rule refuses
    them, the mirror refuses them, and the meta route raises the CUDA
    route's message (the plain version on the CPU takes them)."""
    cfg = EFTAConfig(block_kv=block_kv, stride=8)
    assert b2.tiling(0, 64, block_kv, d, cfg.kv_stride(block_kv),
                     cfg.out_stride(d)) is None
    q = torch.zeros((1, 2, 64, d))
    k = torch.zeros((1, 2, 2 * block_kv, d))
    with pytest.raises(ValueError, match=(
            f"efta_attention kernel: block_kv {block_kv} \\(stride "
            f"{cfg.kv_stride(block_kv)}\\) x head_dim {d} has no tiling "
            f"that fits one thread block")):
        b2.efta_attention(*(x.to("meta") for x in (q, k, k)), cfg=cfg)
    out, det = b2.efta_attention(q, k, k, cfg=cfg)
    assert out.shape == q.shape and int(det.sum()) == 0


def test_meta_route_allocates_the_workspace_as_the_card_does():
    """deepseek-coder's 32k prefill (56 query heads on 8 of 128, bf16,
    causal, block_kv 2,048) on the cluster layout: the output, the counts
    of every CTA (2 clusters of 8 a 128-row tile) and their sum, and no
    workspace."""
    q = torch.empty((1, 56, 32768, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, 32768, 128), dtype=torch.bfloat16, device="meta")
    with opcount() as c:
        b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=2048), causal=True)
    t = b2.tiling(1, 128, 2048, 128, 64, 8)
    assert (t.layout, t.W, t.cluster, t.slot_floats) == ("cluster", 4, 8, 0)
    ctas = 128 // (16 * t.W) * t.cluster
    counts = 56 * 256 * ctas * 5 * 4 + 56 * 256 * 5 * 4
    assert c.peak_bytes["meta"] == q.numel() * 2 + counts
    assert c.launches["efta_attention"]["calls"] == 1


def test_meta_route_allocates_the_workspace_at_block_kv_32768():
    """One 32,768-key block (256 fold segments: the workspace layout), 56
    query heads on 8 at Sq 4,096: the output, the per-thread-block counts
    and their sum, and a persistent grid's workspace as on an H100. Its
    57,344 (bh, tile) pairs outnumber the thread blocks that fit the card
    at once, so the grid is the 132 SMs times the tiling's thread blocks an
    SM, one slot each."""
    q = torch.empty((1, 56, 4096, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, 32768, 128), dtype=torch.bfloat16, device="meta")
    with opcount() as c:
        b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=32768))
    t = b2.tiling(1, 128, 32768, 128, 128, 8)
    assert t.layout == "workspace" and t.cluster == 0
    n_sub = 128 // (16 * t.W)
    pairs = 56 * (4096 // 128) * n_sub
    slots = t.per_sm * b2.H100_SMS
    assert pairs > slots
    # the counts (56, 32 n_sub, 5) and their sum (56, 32, 5), int32, each
    # in the dry run's 512-byte blocks

    def blocks(n):
        return -(-n // 512) * 512

    counts = blocks(pairs * 5 * 4) + blocks(56 * 32 * 5 * 4)
    assert c.peak_bytes["meta"] == (q.numel() * 2 + counts
                                    + slots * t.slot_floats * 4)
    assert c.launches["efta_attention"]["calls"] == 1


def test_plain_version_at_block_kv_32768():
    """One 32,768-key block (stride 128, 256 fold segments, EXP cap 80 /
    256): clean equals softmax attention, and an EXP SEU in the last
    segment is detected and corrected."""
    rng = np.random.default_rng(3)
    q = to_torch(rng.standard_normal((1, 2, 16, 32)).astype(np.float32))
    k = to_torch(rng.standard_normal((1, 1, 32768, 32)).astype(np.float32))
    v = to_torch(rng.standard_normal((1, 1, 32768, 32)).astype(np.float32))
    cfg = EFTAConfig(block_kv=32768)
    out, det = b2.efta_attention(q, k, v, cfg=cfg)
    assert int(det.sum()) == 0
    np.testing.assert_allclose(to_np(out), to_np(reference_attention(q, k, v)),
                               atol=1e-5, rtol=0)
    fault = [int(Site.EXP), 0, 1, 15, 32767, 30, 1, 0]
    got, det_f = b2.efta_attention(q, k, v, cfg=cfg, fault=fault)
    assert int(det_f[1]) >= 1
    np.testing.assert_allclose(to_np(got), to_np(out), atol=1e-5, rtol=0)
