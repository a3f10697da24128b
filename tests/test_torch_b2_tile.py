"""Kernel B2's tile layout (``csrc/efta_attention_tile.cuh``): 64 query rows
a CTA on wgmma, a producer warpgroup, and a fold pass that writes the K
folds, the V column checksums and max|V| once per KV head and KV block
into a scratch tensor that the wrapper allocates.

* The meta route's tiling (``tiling``, the C rule of ``choose_tiles`` in
  Python; ``tests/test_torch_cuda.py`` compares the two on the card) takes
  the tile layout at the narrow path's prefill regimes in bf16 and keeps
  the narrow layout for f32, the per-step output check, query tiles under
  64 rows, a tile's KV block under 8,192 scores (64-token buckets), fewer
  than four row groups, D over 128 and 1,024-key blocks that do not fit;
  shared bytes within the SM's 227 KB.
* The meta route allocates the fold pass's scratch as the card does: one
  slot of ``make_fold`` floats for each (KV head, KV block).
"""
import pytest
import torch

from repro_torch.core.efta import EFTAConfig
from repro_torch.kernels import efta_attention as b2
from repro_torch.utils.opcount import opcount

torch.set_num_threads(1)

# (B, H, Hkv, Sq, Skv, D, causal, block_kv): the narrow path's prefill
# regimes that the tile layout takes
REGIMES = {"kimi_512": (1, 64, 8, 512, 512, 112, True, 512),
           "arctic_512": (1, 56, 8, 512, 512, 128, True, 512),
           "bert": (8, 16, 16, 512, 512, 64, False, 512),
           "vlm_self": (8, 32, 8, 512, 512, 128, True, 64),
           "vlm_cross": (8, 32, 8, 512, 1600, 128, False, 64),
           "gpt2_S512": (1, 12, 12, 512, 512, 64, True, 512)}


def _shapes(regime, dtype_code=1, **kw):
    B, H, Hkv, Sq, Skv, D, causal, bkv = REGIMES[regime]
    cfg = EFTAConfig(block_kv=bkv)
    bkv = min(bkv, Skv)
    return (dtype_code, min(128, Sq), bkv, D, cfg.kv_stride(bkv),
            cfg.out_stride(D)), kw


def _fold_floats(D, bkv, skv, sout):
    """K folds, V checksums (bf16 pairs), max|V| of each of the fold pass's
    blocks (256 checksum entries each), padded to 4 floats."""
    ldc = ((2 * sout + 7) & ~7) + 8
    splits = -(-bkv * ldc // 256)
    return 2 * skv * D + bkv * ldc + -(-splits // 4) * 4


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_tiling_mirror_takes_the_tile_layout(regime):
    shapes, _ = _shapes(regime)
    t = b2.tiling(*shapes)
    assert t is not None and t.layout == "tile", t
    assert (t.W, t.per_sm, t.wide, t.g_kf, t.cluster) == (4, 1, 0, 0, 0)
    assert t.KC in (128, 64, 32) and t.ST in (3, 2)
    assert shapes[2] % t.KC == 0
    assert t.smem <= b2._SMEM_LIMIT
    _, _, bkv, d, skv, sout = shapes
    assert t.slot_floats == _fold_floats(d, bkv, skv, sout)


@pytest.mark.parametrize("case", ["f32", "per_step", "block_q_32",
                                  "decode", "groups_2", "d256",
                                  "bkv1024_d256", "bkv1024_d128",
                                  "bucket_64"])
def test_tiling_mirror_keeps_the_narrow_layout(case):
    shapes, _ = _shapes("kimi_512")
    code, bq, bkv, d, skv, sout = shapes
    kw = {}
    if case == "f32":
        code = 0
    elif case == "per_step":
        kw["unified"] = False
    elif case == "block_q_32":
        bq = 32
    elif case == "decode":
        # one row a query tile under the per-step output check: the decode
        # layout refuses it (under unified verification it takes it)
        bq = 1
        kw["unified"] = False
    elif case == "groups_2":
        kw["max_groups"] = 2
    elif case == "bucket_64":
        # gpt2's and t5's 64-token buckets: 64 x 64 scores a tile's block
        bq, bkv, skv = 64, 64, EFTAConfig().kv_stride(64)
    elif case.endswith("d256") or case.endswith("d128"):
        d = 256 if case.endswith("d256") else 128
        sout = EFTAConfig().out_stride(d)
        if case.startswith("bkv1024"):
            bkv = 1024
            skv = EFTAConfig(block_kv=bkv).kv_stride(bkv)
    t = b2.tiling(code, bq, bkv, d, skv, sout, **kw)
    assert t is not None and t.layout == "narrow", t
    assert t.smem <= b2._SMEM_LIMIT // t.per_sm
    if case == "bkv1024_d128":
        # 64 rows of 1,024 f32 scores (264 KB) fit no SM
        assert b2._tile_layout(32, 2, d, bkv, skv, sout) > b2._SMEM_LIMIT


def test_tile_layout_shared_bytes_at_kimi():
    """kimi-k2's heads (D 112, s_kv 16, s_out 7) at block_kv 512: 64 rows of
    528-float score rows (135,168 bytes), a two-slot ring of 64-key chunks
    with their checksum rows, Q, the K folds, the checksum products."""
    t = b2.tiling(*_shapes("kimi_512")[0])
    assert (t.KC, t.ST) == (64, 2)
    ring = 2 * (64 * 112 * 2 + 64 * 24 * 4)
    parts = [ring, 64 * 112 * 2, 2 * 16 * 116 * 4, 4 * 64 * 528,
             2 * 64 * 16 * 4, 2 * 64 * 7 * 4, (8 * 64 + 4) * 4, 16 * 8 * 4,
             2 * 2 * 8]
    assert t.smem == sum((n + 15) & ~15 for n in parts) == 219696


@pytest.mark.parametrize("regime", ["kimi_512", "vlm_cross"])
def test_meta_route_allocates_the_fold_scratch_as_the_card_does(regime):
    """The output, the counts of every CTA (two 64-row tiles a 128-row
    query tile) and their sum, and the fold pass's scratch: B Hkv n_kv
    slots of ``make_fold`` floats, each tensor in the dry run's 512-byte
    blocks."""
    B, H, Hkv, Sq, Skv, D, causal, bkv = REGIMES[regime]
    q = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Hkv, Skv, D), dtype=torch.bfloat16, device="meta")
    with opcount() as c:
        b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=bkv),
                          causal=causal)
    t = b2.tiling(*_shapes(regime)[0])
    assert t.layout == "tile"
    n_q, n_kv = Sq // 128, Skv // bkv

    def blocks(n):
        return -(-n // 512) * 512

    counts = blocks(B * H * n_q * 2 * 5 * 4) + blocks(B * H * n_q * 5 * 4)
    scratch = blocks(B * Hkv * n_kv * t.slot_floats * 4)
    assert c.peak_bytes["meta"] == blocks(q.numel() * 2) + counts + scratch
    assert c.launches["efta_attention"]["calls"] == 1


def test_meta_route_allocates_nothing_more_on_the_narrow_layout():
    """f32 at kimi's heads keeps the narrow layout: no scratch."""
    B, H, Hkv, Sq, Skv, D, causal, bkv = REGIMES["kimi_512"]
    q = torch.empty((B, H, Sq, D), dtype=torch.float32, device="meta")
    k = torch.empty((B, Hkv, Skv, D), dtype=torch.float32, device="meta")
    with opcount() as c:
        b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=bkv),
                          causal=causal)
    t = b2.tiling(*_shapes("kimi_512", dtype_code=0)[0])
    assert t.layout == "narrow" and t.W == 1
    n_sub = 128 // 16
    counts = B * H * 4 * n_sub * 5 * 4 + B * H * 4 * 5 * 4
    assert c.peak_bytes["meta"] == q.numel() * 4 + counts
