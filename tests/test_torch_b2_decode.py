"""Kernel B2's decode layout (``csrc/efta_attention_decode.cuh``): one query
row a query tile (``block_q`` 1), a unit of work a request's KV head with
all its query heads, three passes (scores, EXP, the running state in block
order) over a workspace that the wrapper allocates.

* The meta route's tiling (``tiling``, the C rule of ``choose_tiles`` in
  Python; ``tests/test_torch_cuda.py`` compares the two on the card) takes
  the decode layout at t5's and the VLM's cross-attention decode in bf16
  and f32, and keeps the other layouts where it did: every launch with
  more than one row a query tile, and at ``block_q`` 1 what the decode
  layout refuses (the per-step output check, more than 128 fold segments).
* The meta route allocates what the card allocates for it: the counts of
  each part of each KV block and of the state pass, and one workspace slot
  a unit and KV block.
"""
import pytest
import torch

from repro_torch.core.efta import EFTAConfig
from repro_torch.kernels import efta_attention as b2
from repro_torch.utils.opcount import opcount

torch.set_num_threads(1)

# (B, H, Hkv, Skv, D, block_kv): the cross-attention decode regimes (Sq 1)
REGIMES = {"t5_cross_decode": (8, 8, 8, 512, 64, 512),
           "vlm_cross_decode": (8, 32, 8, 1600, 128, 64)}


def _shapes(regime, dtype_code, block_q=1):
    B, H, Hkv, Skv, D, bkv = REGIMES[regime]
    cfg = EFTAConfig(block_kv=bkv)
    bkv = min(bkv, Skv)
    return (dtype_code, block_q, bkv, D, cfg.kv_stride(bkv),
            cfg.out_stride(D))


def _up4(n):
    return (n + 3) & ~3


def _decode_floats(D, bkv, skv, sout, parts):
    """A unit's slot of one KV block: 8 rows of scores and of checksum
    products, the parts' block maxima, then each part's P V rows, two O
    checksums, the rowsum terms and max|V|."""
    part = 8 * D + 2 * _up4(8 * sout) + 2 * 8 + 4
    return _up4(8 * bkv) + _up4(8 * skv) + _up4(8 * parts) + parts * part


@pytest.mark.parametrize("regime,parts,keys", [("t5_cross_decode", 4, 128),
                                               ("vlm_cross_decode", 1, 64)])
@pytest.mark.parametrize("code", [0, 1])
def test_tiling_mirror_takes_the_decode_layout(regime, parts, keys, code):
    """t5's 512-key block in 4 parts of 4 fold residues (128 keys a CTA),
    the VLM's 64-key blocks whole; the workspace slot's floats and the
    largest pass's shared bytes within the SM's."""
    shapes = _shapes(regime, code)
    t = b2.tiling(*shapes)
    assert t is not None and t.layout == "decode", t
    assert t.decode == parts and t.KC == shapes[2] // parts == keys
    assert (t.W, t.ST, t.per_sm, t.wide, t.g_kf, t.cluster, t.tile) == (
        1, 1, 1, 0, 0, 0, 0)
    _, _, bkv, d, skv, sout = shapes
    assert t.slot_floats == _decode_floats(d, bkv, skv, sout, parts)
    assert 0 < t.smem <= b2._SMEM_LIMIT


@pytest.mark.parametrize("case,layout", [
    ("per_step", "narrow"), ("t5_cross_prefill_bf16", "tile"),
    ("t5_cross_prefill_f32", "narrow"), ("vlm_cross_prefill", "tile"),
    ("rows_16", "narrow"), ("segments_256", "workspace"),
    ("prefill_2048", "cluster")])
def test_tiling_mirror_keeps_the_other_layouts(case, layout):
    """More than one row a query tile keeps the layout it had; so does
    ``block_q`` 1 under the per-step output check (its count follows the
    summation order) or with more than 128 fold segments a residue (a
    32,768-key block at stride 128: 256)."""
    code, bq, bkv, d, skv, sout = _shapes("t5_cross_decode", 1)
    kw = {}
    if case == "per_step":
        kw["unified"] = False
    elif case.startswith("t5_cross_prefill"):
        bq, code = 64, 0 if case.endswith("f32") else 1
    elif case == "vlm_cross_prefill":
        code, bq, bkv, d, skv, sout = _shapes("vlm_cross_decode", 1, 128)
    elif case == "rows_16":
        bq = 16
    elif case == "segments_256":
        bkv, d, skv, sout = 32768, 128, 128, 8
    elif case == "prefill_2048":
        bq, bkv, d, skv, sout = 128, 2048, 128, 64, 8
    t = b2.tiling(code, bq, bkv, d, skv, sout, **kw)
    assert t is not None and t.layout == layout and t.decode == 0, t
    if case == "segments_256":
        assert b2._decode_parts(bkv, skv) == 0


def test_decode_layout_takes_wide_blocks_by_their_residues():
    """A 2,048-key block at stride 64 (32 segments a residue): 16 parts of
    4 residues, 128 keys a CTA; a 2,048-key block at stride 16 (128
    segments): 16 parts of one residue."""
    assert b2.tiling(1, 1, 2048, 128, 64, 8).decode == 16
    assert b2.tiling(0, 1, 2048, 64, 16, 4).decode == 16


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_meta_route_allocates_the_decode_workspace_as_the_card_does(regime):
    """The output, the counts of every part of every KV block and of the
    state pass, their sum, and the workspace: one slot a (KV head of a
    request, query tile) and KV block, each tensor in the dry run's
    512-byte blocks."""
    B, H, Hkv, Skv, D, bkv = REGIMES[regime]
    q = torch.empty((B, H, 1, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Hkv, Skv, D), dtype=torch.bfloat16, device="meta")
    with opcount() as c:
        out, det = b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=bkv))
    assert out.shape == q.shape and det.shape == (5,)
    t = b2.tiling(*_shapes(regime, 1))
    n_kv = Skv // bkv

    def blocks(n):
        return -(-n // 512) * 512

    counts = (blocks(B * H * (n_kv * t.decode + 1) * 5 * 4)
              + blocks(B * H * 5 * 4))
    ws = blocks(B * Hkv * n_kv * t.slot_floats * 4)
    assert c.peak_bytes["meta"] == blocks(q.numel() * 2) + counts + ws
    assert c.launches["efta_attention"]["calls"] == 1


def test_meta_route_allocates_nothing_more_for_the_per_step_check():
    """``unified = 0`` at Sq 1 keeps the narrow layout: one thread block a
    query head, no workspace."""
    B, H, Hkv, Skv, D, bkv = REGIMES["t5_cross_decode"]
    q = torch.empty((B, H, 1, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Hkv, Skv, D), dtype=torch.bfloat16, device="meta")
    with opcount() as c:
        b2.efta_attention(q, k, k, cfg=EFTAConfig(block_kv=bkv,
                                                  unified=False))
    t = b2.tiling(*_shapes("t5_cross_decode", 1), unified=False)
    assert t.layout == "narrow" and t.W == 1
    # the output, the counts of one thread block a query head, their sum
    assert c.peak_bytes["meta"] == q.numel() * 2 + 2 * 512 * (
        -(-B * H * 5 * 4 // 512))
