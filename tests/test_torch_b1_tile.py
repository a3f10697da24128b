"""Kernel B1's tile layout (``csrc/efta_paged_tile.cuh``): 64 rows of one
(request, KV head) a CTA on wgmma, a producer warpgroup, and a fold pass
that writes the K folds, the V column checksums and max|V| of each
(request, KV head, block) once into a scratch tensor that the wrapper
allocates.

* The rule's Python mirror (``efta_paged.tiling``; the cuda-marked
  ``test_paged_tiling_mirror_equals_the_kernels_rule`` holds it to the C
  rule on the card) takes the tile layout at the chunk path's regimes in
  bf16 (arctic's and kimi's C 64, gpt2's prefill) and keeps the first
  layout for f32, the per-step output check, fewer than 64 rows, other
  block sizes and strides and D over 128; a decode shape (C 1) whose table
  the decode layout's cluster cannot hold takes the long-table layout (C 1
  otherwise takes the decode layout: ``tests/test_torch_b1_decode.py``,
  ``tests/test_torch_b1_long.py``); shared bytes within the SM's 227 KB.
* The wrapper sizes the fold scratch as the card's kernel reads it.
* A shape the rule gives the tile layout never falls back: when its launch
  fails, the wrapper raises, and neither the first layout nor the plain
  version runs.
"""
import pytest
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.efta import EFTAConfig
from repro_torch.kernels import efta_paged as b1

torch.set_num_threads(1)

BF16, F32 = 1, 0
CFG = EFTAConfig(mode="correct", stride=128, block_kv=16)
# (query heads a KV head, head_dim) of the chunk path's regimes
HEADS = {"arctic": (7, 128), "kimi": (8, 112), "gpt2": (1, 64)}


def _shapes(regime, C=64, dtype=BF16, bs=16, cs=8, mb=64):
    grp, d = HEADS[regime]
    return (dtype, grp * C, d, bs, cs, CFG.kv_stride(bs), CFG.out_stride(d),
            mb)


def _fold_floats(d, sout):
    """16 fold rows of D bf16, the V column checksums (16 keys x both
    checksums' s_out columns, padded to 4), max|V| padded to 16 bytes."""
    return 8 * d + 16 * ((2 * sout + 3) & ~3) + 4


@pytest.mark.parametrize("regime", sorted(HEADS))
def test_mirror_takes_the_tile_layout_at_the_chunk_path(regime):
    shapes = _shapes(regime)
    t = b1.tiling(*shapes, chunk=64)
    assert t is not None and t.layout == "tile", t
    assert (t.W, t.G, t.rows) == (4, 4, 64) and t.ST in (3, 2)
    assert t.smem <= b1._SMEM_LIMIT
    assert t.fold_floats == _fold_floats(shapes[2], shapes[6])


@pytest.mark.parametrize("case", ["decode", "rows_48", "f32", "per_step",
                                  "block_32", "stride_8", "d_256"])
def test_mirror_keeps_the_first_layout(case):
    kw = {"chunk": 64}
    shapes = list(_shapes("kimi"))
    if case == "decode":
        # C 1 (grp rows) in f32 over a 256-block table: a CTA's 32 blocks
        # of V and partials exceed the decode layout's shared memory, and
        # the long-table layout takes it
        shapes[0], shapes[1], shapes[7], kw["chunk"] = F32, 8, 256, 1
    elif case == "rows_48":
        shapes[1] = 48
    elif case == "f32":
        shapes[0] = F32
    elif case == "per_step":
        kw["unified"] = False
    elif case == "block_32":
        shapes[3], shapes[5] = 32, CFG.kv_stride(32)
    elif case == "stride_8":
        shapes[5] = 8
    elif case == "d_256":
        shapes[2], shapes[6] = 256, CFG.out_stride(256)
    t = b1.tiling(*shapes, **kw)
    if case == "decode":
        assert t is not None and t.layout == "long" and t.fold_floats > 0, t
    else:
        assert t is not None and t.layout == "narrow" and t.fold_floats == 0, t
    assert t.smem <= b1._SMEM_LIMIT


def test_tile_layout_shared_bytes_at_arctic():
    """arctic's heads (D 128, s_out 8): three stages of four blocks (K and
    its 16 fold rows, V, the V checksums), Q, two steps' scores of 68-float
    rows, the checksum products, the row state, the O checksums, the
    counts, the mbarriers: 192 bytes under the SM's 232,448."""
    t = b1.tiling(*_shapes("arctic"), chunk=64)
    slot = 48 * 128 * 2 + 16 * 16 * 4
    parts = [3 * 4 * slot, 64 * 128 * 2, 4 * 2 * 64 * 68, 4 * 2 * 64 * 4 * 4,
             (33 * 64 + 4) * 4, 2 * 64 * 8 * 4, 16 * 8 * 4, 2 * 3 * 8]
    assert t.ST == 3 and t.smem == sum(parts) == 232256


def test_first_layout_tilings_of_the_parent():
    """The first layout's W, G and ST at the chunk path's regimes, as the
    parent kernel took them: arctic fits one block a step."""
    want = {"arctic": (4, 1, 3), "kimi": (4, 2, 2), "gpt2": (4, 3, 3)}
    for regime, wgs in want.items():
        _, R, d, bs, cs, skv, sout, mb = _shapes(regime)
        t = b1._first_tiling(2, R, d, bs, cs, skv, sout, mb)
        assert (t.W, t.G, t.ST) == wgs, (regime, t)


@pytest.mark.parametrize("regime", sorted(HEADS))
def test_fold_scratch_is_sized_as_the_card_reads_it(regime):
    B, hkv, mb = 8, 8, 64
    t = b1.tiling(*_shapes(regime), chunk=64)
    ws = b1.fold_scratch(t, B, hkv, mb, "meta")
    assert ws.dtype == torch.float32
    assert ws.shape == (B, hkv, mb, t.fold_floats)
    # each slot starts on 16 bytes: the producer copies it with cp.async
    assert t.fold_floats % 4 == 0
    assert b1.fold_scratch(b1.tiling(*_shapes(regime, C=1), chunk=1), B,
                           hkv, mb, "meta") is None


class _FakeLib:
    """The built library's entry points, with the rule of ``tiling`` and a
    launch that returns ``rc``: 1 fails as a refused launch does
    (cudaErrorInvalidValue), 0 succeeds without running anything."""

    def __init__(self, rc):
        self.rc = rc
        self.launch = None

    def efta_paged_tiling(self, *a):
        t = b1.tiling(*a[:9], chunk=a[9])
        if t is None:
            return 0
        for i, v in enumerate(t):
            a[10][i] = v
        return -(-a[1] // t.rows) * (t.cluster or 1)

    def efta_paged_launch(self, *a):
        self.launch = a
        return self.rc

    def efta_paged_error_string(self, rc):
        return b"invalid argument"


def _launch(regime, C, lib, monkeypatch, cfg=CFG):
    """``_paged_cuda`` on CPU tensors of a small step (2 requests of 64
    tokens, one KV head) against ``lib``, with the plain version barred."""
    grp, d = HEADS[regime]
    B, hkv, mb, bs = 2, 1, 4, 16
    g = torch.Generator().manual_seed(0)
    k = torch.randn((B * mb + 1, hkv, bs, d), generator=g).bfloat16()
    v = torch.randn((B * mb + 1, hkv, bs, d), generator=g).bfloat16()
    q = torch.randn((B, hkv * grp, C, d), generator=g).bfloat16()
    bt = torch.arange(1, B * mb + 1, dtype=torch.int32).reshape(B, mb)
    lens = torch.tensor([64, 64], dtype=torch.int32)
    kc, vc = cks.encode_kv(k, 8), cks.encode_kv(v, 8)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(b1, "_lib", lambda: lib)
    monkeypatch.setattr(b1, "_stream", lambda dev: 0)
    monkeypatch.setattr(b1, "_paged_torch", no_plain)
    call = b1._prepare(q, k, kc, bt, lens, None, cfg=cfg,
                       check_threshold=None, window=None, sm_scale=None,
                       fault=None)
    return b1._paged_cuda(call, k, v, kc, vc, bt, lens, cfg)


@pytest.mark.parametrize("regime", ["kimi", "gpt2"])
def test_a_tile_shape_raises_and_never_falls_back(regime, monkeypatch):
    lib = _FakeLib(1)
    launches = b1.efta_paged_attention.launches
    with pytest.raises(RuntimeError, match="tile layout"):
        _launch(regime, 64, lib, monkeypatch)
    # one launch, on the tile layout (with the fold scratch), not counted
    *_, ws, stream = lib.launch
    assert ws
    assert b1.efta_paged_attention.launches == launches


@pytest.mark.parametrize("regime,C,layout", [("kimi", 64, "tile"),
                                             ("gpt2", 64, "tile"),
                                             ("kimi", 1, "narrow"),
                                             ("kimi", 1, "decode")])
def test_a_launch_is_counted_by_layout_and_chunk_width(regime, C, layout,
                                                       monkeypatch):
    """The wrapper counts a launch where it launches, under the layout the
    rule gave it and the call's chunk width. A C 1 launch with the per-step
    output check keeps the first layout."""
    ea = b1.efta_paged_attention
    monkeypatch.setattr(ea, "launches", 0)
    monkeypatch.setattr(ea, "launches_by_layout", type(
        ea.launches_by_layout)())
    lib = _FakeLib(0)
    cfg = (EFTAConfig(mode="correct", stride=128, block_kv=16, unified=False)
           if layout == "narrow" else CFG)
    _launch(regime, C, lib, monkeypatch, cfg)
    assert ea.launches == 1
    assert dict(ea.launches_by_layout) == {(layout, C): 1}
    assert bool(lib.launch[-2]) == (layout == "tile")   # the fold scratch
