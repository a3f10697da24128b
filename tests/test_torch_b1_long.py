"""Kernel B1's long-table layout (``csrc/efta_paged_long.cuh``): launches of
one chunk row (C 1) whose block table is wider than the decode layout's
cluster holds, as three passes (score, EXP, state) over a workspace that
the wrapper allocates a call.

* The rule's Python mirror (``efta_paged.tiling``; the cuda-marked
  ``test_paged_long_tiling_mirror_equals_the_kernels_rule`` holds it to the
  C rule on the card) takes the long-table layout at every shape the decode
  layout refuses: kimi-k2's and arctic's heads from 256 to 16,384 blocks,
  gemma3-1b's D 256, in bf16 and f32. It keeps the decode layout where
  that holds the table, and the first layout for the per-step output check
  and for chunk steps.
* The long-table layout's shared bytes do not grow with the table: the
  same at 256 and at 16,384 blocks; its workspace, a slot a (request, KV
  head, block), does.
* A long-table shape whose launch fails raises; neither the first layout
  nor the plain version runs in its place. A launch is counted once, as
  ("long", 1), however many passes it makes; its count tensor has a row a
  CTA of each pass, and its workspace a slot a (request, KV head, table
  block) of the tiling's floats, allocated a call.
"""
import pytest
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.efta import EFTAConfig
from repro_torch.kernels import efta_paged as b1

torch.set_num_threads(1)

BF16, F32 = 1, 0
CFG = EFTAConfig(mode="correct", stride=128, block_kv=16)
# (query heads a KV head, head_dim) of the moe heads and gemma3-1b's
HEADS = {"kimi": (8, 112), "arctic": (7, 128), "gemma3": (4, 256)}
WIDTHS = [256, 2048, 8192, 16384]


def _shapes(regime, dtype, mb, C=1):
    grp, d = HEADS[regime]
    return (dtype, grp * C, d, 16, 8, CFG.kv_stride(16), CFG.out_stride(d),
            mb)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("mb", WIDTHS)
@pytest.mark.parametrize("regime", sorted(HEADS))
def test_mirror_takes_the_long_layout_on_wide_tables(regime, mb, dtype):
    """Every width here is past what the decode layout holds at these
    heads; the long-table layout takes it: 1 to 8 blocks a group, a CTA a
    group and at most 64 a unit in the score and EXP passes, a workspace
    slot of ``_long_slot`` floats a (request, KV head, block)."""
    shapes = _shapes(regime, dtype, mb)
    t = b1.tiling(*shapes, chunk=1)
    assert t is not None and t.layout == "long", t
    assert (t.W, t.tile, t.cluster, t.long) == (1, 0, 0, 1)
    assert 1 <= t.G <= b1._PL_G and t.ST == min(-(-mb // t.G), b1._PL_GY)
    assert t.smem <= b1._SMEM_LIMIT and t.rows == 16
    grp, d = HEADS[regime]
    assert t.fold_floats == b1._long_slot(grp, d, shapes[6])
    assert t.count_rows(grp) == t.ST + 16


def test_mirror_takes_the_long_layout_at_two_units():
    """20 query heads a KV head: two units of rows (16 and 4), each with its
    own CTAs and workspace slots."""
    t = b1.tiling(BF16, 20, 64, 16, 8, CFG.kv_stride(16), CFG.out_stride(64),
                  4096, chunk=1)
    assert t.layout == "long"
    assert t.fold_floats == 2 * b1._long_slot(20, 64, CFG.out_stride(64))
    assert t.count_rows(20) == 2 * (t.ST + 16)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("regime", sorted(HEADS))
def test_mirror_keeps_the_other_layouts(regime, dtype):
    """The decode layout where it holds the table (64 blocks; gemma3-1b's
    D 256 at 32 in f32), the first layout for the per-step output check at
    a 256-block table, and a chunk step keeps the tile layout (bf16, D up to
    128) or the first (f32, D 256). (The first layout holds the whole
    table row in shared memory; that it refuses the widest tables under
    the per-step check is its own limit.)"""
    small = 32 if (regime, dtype) == ("gemma3", F32) else 64
    assert b1.tiling(*_shapes(regime, dtype, small), chunk=1).layout == \
        "decode"
    per_step = b1.tiling(*_shapes(regime, dtype, 256), unified=False,
                         chunk=1)
    assert per_step is not None and per_step.layout == "narrow"
    chunk = b1.tiling(*_shapes(regime, dtype, 256, C=64), chunk=64)
    d = HEADS[regime][1]
    want = "tile" if dtype == BF16 and d <= 128 else "narrow"
    assert chunk is not None and chunk.layout == want, chunk


@pytest.mark.parametrize("case", ["block_32", "stride_8", "d_72"])
def test_mirror_refuses_the_long_layout_off_its_shapes(case):
    """16-key blocks at ABFT stride 4 and D a multiple of 16 only: a wide
    table off those shapes keeps the first layout, or none."""
    shapes = list(_shapes("kimi", BF16, 2048))
    if case == "block_32":
        shapes[3], shapes[5] = 32, CFG.kv_stride(32)
    elif case == "stride_8":
        shapes[5] = 8
    elif case == "d_72":
        shapes[2], shapes[6] = 72, 8
    t = b1.tiling(*shapes, chunk=1)
    assert t is None or t.layout == "narrow", t


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("regime", sorted(HEADS))
def test_shared_bytes_do_not_grow_with_the_table(regime, dtype):
    at = {mb: b1.tiling(*_shapes(regime, dtype, mb), chunk=1)
          for mb in (256, 16384)}
    assert at[256].smem == at[16384].smem
    assert at[256].G == at[16384].G
    assert at[256].fold_floats == at[16384].fold_floats


def test_long_shared_bytes_at_kimi():
    """kimi-k2's heads (grp 8, D 112, s_out 7) in bf16: eight blocks a
    group. The score pass: q (16 rows of D + 8 bf16); eight stages of K and
    K's two resident planes (8 x 112 bf16 each); eight score tiles (8 x 20
    f32) with their checksum products (8 x 4); the block maxima; the
    counts. The EXP pass: eight slots of V, V's planes, p, the checksum
    products and the row scalars (8 x 3); the running max entering the
    group; each warp's V column checksums (2 x 16 x 7); the counts. Three
    CTAs an SM."""
    t = b1.tiling(*_shapes("kimi", BF16, 256), chunk=1)
    up = lambda n: (n + 15) & ~15                           # noqa: E731
    kslot = up(16 * 120 * 2) + up(2 * 8 * 112 * 2)
    sslot = up(8 * 20 * 4) + up(8 * 4 * 4)
    score = sum(up(n) for n in (16 * 120 * 2, 8 * kslot, 8 * sslot,
                                8 * 8 * 4, 8 * 8 * 4))
    exp = sum(up(n) for n in (8 * (kslot + sslot + up(8 * 3 * 4)), 16 * 4,
                              8 * 2 * 16 * 7 * 4, 8 * 8 * 4))
    assert t.G == 8 and t.smem == max(score, exp) == 73792
    assert 3 * (t.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("mb", [256, 2048])
def test_the_workspace_is_a_slot_a_request_head_and_block(mb):
    t = b1.tiling(*_shapes("kimi", BF16, mb), chunk=1)
    ws = b1.fold_scratch(t, 8, 8, mb, "meta")
    assert ws.shape == (8, 8, mb, t.fold_floats)
    assert ws.dtype == torch.float32
    other = b1.fold_scratch(t, 4, 8, mb, "meta")
    assert other is not ws and other.shape[0] == 4


class _FakeLib:
    """The built library's entry points, with the rule of ``tiling`` and a
    launch that returns ``rc``: 1 fails as a refused launch does
    (cudaErrorInvalidValue), 0 succeeds without running anything."""

    def __init__(self, rc):
        self.rc = rc
        self.launch = None
        self.tiles = None

    def efta_paged_tiling(self, *a):
        t = b1.tiling(*a[:9], chunk=a[9])
        if t is None:
            return 0
        for i, v in enumerate(t):
            a[10][i] = v
        self.tiles = t.count_rows(a[1])
        return self.tiles

    def efta_paged_launch(self, *a):
        self.launch = a
        return self.rc

    def efta_paged_error_string(self, rc):
        return b"invalid argument"


def _launch(lib, monkeypatch, dtype=torch.float32):
    """``_paged_cuda`` on CPU tensors of a decode step (2 requests, one KV
    head of kimi's 8 query heads of 112) over a 256-block table, against
    ``lib``, with the plain version barred."""
    B, hkv, grp, mb, bs, d = 2, 1, 8, 256, 16, 112
    g = torch.Generator().manual_seed(0)
    k = torch.randn((B * 4 + 1, hkv, bs, d), generator=g).to(dtype)
    v = torch.randn((B * 4 + 1, hkv, bs, d), generator=g).to(dtype)
    q = torch.randn((B, hkv * grp, d), generator=g).to(dtype)
    bt = torch.zeros((B, mb), dtype=torch.int32)
    bt[:, :4] = torch.arange(1, B * 4 + 1, dtype=torch.int32).reshape(B, 4)
    lens = torch.tensor([40, 64], dtype=torch.int32)
    kc, vc = cks.encode_kv(k, 8), cks.encode_kv(v, 8)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(b1, "_lib", lambda: lib)
    monkeypatch.setattr(b1, "_stream", lambda dev: 0)
    monkeypatch.setattr(b1, "_paged_torch", no_plain)
    call = b1._prepare(q, k, kc, bt, lens, None, cfg=CFG,
                       check_threshold=None, window=None, sm_scale=None,
                       fault=None)
    return b1._paged_cuda(call, k, v, kc, vc, bt, lens, CFG)


def test_a_long_shape_raises_and_never_falls_back(monkeypatch):
    lib = _FakeLib(1)
    launches = b1.efta_paged_attention.launches
    with pytest.raises(RuntimeError, match="long layout"):
        _launch(lib, monkeypatch)
    # one launch, with the workspace, not counted
    *_, ws, stream = lib.launch
    assert ws
    assert b1.efta_paged_attention.launches == launches


def test_a_long_launch_is_counted_once(monkeypatch):
    """Three passes, one call: counted once under ("long", 1), with a count
    row for each CTA of the passes (GY score / EXP CTAs and 16 state CTAs
    of the one unit)."""
    ea = b1.efta_paged_attention
    monkeypatch.setattr(ea, "launches", 0)
    monkeypatch.setattr(ea, "launches_by_layout", type(
        ea.launches_by_layout)())
    lib = _FakeLib(0)
    _launch(lib, monkeypatch)
    assert ea.launches == 1
    assert dict(ea.launches_by_layout) == {("long", 1): 1}
    t = b1.tiling(F32, 8, 112, 16, 8, CFG.kv_stride(16), CFG.out_stride(112),
                  256, chunk=1)
    assert lib.tiles == t.ST + 16 == 80
