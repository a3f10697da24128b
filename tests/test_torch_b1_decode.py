"""Kernel B1's decode layout (``csrc/efta_paged_decode.cuh``): launches of
one chunk row (C 1), a cluster of 8 CTAs a (request, KV head, 16 query
heads), each on a contiguous span of the running blocks, with the block
maxima and the blocks' partial products read over distributed shared
memory and the running state folded in block order.

* The rule's Python mirror (``efta_paged.tiling``; the cuda-marked
  ``test_paged_tiling_mirror_equals_the_kernels_rule`` holds it to the C
  rule on the card) takes the decode layout at the decode step of gpt2,
  kimi-k2, arctic and gemma3-1b in bf16 and f32, and keeps the first layout
  for the per-step output check and the tile layout for bf16 C 64.
* The shapes whose share of the table does not fit one CTA's shared memory
  are named: they take the long-table layout
  (``tests/test_torch_b1_long.py``).
* The decode layout's shared bytes follow the C layout's arithmetic.
* A decode shape whose launch fails raises; neither the first layout nor
  the plain version runs in its place. A launch is counted as
  ("decode", 1).
"""
import pytest
import torch

from repro_torch.core import checksum as cks
from repro_torch.core.efta import EFTAConfig
from repro_torch.kernels import efta_paged as b1

torch.set_num_threads(1)

BF16, F32 = 1, 0
CFG = EFTAConfig(mode="correct", stride=128, block_kv=16)
# (query heads a KV head, head_dim, table blocks) of the decode regimes:
# the serve runs' 64-block tables; gemma3-1b's D 256 in f32 at a table of
# 32 blocks (its window of 512 tokens), see test_refused_decode_shapes
HEADS = {"gpt2": (1, 64, 64), "kimi": (8, 112, 64), "arctic": (7, 128, 64),
         "gemma3": (4, 256, 64)}


def _shapes(regime, dtype=BF16, C=1, mb=None):
    grp, d, blocks = HEADS[regime]
    return (dtype, grp * C, d, 16, 8, CFG.kv_stride(16), CFG.out_stride(d),
            blocks if mb is None else mb)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("regime", sorted(HEADS))
def test_mirror_takes_the_decode_layout_at_c1(regime, dtype):
    mb = 32 if (regime, dtype) == ("gemma3", F32) else None
    t = b1.tiling(*_shapes(regime, dtype, mb=mb), chunk=1)
    assert t is not None and t.layout == "decode", t
    assert (t.W, t.ST, t.cluster, t.tile, t.fold_floats) == (1, 1, 8, 0, 0)
    assert 1 <= t.G <= 4 and t.rows == 16
    assert t.smem <= b1._SMEM_LIMIT
    # the fold scratch is the tile layout's alone
    assert b1.fold_scratch(t, 8, 8, 64, "meta") is None


@pytest.mark.parametrize("regime", sorted(HEADS))
def test_mirror_keeps_the_other_layouts(regime):
    """The per-step output check keeps the first layout at C 1; a bf16 C 64
    step keeps the tile layout where it took it (D up to 128), an f32 one
    the first layout."""
    per_step = b1.tiling(*_shapes(regime), unified=False, chunk=1)
    assert per_step is not None and per_step.layout == "narrow"
    chunk = b1.tiling(*_shapes(regime, C=64), chunk=64)
    d = HEADS[regime][1]
    assert chunk.layout == ("tile" if d <= 128 else "narrow"), chunk
    f32 = b1.tiling(*_shapes(regime, F32, C=64), chunk=64)
    assert f32.layout == "narrow"


@pytest.mark.parametrize("case", ["block_32", "stride_8", "d_72", "d_272"])
def test_mirror_refuses_the_decode_layout_off_its_shapes(case):
    """16-key blocks at ABFT stride 4 and D a multiple of 16 up to 256
    only; the first layout takes what it can of the rest."""
    shapes = list(_shapes("kimi"))
    if case == "block_32":
        shapes[3], shapes[5] = 32, CFG.kv_stride(32)
    elif case == "stride_8":
        shapes[5] = 8
    elif case == "d_72":
        shapes[2], shapes[6] = 72, 8
    elif case == "d_272":
        shapes[2], shapes[6] = 272, 16
    t = b1.tiling(*shapes, chunk=1)
    assert t is None or t.layout == "narrow", t


# (regime, dtype, table blocks) whose 8-CTA cluster cannot hold a CTA's
# share of the table (V and the partials exchange 2 reads for ceil(mb / 8)
# blocks) in 227 KB: the decode layout refuses them, and the long-table
# layout takes them
REFUSED = [("gemma3", F32, 64), ("gemma3", BF16, 128), ("arctic", F32, 128),
           ("kimi", F32, 256)]


@pytest.mark.parametrize("regime,dtype,mb", REFUSED)
def test_refused_decode_shapes(regime, dtype, mb):
    t = b1.tiling(*_shapes(regime, dtype, mb=mb), chunk=1)
    assert t is not None and t.layout == "long", t
    assert b1._decode_layout(1, HEADS[regime][0], HEADS[regime][1], 8,
                             CFG.out_stride(HEADS[regime][1]),
                             4 if dtype == F32 else 2, mb) > b1._SMEM_LIMIT


def test_decode_shared_bytes_at_kimi():
    """kimi-k2's heads (grp 8, D 112, s_out 7) in bf16 over a 64-block
    table: the table row (64 ints); q (16 rows of D + 8 bf16); 8 span slots
    of V (16 x 120 bf16), the scores (8 x 20 f32), the checksum products
    (8 x 4) and the row scalars (8 x 2); K stages of K and the four
    resident planes (8 x 112 bf16 each), three (four would leave room for
    one CTA an SM, not two); what the owned row's 64 blocks store there:
    alpha and three row terms, P V (116 floats), the two O-checksum
    products (2 x 7); its state; 8 CTAs' max|V|; the counts."""
    t = b1.tiling(*_shapes("kimi"), chunk=1)
    up = lambda n: (n + 15) & ~15                           # noqa: E731
    slot = sum(up(n) for n in (16 * 120 * 2, 8 * 20 * 4, 8 * 4 * 4,
                               8 * 2 * 4))
    kstage = up(16 * 120 * 2) + up(4 * 8 * 112 * 2)
    parts = [64 * 4, 16 * 120 * 2, 8 * slot, 3 * kstage, 64 * 4 * 4,
             64 * 116 * 4, 64 * 2 * 7 * 4, (116 + 2 * 7 + 4) * 4, 8 * 4,
             8 * 8 * 4]
    assert t.G == 3 and t.smem == sum(up(n) for n in parts) == 109632
    assert t.smem + 1024 <= 228 * 1024 // 2
    four = b1._decode_layout(4, 8, 112, 8, 7, 2, 64)
    assert four <= b1._SMEM_LIMIT and four + 1024 > 228 * 1024 // 2


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
        self.tiles = -(-a[1] // t.rows) * (t.cluster or 1)
        return self.tiles

    def efta_paged_launch(self, *a):
        self.launch = a
        return self.rc

    def efta_paged_error_string(self, rc):
        return b"invalid argument"


def _launch(grp, lib, monkeypatch):
    """``_paged_cuda`` on CPU tensors of a decode step (2 requests, one KV
    head of ``grp`` query heads of 64) against ``lib``, with the plain
    version barred."""
    B, hkv, mb, bs, d = 2, 1, 4, 16, 64
    g = torch.Generator().manual_seed(0)
    k = torch.randn((B * mb + 1, hkv, bs, d), generator=g).bfloat16()
    v = torch.randn((B * mb + 1, hkv, bs, d), generator=g).bfloat16()
    q = torch.randn((B, hkv * grp, d), generator=g).bfloat16()
    bt = torch.arange(1, B * mb + 1, dtype=torch.int32).reshape(B, mb)
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


def test_a_decode_shape_raises_and_never_falls_back(monkeypatch):
    lib = _FakeLib(1)
    launches = b1.efta_paged_attention.launches
    with pytest.raises(RuntimeError, match="decode layout"):
        _launch(8, lib, monkeypatch)
    # one launch, without a fold scratch, not counted
    *_, ws, stream = lib.launch
    assert ws is None
    assert b1.efta_paged_attention.launches == launches


@pytest.mark.parametrize("grp,tiles", [(8, 8), (20, 16)])
def test_a_decode_launch_is_counted(grp, tiles, monkeypatch):
    """Counted under ("decode", 1) where it launches; its count tensor has
    a row a CTA (8 a unit of up to 16 query heads)."""
    ea = b1.efta_paged_attention
    monkeypatch.setattr(ea, "launches", 0)
    monkeypatch.setattr(ea, "launches_by_layout", type(
        ea.launches_by_layout)())
    lib = _FakeLib(0)
    _launch(grp, lib, monkeypatch)
    assert ea.launches == 1
    assert dict(ea.launches_by_layout) == {("decode", 1): 1}
    assert lib.tiles == tiles
