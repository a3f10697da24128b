"""Tests that need an NVIDIA card: the CUDA kernels (fused paged EFTA,
fused contiguous EFTA) against their plain PyTorch versions on the same
CUDA tensors. Marked ``cuda``; each skips with
a reason where ``torch.cuda.is_available()`` is false. This file imports
no JAX, so it also runs on a machine with only the port installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import cuda_or_skip, to_np  # noqa: E402

from repro_torch.core import checksum as cks  # noqa: E402
from repro_torch.core.efta import EFTAConfig  # noqa: E402
from repro_torch.core.fault import Site, flip_bit_at  # noqa: E402
from repro_torch.kernels.efta_paged import (  # noqa: E402
    efta_paged_attention, efta_paged_attention_torch)


def _bound(ref_out):
    """The largest difference allowed at each output element. f32: 1e-5 of
    the largest finite output. bf16: about one bf16 ulp of the element,
    2^-7 |b| + 2^-8 rms(b) (both versions round the same f32 result to
    bf16 once; the rms term covers elements near zero)."""
    b = to_np(ref_out.float())
    fin = b[np.isfinite(b)]
    if ref_out.dtype == torch.float32:
        return np.full(b.shape, 1e-5 * max(1.0, float(np.abs(fin).max())))
    return 2.0 ** -7 * np.abs(b) + 2.0 ** -8 * float(np.sqrt(
        np.mean(np.square(fin))))


def _case(dev, dtype, *, B=3, mb=4, bs=16, hkv=2, grp=2, hd=64, C=5,
          seed=0, q_lens=None, full=False):
    g = torch.Generator().manual_seed(seed)
    nb = B * mb
    k = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    v = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    q = torch.randn((B, hkv * grp, C, hd), generator=g)
    bt = torch.randperm(nb, generator=g).add(1).reshape(B, mb).int()
    lens = torch.randint(C, mb * bs + 1, (B,), generator=g).int()
    if full:
        lens[1] = mb * bs
    k, v, q = (x.to(dev, dtype) for x in (k, v, q))
    kc, vc = cks.encode_kv(k, 8), cks.encode_kv(v, 8)
    args = [q, k, v, kc, vc, bt.to(dev), lens.to(dev)]
    if q_lens is not None:
        args.append(torch.tensor(q_lens, dtype=torch.int32, device=dev))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_kernel_matches_plain_version(dtype, site):
    dev = cuda_or_skip()
    args = _case(dev, dtype)
    cfg = EFTAConfig(mode="correct", stride=8, block_kv=16)
    fault = None if site is None else [int(site), 0, 1, 1, 2, 3, 27, 1]
    got = efta_paged_attention(*args, cfg=cfg, fault=fault)
    plain = efta_paged_attention_torch(*args, cfg=cfg, fault=fault)
    diff = np.abs(to_np(got.out.float()) - to_np(plain.out.float()))
    assert (diff <= _bound(plain.out)).all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(got.detected), to_np(plain.detected))
    np.testing.assert_array_equal(to_np(got.bad_blocks),
                                  to_np(plain.bad_blocks))


# the redesign's cases: decode at grp 4 (one warp, 4 real rows of 16), a
# C 64 step whose requests 1 and 2 are decode rows (their other 63 rows are
# padding, computed and counted as the reference counts them) and request
# 0 a half chunk, and a 64-block table walked to its end. The SEU strikes
# request 1 in its first and its last block.
B1_CASES = {
    "decode_grp4": dict(grp=4, C=1, mb=8),
    "mixed_c64": dict(grp=1, C=64, mb=8, q_lens=[32, 1, 1]),
    "context_1024": dict(grp=1, C=1, mb=64, full=True),
    # the moe family's heads: kimi-k2 (8 query heads a KV head of 112,
    # output stride 7) and arctic (7 a KV head of 128: 7 decode rows of a
    # 16-row group)
    "kimi_decode_d112": dict(grp=8, hd=112, C=1, mb=8, stride=128),
    "kimi_mixed_d112": dict(grp=8, hd=112, C=64, mb=8, q_lens=[32, 1, 1],
                            stride=128),
    "arctic_decode_d128": dict(grp=7, hd=128, C=1, mb=8, stride=128),
    "arctic_mixed_d128": dict(grp=7, hd=128, C=64, mb=8, q_lens=[32, 1, 1],
                              stride=128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(B1_CASES))
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
@pytest.mark.parametrize("mode", ["correct", "detect"])
def test_kernel_redesign_cases(name, site, mode):
    dev = cuda_or_skip()
    case = dict(B1_CASES[name])
    stride = case.pop("stride", 8)        # 128: the engine's config
    args = _case(dev, torch.bfloat16, **case)
    cfg = EFTAConfig(mode=mode, stride=stride, block_kv=16)
    last = (int(args[6][1]) - 1) // 16
    runs = [(None if site is None else [int(site), block, 1, 1, 0, 3, 27, 1],
             args) for block in (0, last)]
    if site is None:
        # a resident flip (top bf16 exponent bit) in request 2's last block:
        # every row of the request counts it, padding rows included
        k = args[1].clone()
        hkv, bs, hd = k.shape[1:]
        blk = int(args[5][2, (int(args[6][2]) - 1) // 16])
        flip_bit_at(k, ((blk * hkv + 1) * bs + 2) * hd + 5, 14)
        runs = [(None, args), (None, [args[0], k, *args[2:]])]
    for fault, a in runs:
        got = efta_paged_attention(*a, cfg=cfg, fault=fault)
        plain = efta_paged_attention_torch(*a, cfg=cfg, fault=fault)
        ref = to_np(plain.out.float())
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.where(fin, 0, to_np(got.out.float())),
                                      np.where(fin, 0, ref))
        diff = np.abs(to_np(got.out.float()) - ref)[fin]
        assert (diff <= _bound(plain.out)[fin]).all(), \
            f"max |kernel - plain| {diff.max():.3e} over its bound"
        np.testing.assert_array_equal(to_np(got.detected),
                                      to_np(plain.detected))
        np.testing.assert_array_equal(to_np(got.bad_blocks),
                                      to_np(plain.bad_blocks))


# --- the fused contiguous EFTA kernel (efta_attention.cu) -------------------

from repro_torch.kernels.efta_attention import (  # noqa: E402
    efta_attention, efta_attention_torch)


def _contig(dev, dtype, *, B=1, H=4, Hkv=2, Sq=64, Skv=128, D=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, Sq, D), generator=g)
    k = torch.randn((B, Hkv, Skv, D), generator=g)
    v = torch.randn((B, Hkv, Skv, D), generator=g)
    return [x.to(dev, dtype) for x in (q, k, v)]


def _same(got, plain):
    out, det = got
    ref_out, ref_det = plain
    ref = to_np(ref_out.float())
    # an uncorrected SEU in detect mode may leave inf or NaN, which must
    # then match exactly; finite values within _bound element by element
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(out.float())),
                                  np.where(fin, 0, ref))
    diff = np.abs(to_np(out.float()) - ref)[fin]
    assert (diff <= _bound(ref_out)[fin]).all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(det), to_np(ref_det))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
@pytest.mark.parametrize("mode", ["correct", "detect"])
def test_contiguous_kernel_matches_plain_version(dtype, site, mode):
    dev = cuda_or_skip()
    q, k, v = _contig(dev, dtype)
    cfg = EFTAConfig(mode=mode, stride=8, block_kv=32)
    # the top exponent bit of the f32 compute tile in correct mode; bit 27
    # in detect mode, where a top-bit flip can leave an uncorrected
    # subnormal rowsum whose value hangs on the summation order
    bit = 30 if mode == "correct" else 27
    fault = None if site is None else [int(site), 1, 3, 37, 9, bit, 1, 0]
    kw = dict(cfg=cfg, causal=True, fault=fault, block_q=32)
    _same(efta_attention(q, k, v, **kw), efta_attention_torch(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["per_step", "off", "ragged", "window",
                                     "gemma3", "gemma3_f32",
                                     "gemma3_f32_nowindow", "gpt2_prefill"])
def test_contiguous_kernel_variants(variant):
    dev = cuda_or_skip()
    kw = dict(causal=True, block_q=32)
    shape = {}
    cfg = EFTAConfig(mode="correct", stride=8, block_kv=32)
    if variant == "per_step":
        cfg = EFTAConfig(mode="correct", stride=8, block_kv=32, unified=False)
    elif variant == "off":
        cfg = EFTAConfig(mode="off", stride=8, block_kv=32)
    elif variant == "ragged":
        kw = dict(causal=False, kv_len=100, block_q=32)
    elif variant == "window":
        kw = dict(causal=True, window=40, block_q=32)
    elif variant.startswith("gemma3"):
        shape = dict(H=4, Hkv=1, Sq=256, Skv=1024, D=256)
        cfg = EFTAConfig()
        kw = dict(causal=True, window=None if "nowindow" in variant
                  else 512)
    else:
        shape = dict(H=12, Hkv=12, Sq=512, Skv=512, D=64)
        cfg = EFTAConfig()
        kw = dict(causal=True)
    q, k, v = _contig(dev, torch.bfloat16 if variant == "gemma3"
                      else torch.float32, **shape)
    fault = [int(Site.EXP), 0, 1, 5, 3, 30, 1, 0]
    for f in (None, fault):
        _same(efta_attention(q, k, v, cfg=cfg, fault=f, **kw),
              efta_attention_torch(q, k, v, cfg=cfg, fault=f, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bucket64", "bucket512", "gemma3"])
@pytest.mark.parametrize("groups", [2, 1])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
@pytest.mark.parametrize("mode", ["correct", "detect"])
def test_contiguous_rows_per_block(variant, groups, site, mode, monkeypatch):
    """The kernel at each choice of rows per thread block (2 or 1 groups of
    16 rows), at the ring prefill's buckets and gemma3-1b's D 256, in
    bf16."""
    import importlib
    dev = cuda_or_skip()
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.efta_attention"), "_MAX_GROUPS", groups)
    shape = {"bucket64": dict(H=4, Hkv=4, Sq=64, Skv=64, D=64),
             "bucket512": dict(H=2, Hkv=2, Sq=512, Skv=512, D=64),
             "gemma3": dict(H=4, Hkv=1, Sq=256, Skv=1024, D=256)}[variant]
    kw = dict(causal=True, window=512 if variant == "gemma3" else None)
    q, k, v = _contig(dev, torch.bfloat16, **shape)
    cfg = EFTAConfig(mode=mode)
    bit = 30 if mode == "correct" else 27
    row = shape["Sq"] - 1
    fault = None if site is None else [int(site), row // 512, 1, row, 3, bit,
                                       1, 0]
    _same(efta_attention(q, k, v, cfg=cfg, fault=fault, **kw),
          efta_attention_torch(q, k, v, cfg=cfg, fault=fault, **kw))


# --- a speculative scoring step and its KV rollback ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flip", [False, True])
def test_spec_step_and_rollback_match_plain(dtype, flip):
    """One layer's speculative scoring step on the card — a C 64 chunk with
    slots feeding 1 + 4 rows (pending token + drafts), 1 row (a plain
    decode riding along) and none — then ``paged_rollback`` of the rejected
    rows, against the same step and rollback on the CPU's plain path. The
    outputs agree within ``_bound``; the pools and checksums are equal (the
    appended rows are copies, the two-segment folds exact); the bad planes
    and the zeroed rows are equal. With ``flip``, a committed row of a
    rolled-back block is struck between the two: the guard flags it on
    both."""
    from repro_torch.models.attention import (PagedKVCache, _paged_chunk,
                                              paged_rollback)
    dev = cuda_or_skip()
    g = torch.Generator().manual_seed(3)
    B, hkv, grp, hd, bs, mb, C, K = 4, 2, 2, 64, 16, 8, 64, 4
    nb = B * mb
    pos = torch.tensor([37, 20, 47, 0], dtype=torch.int32)
    q_len = torch.tensor([1 + K, 1, 1 + K, 0], dtype=torch.int32)
    keep = pos + torch.tensor([1 + 2, 1, 1, 0], dtype=torch.int32)
    k = torch.randn((1, nb + 1, hkv, bs, hd), generator=g)
    v = torch.randn((1, nb + 1, hkv, bs, hd), generator=g)
    bt = torch.randperm(nb, generator=g).add(1).reshape(B, mb).int()
    q = torch.randn((B, hkv * grp, C, hd), generator=g)
    kn = torch.randn((B, hkv, C, hd), generator=g)
    vn = torch.randn((B, hkv, C, hd), generator=g)
    cfg = EFTAConfig(mode="correct", stride=8, block_kv=16)
    thr = cks.kv_block_threshold(dtype)
    res = {}
    for d in ("cpu", dev):
        kk, vv = k.to(d, dtype), v.to(d, dtype)
        kc, vc = cks.encode_kv(kk, 8), cks.encode_kv(vv, 8)
        pool = [kk, vv, kc.c1, kc.c2, vc.c1, vc.c2]
        cache = PagedKVCache(*pool, bt=bt.to(d), pos=pos.to(d),
                             q_len=q_len.to(d),
                             bad=torch.zeros((B, mb), dtype=torch.int32,
                                             device=d))
        out, rep, bad = _paged_chunk(
            q.to(d, dtype), kn.to(d, dtype), vn.to(d, dtype), cache.layer(0),
            cfg=cfg, window=None, sm_scale=None, fault=None)
        if flip:
            # slot 0 keeps 40 rows: row 39 sits in block 2, which the
            # rollback of rows 40..41 touches
            blk = int(bt[0, 2])
            flip_bit_at(pool[0], ((blk * hkv + 1) * bs + 7) * hd + 5,
                        14 if dtype == torch.bfloat16 else 30)
        rb = paged_rollback(*pool, bt.to(d), keep.to(d), (pos + q_len).to(d),
                            check_stride=8, threshold=thr)
        res[d if d == "cpu" else "cuda"] = (out, rep, bad, rb, pool)
    out_c, rep_c, bad_c, rb_c, pool_c = res["cuda"]
    out_p, rep_p, bad_p, rb_p, pool_p = res["cpu"]
    valid = (torch.arange(C)[None, :] < q_len[:, None])[:, None, :, None]
    diff = np.abs(to_np(out_c.float().cpu()) - to_np(out_p.float()))
    bound = _bound(out_p)
    assert (diff <= bound)[to_np(valid.expand_as(out_p))].all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(rep_c.detected), to_np(rep_p.detected))
    np.testing.assert_array_equal(to_np(bad_c), to_np(bad_p))
    np.testing.assert_array_equal(to_np(rb_c), to_np(rb_p))
    assert int(rb_p.sum()) == (1 if flip else 0)
    for a, b in zip(pool_c, pool_p):      # block 0 is the padding scratch
        np.testing.assert_array_equal(to_np(a[:, 1:].float().cpu()),
                                      to_np(b[:, 1:].float()))
    # the rejected rows are zero: slot 0 rows 40..41, slot 2 rows 48..51
    kz = pool_p[0][0]
    assert not bool(kz[int(bt[0, 2]), :, 8:10].any())
    assert not bool(kz[int(bt[2, 3]), :, 0:4].any())
    assert bool(kz[int(bt[2, 2]), :, 15].any())     # slot 2 row 47 kept


# --- the encoder and encoder-decoder regimes of the contiguous kernel ------

# bert-large's non-causal self-attention (H 16, Sq = Skv 512) and t5-small's
# cross-attention of a 64-token prompt and of one decode row to a 512-row
# encoder memory (H 8): at Sq 1 a thread block computes one real row and 15
# padding rows, which must not count
B2_REGIMES = {"bert_large_encoder": dict(H=16, Hkv=16, Sq=512, Skv=512),
              "cross_prefill": dict(H=8, Hkv=8, Sq=64, Skv=512),
              "cross_decode": dict(H=8, Hkv=8, Sq=1, Skv=512)}

# the moe family's ring prefill at bucket 512, causal: kimi-k2's 8 query
# heads a KV head of 112 (output stride 7, 16-column PV slices) and
# arctic's 7 a KV head of 128
MOE_B2 = {"kimi_d112": dict(H=16, Hkv=2, D=112),
          "arctic_d128": dict(H=14, Hkv=2, D=128)}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(MOE_B2))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_moe_heads(regime, dtype, site):
    dev = cuda_or_skip()
    q, k, v = _contig(dev, dtype, Sq=512, Skv=512, seed=11, **MOE_B2[regime])
    fault = None if site is None else [int(site), 0, 3, 511, 5, 30, 1, 0]
    kw = dict(cfg=EFTAConfig(mode="correct"), causal=True, fault=fault)
    got = efta_attention(q, k, v, **kw)
    _same(got, efta_attention_torch(q, k, v, **kw))
    if site is None:
        assert int(got[1].sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP):
        assert int(got[1].sum()) >= 1


# llama-3.2-vision-11b's attention under efta_pallas at block_kv 64 (its
# 1,600 frontend rows are 25 blocks; 512 do not divide them): 32 heads of
# 128 on 8 KV heads, the causal self-attention prefill of a 512-token
# prompt, and the cross-attention of that prompt and of one decode row to
# the 1,600 rows
VLM_B2 = {"vlm_self_prefill": dict(Sq=512, Skv=512, causal=True),
          "vlm_cross_prefill": dict(Sq=512, Skv=1600, causal=False),
          "vlm_cross_decode": dict(Sq=1, Skv=1600, causal=False)}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(VLM_B2))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_vlm_regimes(regime, dtype, site):
    dev = cuda_or_skip()
    shape = dict(VLM_B2[regime])
    causal = shape.pop("causal")
    q, k, v = _contig(dev, dtype, H=32, Hkv=8, D=128, seed=13, **shape)
    row = shape["Sq"] - 1
    fault = None if site is None else [int(site), 0, 3, row, 5, 30, 1, 0]
    kw = dict(cfg=EFTAConfig(mode="correct", block_kv=64), causal=causal,
              fault=fault)
    got = efta_attention(q, k, v, **kw)
    _same(got, efta_attention_torch(q, k, v, **kw))
    if site is None:
        assert int(got[1].sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP):
        assert int(got[1].sum()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B2_REGIMES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_encoder_and_cross_regimes(regime, dtype, site):
    dev = cuda_or_skip()
    shape = B2_REGIMES[regime]
    q, k, v = _contig(dev, dtype, B=2, D=64, seed=7, **shape)
    cfg = EFTAConfig(mode="correct")
    row = shape["Sq"] - 1
    fault = None if site is None else [int(site), 0, 3, row, 5, 30, 1, 0]
    kw = dict(cfg=cfg, causal=False, fault=fault)
    got = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    _same(got, plain)
    if site is None:
        assert int(got[1].sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP):
        # the shadows and the EXP recompute catch every flip at their site
        assert int(got[1].sum()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["abft_matmul", "tensor_abft_matmul"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abft_matmul_on_the_card_matches_the_cpu(fn, dtype):
    """The linear-module ABFT at gpt2's MLP shape on the card (16-bit
    products on the tensor cores with an f32 result) against the same call
    on the CPU, clean and under a GEMM1 SEU at the top exponent bit of an
    element of |y| >= 2 (which it shrinks to ~0): equal counts, outputs
    within one bf16 ulp (f32: 1e-5 of the largest). The rank-1 check of a
    3,072-wide bf16 row has a threshold of 5e-2 of the row sum (~2.8 here),
    so it may miss that flip, on both devices alike; the strided one
    folds 24 values a column and sees it."""
    from repro_torch.core import abft_gemm
    from repro_torch.core.fault import FaultSpec
    dev = cuda_or_skip()
    g = torch.Generator().manual_seed(9)
    x = torch.randn((512, 768), generator=g).to(dtype)
    w = (torch.randn((768, 3072), generator=g) / 768 ** 0.5).to(dtype)
    y = x.float() @ w.float()
    r, c = (int(i) for i in (y.abs() >= 2).nonzero()[0])
    for fault in (None, FaultSpec.single(Site.GEMM1, batch=r, head=c,
                                         bit=30)):
        got = getattr(abft_gemm, fn)(x.to(dev), w.to(dev), fault=fault)
        ref = getattr(abft_gemm, fn)(x, w, fault=fault)
        assert int(got[1]) == int(ref[1])
        if fn == "tensor_abft_matmul" or dtype == torch.float32:
            assert int(got[1]) == (fault is not None)
        _same((got[0].cpu(), got[1].cpu()), ref)


# kernel B2 at wide KV blocks: the dry run's block_kv 2,048 (fold stride
# 64) over two blocks and 4,096 (stride 128) with a ragged tail on the
# cluster layout (a cluster of CTAs shares a tile's rows, each CTA its fold
# residues), and 32,768 (256 fold segments) at 16 query rows on the
# workspace layout (scores in a global workspace, a persistent grid); 2
# query heads on one KV head
B2_WIDE = {"bkv2048_causal": dict(Sq=4096, Skv=4096, bkv=2048, causal=True),
           "bkv4096_ragged": dict(Sq=256, Skv=8192, bkv=4096, causal=False,
                                  kv_len=8092),
           "bkv32768_sq16": dict(Sq=16, Skv=65536, bkv=32768, causal=False)}
B2_WIDE_LAYOUT = {"bkv2048_causal": "cluster", "bkv4096_ragged": "cluster",
                  "bkv32768_sq16": "workspace"}


def _wide_bound(plain, q, k, v, causal, kv_len, window=None):
    """``_bound`` plus, in bf16, 2^-7 (P |V|): the kernel and the plain
    version may round a p next to a bf16 boundary apart (their f32 scores
    differ in the last bits)."""
    from repro_torch.core.efta import reference_attention
    bound = _bound(plain[0])
    if plain[0].dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * to_np(reference_attention(
            q, k, v.float().abs(), causal=causal, kv_len=kv_len,
            window=window).float())
    return bound


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B2_WIDE))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_wide_blocks(regime, d, dtype, site):
    from repro_torch.kernels import efta_attention as mod
    dev = cuda_or_skip()
    shape = dict(B2_WIDE[regime])
    bkv, causal = shape.pop("bkv"), shape.pop("causal")
    kv_len = shape.pop("kv_len", None)
    q, k, v = _contig(dev, dtype, H=2, Hkv=1, D=d, seed=17, **shape)
    cfg = EFTAConfig(mode="correct", block_kv=bkv)
    assert mod.kernel_tiling(mod.DTYPES[dtype], min(128, shape["Sq"]), bkv,
                             d, cfg.kv_stride(bkv), cfg.out_stride(d)
                             ).layout == B2_WIDE_LAYOUT[regime]
    row = shape["Sq"] - 1
    fault = None if site is None else [int(site), 0, 1, row, 3, 30, 1, 0]
    kw = dict(cfg=cfg, causal=causal, kv_len=kv_len, fault=fault)
    got = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    out, det = got
    ref = to_np(plain[0].float())
    bound = _wide_bound(plain, q, k, v, causal, kv_len)
    diff = np.abs(to_np(out.float()) - ref)
    assert (diff <= bound).all(), f"max |kernel - plain| {diff.max():.3e}"
    np.testing.assert_array_equal(to_np(det), to_np(plain[1]))
    if site is None:
        assert int(det.sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP, Site.GEMM1):
        assert int(det.sum()) >= 1


# the cluster layout in its regimes at block_kv 2,048 (D 128, a cluster of
# 8 CTAs of 8 fold residues each), two KV blocks: a ragged kv_len that ends
# inside the second block (non-causal, 256 query rows), GQA (6 query heads
# on 2 KV heads) under the causal mask, and causal with a 1,000-key window
# (the first block skipped for the last tiles); the SEU strikes the last
# row in the second block, at a visible key column whose residue lies in
# CTA 0, 6 or 7 (output column 3 for GEMM II). bf16 at one cluster tile of
# 16, 32 or 64 rows (max_groups 1, 2, 4); f32 at 64.
B2_CLUSTER = {"ragged": dict(H=2, Hkv=1, Sq=256, causal=False, kv_len=3000,
                             col=901),
              "gqa": dict(H=6, Hkv=2, Sq=4096, causal=True, col=1077),
              "window": dict(H=2, Hkv=1, Sq=4096, causal=True, window=1000,
                             col=1085)}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B2_CLUSTER))
@pytest.mark.parametrize("groups,dtype", [(1, torch.bfloat16),
                                          (2, torch.bfloat16),
                                          (4, torch.bfloat16),
                                          (4, torch.float32)])
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_cluster_layout(regime, groups, dtype, site,
                                          monkeypatch):
    from repro_torch.kernels import efta_attention as mod
    dev = cuda_or_skip()
    monkeypatch.setattr(mod, "_MAX_GROUPS", groups)
    shape = dict(B2_CLUSTER[regime])
    causal, kv_len = shape.pop("causal"), shape.pop("kv_len", None)
    window, key_col = shape.pop("window", None), shape.pop("col")
    q, k, v = _contig(dev, dtype, Skv=4096, D=128, seed=23, **shape)
    cfg = EFTAConfig(mode="correct", block_kv=2048)
    t = mod.kernel_tiling(mod.DTYPES[dtype], 128, 2048, 128, 64, 8, groups)
    assert t.layout == "cluster" and t.cluster == 8
    assert t.W == (groups if dtype == torch.bfloat16 else 4)
    col = 3 if site == Site.GEMM2 else key_col
    fault = None if site is None else [int(site), 1, 1, shape["Sq"] - 1, col,
                                       30, 1, 0]
    kw = dict(cfg=cfg, causal=causal, kv_len=kv_len, window=window,
              fault=fault)
    out, det = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    bound = _wide_bound(plain, q, k, v, causal, kv_len, window)
    diff = np.abs(to_np(out.float()) - to_np(plain[0].float()))
    assert (diff <= bound).all(), f"max |kernel - plain| {diff.max():.3e}"
    np.testing.assert_array_equal(to_np(det), to_np(plain[1]))
    if site is None:
        assert int(det.sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP, Site.GEMM1):
        assert int(det.sum()) >= 1


# the tile layout (csrc/efta_attention_tile.cuh: a fold pass once per KV
# head and KV block, then 64 query rows a CTA on wgmma) at the narrow
# path's bf16 prefill regimes, fewer heads: kimi-k2's (D 112, 8 a KV head)
# and arctic's (D 128, 7) causal bucket 512, bert-large's non-causal
# encoder, the VLM's self and cross prefill at block_kv 64 (25 blocks of
# the 1,600 rows), gpt2's bucket 512 and t5's cross prefill (64 rows to a
# 512-row memory); held to _bound plus the p rounding slack (its GEMM I
# sums in another order than the plain version's)
B2_TILE = {"kimi_512": dict(H=16, Hkv=2, Sq=512, Skv=512, D=112, causal=True),
           "arctic_512": dict(H=14, Hkv=2, Sq=512, Skv=512, D=128,
                              causal=True),
           "bert": dict(B=2, H=4, Hkv=4, Sq=512, Skv=512, D=64, causal=False),
           "vlm_self": dict(H=8, Hkv=2, Sq=512, Skv=512, D=128, causal=True,
                            bkv=64),
           "vlm_cross": dict(H=8, Hkv=2, Sq=512, Skv=1600, D=128,
                             causal=False, bkv=64),
           "gpt2_512": dict(H=4, Hkv=4, Sq=512, Skv=512, D=64, causal=True),
           "t5_cross": dict(H=8, Hkv=8, Sq=64, Skv=512, D=64, causal=False)}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B2_TILE))
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.ROWMAX,
                                  Site.ROWSUM, Site.GEMM2])
def test_contiguous_kernel_tile_layout(regime, site):
    from repro_torch.kernels import efta_attention as mod
    dev = cuda_or_skip()
    shape = dict(B2_TILE[regime])
    causal, bkv = shape.pop("causal"), shape.pop("bkv", 512)
    q, k, v = _contig(dev, torch.bfloat16, seed=29, **shape)
    cfg = EFTAConfig(mode="correct", block_kv=bkv)
    bk, d = min(bkv, shape["Skv"]), shape["D"]
    t = mod.kernel_tiling(mod.DTYPES[torch.bfloat16], min(128, shape["Sq"]),
                          bk, d, cfg.kv_stride(bk), cfg.out_stride(d))
    assert t.layout == "tile" and t.W == 4 and t.slot_floats > 0, t
    row = shape["Sq"] - 1
    blk = row // bk if causal else shape["Skv"] // bk - 1
    fault = None if site is None else [int(site), blk, 1, row, 5, 30, 1, 0]
    kw = dict(cfg=cfg, causal=causal, fault=fault)
    out, det = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    bound = _wide_bound(plain, q, k, v, causal, None)
    diff = np.abs(to_np(out.float()) - to_np(plain[0].float()))
    assert (diff <= bound).all(), f"max |kernel - plain| {diff.max():.3e}"
    np.testing.assert_array_equal(to_np(det), to_np(plain[1]))
    if site is None:
        assert int(det.sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP, Site.GEMM1):
        assert int(det.sum()) >= 1


# the tile layout under its other options: detect mode (bit 27), EFTA off,
# a ragged kv_len that ends inside a KV block (non-causal) and a sliding
# window (causal, the first blocks skipped for the last tiles), at 64-key
# blocks
B2_TILE_VARIANTS = {"detect": dict(mode="detect"), "off": dict(mode="off"),
                    "ragged": dict(causal=False, kv_len=1000),
                    "window": dict(window=200)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(B2_TILE_VARIANTS))
@pytest.mark.parametrize("site", [None, Site.GEMM1, Site.EXP, Site.GEMM2])
def test_contiguous_kernel_tile_layout_variants(variant, site):
    from repro_torch.kernels import efta_attention as mod
    dev = cuda_or_skip()
    opt = dict(B2_TILE_VARIANTS[variant])
    mode = opt.pop("mode", "correct")
    causal = opt.pop("causal", True)
    q, k, v = _contig(dev, torch.bfloat16, H=8, Hkv=2, Sq=512, Skv=1024,
                      D=128, seed=31)
    if causal:
        k, v = k[:, :, :512].contiguous(), v[:, :, :512].contiguous()
    cfg = EFTAConfig(mode=mode, block_kv=64)
    t = mod.kernel_tiling(mod.DTYPES[torch.bfloat16], 128, 64, 128,
                          cfg.kv_stride(64), cfg.out_stride(128))
    assert t.layout == "tile", t
    bit = 27 if mode == "detect" else 30
    row = 511
    blk = (opt.get("kv_len", 512) - 1) // 64 if not causal else row // 64
    fault = None if site is None else [int(site), blk, 1, row, 5, bit, 1, 0]
    kw = dict(cfg=cfg, causal=causal, fault=fault, **opt)
    out, det = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    ref = to_np(plain[0].float())
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(out.float())),
                                  np.where(fin, 0, ref))
    bound = _wide_bound(plain, q, k, v, causal, opt.get("kv_len"),
                        opt.get("window"))
    diff = np.abs(to_np(out.float()) - ref)[fin]
    assert (diff <= bound[fin]).all(), f"max |kernel - plain| {diff.max():.3e}"
    np.testing.assert_array_equal(to_np(det), to_np(plain[1]))
    if site is None or mode == "off":
        assert int(det.sum()) == 0


@pytest.mark.cuda
def test_tiling_mirror_equals_the_kernels_rule():
    """``tiling`` (the C rule in Python, which the meta route takes)
    against the built kernel's ``efta_attention_tiles``, refusals
    included, with and without unified output verification."""
    from repro_torch.kernels import efta_attention as mod
    cuda_or_skip()
    for code in (0, 1):
        for bq in (1, 16, 64, 128):
            for mg in (1, 2, 4):
                for bkv in (16, 64, 512, 1024, 2048, 4096, 8192, 32768):
                    for d in (64, 72, 112, 128, 160, 256):
                        for skv in (4, 8, 16, 32, 64, 128):
                            if skv > bkv:
                                continue
                            for unified in (True, False):
                                shapes = (code, bq, bkv, d, skv,
                                          EFTAConfig().out_stride(d), mg,
                                          unified)
                                assert mod.tiling(*shapes) == \
                                    mod.kernel_tiling(*shapes), shapes


# the decode layout (csrc/efta_attention_decode.cuh: one query row a query
# tile, a unit a KV head's query heads, a score, an EXP and a state pass)
# at 1, 4, 8 and 12 (two row groups of 8) query heads a KV head, D 64, 112
# and 128, one KV block (t5's 512 keys in 4 parts) and many (the VLM's 25
# blocks of 64), ragged kv_len that ends inside a block, causal (only key
# 0 visible); the SEU strikes the last KV block that runs, at a visible key
# column (output column 3 for GEMM II), on the last query head of the
# second KV head (the second row group at 12)
B2_DECODE = {"grp1_d64_one_block": dict(H=4, Hkv=4, Skv=512, D=64, bkv=512),
             "grp4_d128_blocks": dict(H=8, Hkv=2, Skv=1600, D=128, bkv=64),
             "grp8_d112_ragged": dict(H=16, Hkv=2, Skv=1024, D=112, bkv=128,
                                      kv_len=1000),
             "grp4_d64_causal": dict(H=8, Hkv=2, Skv=256, D=64, bkv=64,
                                     causal=True),
             "grp1_d128_ragged": dict(H=4, Hkv=4, Skv=2048, D=128, bkv=512,
                                      kv_len=1500),
             "grp12_d64": dict(H=24, Hkv=2, Skv=512, D=64, bkv=128)}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B2_DECODE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,site", [
    ("off", None), ("correct", None), ("correct", Site.GEMM1),
    ("correct", Site.EXP), ("correct", Site.ROWMAX),
    ("correct", Site.ROWSUM), ("correct", Site.GEMM2),
    ("detect", Site.GEMM1), ("detect", Site.EXP), ("detect", Site.ROWMAX),
    ("detect", Site.ROWSUM), ("detect", Site.GEMM2)])
def test_contiguous_kernel_decode_layout(regime, dtype, mode, site):
    from repro_torch.kernels import efta_attention as mod
    dev = cuda_or_skip()
    shape = dict(B2_DECODE[regime])
    bkv, causal = shape.pop("bkv"), shape.pop("causal", False)
    kv_len = shape.pop("kv_len", None)
    q, k, v = _contig(dev, dtype, B=2, Sq=1, seed=37, **shape)
    cfg = EFTAConfig(mode=mode, block_kv=bkv)
    d = shape["D"]
    t = mod.kernel_tiling(mod.DTYPES[dtype], 1, bkv, d, cfg.kv_stride(bkv),
                          cfg.out_stride(d))
    assert t.layout == "decode", t
    last = 0 if causal else ((kv_len or shape["Skv"]) - 1) // bkv
    col = 3 if site == Site.GEMM2 else 0 if causal else 5
    grp = shape["H"] // shape["Hkv"]
    bh = 2 * grp - 1   # the last query head of the second KV head
    bit = 27 if mode == "detect" else 30
    fault = None if site is None else [int(site), last, bh, 0, col, bit, 1,
                                       0]
    kw = dict(cfg=cfg, causal=causal, kv_len=kv_len, fault=fault)
    out, det = efta_attention(q, k, v, **kw)
    plain = efta_attention_torch(q, k, v, **kw)
    ref = to_np(plain[0].float())
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(out.float())),
                                  np.where(fin, 0, ref))
    bound = _wide_bound(plain, q, k, v, causal, kv_len)
    diff = np.abs(to_np(out.float()) - ref)[fin]
    assert (diff <= bound[fin]).all(), f"max |kernel - plain| {diff.max():.3e}"
    np.testing.assert_array_equal(to_np(det), to_np(plain[1]))
    if mode == "off":
        assert int(det.sum()) == 0
    elif site in (Site.ROWMAX, Site.ROWSUM, Site.EXP) and mode == "correct":
        assert int(det.sum()) >= 1


# --- kernel B1's tile layout (csrc/efta_paged_tile.cuh) ----------------------

@pytest.mark.cuda
def test_paged_tiling_mirror_equals_the_kernels_rule():
    """``efta_paged.tiling`` (the C rule in Python) against the built
    kernel's ``efta_paged_tiling``, refusals included, at chunk widths 1
    (the decode layout's) and 64."""
    from repro_torch.kernels import efta_paged as mod
    cuda_or_skip()
    for code in (0, 1):
        for R in (1, 7, 8, 16, 48, 63, 64, 70, 448, 512, 1024):
            for d in (16, 48, 64, 112, 128, 160, 256):
                for bs, cs in ((16, 8), (16, 16), (32, 8), (64, 8)):
                    for skv in (2, 4, 8):
                        for mb in (8, 64, 256):
                            for unified in (True, False):
                                for chunk in (1, 64):
                                    shapes = (code, R, d, bs, cs, skv,
                                              EFTAConfig().out_stride(d), mb,
                                              unified)
                                    assert mod.tiling(
                                        *shapes, chunk=chunk) == \
                                        mod.kernel_tiling(
                                            *shapes, chunk=chunk), \
                                        (shapes, chunk)


def _tile_case(dev, *, grp, hd, seed, hkv=2, mb=16, full=False, shared=0):
    """A C 64 step of 4 requests for the tile layout: a whole chunk, a
    decode row (63 padding rows), an idle slot (no rows: its blocks are
    streamed and verified all the same) and a ragged half chunk, over
    fragmented tables; ``full``: request 0 fills a 64-block table;
    ``shared``: requests 0 and 1 share their first ``shared`` blocks, as
    two requests with one prompt prefix do."""
    g = torch.Generator().manual_seed(seed)
    B, C, bs = 4, 64, 16
    if full:
        mb = 64
    lens = torch.randint(C + shared * bs, mb * bs + 1, (B,), generator=g)
    if full:
        lens[0] = mb * bs
    need = [-(-int(n) // bs) for n in lens]
    nb = sum(need) + 2
    ids = (torch.randperm(nb, generator=g) + 1).tolist()
    bt = torch.zeros((B, mb), dtype=torch.int32)
    for b in range(B):
        own = need[b] - (shared if b == 1 else 0)
        row = ([int(x) for x in bt[0, :shared]] if b == 1 else []) + \
            [ids.pop() for _ in range(own)]
        bt[b, :need[b]] = torch.tensor(row, dtype=torch.int32)
    k = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    v = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    q = torch.randn((B, hkv * grp, C, hd), generator=g)
    k, v, q = (x.to(dev, torch.bfloat16) for x in (k, v, q))
    q_lens = torch.tensor([64, 1, 0, 33], dtype=torch.int32, device=dev)
    return [q, k, v, cks.encode_kv(k, 8), cks.encode_kv(v, 8), bt.to(dev),
            lens.int().to(dev), q_lens]


def _tile_slack(args, window, fault=None):
    """2^-7 (P |V|) per output element, P the masked softmax in f32: how far
    rounding p to bf16 for P V can move an output where the kernel and the
    plain version round a p next to a bf16 boundary differently (their f32
    scores differ in the last bits). ``fault``: an EXP SEU left in place
    (detect mode) struck one p, which renormalises its row's P, so P is
    taken from the struck numerators."""
    q, k_pool, v_pool, _, _, bt, lens, q_lens = args
    B, H, C, D = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    mb = bt.shape[1]
    idx = bt.long()
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, mb * bs, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, mb * bs, D)
    k = k.repeat_interleave(H // hkv, dim=1).float()
    v = v.repeat_interleave(H // hkv, dim=1).float().abs()
    pos = (lens - q_lens).long()[:, None] + torch.arange(C, device=q.device)
    cols = torch.arange(mb * bs, device=q.device)
    win = 1 << 30 if window is None else window
    mask = ((cols[None, None, :] <= pos[:, :, None])
            & (pos[:, :, None] - cols[None, None, :] < win)
            & (torch.arange(C, device=q.device)[None, :, None]
               < q_lens.long()[:, None, None]))[:, None]
    s = torch.matmul(q.float(), k.transpose(-1, -2)) / float(D) ** 0.5
    s = s.masked_fill(~mask, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
    if fault is not None and fault[0] == int(Site.EXP):
        j, b, h, row, col, bit = fault[1:7]
        grp = H // hkv
        at = (b, h * grp + row // C, row % C, j * bs + col)
        flip_bit_at(e, int(np.ravel_multi_index(at, e.shape)), bit)
    p = e / e.sum(-1, keepdim=True)
    return to_np(2.0 ** -7 * torch.matmul(p.nan_to_num(0.0), v))


# kernel B1's tile layout at the moe heads (arctic D 128 / grp 7, kimi D
# 112 / grp 8, output strides 8 and 7) and gpt2's (D 64, grp 1), a C 64
# step; every SEU strikes request 0 (a whole chunk), KV head 1, a chunk row
# of its last query head, in a block the row sees
B1_TILE = {"arctic": dict(grp=7, hd=128), "kimi": dict(grp=8, hd=112),
           "gpt2": dict(grp=1, hd=64)}
B1_TILE_RUNS = ["clean", "GEMM1", "EXP", "ROWMAX", "ROWSUM", "GEMM2",
                "detect_EXP", "detect_GEMM1", "off", "k_flip", "v_flip",
                "v_flip_grow", "window", "full_table", "shared_prefix"]


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B1_TILE))
@pytest.mark.parametrize("run", B1_TILE_RUNS)
def test_paged_kernel_tile_layout(regime, run):
    from repro_torch.kernels import efta_paged as mod
    dev = cuda_or_skip()
    shape = B1_TILE[regime]
    args = _tile_case(dev, seed=41 + B1_TILE_RUNS.index(run), **shape,
                      full=run == "full_table",
                      shared=8 if run == "shared_prefix" else 0)
    mode = ("detect" if run.startswith("detect") else
            "off" if run == "off" else "correct")
    cfg = EFTAConfig(mode=mode, stride=128, block_kv=16)
    window = 200 if run == "window" else None
    q, k = args[0], args[1]
    hkv, bs, d = k.shape[1], k.shape[2], k.shape[3]
    t = mod.kernel_tiling(mod.DTYPES[torch.bfloat16], shape["grp"] * 64, d,
                          bs, 8, cfg.kv_stride(bs), cfg.out_stride(d),
                          args[5].shape[1], True, chunk=64)
    assert t.layout == "tile" and t.fold_floats > 0, t
    fault = None
    site = run.split("_")[-1]
    if site in Site.__members__:
        row = (shape["grp"] - 1) * 64 + 5
        j = (int(args[6][0]) - 64 + 5) // bs
        fault = [int(Site[site]), j, 0, 1, row, 3,
                 27 if mode == "detect" else 30, 1]
    if run.startswith(("k_flip", "v_flip")):
        # a resident flip (top bf16 exponent bit) in request 3's last block,
        # KV head 1. "v_flip" strikes an element of V of magnitude 2 or
        # more, which it shrinks by 2^-128; "v_flip_grow" one under 1,
        # which it grows by 2^128, so P V overflows in request 3's rows
        i = 1 if run == "k_flip" else 2
        pool = args[i].clone()
        blk = int(args[5][3, (int(args[6][3]) - 1) // bs])
        at = ((blk * hkv + 1) * bs + 2) * d + 5
        if run != "k_flip":
            tile = pool[blk, 1].float().abs().flatten()
            pick = tile >= 2 if run == "v_flip" else tile < 1
            at = (blk * hkv + 1) * bs * d + int(torch.nonzero(pick)[0])
        flip_bit_at(pool, at, 14)
        args[i] = pool
    got = efta_paged_attention(*args, cfg=cfg, fault=fault, window=window)
    plain = efta_paged_attention_torch(*args, cfg=cfg, fault=fault,
                                       window=window)
    if run == "v_flip_grow":
        # the output check's locate step has no defined segment once an
        # output is inf or NaN, in either version: only the site-6 check
        # (det[5], the bad plane), which flags the block for the engine to
        # repair, and the requests that never read the block are held
        np.testing.assert_array_equal(to_np(got.bad_blocks),
                                      to_np(plain.bad_blocks))
        det, det_plain = to_np(got.detected), to_np(plain.detected)
        np.testing.assert_array_equal(det[:, 5], det_plain[:, 5])
        assert det[3, 5] == 1 and to_np(got.bad_blocks).sum() == 1
        np.testing.assert_array_equal(det[:3], det_plain[:3])
        ref = to_np(plain.out.float())[:3]
        diff = np.abs(to_np(got.out.float())[:3] - ref)
        bound = _bound(plain.out[:3]) + _tile_slack(args, window)[:3]
        assert np.isfinite(ref).all() and (diff <= bound).all()
        return
    ref = to_np(plain.out.float())
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(got.out.float())),
                                  np.where(fin, 0, ref))
    bound = _bound(plain.out) + _tile_slack(
        args, window, fault if mode == "detect" else None)
    diff = np.abs(to_np(got.out.float()) - ref)[fin]
    assert (diff <= bound[fin]).all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(got.detected), to_np(plain.detected))
    np.testing.assert_array_equal(to_np(got.bad_blocks),
                                  to_np(plain.bad_blocks))
    det = to_np(got.detected)
    if run in ("clean", "off", "window", "full_table", "shared_prefix"):
        assert det.sum() == 0 and not to_np(got.bad_blocks).any()
    elif run in ("k_flip", "v_flip"):
        assert det[3, 5] == 1 and to_np(got.bad_blocks).sum() == 1
    elif mode == "correct" and site in ("EXP", "ROWMAX", "ROWSUM", "GEMM1"):
        # (in bf16 a flip that shrinks p stays under the EXP check's
        # relative threshold of 1; in correct mode the backstop counts it)
        assert det[0, :5].sum() >= 1, det


# --- kernel B1's decode layout (csrc/efta_paged_decode.cuh) -----------------

# (query heads a KV head, head_dim): gpt2's, gemma3-1b's, arctic's, kimi's
# and a 16-head group (one full mma tile a unit)
B1_DECODE = {"grp1_d64": (1, 64), "grp4_d256": (4, 256), "grp7_d128": (7, 128),
             "grp8_d112": (8, 112), "grp16_d64": (16, 64)}
B1_DECODE_RUNS = (["clean", "off", "window"]
                  + [f"{m}{s}" for m in ("", "detect_")
                     for s in ("GEMM1", "EXP", "ROWMAX", "ROWSUM", "GEMM2")]
                  + ["k_flip_first", "v_flip_mid", "k_flip_last"])


def _decode_case(dev, dtype, *, grp, hd, seed, mb, hkv=2):
    """A decode step (C 1) of 5 requests over fragmented 64-block (gemma3's
    f32: 32-block) tables: a context of 1 token, of 16 (one whole block), a
    full table, a ragged one, and an idle slot (q_len 0: its blocks are
    streamed and verified, its rows computed and counted)."""
    g = torch.Generator().manual_seed(seed)
    B, bs = 5, 16
    lens = [1, 16, mb * bs, int(torch.randint(17, mb * bs, (1,),
                                              generator=g)),
            int(torch.randint(1, mb * bs + 1, (1,), generator=g))]
    need = [-(-n // bs) for n in lens]
    nb = sum(need) + 2
    ids = (torch.randperm(nb, generator=g) + 1).tolist()
    bt = torch.zeros((B, mb), dtype=torch.int32)
    for b in range(B):
        bt[b, :need[b]] = torch.tensor([ids.pop() for _ in range(need[b])],
                                       dtype=torch.int32)
    k = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    v = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    q = torch.randn((B, hkv * grp, 1, hd), generator=g)
    k, v, q = (x.to(dev, dtype) for x in (k, v, q))
    q_lens = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32, device=dev)
    return [q, k, v, cks.encode_kv(k, 8), cks.encode_kv(v, 8), bt.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), q_lens]


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B1_DECODE))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("run", B1_DECODE_RUNS)
def test_paged_kernel_decode_layout(regime, dtype, run):
    from repro_torch.kernels import efta_paged as mod
    dev = cuda_or_skip()
    grp, hd = B1_DECODE[regime]
    mb = 32 if (hd == 256 and dtype == torch.float32) else 64
    args = _decode_case(dev, dtype, grp=grp, hd=hd, mb=mb,
                        seed=71 + B1_DECODE_RUNS.index(run))
    mode = ("detect" if run.startswith("detect") else
            "off" if run == "off" else "correct")
    cfg = EFTAConfig(mode=mode, stride=128, block_kv=16)
    window = 512 if run == "window" else None
    k = args[1]
    hkv, bs = k.shape[1], k.shape[2]
    t = mod.kernel_tiling(mod.DTYPES[dtype], grp, hd, bs, 8,
                          cfg.kv_stride(bs), cfg.out_stride(hd), mb, True,
                          chunk=1)
    assert t.layout == "decode", t
    fault = None
    site = run.split("_")[-1]
    last = mb - 1
    if site in Site.__members__:
        # request 2 (the full table), KV head 1, its last query head: in
        # the decode row's block in correct mode, a middle one in detect
        j = last if mode == "correct" else mb // 2
        fault = [int(Site[site]), j, 2, 1, grp - 1, 3,
                 (30 if dtype == torch.float32 else 14)
                 if mode == "correct" else 27, 1]
    if "flip" in run:
        # a resident flip of the top exponent bit in request 2's first,
        # middle or last block, KV head 1: a K element grown by 2^128, or a
        # V element of magnitude 2 or more shrunk by 2^-128
        i = 1 if run.startswith("k_") else 2
        j = {"first": 0, "mid": mb // 2, "last": last}[run.split("_")[-1]]
        pool = args[i].clone()
        blk = int(args[5][2, j])
        top = 30 if dtype == torch.float32 else 14
        at = ((blk * hkv + 1) * bs + 2) * hd + 5
        if i == 2:
            tile = pool[blk, 1].float().abs().flatten()
            at = (blk * hkv + 1) * bs * hd + int(torch.nonzero(tile >= 2)[0])
        flip_bit_at(pool, at, top)
        args[i] = pool
    launches = mod.efta_paged_attention.launches_by_layout[("decode", 1)]
    got = efta_paged_attention(*args, cfg=cfg, fault=fault, window=window)
    assert mod.efta_paged_attention.launches_by_layout[("decode", 1)] == \
        launches + 1
    plain = efta_paged_attention_torch(*args, cfg=cfg, fault=fault,
                                       window=window)
    ref = to_np(plain.out.float())
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(got.out.float())),
                                  np.where(fin, 0, ref))
    bound = _bound(plain.out)
    if dtype == torch.bfloat16:
        bound = bound + _tile_slack(args, window,
                                    fault if mode == "detect" else None)
    diff = np.abs(to_np(got.out.float()) - ref)[fin]
    assert (diff <= bound[fin]).all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(got.detected), to_np(plain.detected))
    np.testing.assert_array_equal(to_np(got.bad_blocks),
                                  to_np(plain.bad_blocks))
    det = to_np(got.detected)
    if run in ("clean", "off", "window"):
        assert det.sum() == 0 and not to_np(got.bad_blocks).any()
    elif "flip" in run:
        assert to_np(got.bad_blocks)[2, j] and to_np(got.bad_blocks).sum() == 1
    elif mode == "correct" and site in ("EXP", "ROWSUM"):
        assert det[2, :5].sum() >= 1, det


# --- kernel B1's long-table layout (csrc/efta_paged_long.cuh) ---------------

# (query heads a KV head, head_dim) as the decode layout's cases, two units
# of rows (grp 20), and for each dtype the narrowest of these tables that
# the decode layout does not hold
B1_LONG = {"grp1_d64": (1, 64), "grp4_d256": (4, 256), "grp7_d128": (7, 128),
           "grp8_d112": (8, 112), "grp20_d64": (20, 64)}
B1_LONG_RUNS = (["clean", "off", "window"]
                + [f"{s}_{at}" for s in ("GEMM1", "EXP", "ROWMAX", "ROWSUM",
                                         "GEMM2")
                   for at in ("early", "mid", "last")]
                + [f"detect_{s}" for s in ("GEMM1", "EXP", "ROWMAX",
                                           "ROWSUM", "GEMM2")]
                + ["k_flip_first", "v_flip_mid", "k_flip_last"])


def _long_table(dtype, grp, hd):
    from repro_torch.kernels import efta_paged as mod
    cfg = EFTAConfig(mode="correct", stride=128, block_kv=16)
    for mb in (64, 128, 256, 2048):
        t = mod.tiling(mod.DTYPES[dtype], grp, hd, 16, 8, cfg.kv_stride(16),
                       cfg.out_stride(hd), mb, True, chunk=1)
        if t.layout == "long":
            return mb
    raise AssertionError(f"no table up to 2,048 blocks takes the long-table "
                         f"layout at grp {grp}, D {hd}")


@pytest.mark.cuda
@pytest.mark.parametrize("regime", sorted(B1_LONG))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("run", B1_LONG_RUNS)
def test_paged_kernel_long_layout(regime, dtype, run):
    """The long-table layout against the plain version on a decode step of
    5 requests (a context of 1 token, of 16, a full table, a ragged one, an
    idle slot): outputs within the bound, counts and bad planes equal. Each
    SEU strikes request 2 (the full table), KV head 1, its last query head,
    at an early, a middle or the last block in correct mode, a middle one in
    detect mode."""
    from repro_torch.kernels import efta_paged as mod
    dev = cuda_or_skip()
    grp, hd = B1_LONG[regime]
    mb = _long_table(dtype, grp, hd)
    args = _decode_case(dev, dtype, grp=grp, hd=hd, mb=mb,
                        seed=131 + B1_LONG_RUNS.index(run))
    mode = ("detect" if run.startswith("detect") else
            "off" if run == "off" else "correct")
    cfg = EFTAConfig(mode=mode, stride=128, block_kv=16)
    window = 512 if run == "window" else None
    k = args[1]
    hkv, bs = k.shape[1], k.shape[2]
    t = mod.kernel_tiling(mod.DTYPES[dtype], grp, hd, bs, 8,
                          cfg.kv_stride(bs), cfg.out_stride(hd), mb, True,
                          chunk=1)
    assert t.layout == "long", t
    fault = None
    parts = run.split("_")
    site = parts[1] if mode == "detect" else parts[0]
    last = mb - 1
    if site in Site.__members__:
        j = {"early": 1, "mid": mb // 2, "last": last}.get(parts[-1], mb // 2)
        fault = [int(Site[site]), j, 2, 1, grp - 1, 3,
                 (30 if dtype == torch.float32 else 14)
                 if mode == "correct" else 27, 1]
    if "flip" in run:
        i = 1 if run.startswith("k_") else 2
        j = {"first": 0, "mid": mb // 2, "last": last}[parts[-1]]
        pool = args[i].clone()
        blk = int(args[5][2, j])
        top = 30 if dtype == torch.float32 else 14
        at = ((blk * hkv + 1) * bs + 2) * hd + 5
        if i == 2:
            tile = pool[blk, 1].float().abs().flatten()
            at = (blk * hkv + 1) * bs * hd + int(torch.nonzero(tile >= 2)[0])
        flip_bit_at(pool, at, top)
        args[i] = pool
    launches = mod.efta_paged_attention.launches_by_layout[("long", 1)]
    got = efta_paged_attention(*args, cfg=cfg, fault=fault, window=window)
    assert mod.efta_paged_attention.launches_by_layout[("long", 1)] == \
        launches + 1
    plain = efta_paged_attention_torch(*args, cfg=cfg, fault=fault,
                                       window=window)
    ref = to_np(plain.out.float())
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.where(fin, 0, to_np(got.out.float())),
                                  np.where(fin, 0, ref))
    bound = _bound(plain.out)
    if dtype == torch.bfloat16:
        bound = bound + _tile_slack(args, window,
                                    fault if mode == "detect" else None)
    diff = np.abs(to_np(got.out.float()) - ref)[fin]
    assert (diff <= bound[fin]).all(), \
        f"max |kernel - plain| {diff.max():.3e} over its bound"
    np.testing.assert_array_equal(to_np(got.detected), to_np(plain.detected))
    np.testing.assert_array_equal(to_np(got.bad_blocks),
                                  to_np(plain.bad_blocks))
    det = to_np(got.detected)
    if run in ("clean", "off", "window"):
        assert det.sum() == 0 and not to_np(got.bad_blocks).any()
    elif "flip" in run:
        assert to_np(got.bad_blocks)[2, j] and to_np(got.bad_blocks).sum() == 1
    elif mode == "correct" and site in ("EXP", "ROWSUM") and \
            parts[-1] == "last":
        # (at an earlier block a flipped rowsum bit can shrink under the
        # shadow's threshold by the end, in both versions alike)
        assert det[2, :5].sum() >= 1, det


@pytest.mark.cuda
def test_paged_long_tiling_mirror_equals_the_kernels_rule():
    """``efta_paged.tiling`` against the built kernel's rule at C 1 over
    tables of 64 to 16,384 blocks (the decode layout up to its width, the
    long-table layout past it), both dtypes, the engines' block and
    strides and their neighbours."""
    from repro_torch.kernels import efta_paged as mod
    cuda_or_skip()
    for code in (0, 1):
        for R in (1, 4, 7, 8, 16, 20, 64):
            for d in (16, 64, 112, 128, 256):
                for bs, cs, skv in ((16, 8, 4), (16, 16, 4), (16, 8, 8),
                                    (32, 8, 8)):
                    for mb in (64, 128, 192, 256, 2048, 16384):
                        for unified in (True, False):
                            shapes = (code, R, d, bs, cs, skv,
                                      EFTAConfig().out_stride(d), mb, unified)
                            assert mod.tiling(*shapes, chunk=1) == \
                                mod.kernel_tiling(*shapes, chunk=1), shapes
