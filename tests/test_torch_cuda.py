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
from repro_torch.core.fault import Site  # noqa: E402
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
          seed=0):
    g = torch.Generator().manual_seed(seed)
    nb = B * mb
    k = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    v = torch.randn((nb + 1, hkv, bs, hd), generator=g)
    q = torch.randn((B, hkv * grp, C, hd), generator=g)
    bt = torch.randperm(nb, generator=g).add(1).reshape(B, mb).int()
    lens = torch.randint(C, mb * bs + 1, (B,), generator=g).int()
    k, v, q = (x.to(dev, dtype) for x in (k, v, q))
    kc, vc = cks.encode_kv(k, 8), cks.encode_kv(v, 8)
    return q, k, v, kc, vc, bt.to(dev), lens.to(dev)


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
