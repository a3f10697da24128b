"""Tests that need an NVIDIA card: the CUDA kernel against its plain
PyTorch version on the same CUDA tensors. Marked ``cuda``; each skips with
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
    ref = to_np(plain.out.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(to_np(got.out.float()), ref, atol=tol, rtol=0)
    np.testing.assert_array_equal(to_np(got.detected), to_np(plain.detected))
    np.testing.assert_array_equal(to_np(got.bad_blocks),
                                  to_np(plain.bad_blocks))
