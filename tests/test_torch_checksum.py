"""Parity of the port's checksum algebra with ``repro.core.checksum``: the
folds, ``encode_kv``, ``encode_kv_tile``, ``block_fold_bad`` and
``verify_block`` on the same arrays, in f32 and bf16, clean and with a bit
flipped. Flags must be exactly equal; values within 1e-6 relative in f32
(one rounding to the storage dtype in bf16, so bf16 values must be equal
bit for bit)."""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import checksum as jcks  # noqa: E402
from repro.core import fault as jfault  # noqa: E402
from repro_torch.core import checksum as tcks  # noqa: E402
from repro_torch.core import fault as tfault  # noqa: E402

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _pair(seed, shape, dtype_name):
    npt, tt, jt = DTYPES[dtype_name]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    a = a.astype(npt)
    j = jnp.asarray(a, jt)
    t = (to_torch(a.view(np.int16)).view(torch.bfloat16)
         if dtype_name == "bfloat16" else to_torch(a))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return to_np(x.float())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, dtype_name):
    if dtype_name == "float32":
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_f32(t), _f32(j))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_folds_and_encodes_match(dtype_name):
    j, t = _pair(0, (3, 2, 16, 24), dtype_name)
    for stride in (4, 8):
        _close(tcks.fold1(t.float(), stride), jcks.fold1(
            jnp.asarray(j, jnp.float32), stride), "float32")
        _close(tcks.fold2(t.float(), stride), jcks.fold2(
            jnp.asarray(j, jnp.float32), stride), "float32")
        tc, jc = tcks.encode_kv(t, stride), jcks.encode_kv(j, stride)
        assert tc.c1.dtype == t.dtype
        _close(tc.c1, jc.c1, dtype_name)
        _close(tc.c2, jc.c2, dtype_name)
        tt, jt = tcks.encode_kv_tile(t, stride), jcks.encode_kv_tile(j, stride)
        assert tt.c1.dtype == torch.float32
        _close(tt.c1, jt.c1, "float32")
        _close(tt.c2, jt.c2, "float32")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_block_verify_flags_match_clean_and_flipped(dtype_name):
    npt, tdt, jdt = DTYPES[dtype_name]
    j, t = _pair(1, (5, 2, 16, 16), dtype_name)
    cs = 8
    jc = jcks.encode_kv(j, cs)
    tc = tcks.encode_kv(t, cs)
    thr_t = tcks.kv_block_threshold(tdt)
    thr_j = jcks.kv_block_threshold(jdt)
    assert thr_t == thr_j
    for bit, idx in [(None, None), (27, 3 * 512 + 37), (30, 4 * 512 + 500),
                     (3, 17)]:
        if dtype_name == "bfloat16" and bit is not None:
            bit = min(bit - 16, 15) if bit >= 16 else bit
        jx, tx = j, t.clone()
        if bit is not None:
            jx = jfault.flip_bit_at(j, jnp.int32(idx), jnp.int32(bit))
            tfault.flip_bit_at(tx, idx, bit)
            np.testing.assert_array_equal(_f32(tx), _f32(jx))
        jbad, jn = jcks.verify_block(jx, jc, cs, threshold=thr_j)
        tbad, tn = tcks.verify_block(tx, tc, cs, threshold=thr_t)
        np.testing.assert_array_equal(to_np(tbad), np.asarray(jbad))
        assert int(tn) == int(jn)
        if bit is not None and bit >= (12 if dtype_name == "bfloat16" else 24):
            assert bool(to_np(tbad)[idx // 512, (idx // 256) % 2])
        # block_fold_bad on one streamed tile, as the kernels call it
        jf = jcks.encode_kv_tile(jx[idx // 512 if idx else 0], cs)
        tf = tcks.encode_kv_tile(tx[idx // 512 if idx else 0], cs)
        k = idx // 512 if idx else 0
        jb = jcks.block_fold_bad(jf, jcks.Checksums(jc.c1[k], jc.c2[k]),
                                 threshold=thr_j)
        tb = tcks.block_fold_bad(tf, tcks.Checksums(tc.c1[k], tc.c2[k]),
                                 threshold=thr_t)
        np.testing.assert_array_equal(to_np(tb), np.asarray(jb))


def test_flip_bit_at_is_an_xor_on_the_bits():
    x = torch.tensor([1.0, -2.5, 3.0], dtype=torch.float32)
    for bit in (0, 22, 30, 31):
        y = tfault.flip_bit_at(x.clone(), 1, bit)
        j = jfault.flip_bit_at(jnp.asarray(to_np(x)), jnp.int32(1),
                               jnp.int32(bit))
        np.testing.assert_array_equal(to_np(y.view(torch.int32)),
                                      np.asarray(j).view(np.int32))
        np.testing.assert_array_equal(
            to_np(tfault.flip_bit_at(y, 1, bit)), to_np(x))   # involution
    assert [int(s) for s in tfault.Site] == [int(s) for s in jfault.Site]
