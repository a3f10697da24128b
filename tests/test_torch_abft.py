"""Linear-module ABFT of the port against the JAX package, on the CPU.

* The traditional rank-1 helpers (``traditional_encode_rows``/``_cols``,
  ``traditional_verify_correct``) on the same numpy inputs: checksums
  within one rounding, detection counts exactly equal, corrected tensors
  within 1e-5 (f32) of the reference's.
* ``abft_matmul`` and ``tensor_abft_matmul`` at the reference tests'
  shapes (8, 64, 128), (16, 32, 64) and (4, 16, 24), in f32 and bf16,
  clean and under a GEMM1 SEU: ``n_detected`` exactly equal to the
  reference's, outputs within 1e-5 of it in f32 (the products sum in
  another order) and within one bf16 ulp in bf16; a repaired element
  within the rounding of its checksum.
* bf16 raises no false positive (as ``tests/test_abft_gemm.py``).
* A top-exponent flip of a value below 2 makes the fold overflow, in both
  packages: detected, but the correction is lost to cancellation (ROADMAP,
  Queue C).
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import abft_gemm as jabft  # noqa: E402
from repro.core import checksum as jcks  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.fault import Site as JSite  # noqa: E402
from repro_torch.core import abft_gemm as tabft  # noqa: E402
from repro_torch.core import checksum as tcks  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.models.layers import matmul  # noqa: E402

SHAPES = [(8, 64, 128), (16, 32, 64), (4, 16, 24)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return to_torch(a).to(tdt), jnp.asarray(a, jdt)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else to_np(x.float())


def _close(got, ref, dtype):
    """f32: within 1e-5 of the largest output (only the summation order
    differs). bf16: about one bf16 ulp of each element, 2^-7 |b| + 2^-8
    rms(b) (both round one f32 result to bf16)."""
    a, b = _f32(got), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))
    else:
        bound = 2.0 ** -7 * np.abs(b) + 2.0 ** -8 * np.sqrt(np.mean(b * b))
        assert (np.abs(a - b) <= bound).all(), np.abs(a - b).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_traditional_helpers_match_reference(dtype):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 12, 20)).astype(np.float32)
    ta, ja = _pair(a, dtype)
    _close(tcks.traditional_encode_rows(ta),
           jcks.traditional_encode_rows(ja), dtype)
    _close(tcks.traditional_encode_cols(ta),
           jcks.traditional_encode_cols(ja), dtype)

    # C = A @ B with its row checksums; one element struck in row 5
    b = rng.standard_normal((20, 16)).astype(np.float32)
    c = (a @ b).astype(np.float32)
    checks = (a @ np.stack([b.sum(-1), (b * np.arange(1, 17)).sum(-1)],
                           -1)).astype(np.float32)
    c[1, 5, 9] += 40.0
    for correct in (True, False):
        tv = tcks.traditional_verify_correct(
            to_torch(c), to_torch(checks), threshold=1e-3, correct=correct)
        jv = jcks.traditional_verify_correct(
            jnp.asarray(c), jnp.asarray(checks), threshold=1e-3,
            correct=correct)
        assert int(tv.n_detected) == int(jv.n_detected) == 1
        np.testing.assert_allclose(to_np(tv.corrected), np.asarray(
            jv.corrected), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(tv.max_delta), float(jv.max_delta),
                                   rtol=1e-5)
    fixed = to_np(tcks.traditional_verify_correct(
        to_torch(c), to_torch(checks), threshold=1e-3).corrected)
    np.testing.assert_allclose(fixed[1, 5, 9], c[1, 5, 9] - 40.0, atol=1e-3)
    # a NaN difference counts as detected (the negated <= form)
    c[0, 0, 0] = np.nan
    tv = tcks.traditional_verify_correct(to_torch(c), to_torch(checks),
                                         threshold=1e-3, correct=False)
    jv = jcks.traditional_verify_correct(jnp.asarray(c), jnp.asarray(checks),
                                         threshold=1e-3, correct=False)
    assert int(tv.n_detected) == int(jv.n_detected) == 2


@pytest.mark.parametrize("fn", ["abft_matmul", "tensor_abft_matmul"])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("struck", [False, True])
def test_abft_matmul_matches_reference(fn, m, k, n, dtype, struck):
    rng = np.random.default_rng(m * 100 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    tx, jx = _pair(x, dtype)
    tw, jw = _pair(w, dtype)
    # y (M, N) is struck at (batch, head) = (row 3, column n - 5): bit 25
    # scales the value by 2^(+-4) at most, inside the f32 range
    tf = jf = None
    if struck:
        tf = FaultSpec.single(Site.GEMM1, batch=3, head=n - 5, bit=25)
        jf = JFaultSpec.single(JSite.GEMM1, batch=3, head=n - 5, bit=25)
    ty, tn = getattr(tabft, fn)(tx, tw, fault=tf)
    jy, jn = getattr(jabft, fn)(jx, jw, fault=jf)
    assert int(tn) == int(jn)
    # f32 always sees the flip; in bf16 a flip that shrinks a small value
    # can stay under the 5e-2 relative threshold, in both packages alike
    # (ROADMAP, Queue C), and then the struck value stays in the output
    assert int(tn) == int(struck) or (dtype == "bfloat16" and int(tn) == 0)
    assert ty.dtype == tx.dtype
    clean = matmul(tx, tw)
    if struck and not int(tn):
        clean = jy
    elif struck:
        # the repaired element is the struck value plus the checksum's
        # difference, so it carries the rounding of the checksum weights
        # (stored in the operands' dtype): at most 2^-8 of |x_row| . the
        # absolute row sums of w in bf16, the f32 rule's bound in f32
        xs = _f32(tx)[3]
        tol = (2.0 ** -8 * float(np.abs(xs) @ np.abs(_f32(tw)).sum(-1))
               if dtype == "bfloat16" else 1e-5 * max(1.0, float(np.abs(
                   _f32(jy)).max())))
        for ref in (jy, clean):
            assert abs(_f32(ty)[3, n - 5] - _f32(ref)[3, n - 5]) <= tol
        keep = np.ones((m, n), bool)
        keep[3, n - 5] = False
        ty, jy, clean = (_f32(t)[keep] for t in (ty, jy, clean))
    _close(ty, jy, dtype)
    # and the corrected output is the clean product
    _close(ty, clean, dtype)


@pytest.mark.parametrize("fn", ["abft_matmul", "tensor_abft_matmul"])
def test_bf16_no_false_positive(fn):
    rng = np.random.default_rng(2)
    x = to_torch(rng.standard_normal((32, 256))).bfloat16()
    w = to_torch(rng.standard_normal((256, 512))).bfloat16()
    _, nd = getattr(tabft, fn)(x, w)
    assert int(nd) == 0


@pytest.mark.parametrize("fn", ["abft_matmul", "tensor_abft_matmul"])
def test_detect_mode_leaves_the_fault(fn):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    tf = FaultSpec.single(Site.GEMM1, batch=2, head=77, bit=27)
    jf = JFaultSpec.single(JSite.GEMM1, batch=2, head=77, bit=27)
    ty, tn = getattr(tabft, fn)(to_torch(x), to_torch(w), correct=False,
                                fault=tf)
    jy, jn = getattr(jabft, fn)(jnp.asarray(x), jnp.asarray(w),
                                correct=False, fault=jf)
    assert int(tn) == int(jn) == 1
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), rtol=1e-6,
                               atol=1e-5)
    assert abs(float(ty[2, 77]) - float((x @ w)[2, 77])) > 1.0


def test_top_bit_flip_below_two_is_not_repaired_in_either_package():
    """Flipping the top exponent bit of an element of |y| in [0.5, 2)
    gives inf/NaN or ~1e38: the fold overflows, so the check detects it,
    but the delta it recovers has lost the element (cancellation at the
    fold's magnitude). Both packages agree; chip_smoke strikes an element
    of |y| >= 2, which the top bit shrinks instead."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    y = x @ w
    r, c = np.argwhere((np.abs(y) >= 0.5) & (np.abs(y) < 1.0))[0]
    big = np.argwhere(np.abs(y) >= 2.0)[0]
    for (rr, cc), repaired in (((r, c), False), (tuple(big), True)):
        tf = FaultSpec.single(Site.GEMM1, batch=int(rr), head=int(cc),
                              bit=30)
        jf = JFaultSpec.single(JSite.GEMM1, batch=int(rr), head=int(cc),
                               bit=30)
        ty, tn = tabft.tensor_abft_matmul(to_torch(x), to_torch(w), fault=tf)
        jy, jn = jabft.tensor_abft_matmul(jnp.asarray(x), jnp.asarray(w),
                                          fault=jf)
        assert int(tn) == int(jn) == 1
        err_t = abs(float(ty[rr, cc]) - float(y[rr, cc]))
        err_j = abs(float(jy[rr, cc]) - float(y[rr, cc]))
        if repaired:
            assert err_t < 1e-4 and err_j < 1e-4
        else:
            assert not err_t < 1e-2 and not err_j < 1e-2


@pytest.mark.parametrize("glu", [False, True])
def test_mlp_with_ff_abft_matches_reference(glu):
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    p = {"up": rng.standard_normal((32, 128)).astype(np.float32) / 6,
         "down": rng.standard_normal((128, 32)).astype(np.float32) / 11}
    if glu:
        p["gate"] = rng.standard_normal((32, 128)).astype(np.float32) / 6
    ty = tlayers.mlp_apply({k: to_torch(v) for k, v in p.items()},
                           to_torch(x), act="silu", glu=glu, ff_abft=True)
    jy = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), act="silu", glu=glu, ff_abft=True)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), rtol=0, atol=1e-5)
