"""The decoupled baseline of the port against the JAX package, on the CPU
(as ``tests/test_decoupled.py`` holds the reference).

The same numpy inputs go through ``repro.core.decoupled_ft_attention`` and
the port's: clean (causal and not, GQA), and under SEUs at GEMM1, EXP and
GEMM2 in correct and detect mode. Detection vectors are exactly equal;
outputs agree within 1e-5 in f32 (the products and softmax sum in another
order). The EXP site strikes P between stages II and III, where nothing
checks it: both packages count nothing and emit the struck output.
``decoupled_memory_bytes`` is equal. Each stage is also held to the
reference's on its own.
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import decoupled as jdec  # noqa: E402
from repro.core import reference_attention as jref  # noqa: E402
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.fault import Site as JSite  # noqa: E402
from repro_torch.core import decoupled as tdec  # noqa: E402
from repro_torch.core import reference_attention  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, *, b=2, h=4, hkv=2, sq=32, skv=32, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _both(arrs, **kw):
    site = kw.pop("site", None)
    tf = jf = None
    if site is not None:
        f = dict(block=0, batch=1, head=2, row=20, col=7, bit=kw.pop("bit"))
        tf = FaultSpec.single(Site(int(site)), **f)
        jf = JFaultSpec.single(JSite(int(site)), **f)
    to, trep = tdec.decoupled_ft_attention(*map(to_torch, arrs), fault=tf,
                                           **kw)
    jo, jrep = jdec.decoupled_ft_attention(*map(jnp.asarray, arrs), fault=jf,
                                           **kw)
    return to_np(to), trep, np.asarray(jo), jrep


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_clean_matches_reference(causal, gqa):
    arrs = _qkv(0, hkv=2 if gqa else 4, sq=24 if causal else 16, skv=40)
    to, trep, jo, jrep = _both(arrs, causal=causal)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to_np(trep.detected),
                                  np.asarray(jrep.detected))
    assert int(trep.detected.sum()) == 0
    ref = reference_attention(*map(to_torch, arrs), causal=causal,
                              q_offset=40 - (24 if causal else 16))
    np.testing.assert_allclose(to, to_np(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(jo, np.asarray(jref(
        *map(jnp.asarray, arrs), causal=causal,
        q_offset=40 - (24 if causal else 16))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("site", [Site.GEMM1, Site.EXP, Site.GEMM2])
@pytest.mark.parametrize("correct", [True, False])
@pytest.mark.parametrize("bit", [25, 30])
def test_seu_counts_match_reference(site, correct, bit):
    arrs = _qkv(1)
    clean, _, _, _ = _both(arrs, causal=True)
    to, trep, jo, jrep = _both(arrs, causal=True, correct=correct,
                               site=site, bit=bit)
    np.testing.assert_array_equal(to_np(trep.detected),
                                  np.asarray(jrep.detected))
    np.testing.assert_array_equal(to_np(trep.corrected),
                                  np.asarray(jrep.corrected))
    fin = np.isfinite(jo)
    np.testing.assert_array_equal(np.isfinite(to), fin)
    # relative too: an uncorrected top-bit flip leaves ~1e38 there
    np.testing.assert_allclose(to[fin], jo[fin], rtol=1e-5, atol=1e-5)
    n = int(trep.detected.sum())
    if site == Site.EXP:
        # the inter-stage gap: stage III checksums the struck P it is given
        assert n == 0
        assert not np.allclose(to, clean, atol=1e-4)
    else:
        assert int(trep.detected[0 if site == Site.GEMM1 else 4]) == 1
        if correct and bit == 25:
            np.testing.assert_allclose(to, clean, rtol=0, atol=1e-3)
        # the top bit takes a value below 2 to ~1e38 or inf: detected, but
        # its repair is lost to cancellation in both packages (ROADMAP,
        # Queue C); the outputs are held to the reference's above


def test_each_stage_matches_reference():
    q, k, v = _qkv(2, hkv=4)
    f = dict(block=0, batch=0, head=1, row=3, col=4, bit=26)
    s_t, n_t = tdec.abft_gemm_qk(to_torch(q), to_torch(k),
                                 fault=FaultSpec.single(Site.GEMM1, **f))
    s_j, n_j = jdec.abft_gemm_qk(jnp.asarray(q), jnp.asarray(k),
                                 fault=JFaultSpec.single(JSite.GEMM1, **f))
    assert int(n_t) == int(n_j) == 1
    np.testing.assert_allclose(to_np(s_t), np.asarray(s_j), atol=1e-5)
    p_t, d_t = tdec.dmr_row_softmax(s_t, causal=True)
    p_j, d_j = jdec.dmr_row_softmax(s_j, causal=True)
    assert int(d_t) == int(d_j) == 0
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), atol=1e-6)
    o_t, m_t = tdec.abft_gemm_pv(p_t, to_torch(v),
                                 fault=FaultSpec.single(Site.GEMM2, **f))
    o_j, m_j = jdec.abft_gemm_pv(p_j, jnp.asarray(v),
                                 fault=JFaultSpec.single(JSite.GEMM2, **f))
    assert int(m_t) == int(m_j) == 1
    np.testing.assert_allclose(to_np(o_t), np.asarray(o_j), atol=1e-5)


def test_bf16_matches_reference():
    arrs = _qkv(3, sq=32, skv=32)
    t = [to_torch(a).bfloat16() for a in arrs]
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    to, trep = tdec.decoupled_ft_attention(*t, causal=True)
    jo, jrep = jdec.decoupled_ft_attention(*j, causal=True)
    np.testing.assert_array_equal(to_np(trep.detected),
                                  np.asarray(jrep.detected))
    b = np.asarray(jo, np.float32)
    # one bf16 rounding of P before stage III and one of the output: about
    # two bf16 ulps of each element
    bound = 2.0 ** -6 * np.abs(b) + 2.0 ** -7 * np.sqrt(np.mean(b * b))
    assert (np.abs(to_np(to.float()) - b) <= bound).all()


@pytest.mark.parametrize("dims", [(1, 32, 16384, 16384), (2, 12, 512, 512),
                                  (16, 16, 1024, 1024)])
def test_memory_bytes_match_reference(dims):
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        assert tdec.decoupled_memory_bytes(*dims, dtype=tdt) == \
            jdec.decoupled_memory_bytes(*dims, dtype=jdt)
    assert tdec.decoupled_memory_bytes(1, 32, 16384, 16384) > 30e9
