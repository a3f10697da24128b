"""Parity of the port's fused paged EFTA attention with the JAX package's
Pallas kernel (``efta_paged_attention_pallas(interpret=True)``).

The same numpy inputs go through both. ``out`` must agree within 1e-5
(f32; the two sum in different orders), and the per-request detection
vectors and the bad-block planes must be exactly equal — on clean pools,
under resident bit flips and under each compute-site SEU in correct and in
detect mode. Ported from the 11 tests of ``test_paged_attention_kernel.py``;
the two property sweeps there run here over fixed draws.
"""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import checksum as jcks  # noqa: E402
from repro.core.efta import EFTAConfig as JEFTAConfig  # noqa: E402
from repro.core.fault import Site  # noqa: E402
from repro.kernels.efta_paged import efta_paged_attention_pallas  # noqa: E402
from repro_torch.core import checksum as tcks  # noqa: E402
from repro_torch.core.efta import EFTAConfig  # noqa: E402
from repro_torch.core.fault import flip_bit_at  # noqa: E402
from repro_torch.kernels.efta_paged import (  # noqa: E402
    efta_paged_attention, efta_paged_attention_torch)

TOL = dict(atol=1e-5, rtol=1e-5)


def _make_case(seed, *, B, mb, bs, hkv, grp, hd, cs, C=None, fragment=True,
               stale_scale=1.0):
    """Random pool + fragmented tables + ragged lengths (numpy). Pool rows
    past each request's valid prefix hold stale data scaled by
    ``stale_scale``; the kernels must mask them out."""
    rng = np.random.default_rng(seed)
    per_req = [int(rng.integers(1, mb * bs + 1)) for _ in range(B)]
    n_real = sum(-(-t // bs) for t in per_req)
    nb = n_real + 3
    ids = np.arange(1, nb + 1)
    if fragment:
        rng.shuffle(ids)
    bt = np.zeros((B, mb), np.int32)
    used = 0
    for i, t in enumerate(per_req):
        n = -(-t // bs)
        bt[i, :n] = ids[used:used + n]
        used += n
    pool_k = (rng.standard_normal((nb + 1, hkv, bs, hd)) * stale_scale
              ).astype(np.float32)
    pool_v = (rng.standard_normal((nb + 1, hkv, bs, hd)) * stale_scale
              ).astype(np.float32)
    if stale_scale != 1.0:
        for i, t in enumerate(per_req):
            for j in range(-(-t // bs)):
                fill = min(bs, t - j * bs)
                for p in (pool_k, pool_v):
                    p[bt[i, j], :, :fill, :] = rng.standard_normal(
                        (hkv, fill, hd)).astype(np.float32)
    qshape = (B, hkv * grp, hd) if C is None else (B, hkv * grp, C, hd)
    q = rng.standard_normal(qshape).astype(np.float32)
    return dict(q=q, pk=pool_k, pv=pool_v, bt=bt,
                lens=np.asarray(per_req, np.int32), cs=cs)


def _checks(pool, cs):
    c = jcks.encode_kv(jnp.asarray(pool), cs)
    return np.asarray(c.c1), np.asarray(c.c2)


def _run_both(case, *, mode="correct", stride=8, bs=16, q_lens=None,
              window=None, fault=None, pk=None, pv=None, kc=None, vc=None,
              fn=efta_paged_attention):
    """Run the reference and the port on the same numpy inputs; return both
    outcomes as numpy (out, detected, bad)."""
    pk = case["pk"] if pk is None else pk
    pv = case["pv"] if pv is None else pv
    kc = _checks(case["pk"], case["cs"]) if kc is None else kc
    vc = _checks(case["pv"], case["cs"]) if vc is None else vc
    jcfg = JEFTAConfig(mode=mode, stride=stride, block_kv=bs)
    tcfg = EFTAConfig(mode=mode, stride=stride, block_kv=bs)
    jref = efta_paged_attention_pallas(
        jnp.asarray(case["q"]), jnp.asarray(pk), jnp.asarray(pv),
        jcks.Checksums(jnp.asarray(kc[0]), jnp.asarray(kc[1])),
        jcks.Checksums(jnp.asarray(vc[0]), jnp.asarray(vc[1])),
        jnp.asarray(case["bt"]), jnp.asarray(case["lens"]),
        None if q_lens is None else jnp.asarray(q_lens), cfg=jcfg,
        window=None if window is None else jnp.int32(window),
        fault=None if fault is None else jnp.asarray(fault, jnp.int32),
        interpret=True)
    got = fn(
        to_torch(case["q"]), to_torch(pk), to_torch(pv),
        tcks.Checksums(to_torch(kc[0]), to_torch(kc[1])),
        tcks.Checksums(to_torch(vc[0]), to_torch(vc[1])),
        to_torch(case["bt"]), to_torch(case["lens"]),
        None if q_lens is None else to_torch(np.asarray(q_lens, np.int32)),
        cfg=tcfg, window=window,
        fault=None if fault is None else np.asarray(fault, np.int32))
    ref = tuple(np.asarray(x) for x in jref)
    return ref, tuple(to_np(x) for x in got)


def _assert_parity(ref, got, tol=TOL):
    np.testing.assert_allclose(got[0], ref[0], **tol)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


STD = dict(B=3, mb=3, bs=16, hkv=2, grp=2, hd=16, cs=8)


@pytest.fixture(scope="module")
def std_case():
    return _make_case(7, **STD)


def test_fused_matches_gather_efta_and_reference(std_case):
    ref, got = _run_both(std_case)
    _assert_parity(ref, got)
    assert got[1].sum() == 0 and not got[2].any()


def test_resident_flip_flagged_at_exact_block(std_case):
    """A pool SEU: both flag exactly the (request, table slot) holding the
    flipped block, with equal site-6 counts."""
    rng = np.random.default_rng(3)
    bt, lens = std_case["bt"], std_case["lens"]
    hkv, bs, hd = std_case["pk"].shape[1:]
    for trial in range(4):
        b = int(rng.integers(0, bt.shape[0]))
        j = int(rng.integers(0, -(-int(lens[b]) // bs)))
        fill = min(bs, int(lens[b]) - j * bs)
        flat = (((int(bt[b, j]) * hkv + int(rng.integers(0, hkv))) * bs
                 + int(rng.integers(0, fill))) * hd + int(rng.integers(0, hd)))
        bit = int(rng.integers(24, 31))
        into_k = bool(rng.integers(0, 2))
        pool = (std_case["pk"] if into_k else std_case["pv"]).copy()
        flip_bit_at(torch.from_numpy(pool), flat, bit)
        kw = {"pk": pool} if into_k else {"pv": pool}
        ref, got = _run_both(std_case, **kw)
        _assert_parity(ref, got)
        assert got[2][b, j] and got[2].sum() == 1, f"trial {trial}"
        assert got[1][b, 5] >= 1 and got[1][:, 5].sum() == got[1][b, 5]


def test_checksum_corruption_is_also_detected(std_case):
    """A flip in the resident c1 plane mismatches like a data flip."""
    kc1, kc2 = _checks(std_case["pk"], std_case["cs"])
    blk = int(std_case["bt"][1, 0])
    hkv, cs, hd = kc1.shape[1:]
    kc1 = kc1.copy()
    flip_bit_at(torch.from_numpy(kc1), ((blk * hkv + 1) * cs + 2) * hd + 3, 26)
    ref, got = _run_both(std_case, kc=(kc1, kc2))
    _assert_parity(ref, got)
    assert got[2][1, 0] and got[1][1, 5] >= 1


@pytest.mark.parametrize("mode", ["correct", "detect"])
def test_compute_site_seus_corrected_in_kernel(std_case, mode):
    """High-bit SEUs at the five EFTA sites through the descriptor: equal
    detection vectors; correct mode also repairs the output."""
    clean, _ = _run_both(std_case)
    for site in (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM, Site.GEMM2):
        desc = [int(site), 0, 1, 1, 1, 3, 27, 1]
        ref, got = _run_both(std_case, mode=mode, fault=desc)
        np.testing.assert_array_equal(got[1], ref[1], err_msg=site.name)
        np.testing.assert_array_equal(got[2], ref[2], err_msg=site.name)
        if mode == "correct":
            np.testing.assert_allclose(got[0], ref[0], **TOL)
            assert np.max(np.abs(got[0] - clean[0])) < 1e-3, site.name
        if site != Site.ROWMAX:   # rowmax may cancel analytically (Case 1)
            assert got[1][1].sum() >= 1, site.name
        assert got[2].sum() == 0


def test_detect_mode_flags_without_correcting():
    case = _make_case(11, B=2, mb=2, bs=16, hkv=2, grp=2, hd=16, cs=8)
    desc = [int(Site.GEMM2), 0, 0, 0, 0, 2, 28, 1]
    ref, got = _run_both(case, mode="detect", fault=desc)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1][0].sum() >= 1
    ref, got = _run_both(case, mode="detect")
    _assert_parity(ref, got)
    assert got[1].sum() == 0


@pytest.mark.parametrize("seed,bs,heads,fragment", [
    (101, 8, (1, 1), True), (202, 16, (2, 1), False),
    (303, 16, (1, 4), True), (404, 8, (2, 2), True)])
def test_parity_property_ragged_gqa_fragmented(seed, bs, heads, fragment):
    """Ragged lengths, permuted tables, MHA/GQA/MQA, two block sizes, loud
    stale rows past every valid prefix."""
    hkv, grp = heads
    case = _make_case(seed, B=2, mb=3, bs=bs, hkv=hkv, grp=grp, hd=16,
                      cs=min(8, bs), fragment=fragment, stale_scale=50.0)
    ref, got = _run_both(case, bs=bs)
    _assert_parity(ref, got)
    assert got[1].sum() == 0


def test_chunked_q_matches_per_row_decode_oracle():
    """A 7-row chunk straddling block edges, one padding row: equal outputs,
    padding rows exactly zero."""
    case = _make_case(7, C=7, stale_scale=50.0, **STD)
    q_lens = np.minimum(6, case["lens"]).astype(np.int32)
    ref, got = _run_both(case, q_lens=q_lens)
    _assert_parity(ref, got)
    for i in range(3):
        assert not got[0][i, :, int(q_lens[i]):].any()
    assert got[1].sum() == 0


@pytest.mark.parametrize("seed,bs,heads,chunk", [
    (11, 8, (1, 1), 3), (22, 16, (2, 2), 8), (33, 16, (1, 4), 13)])
def test_chunked_parity_property_matrix(seed, bs, heads, chunk):
    hkv, grp = heads
    case = _make_case(seed, B=2, mb=3, bs=bs, hkv=hkv, grp=grp, hd=16,
                      cs=min(8, bs), C=chunk, stale_scale=50.0)
    rng = np.random.default_rng(seed + 1)
    q_lens = np.minimum(rng.integers(1, chunk + 1, size=2),
                        case["lens"]).astype(np.int32)
    ref, got = _run_both(case, bs=bs, q_lens=q_lens)
    _assert_parity(ref, got)
    assert got[1].sum() == 0


def test_chunked_sliding_window_and_idle_rows():
    """Rows apply the window at their own positions; an idle (q_len 0)
    request emits zeros while its blocks are still verified."""
    case = _make_case(5, B=3, mb=3, bs=16, hkv=2, grp=2, hd=16, cs=8, C=5)
    q_lens = np.minimum(5, case["lens"]).astype(np.int32)
    q_lens[2] = 0
    ref, got = _run_both(case, q_lens=q_lens, window=9)
    _assert_parity(ref, got)
    assert not got[0][2].any()
    pk = case["pk"].copy()
    hkv, bs, hd = pk.shape[1:]
    flip_bit_at(torch.from_numpy(pk), ((int(case["bt"][2, 0]) * hkv) * bs)
                * hd + 1, 27)
    ref, got = _run_both(case, q_lens=q_lens, pk=pk)
    _assert_parity(ref, got)
    assert got[2][2, 0] and got[1][2, 5] >= 1


def test_chunked_compute_site_seus_corrected():
    """SEUs at tile row 1*C + 2 of a chunk: equal counts, repaired output."""
    case = _make_case(11, B=2, mb=3, bs=16, hkv=2, grp=2, hd=16, cs=8, C=6)
    q_lens = np.minimum(6, case["lens"]).astype(np.int32)
    for site in (Site.GEMM1, Site.EXP, Site.ROWSUM, Site.GEMM2):
        desc = [int(site), 0, 1, 1, 1 * 6 + 2, 3, 27, 1]
        ref, got = _run_both(case, q_lens=q_lens, fault=desc)
        _assert_parity(ref, got)
        assert got[1][1].sum() >= 1, site.name
        assert got[2].sum() == 0


def test_sliding_window_masks_like_the_contiguous_path():
    case = _make_case(5, B=2, mb=3, bs=16, hkv=2, grp=2, hd=16, cs=8)
    ref, got = _run_both(case, window=9)
    _assert_parity(ref, got)
    assert got[1].sum() == 0


def test_wrapper_takes_plain_version_on_cpu_and_refuses_other_devices(
        std_case):
    """A CPU tensor reaches the plain version (same result as calling it
    directly, launch counter untouched); a tensor on a device without a
    kernel raises instead of falling back."""
    before = efta_paged_attention.launches
    ref, got = _run_both(std_case)
    _, plain = _run_both(std_case, fn=efta_paged_attention_torch)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    assert efta_paged_attention.launches == before
    cfg = EFTAConfig(mode="correct", stride=8, block_kv=16)
    meta = torch.zeros((3, 4, 16), device="meta")
    pool = torch.zeros((4, 2, 16, 16), device="meta")
    cks_ = tcks.Checksums(torch.zeros((4, 2, 8, 16), device="meta"),
                          torch.zeros((4, 2, 8, 16), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        efta_paged_attention(meta, pool, pool, cks_, cks_,
                             torch.zeros((3, 3), dtype=torch.int32),
                             torch.ones((3,), dtype=torch.int32), cfg=cfg)


def test_cuda_requested_without_card_raises():
    """Asking for the card where there is none raises; nothing silently
    runs on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("gpt2-smoke"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("gpt2-smoke"))          # cuda is the default
