"""The port's SEU campaigns (``repro_torch.core.campaign``) on the CPU,
held to the properties ``tests/test_fault_campaign.py`` holds the JAX
package's to: ~50 seeded faults per mode across every attention site with
zero silent corruptions in correct mode (and every visible corruption
repaired), every corruption flagged in detect mode, silent corruption with
protection off, deterministic tallies; and resident-KV campaigns through
both paged backends with every flip detected, repaired and the clean
tokens kept. The inputs come from ``torch.Generator`` streams, not
``jax.random``, so the tallies compare by property, not by value.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DEFAULT_SITES, Site, run_campaign, run_kv_campaign

N = 50
BITS = (20, 30)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def correct_result():
    return run_campaign(mode="correct", n_trials=N, seed=0, bit_range=BITS,
                        device="cpu")


def test_correct_mode_no_silent_corruption(correct_result):
    t = correct_result.totals
    assert t.trials == N
    assert t.silent == 0, correct_result.format_table()
    assert t.detected == 0, correct_result.format_table()
    assert correct_result.worst_residual < 1e-3


def test_correct_mode_per_site_coverage(correct_result):
    for site in DEFAULT_SITES:
        tally = correct_result.per_site[site]
        assert tally.trials > 0, f"campaign never sampled {site.name}"
        assert tally.silent == 0, f"{site.name}: {tally}"
    for site in (Site.GEMM1, Site.EXP, Site.ROWSUM, Site.GEMM2):
        assert correct_result.per_site[site].corrected > 0, site.name


def test_detect_mode_flags_every_corruption():
    r = run_campaign(mode="detect", n_trials=N, seed=0, bit_range=BITS,
                     device="cpu")
    assert r.totals.silent == 0, r.format_table()
    assert r.totals.detected > 0


def test_off_mode_suffers_silent_corruption():
    r = run_campaign(mode="off", n_trials=20, seed=0, bit_range=BITS,
                     device="cpu")
    assert r.totals.silent > 0
    assert r.totals.corrected == 0 and r.totals.detected == 0


def test_campaign_is_deterministic():
    a = run_campaign(mode="correct", n_trials=10, seed=3, bit_range=BITS,
                     device="cpu")
    b = run_campaign(mode="correct", n_trials=10, seed=3, bit_range=BITS,
                     device="cpu")
    assert a.per_site == b.per_site
    assert np.isclose(a.worst_residual, b.worst_residual)


@pytest.mark.parametrize("kernel,kw", [
    ("gather", dict(n_trials=6, seed=3)),
    ("fused", dict(n_trials=4, seed=5, n_requests=2, cache_len=48, gen=6)),
    ("fused", dict(n_trials=4, seed=2, chunk_size=16, chunk_budget=8,
                   max_prompt=40, cache_len=64))])
def test_kv_campaign_no_silent_resident_corruption(kernel, kw):
    """Every randomized high-bit resident flip is caught at read time,
    healed by block re-prefill, and leaves every request's tokens as the
    clean run's — on both backends, and through chunked prefill."""
    r = run_kv_campaign(kernel=kernel, device="cpu", **kw)
    n = kw["n_trials"]
    assert r.n_trials == n
    assert r.detected == n, r.format_table()
    assert r.undetected == 0
    assert r.repaired_blocks >= n
    assert r.mismatched_requests == 0, r.format_table()
    assert r.telemetry_kv_detected == n
