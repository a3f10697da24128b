"""The port's five examples (``examples_torch/``) on the CPU, against the
JAX package where a reference exists.

* ``main(["--device", "cpu"])`` of each example runs at its defaults
  (gpt2-smoke where it drives a model) and passes its own assertions.
* ``quickstart``: its detection and correction vectors equal
  ``repro.core.efta_attention``'s on the same numpy q/k/v and SEU.
* ``fault_injection_campaign``: at ``n_trials`` 8, given the reference's
  ``jax.random`` q/k/v, every mode's table equals
  ``repro.core.run_campaign``'s (the faults come from the same numpy
  generator in both packages); the worst residuals agree to 1e-5.
* ``serve_fault_tolerant`` and ``paged_prefix_serving``: with weights
  converted from the reference's ``init(PRNGKey(0))``, the tokens,
  detections and repairs equal the reference engine's on the same prompts
  and faults (the JAX ring engine; the JAX paged engine on its fused
  kernel, in interpret mode).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                       / "examples_torch"))
import fault_injection_campaign  # noqa: E402
import paged_prefix_serving  # noqa: E402
import quickstart  # noqa: E402
import serve_fault_tolerant  # noqa: E402
import train_with_restart  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import EFTAConfig as JEFTAConfig  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core import Site as JSite  # noqa: E402
from repro.core import efta_attention as jefta  # noqa: E402
from repro.core import run_campaign as jrun_campaign  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import batch_faults as jbatch_faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import from_reference_params  # noqa: E402

CPU = ["--device", "cpu"]
ARCH = "gpt2-smoke"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jbuild(jget(ARCH)).init(jax.random.PRNGKey(0))
    tp = from_reference_params(jax.tree.map(np.asarray, jp), get_config(ARCH),
                               device="cpu")
    return jp, tp


@pytest.mark.parametrize("example", [
    quickstart, fault_injection_campaign, serve_fault_tolerant,
    paged_prefix_serving, train_with_restart])
def test_example_runs_on_cpu_and_passes_its_assertions(example):
    argv = (["8"] if example is fault_injection_campaign else []) + CPU
    out = example.main(argv)
    assert isinstance(out, dict) and out


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


def test_quickstart_vectors_match_reference():
    qkv = quickstart.make_qkv()
    got = quickstart.main(CPU, params=qkv)
    q, k, v = map(jnp.asarray, qkv)
    fault = JFaultSpec.single(JSite.GEMM2, block=1, batch=0, head=2,
                              row=100, col=17, bit=28)
    _, rep = jefta(q, k, v, cfg=JEFTAConfig(mode="correct", stride=64,
                                            block_kv=128),
                   causal=True, fault=fault)
    assert got["detected"] == np.asarray(rep.detected).tolist()
    assert got["corrected"] == np.asarray(rep.corrected).tolist()
    assert sum(got["corrected"]) >= 1


def _tally(result):
    return {site.name: (t.trials, t.harmless, t.corrected, t.detected,
                        t.silent) for site, t in result.per_site.items()}


def test_campaign_table_matches_reference():
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    qkv = [np.asarray(jax.random.normal(kk, (1, 4, 128, 32))) for kk in ks]
    got = fault_injection_campaign.main(["8"] + CPU, params=qkv)
    for mode in ("off", "detect", "correct"):
        want = jrun_campaign(mode=mode, n_trials=8, seed=1)
        assert _tally(got[mode]) == _tally(want), mode
        # the table but for its first line (the worst residual's digits)
        assert got[mode].format_table().splitlines()[1:] == \
            want.format_table().splitlines()[1:]
        np.testing.assert_allclose(got[mode].worst_residual,
                                   want.worst_residual, rtol=1e-5,
                                   atol=1e-6)


def test_serve_fault_tolerant_matches_reference_engine(weights):
    jp, tp = weights
    got = serve_fault_tolerant.main(CPU, params=tp)
    jcfg = jget(ARCH)
    jm = jbuild(jcfg)
    rng = np.random.default_rng(0)
    eng = JServeEngine(jm, jp, n_slots=4, cache_len=48)
    for _ in range(8):
        t = int(rng.integers(4, 25))
        eng.submit(rng.integers(0, jcfg.vocab_size, (t,)).astype(np.int32),
                   max_new_tokens=8)
    seu = JFaultSpec.single(JSite.GEMM1, block=0, batch=0, head=1, row=0,
                            col=3, bit=27)
    want = eng.run({2: jbatch_faults(4, {1: seu})})
    summ = eng.telemetry.summary()
    assert sorted(got["tokens"]) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got["tokens"][rid],
                                      np.asarray(want[rid]))
        st = eng.telemetry.requests[rid]
        assert got["per_request"][rid] == (st.total_detected,
                                           st.total_corrected)
    assert (got["detected"], got["retries"], got["status"]) == (
        summ["detected"], summ["retries"], summ["status"])
    assert got["detected"] >= 1
    prompt = rng.integers(0, jcfg.vocab_size, (16,)).astype(np.int32)
    eng2 = JServeEngine(jm, jp, n_slots=2, cache_len=48)
    rid = eng2.submit(prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got["greedy"], np.asarray(eng2.run()[rid]))


def test_paged_prefix_serving_matches_reference_engine(weights):
    jp, tp = weights
    got = paged_prefix_serving.main(CPU, params=tp)
    jcfg = jget(ARCH)
    jm = jbuild(jcfg)
    rng = np.random.default_rng(0)
    system = rng.integers(0, jcfg.vocab_size, (32,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        0, jcfg.vocab_size, (n,)).astype(np.int32)]) for n in (4, 6, 5, 7)]

    def serve(flip):
        eng = JPagedServeEngine(jm, jp, n_slots=2, cache_len=64,
                                block_size=16, num_blocks=24, kernel="fused")
        rids = [eng.submit(prompts[0], max_new_tokens=6)]
        eng.step()
        rids += [eng.submit(p, max_new_tokens=6) for p in prompts[1:]]
        eng.step()
        if flip:
            block = next(r for r in eng.scheduler.active_rows()
                         if not r.is_done()).block_ids[0]
            eng.inject_kv_fault(layer=1, block=block, head=0, row=2, col=3,
                                bit=28, into="k")
        while eng.scheduler.has_work:
            eng.step()
        outs = {r.rid: np.asarray(r.generated)
                for r in eng.scheduler.finished}
        return eng, [outs[r] for r in rids]

    _, clean = serve(False)
    eng, healed = serve(True)
    for name, want in (("clean", clean), ("healed", healed)):
        for a, b in zip(got[name], want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    xs, ps = eng.pool.prefix.stats, eng.paged_stats
    assert (got["hit_tokens"], got["lookup_tokens"]) == (xs.hit_tokens,
                                                         xs.lookup_tokens)
    assert (got["kv_detected_blocks"], got["kv_repaired_blocks"]) == (
        ps.kv_detected_blocks, ps.kv_repaired_blocks)
    assert got["b1_launches"] == 0        # the plain version on the CPU


def test_train_with_restart_from_reference_weights(weights):
    _, tp = weights
    got = train_with_restart.main(CPU, params=tp)
    assert got["resumed_at"] == 10
    assert got["loss_a"] == pytest.approx(got["loss_b"], rel=1e-5)
    # the weights taken are the reference's, not the seed's own
    own = train_with_restart.main(CPU)
    assert own["loss_a"] != got["loss_a"]

