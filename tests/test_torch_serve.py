"""Serving parity on ``gpt2-smoke``: the port's fused paged engine on the
CPU against the JAX package's ``PagedServeEngine(kernel="fused")``, with
the weights carried across by ``from_reference_params``.

Greedy tokens must be identical on the prompt matrix of
``test_unified_mixed_batches_token_identical_to_gather`` (ragged prompts
straddling chunk and block edges, more requests than slots) for chunk
widths 16 and 32; the clean run detects nothing and launches at most two
chunk widths. A resident KV flip and compute-site SEUs mid-prefill must be
detected, repaired or retried, and leave the clean run's tokens: zero
silent corruptions. The reference engine runs once (its tokens do not
depend on the chunk width).
"""
import ast
import dataclasses
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,  # noqa: E402
                               PagedServeEngine, Request, batch_faults)

LENGTHS = [3, 9, 16, 17, 25, 31, 40]
STEPS = [5, 4, 7, 3, 6, 4, 5]


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("gpt2-smoke")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("gpt2-smoke")
    tm = build_model(cfg, device="cpu")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
               for t in LENGTHS]
    ref_eng = JPagedServeEngine(jm, jp, n_slots=3, cache_len=48,
                                block_size=16, kernel="fused", chunk_size=16)
    for p, s in zip(prompts, STEPS):
        ref_eng.submit(p, max_new_tokens=s)
    ref = ref_eng.run()
    return cfg, tm, tp, prompts, ref


def _engine(model, params, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("cache_len", 48)
    kw.setdefault("block_size", 16)
    return PagedServeEngine(model, params, kernel="fused", **kw)


@pytest.mark.parametrize("chunk", [16, 32])
def test_fused_engine_tokens_identical_to_reference(setup, chunk):
    cfg, tm, tp, prompts, ref = setup
    eng = _engine(tm, tp, chunk_size=chunk)
    for p, s in zip(prompts, STEPS):
        eng.submit(p, max_new_tokens=s)
    got = eng.run()
    assert set(got) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], np.asarray(ref[rid]),
                                      err_msg=f"chunk={chunk} rid={rid}")
    assert eng.paged_stats.chunked_prefill_tokens > 0
    assert eng.paged_stats.kv_detected_blocks == 0
    assert eng.telemetry.summary()["detected"] == 0
    assert eng.stats.steps < sum(STEPS) + len(LENGTHS)      # actually mixed
    assert eng.chunk_widths <= {1, chunk}


def test_at_most_two_chunk_widths_launched(setup):
    cfg, tm, tp, _, _ = setup
    rng = np.random.default_rng(5)
    eng = _engine(tm, tp, chunk_size=16, cache_len=64)
    for t in (3, 5, 9, 14, 17, 23, 26, 31, 40, 44):
        eng.submit(rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32),
                   max_new_tokens=3)
    eng.run()
    assert len(eng.chunk_widths) <= 2, eng.chunk_widths
    # every launch is one forward pass of the whole stack
    assert eng.stats.forwards >= eng.stats.steps


def test_resident_kv_flip_detected_repaired_token_identical(setup):
    cfg, tm, tp, prompts, _ = setup
    prompt = prompts[4]                         # 25 tokens: two blocks
    clean = _engine(tm, tp, n_slots=2, chunk_size=16)
    rc = clean.submit(prompt, max_new_tokens=8)
    ref = clean.run()[rc]

    eng = _engine(tm, tp, n_slots=2, chunk_size=16)
    rid = eng.submit(prompt, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    widths = set(eng.chunk_widths)
    req = list(eng.scheduler.active_rows())[0]
    eng.inject_kv_fault(layer=1, block=req.block_ids[0], head=0, row=3,
                        col=5, bit=27, into="v")
    out = eng.run()[rid]
    np.testing.assert_array_equal(out, ref)
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.paged_stats.kv_repaired_blocks == 1
    assert eng.telemetry.requests[rid].detected[5] >= 1
    assert eng.chunk_widths == widths          # repair reuses the step


@pytest.mark.parametrize("mode", ["correct", "detect"])
def test_compute_site_seu_during_chunked_prefill(setup, mode):
    cfg, tm, tp, prompts, _ = setup
    prompt = prompts[6]                         # 40 tokens: 3 prefill chunks
    clean = _engine(tm, tp, n_slots=2, chunk_size=16)
    rc = clean.submit(prompt, max_new_tokens=4)
    ref = clean.run()[rc]

    mcfg = dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, mode=mode))
    eng = _engine(build_model(mcfg, device="cpu"), tp, n_slots=2,
                  chunk_size=16)
    rid = eng.submit(prompt, max_new_tokens=4)
    faults = {0: batch_faults(2, {0: FaultSpec.single(
                  Site.GEMM2, block=0, head=1, row=0, col=3, bit=27)}),
              1: batch_faults(2, {0: FaultSpec.single(
                  Site.GEMM1, block=1, head=2, row=0, col=5, bit=26)})}
    out = eng.run(faults_by_step=faults)[rid]
    np.testing.assert_array_equal(out, ref)
    st = eng.telemetry.requests[rid]
    assert sum(st.detected[:5]) >= 1
    assert st.detected[5] == 0
    if mode == "detect":
        assert eng.stats.retries >= 1          # detected only: retried


def _req(rid, admit_order):
    r = Request(rid=rid, prompt=np.asarray([1], np.int32), max_new_tokens=1)
    r.admit_order = admit_order
    return r


def test_plan_chunks_decodes_never_starve_and_budget_is_fcfs():
    sched = ContinuousBatchingScheduler(4, chunk_budget=6)
    a, b, c = _req(0, 0), _req(1, 1), _req(2, 2)
    grants = sched.plan_chunks([(a, 1), (b, 30), (c, 30)], chunk_size=8)
    assert grants == {a.rid: 1, b.rid: 7, c.rid: 1}
    sched.chunk_budget = None
    grants = sched.plan_chunks([(a, 1), (b, 30), (c, 5)], chunk_size=8)
    assert grants == {a.rid: 1, b.rid: 8, c.rid: 5}
    assert sched.plan_chunks([(a, 0), (b, 3)], chunk_size=4) == \
        {a.rid: 0, b.rid: 3}


def test_engine_refuses_unported_backends(setup):
    cfg, tm, tp, _, _ = setup
    for kw in ({"kernel": "gather"}, {"kv_verify": "stamped"},
               {"scrub_interval": 2}, {"speculate": "ngram"}):
        args = dict(n_slots=2, cache_len=48, block_size=16, **kw)
        with pytest.raises(NotImplementedError):
            PagedServeEngine(tm, tp, **args)


def test_sampling_greedy_exact_and_per_request_streams():
    """Greedy rows are exact argmax; a stochastic row's draw depends only
    on its own (seed, rid, counter) and logits, stays inside its top-k, and
    repeats exactly."""
    import torch
    from repro_torch.serve.sampling import sample_tokens
    logits = torch.randn((4, 50), generator=torch.Generator().manual_seed(0))
    kw = dict(temperature=np.asarray([0.0, 1.0, 1.0, 0.7], np.float32),
              top_k=np.asarray([0, 0, 3, 5]), seeds=np.asarray([1, 1, 1, 2]),
              rids=np.asarray([0, 1, 2, 3]), counters=np.asarray([0, 0, 0, 4]))
    a = sample_tokens(logits, **kw)
    assert a.tolist() == sample_tokens(logits, **kw).tolist()
    assert a[0] == int(torch.argmax(logits[0]))
    assert a[2] in torch.topk(logits[2], 3).indices.tolist()
    assert a[3] in torch.topk(logits[3], 5).indices.tolist()
    alone = sample_tokens(logits[1:2], **{k: v[1:2] for k, v in kw.items()})
    assert alone[0] == a[1]
    draws = {int(sample_tokens(logits[1:2], **dict(
        {k: v[1:2] for k, v in kw.items()}, counters=np.asarray([c])))[0])
        for c in range(40)}
    assert len(draws) > 1                   # the counter moves the stream


def test_launch_serve_cli_on_cpu(capsys):
    """The serve entry point runs end to end on the CPU when asked to, with
    compute SEUs and resident flips injected."""
    from repro_torch.launch.serve import main
    main(["--arch", "gpt2-smoke", "--paged", "--kernel", "fused",
          "--device", "cpu", "--requests", "3", "--slots", "2", "--gen", "4",
          "--inject-faults", "2", "--kv-flips", "1", "--cache-len", "48"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    tokens = ast.literal_eval(out)           # {rid: [tokens]}
    assert sorted(tokens) == [0, 1, 2]
    assert all(len(t) == 4 for t in tokens.values())
