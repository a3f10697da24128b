"""The port's gather backend on ``gpt2-smoke``: ``PagedServeEngine(kernel=
"gather")`` — tables gathered into contiguous ring views, plain-PyTorch EFTA,
read-time checksum verification outside attention — against the JAX
package's gather engine, and against the port's own fused backend and ring
engine.

Greedy tokens, ``paged_stats`` and per-request telemetry equal the JAX
engine's under ``kv_verify="always"`` and ``"stamped"`` and with the scrub
catching a flip in a stamped block; the fused backend and the ring engine
emit the same tokens; stamps invalidate on write and on repair, the stamped
policy defers detection in verified blocks and the scrub bounds it,
including over parked prefix-cache blocks; resident flips are detected,
repaired and reported; and the serve CLI runs ``--kernel gather`` and
``--speculate ngram`` on the CPU.
"""
import ast
import dataclasses
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa
from repro_torch.serve import PagedServeEngine, ServeEngine  # noqa: E402

LENGTHS = [3, 9, 16, 17, 25, 31, 40]
STEPS = [5, 4, 7, 3, 6, 4, 5]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jm = jbuild(jget("gpt2-smoke"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("gpt2-smoke")
    tm = build_model(cfg, device="cpu")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
               for t in LENGTHS]
    return dict(cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, prompts=prompts)


def _paged(model, params, cls=PagedServeEngine, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("cache_len", 48)
    kw.setdefault("block_size", 16)
    return cls(model, params, **kw)


def _submit_all(eng, prompts):
    for p, s in zip(prompts, STEPS):
        eng.submit(p, max_new_tokens=s)


def _telemetry(eng):
    return {rid: dataclasses.asdict(st)
            for rid, st in sorted(eng.telemetry.requests.items())}


def _prompt(s, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, s["cfg"].vocab_size, (n,)).astype(np.int32)


@pytest.mark.parametrize("kv_verify", ["always", "stamped"])
def test_gather_engine_equals_reference(setup, kv_verify):
    """Ragged prompts straddling block edges, more requests than slots:
    tokens, stats and telemetry equal the JAX gather engine's; the stamped
    policy skips folds and keeps the tokens."""
    s = setup
    eng = _paged(s["tm"], s["tp"], kv_verify=kv_verify)
    jeng = _paged(s["jm"], s["jp"], JPagedServeEngine, kv_verify=kv_verify)
    _submit_all(eng, s["prompts"])
    _submit_all(jeng, s["prompts"])
    got, ref = eng.run(), jeng.run()
    assert set(got) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], np.asarray(ref[rid]),
                                      err_msg=f"rid={rid}")
    assert dataclasses.asdict(eng.paged_stats) == \
        dataclasses.asdict(jeng.paged_stats)
    assert _telemetry(eng) == _telemetry(jeng)
    assert eng.stats.steps == jeng.stats.steps
    ps = eng.paged_stats
    assert ps.kv_detected_blocks == 0
    if kv_verify == "stamped":
        assert ps.kv_verify_skips > 0
    else:
        assert ps.kv_verify_skips == 0 and ps.kv_verified_blocks > 0
    assert eng.chunk_widths == set()              # B1 never launched


@pytest.mark.parametrize("chunk", [16, 32])
def test_fused_backend_token_identical_to_gather(setup, chunk):
    s = setup
    gather = _paged(s["tm"], s["tp"])
    fused = _paged(s["tm"], s["tp"], kernel="fused", chunk_size=chunk)
    _submit_all(gather, s["prompts"])
    _submit_all(fused, s["prompts"])
    ref, got = gather.run(), fused.run()
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid],
                                      err_msg=f"chunk={chunk} rid={rid}")
    assert fused.paged_stats.chunked_prefill_tokens > 0
    assert fused.chunk_widths <= {1, chunk}


def test_gather_engine_token_identical_to_ring_engine(setup):
    s = setup
    lengths, steps = [5, 9, 16, 3, 12, 7], [6, 4, 8, 5, 3, 7]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, s["cfg"].vocab_size, (t,)).astype(np.int32)
               for t in lengths]
    ring = ServeEngine(s["tm"], s["tp"], n_slots=3, cache_len=48)
    paged = _paged(s["tm"], s["tp"])
    for p, n in zip(prompts, steps):
        ring.submit(p, max_new_tokens=n)
        paged.submit(p, max_new_tokens=n)
    ref, got = ring.run(), paged.run()
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert paged.stats.steps < sum(steps)


def test_kv_bit_flip_detected_repaired_and_reported(setup):
    """A resident flip between decode steps: detected at the next gather,
    only that block re-prefilled, reported at site 6 — as the JAX engine
    reports it — and the clean run's tokens."""
    s = setup
    prompt = _prompt(s, 20, 2)
    clean = _paged(s["tm"], s["tp"], n_slots=2)
    rc = clean.submit(prompt, max_new_tokens=8)
    ref = clean.run()[rc]
    engines = []
    for model, params, cls in ((s["tm"], s["tp"], PagedServeEngine),
                               (s["jm"], s["jp"], JPagedServeEngine)):
        eng = _paged(model, params, cls, n_slots=2)
        rid = eng.submit(prompt, max_new_tokens=8)
        eng.step()
        req = list(eng.scheduler.active_rows())[0]
        eng.inject_kv_fault(layer=1, block=req.block_ids[0], head=0, row=3,
                            col=5, bit=27, into="v")
        np.testing.assert_array_equal(eng.run()[rid], ref)
        engines.append(eng)
    eng, jeng = engines
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.paged_stats.kv_repaired_blocks == 1
    st = eng.telemetry.requests[rid]
    assert st.detected[5] == 1 and st.corrected[5] == 1
    assert _telemetry(eng) == _telemetry(jeng)
    assert dataclasses.asdict(eng.paged_stats) == \
        dataclasses.asdict(jeng.paged_stats)


def test_kv_repair_survives_zero_retry_budget(setup):
    """With ``max_retries=0`` an attempt that read poisoned KV is still
    never committed: KV repair has its own >= 1 retry budget."""
    s = setup
    prompt = _prompt(s, 18, 3)
    clean = _paged(s["tm"], s["tp"], n_slots=2, max_retries=0)
    rc = clean.submit(prompt, max_new_tokens=6)
    ref = clean.run()[rc]
    eng = _paged(s["tm"], s["tp"], n_slots=2, max_retries=0)
    rid = eng.submit(prompt, max_new_tokens=6)
    eng.step()
    req = list(eng.scheduler.active_rows())[0]
    eng.inject_kv_fault(layer=0, block=req.block_ids[1], head=1, row=1,
                        col=2, bit=26, into="k")
    np.testing.assert_array_equal(eng.run()[rid], ref)
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.paged_stats.kv_repaired_blocks == 1


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_persistent_kv_corruption_never_commits(setup, kernel):
    """A corruption that outlives its repair (simulated by defeating the
    repair) in the tail block: no attempt that read it is committed — the
    attempt's in-place append must not restamp the flagged block — and
    repeated poisoned steps escalate to an error."""
    s = setup
    eng = _paged(s["tm"], s["tp"], n_slots=2, kernel=kernel)
    rid = eng.submit(_prompt(s, 10, 4), max_new_tokens=6)
    eng.step()
    req = list(eng.scheduler.active_rows())[0]
    eng.inject_kv_fault(layer=0, block=req.block_ids[0], head=0, row=1,
                        col=1, bit=28, into="k")
    eng._repair_blocks = lambda *a, **k: None     # sticky: repair defeated
    n_before = req.num_generated
    eng.step()
    assert req.num_generated == n_before
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.telemetry.requests[rid].detected[5] >= 1
    with pytest.raises(RuntimeError, match="cordon"):
        eng.run()


def test_prefix_cache_prefill_once_and_token_identity(setup):
    s = setup
    sys_prompt = _prompt(s, 32, 5)
    prompts = [np.concatenate([sys_prompt, _prompt(s, n, 6 + n)])
               for n in (5, 7)]
    eng = _paged(s["tm"], s["tp"], cache_len=64, num_blocks=16)
    eng.submit(prompts[0], max_new_tokens=4)
    eng.run()
    r1 = eng.submit(prompts[1], max_new_tokens=4)
    out1 = eng.run()[r1]
    assert eng.pool.prefix.stats.hit_tokens >= 32
    cold = _paged(s["tm"], s["tp"], cache_len=64, num_blocks=16)
    rc = cold.submit(prompts[1], max_new_tokens=4)
    np.testing.assert_array_equal(out1, cold.run()[rc])


def test_stamps_invalidate_on_write_and_on_repair(setup):
    s = setup
    prompt = _prompt(s, 20, 7)
    clean = _paged(s["tm"], s["tp"], n_slots=2, kv_verify="stamped")
    rc = clean.submit(prompt, max_new_tokens=8)
    ref = clean.run()[rc]
    eng = _paged(s["tm"], s["tp"], n_slots=2, kv_verify="stamped")
    rid = eng.submit(prompt, max_new_tokens=8)
    eng.step()
    req = list(eng.scheduler.active_rows())[0]
    blocks = eng.pool.blocks
    tail_j = int(eng._pos[req.slot]) // eng.block_size
    assert not blocks.needs_verify(req.block_ids[0])
    assert blocks.needs_verify(req.block_ids[tail_j])
    eng.inject_kv_fault(layer=0, block=req.block_ids[tail_j], head=1,
                        row=1, col=2, bit=27, into="k")
    eng.step()
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.paged_stats.kv_repaired_blocks >= 1
    np.testing.assert_array_equal(eng.run()[rid], ref)


def _poisoned_block0(s, cls=PagedServeEngine, model=None, params=None,
                     run=False, **kw):
    """One request of 20 tokens, one step, then a flip in block 0 (non-tail:
    stamped-verified and untouched)."""
    eng = _paged(model or s["tm"], params or s["tp"], cls, n_slots=2, **kw)
    eng.submit(_prompt(s, 20, 8), max_new_tokens=4)
    eng.step()
    req = list(eng.scheduler.active_rows())[0]
    eng.inject_kv_fault(layer=0, block=req.block_ids[0], head=0,
                        row=2, col=3, bit=27, into="k")
    if run:
        eng.run()
    else:
        eng.step()
    return eng


def test_stamped_policy_defers_detection_of_stamped_blocks(setup):
    """The documented coverage tradeoff: under the stamped policy a flip in
    a verified, untouched block is not re-folded; the always policy catches
    the same flip at once."""
    s = setup
    assert _poisoned_block0(s).paged_stats.kv_detected_blocks == 1
    assert _poisoned_block0(
        s, kv_verify="stamped").paged_stats.kv_detected_blocks == 0


def test_scrub_bounds_stamped_deferred_detection(setup):
    """The scrub catches the flip the stamped selector skips, and the
    engine repairs it, as the JAX engine does."""
    s = setup
    missed = _poisoned_block0(s, kv_verify="stamped", run=True)
    assert missed.paged_stats.kv_detected_blocks == 0
    kw = dict(kv_verify="stamped", scrub_interval=1, scrub_batch=4, run=True)
    eng = _poisoned_block0(s, **kw)
    jeng = _poisoned_block0(s, JPagedServeEngine, s["jm"], s["jp"], **kw)
    assert eng.paged_stats.kv_scrubbed_blocks > 0
    assert eng.paged_stats.kv_detected_blocks == 1
    assert eng.paged_stats.kv_repaired_blocks >= 1
    assert dataclasses.asdict(eng.paged_stats) == \
        dataclasses.asdict(jeng.paged_stats)
    assert _telemetry(eng) == _telemetry(jeng)


def test_scrub_covers_parked_prefix_blocks(setup):
    """A flip in a parked prefix-cache block (in no live table) is caught by
    the scrub, the cache entry is discarded, and the next admission of the
    same prefix misses cleanly and is token-identical."""
    s = setup
    prompt = np.concatenate([_prompt(s, 16, 9), _prompt(s, 4, 10)])
    eng = _paged(s["tm"], s["tp"], cache_len=64, num_blocks=16,
                 kv_verify="stamped", scrub_interval=1, scrub_batch=2)
    eng.submit(prompt, max_new_tokens=2)
    eng.run()
    parked = eng.pool.blocks.parked_blocks()
    assert parked
    eng.inject_kv_fault(layer=0, block=parked[0], head=0, row=3, col=1,
                        bit=27, into="k")
    det0 = eng.paged_stats.kv_detected_blocks
    eng.submit(_prompt(s, 4, 11), max_new_tokens=6)
    steps = 0
    while eng.scheduler.has_work and \
            eng.paged_stats.kv_detected_blocks == det0:
        eng.step()
        steps += 1
        assert steps < 20, "scrub never reached the parked block"
    assert eng.paged_stats.kv_detected_blocks == det0 + 1
    assert parked[0] not in eng.pool.blocks.parked_blocks()
    eng.run()
    r2 = eng.submit(prompt, max_new_tokens=2)
    out = eng.run()[r2]
    ref_eng = _paged(s["tm"], s["tp"], cache_len=64, num_blocks=16)
    rr = ref_eng.submit(prompt, max_new_tokens=2)
    np.testing.assert_array_equal(out, ref_eng.run()[rr])


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_decode_filled_blocks_register_in_prefix_cache(setup, kernel):
    s = setup
    prompt = _prompt(s, 16, 12)
    eng = _paged(s["tm"], s["tp"], n_slots=2, cache_len=64, num_blocks=16,
                 kernel=kernel)
    r0 = eng.submit(prompt, max_new_tokens=20)
    first = eng.run()[r0]
    hit_before = eng.pool.prefix.stats.hit_tokens
    eng.submit(np.concatenate([prompt, first]).astype(np.int32),
               max_new_tokens=2)
    eng.run()
    assert eng.pool.prefix.stats.hit_tokens - hit_before >= 32


def test_pool_pressure_preempts_and_evicts_yet_stays_exact(setup):
    s = setup
    pa, pb = _prompt(s, 10, 13), _prompt(s, 9, 14)
    eng = _paged(s["tm"], s["tp"], n_slots=2, cache_len=32, block_size=8,
                 num_blocks=5)
    ra = eng.submit(pa, max_new_tokens=12)
    rb = eng.submit(pb, max_new_tokens=12)
    outs = eng.run()
    assert eng.paged_stats.preemptions >= 1
    ring = ServeEngine(s["tm"], s["tp"], n_slots=2, cache_len=32)
    r2a = ring.submit(pa, max_new_tokens=12)
    r2b = ring.submit(pb, max_new_tokens=12)
    ref = ring.run()
    np.testing.assert_array_equal(outs[ra], ref[r2a])
    np.testing.assert_array_equal(outs[rb], ref[r2b])


@pytest.mark.parametrize("extra", [
    ["--speculate", "ngram", "--kernel", "fused", "--inject-faults", "2"],
    ["--paged", "--kernel", "gather", "--kv-verify", "stamped",
     "--scrub-interval", "2", "--kv-flips", "1"],
    ["--speculate", "draft", "--kernel", "gather", "--draft-len", "2"]])
def test_launch_serve_cli_speculate_and_gather(capsys, extra):
    """The serve entry point runs the gather backend and both proposers end
    to end on the CPU."""
    from repro_torch.launch.serve import main
    main(["--arch", "gpt2-smoke", "--device", "cpu", "--requests", "3",
          "--slots", "2", "--gen", "4", "--cache-len", "48"] + extra)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    tokens = ast.literal_eval(out)
    assert sorted(tokens) == [0, 1, 2]
    assert all(len(t) == 4 for t in tokens.values())
