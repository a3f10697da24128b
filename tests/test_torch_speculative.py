"""Speculative decoding in the port on ``gpt2-smoke``, against the JAX
package: the acceptance stage and the n-gram proposer on equal inputs,
``paged_rollback`` bit for bit on equal numpy pools (clean, and with a flip
between the scoring step and the rollback), and the greedy parity matrix —
``kernel`` in {gather, fused} x ``speculate`` in {ngram K 1, 2, 4, draft
self, draft cold} — whose tokens must equal the JAX engine's plain greedy
tokens, with ``paged_stats`` and per-request telemetry equal to the JAX
engine's where the JAX engine runs the same configuration. The weights are
the JAX package's, carried across by ``from_reference_params``.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_util import to_np, to_torch  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.attention import paged_rollback as jrollback  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve.draft import NGramProposer as JNGram  # noqa: E402
from repro.serve.sampling import speculative_accept as jaccept  # noqa: E402
from repro.serve.sampling import target_probs as jprobs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import checksum as cks  # noqa: E402
from repro_torch.core.fault import flip_bit_at  # noqa: E402
from repro_torch.models import (build_model, from_reference_params,  # noqa
                                paged_rollback)
from repro_torch.serve import PagedServeEngine  # noqa: E402
from repro_torch.serve.draft import NGramProposer  # noqa: E402
from repro_torch.serve.sampling import (speculative_accept,  # noqa: E402
                                        target_probs)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU matmuls run fastest on one thread when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# acceptance stage and proposer on equal inputs (no engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0), (1.0, 5)])
def test_speculative_accept_equals_reference(temperature, top_k):
    rng = np.random.default_rng(11)
    for trial in range(40):
        k = int(rng.integers(0, 5))
        rows = rng.standard_normal((k + 1, 12)).astype(np.float32) * 3
        if trial % 3 == 0:          # drafts that greedy accepts, then breaks
            drafts = rows[:k].argmax(-1)
            if k:
                drafts[-1] = (drafts[-1] + 1) % 12
        else:
            drafts = rng.integers(0, 12, (k,))
        seed = (3, trial, k)
        got = speculative_accept(rows, drafts, temperature=temperature,
                                 top_k=top_k,
                                 rng=np.random.default_rng(seed))
        ref = jaccept(rows, drafts, temperature=temperature, top_k=top_k,
                      rng=np.random.default_rng(seed))
        assert got == ref, (trial, got, ref)
    np.testing.assert_array_equal(
        target_probs(rows[0], temperature=0.7, top_k=3),
        jprobs(rows[0], temperature=0.7, top_k=3))


def test_rejection_sampling_preserves_target_distribution():
    """Committed tokens are distributed as non-speculative samples from the
    target, whatever the one-hot proposal."""
    rng = np.random.default_rng(0)
    logits = np.array([1.2, -0.4, 0.7, 2.1, 0.0], np.float32)
    p = target_probs(logits, temperature=0.9, top_k=0)
    n = 20000
    for draft_tok in (3, 1):
        counts = np.zeros(5)
        accepted = 0
        for _ in range(n):
            a, nxt = speculative_accept(
                logits[None].repeat(2, axis=0), [draft_tok],
                temperature=0.9, top_k=0, rng=rng)
            counts[draft_tok if a == 1 else nxt] += 1
            accepted += a
        np.testing.assert_allclose(counts / n, p, atol=0.015)
        assert abs(accepted / n - p[draft_tok]) < 0.015


def test_ngram_proposer_equals_reference():
    rng = np.random.default_rng(4)
    got_any = False
    for trial in range(60):
        t = int(rng.integers(1, 30))
        vocab = int(rng.integers(2, 8))        # small vocab: many matches
        toks = rng.integers(0, vocab, (t,)).astype(np.int32)
        k = int(rng.integers(0, 6))
        got = NGramProposer().propose(0, toks, k)
        ref = JNGram().propose(0, toks, k)
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=trial)
        got_any |= got.size > 0
    assert got_any


# ---------------------------------------------------------------------------
# paged_rollback bit for bit
# ---------------------------------------------------------------------------

def _rollback_case(dtype, seed):
    """A pool with 3 requests' tail blocks freshly checksummed, keep/old
    positions spanning a block edge, one untouched slot."""
    rng = np.random.default_rng(seed)
    L, nb, hkv, bs, hd, cs, mb = 2, 9, 2, 16, 8, 8, 4
    k = rng.standard_normal((L, nb + 1, hkv, bs, hd)).astype(np.float32)
    v = rng.standard_normal((L, nb + 1, hkv, bs, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    keep = np.asarray([13, 20, 40], np.int32)
    old = np.asarray([18, 20, 45], np.int32)    # 5 rows, none, 5 rows
    tk, tv = to_torch(k).to(dtype), to_torch(v).to(dtype)
    kc, vc = cks.encode_kv(tk, cs), cks.encode_kv(tv, cs)
    planes = [tk, tv, kc.c1, kc.c2, vc.c1, vc.c2]
    return planes, bt, keep, old, cs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flip", [False, True])
def test_paged_rollback_bit_equal_to_reference(dtype, flip):
    planes, bt, keep, old, cs = _rollback_case(dtype, seed=5)
    if flip:
        # a resident SEU between the scoring step and the rollback: layer 1,
        # block 1 (slot 0's first touched block), row 12 — a committed row
        # below keep_pos, which the restamp would launder
        k = planes[0]
        hkv, bs, hd = k.shape[2:]
        flip_bit_at(k, (((1 * k.shape[1] + 1) * hkv + 1) * bs + 12) * hd + 4,
                    14 if dtype == torch.bfloat16 else 30)
    thr = cks.kv_block_threshold(dtype)
    jplanes = [jnp.asarray(to_np(p.float())).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for p in planes]
    ref = jrollback(*jplanes, jnp.asarray(bt), jnp.asarray(keep),
                    jnp.asarray(old), check_stride=cs, threshold=thr,
                    max_span=16)
    got = [p.clone() for p in planes]
    bad = paged_rollback(*got, to_torch(bt), to_torch(keep), to_torch(old),
                         check_stride=cs, threshold=thr)
    np.testing.assert_array_equal(to_np(bad), np.asarray(ref[6]))
    for g, r in zip(got, ref[:6]):
        np.testing.assert_array_equal(to_np(g.float()),
                                      np.asarray(r.astype(jnp.float32)))
    assert int(bad.sum()) == (1 if flip else 0)
    if flip:
        assert bool(bad[0, 0])
    # the rejected rows are zero, the kept ones untouched
    k0 = got[0]
    assert not bool(k0[:, 1, :, 13:].any())           # slot 0 rows 13..15
    assert not bool(k0[:, 2, :, :2].any())            # slot 0 rows 16..17
    assert bool(k0[:, 4, :, 0].any())                 # slot 1 untouched


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jget("gpt2-smoke")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jcold = jm.init(jax.random.PRNGKey(7))
    cfg = get_config("gpt2-smoke")
    tm = build_model(cfg, device="cpu")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    tcold = from_reference_params(jax.tree.map(np.asarray, jcold), cfg,
                                  device="cpu")
    rng = np.random.default_rng(0)
    # ragged batch mixing repetitive prompts (the ngram proposer's regime)
    # with random ones (mostly-rejected proposals), more requests than slots
    prompts = []
    for i, t in enumerate((6, 17, 21, 9, 26)):
        if i % 2 == 0:
            pat = rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)
            prompts.append(np.tile(pat, -(-t // 3))[:t])
        else:
            prompts.append(rng.integers(0, cfg.vocab_size,
                                        (t,)).astype(np.int32))
    ref_eng = _paged(JPagedServeEngine, jm, jp)
    ref = _run(ref_eng, prompts)
    return dict(jm=jm, jp=jp, jcold=jcold, tm=tm, tp=tp, tcold=tcold,
                prompts=prompts, ref=ref)


def _paged(cls, model, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("block_size", 16)
    kw.setdefault("chunk_size", 16)
    return cls(model, params, **kw)


def _run(eng, prompts, gen=8):
    rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    outs = eng.run()
    return [[int(t) for t in outs[r]] for r in rids]


def _telemetry(eng):
    return {rid: dataclasses.asdict(st)
            for rid, st in sorted(eng.telemetry.requests.items())}


SPEC = {"ngram1": dict(speculate="ngram", draft_len=1),
        "ngram2": dict(speculate="ngram", draft_len=2),
        "ngram4": dict(speculate="ngram", draft_len=4),
        "self": dict(speculate="draft", draft_len=4),
        "cold": dict(speculate="draft", draft_len=4)}
# configurations the JAX engine also runs, for stats and telemetry equality
WITH_REFERENCE = {("gather", "ngram4"), ("fused", "ngram2"),
                  ("fused", "cold")}


@pytest.mark.parametrize("kernel", ["gather", "fused"])
@pytest.mark.parametrize("spec", list(SPEC))
def test_greedy_speculative_parity_matrix(setup, kernel, spec):
    s = setup
    kw = dict(SPEC[spec], kernel=kernel)
    if spec in ("self", "cold"):
        kw.update(draft_model=s["tm"],
                  draft_params=s["tp"] if spec == "self" else s["tcold"])
    eng = _paged(PagedServeEngine, s["tm"], s["tp"], **kw)
    prompts = s["prompts"] if spec.startswith("ngram") else s["prompts"][:3]
    got = _run(eng, prompts)
    assert got == s["ref"][:len(prompts)], f"kernel={kernel} {spec}"
    ps = eng.paged_stats
    assert ps.spec_proposed_tokens > 0
    assert ps.kv_detected_blocks == 0
    if spec in ("ngram2", "ngram4", "cold"):
        assert ps.spec_rolled_back_rows > 0
    if spec == "self":
        assert eng.acceptance_rate > 0.9
    if spec == "cold":
        assert eng.acceptance_rate < 0.5
    if kernel == "fused":
        assert eng.chunk_widths <= {1, 16}
    if (kernel, spec) in WITH_REFERENCE:
        jkw = dict(SPEC[spec], kernel=kernel)
        if spec == "cold":
            jkw.update(draft_model=s["jm"], draft_params=s["jcold"])
        jeng = _paged(JPagedServeEngine, s["jm"], s["jp"], **jkw)
        assert _run(jeng, prompts) == got
        assert dataclasses.asdict(ps) == dataclasses.asdict(jeng.paged_stats)
        assert _telemetry(eng) == _telemetry(jeng)
        assert eng.stats.steps == jeng.stats.steps
        assert eng.stats.tokens == jeng.stats.tokens


def test_speculation_respects_chunk_budget(setup):
    """Draft rows spend only leftover chunk budget: a decoding request keeps
    its token per step while a long prompt prefills."""
    s = setup
    cfg = s["tm"].cfg
    rng = np.random.default_rng(3)
    short = np.tile(rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32),
                    3)
    long_p = rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
    eng = _paged(PagedServeEngine, s["tm"], s["tp"], kernel="fused",
                 speculate="ngram", draft_len=4, chunk_budget=4, cache_len=96)
    r_short = eng.submit(short, max_new_tokens=6)
    eng.step()
    r_long = eng.submit(long_p, max_new_tokens=2)
    short_req = next(r for r in eng.scheduler.active_rows()
                     if r.rid == r_short)
    trace = []
    while not short_req.is_done():
        eng.step()
        trace.append(short_req.num_generated)
    assert all(b > a for a, b in zip(trace, trace[1:]))
    long_req = next((r for r in eng.scheduler.active_rows()
                     if r.rid == r_long), None)
    assert long_req is not None and long_req.num_generated == 0
    got = eng.run()
    plain = _paged(PagedServeEngine, s["tm"], s["tp"], kernel="fused",
                   cache_len=96)
    pa = plain.submit(short, max_new_tokens=6)
    pb = plain.submit(long_p, max_new_tokens=2)
    ref = plain.run()
    np.testing.assert_array_equal(got[r_short], ref[pa])
    np.testing.assert_array_equal(got[r_long], ref[pb])
