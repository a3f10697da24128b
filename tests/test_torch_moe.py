"""The ``moe`` family (kimi-k2, arctic) of the port against the JAX package,
on the CPU, with the reference's weights carried across by
``from_reference_params``.

* ``moe_apply`` against ``repro.models.moe.moe_apply``: outputs within
  1e-5, the aux loss within 1e-6, at the smoke configs' capacity factor
  (4.0) and at 1.25 where the capacity drops tokens; with
  ``independent_rows`` against the reference called once per row; ties of
  the router broken to the lower expert id as ``jax.lax.top_k`` does.
* ``Model.logits``, prefill plus 3 decode steps, the aux loss and
  ``greedy_generate`` of ``kimi-k2-1t-a32b-smoke`` and
  ``arctic-480b-smoke`` under ``efta`` and ``efta_pallas`` (the fused
  kernel's plain version here, the reference's Pallas kernel in interpret
  mode): f32 within 1e-5, detections equal, tokens identical.
* kimi-smoke through the ring ``ServeEngine`` and both paged backends:
  tokens equal the reference's ring and gather engines' (the reference's
  fused paged engine cannot run RoPE models, ROADMAP standing item 3); a
  fused run with a compute SEU and a resident flip repairs both and emits
  the clean tokens.
* The kernels' plain versions at the full configs' attention shapes: B1
  (paged) at head_dim 112 with 8 query heads per KV head (kimi) and at 128
  with 7 (arctic), decode and a chunked step; B2 (contiguous) at 112 and
  128; against the reference's Pallas kernels in interpret mode, clean and
  under each of the five compute-site SEUs (B1 also under a resident flip).
* A bf16 tree carried across keeps the router (and the SSM leaves) in f32.
* The CLI sends ``moe`` to both engines on ``--device cpu``.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site, flip_bit_at  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa: E402
from repro_torch.models.moe import capacity, moe_apply  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve import (PagedServeEngine, ServeEngine,  # noqa: E402
                               batch_faults, greedy_generate)

from test_torch_efta_attention import (_assert_same, _both,  # noqa: E402
                                       _qkv, seu_bit)
from test_torch_paged_kernel import (_assert_parity, _make_case,  # noqa: E402
                                     _run_both)

ARCHS = ["kimi-k2-1t-a32b-smoke", "arctic-480b-smoke"]
IMPLS = ["efta", "efta_pallas"]
TOL = dict(atol=1e-5, rtol=0)
SITES = (Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM, Site.GEMM2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with(cfg, **ft):
    return dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, **ft))


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            jp = jbuild(jget(arch)).init(jax.random.PRNGKey(0))
            tp = from_reference_params(jax.tree.map(np.asarray, jp),
                                       get_config(arch), device="cpu")
            cache[arch] = (jp, tp)
        return cache[arch]
    return get


def _pair(weights, arch, **ft):
    jm = jbuild(_with(jget(arch), **ft))
    tm = build_model(_with(get_config(arch), **ft), device="cpu")
    return (jm, tm) + weights(arch)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_case(weights, arch, cf, seed=0, b=2, s=16, repeat=0):
    """One layer's MoE parameters of ``arch`` (capacity factor ``cf``) and
    inputs x (b, s, d); the first ``repeat`` rows of each batch row are one
    repeated token (as the padding rows of a serve step are), which piles
    its top-k experts past their capacity."""
    jp, tp = weights(arch)
    jm_cfg = dataclasses.replace(jget(arch).moe, capacity_factor=cf)
    tm_cfg = dataclasses.replace(get_config(arch).moe, capacity_factor=cf)
    jparams = jax.tree.map(lambda t: t[0], jp["blocks"]["moe"])
    tparams = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, get_config(arch).d_model)).astype(
        np.float32)
    x[:, :repeat] = x[0, 0]
    return jparams, tparams, jm_cfg, tm_cfg, x


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(weights, arch, cf):
    jparams, tparams, jcfg, tcfg, x = _moe_case(weights, arch, cf,
                                                repeat=12)
    jy, jaux = j_moe_apply(jparams, jnp.asarray(x), jcfg)
    ty, taux = moe_apply(tparams, to_torch(x), tcfg)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    full, _ = moe_apply(tparams, to_torch(x), dataclasses.replace(
        tcfg, capacity_factor=64.0))
    dropped = not torch.equal(ty, full)
    # 24 copies of one token exceed the capacity only at 1.25
    assert dropped == (cf == 1.25), capacity(32, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_independent_rows_match_reference_per_row(weights, arch):
    """Each row its own routing group with its own capacity: the JAX
    package's vmapped batch-1 calls (its serve slots)."""
    jparams, tparams, jcfg, tcfg, x = _moe_case(weights, arch, 1.25, seed=1,
                                                b=3, s=8, repeat=6)
    ty, _ = moe_apply(tparams, to_torch(x), tcfg, independent_rows=True)
    for r in range(x.shape[0]):
        jy, _ = j_moe_apply(jparams, jnp.asarray(x[r:r + 1]), jcfg)
        np.testing.assert_allclose(to_np(ty[r:r + 1]), np.asarray(jy), **TOL)
    batched, _ = moe_apply(tparams, to_torch(x), tcfg)
    assert not torch.equal(ty, batched)      # the groups' capacities differ


def test_router_ties_go_to_the_lower_expert(weights):
    """A zero router makes every probability equal: both packages pick
    experts 0 .. k-1."""
    jparams, tparams, jcfg, tcfg, x = _moe_case(weights, ARCHS[0], 4.0)
    jparams = dict(jparams, router=jnp.zeros_like(jparams["router"]))
    tparams = dict(tparams, router=torch.zeros_like(tparams["router"]))
    jy, jaux = j_moe_apply(jparams, jnp.asarray(x), jcfg)
    ty, taux = moe_apply(tparams, to_torch(x), tcfg)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_decode_match_reference(weights, arch, impl):
    jm, tm, jp, tp = _pair(weights, arch, attn_impl=impl)
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jrep = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    tl, trep = tm.logits(tp, {"tokens": to_torch(toks).long()})
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))
    jc, tc = jm.init_cache(2, cache_len=24), tm.init_cache(2, cache_len=24)
    jlog, _, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tlog, _, tc = tm.prefill(tp, to_torch(toks).long(), tc)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(to_np(tlog), to_np(tl[:, -1]), **TOL)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    seq = np.concatenate([toks, tok], axis=1)
    for _ in range(3):
        jlog, jrep, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tlog, trep, tc = tm.decode_step(tp, to_torch(tok).long(), tc)
        np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), **TOL)
        assert int(trep.detected.sum()) == 0
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        seq = np.concatenate([seq, tok], axis=1)
    # prefill plus decode equal the full forward (dropless smoke routing;
    # plain EFTA: 19 tokens are no multiple of the fused kernel's blocks)
    full, _ = build_model(_with(tm.cfg, attn_impl="efta"), device="cpu"
                          ).logits(tp, {"tokens": to_torch(seq[:, :-1]).long()})
    np.testing.assert_allclose(to_np(tlog), to_np(full[:, -1]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_reference(weights, arch):
    jp, tp = weights(arch)
    toks = np.random.default_rng(2).integers(
        0, get_config(arch).vocab_size, (2, 16)).astype(np.int32)
    _, _, jaux, _ = j_forward(jp, jget(arch), {"tokens": jnp.asarray(toks)})
    _, _, taux, cache = forward(tp, get_config(arch),
                                to_torch(toks).long(), return_aux=True)
    assert cache is None and float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(weights, arch, impl):
    jm, tm, jp, tp = _pair(weights, arch, attn_impl=impl)
    toks = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jgreedy(jm, jp, jnp.asarray(toks), steps=6)
    got, rep = greedy_generate(tm, tp, to_torch(toks).long(), steps=6)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert int(rep.detected.sum()) == 0


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

LENGTHS = [5, 16, 9, 12, 3, 32, 7]


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENGTHS]


def _run(engine, prompts, n_new, faults=None):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    return engine.run(faults)


@pytest.fixture(scope="module")
def kimi_runs(weights):
    """The reference's ring and gather engines on kimi-smoke."""
    arch = ARCHS[0]
    jm, tm, jp, tp = _pair(weights, arch)
    prompts = _prompts(tm.cfg.vocab_size)
    ring = _run(JServeEngine(jm, jp, n_slots=3, cache_len=48), prompts, 7)
    jeng = JPagedServeEngine(jm, jp, n_slots=3, cache_len=48, block_size=16)
    gather = _run(jeng, prompts, 7)
    return dict(jm=jm, tm=tm, jp=jp, tp=tp, prompts=prompts, ring=ring,
                gather=gather, jeng=jeng)


def test_ring_engine_matches_reference_engine_and_greedy(kimi_runs):
    r = kimi_runs
    eng = ServeEngine(r["tm"], r["tp"], n_slots=3, cache_len=48)
    got = _run(eng, r["prompts"], 7)
    assert sorted(got) == sorted(r["ring"])
    for rid, want in r["ring"].items():
        np.testing.assert_array_equal(got[rid], np.asarray(want))
        toks, _ = greedy_generate(r["tm"], r["tp"],
                                  to_torch(r["prompts"][rid])[None].long(),
                                  steps=7, cache_len=48)
        np.testing.assert_array_equal(to_np(toks[0]), got[rid])
    assert eng.telemetry.summary()["detected"] == 0


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_paged_backends_match_reference_engines(kimi_runs, kernel):
    r = kimi_runs
    eng = PagedServeEngine(r["tm"], r["tp"], n_slots=3, cache_len=48,
                           block_size=16, kernel=kernel)
    got = _run(eng, r["prompts"], 7)
    for rid, want in r["gather"].items():
        np.testing.assert_array_equal(got[rid], np.asarray(want))
        np.testing.assert_array_equal(got[rid], np.asarray(r["ring"][rid]))
    if kernel == "gather":
        assert dataclasses.asdict(eng.paged_stats) == \
            dataclasses.asdict(r["jeng"].paged_stats)
        assert eng.stats.steps == r["jeng"].stats.steps
    assert eng.telemetry.summary()["detected"] == 0


def test_fused_run_repairs_a_compute_seu_and_a_resident_flip(kimi_runs):
    r = kimi_runs
    eng = PagedServeEngine(r["tm"], r["tp"], n_slots=3, cache_len=48,
                           block_size=16, kernel="fused")
    for p in r["prompts"]:
        eng.submit(p, max_new_tokens=7)
    step, flipped = 0, False
    while eng.scheduler.has_work:
        if step == 4:
            live = [q for q in eng.scheduler.active_rows()
                    if not q.is_done() and eng._pos[q.slot] > 2]
            eng.inject_kv_fault(layer=1, block=live[0].block_ids[0], head=1,
                                row=1, col=5, bit=30, into="k")
            flipped = True
        spec = FaultSpec.single(Site.EXP, block=0, head=1, row=0, col=3,
                                bit=27)
        eng.step(faults=batch_faults(3, {0: spec}) if step == 6 else None)
        step += 1
    got = {q.rid: np.asarray(q.generated) for q in eng.scheduler.finished}
    assert flipped
    for rid, want in r["ring"].items():
        np.testing.assert_array_equal(got[rid], np.asarray(want))
    ps = eng.paged_stats
    assert ps.kv_detected_blocks >= 1 and ps.kv_repaired_blocks >= 1
    assert eng.telemetry.summary()["detected"] >= 2


# ---------------------------------------------------------------------------
# the kernels' plain versions at the full configs' attention shapes
# ---------------------------------------------------------------------------

# (head_dim, query heads per KV head): kimi-k2 64:8 at 112, arctic 56:8 at
# 128
REGIMES = [(112, 8), (128, 7)]


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("hd,grp", REGIMES)
def test_b1_plain_matches_pallas_at_full_head_shapes(hd, grp, chunk):
    """Decode (one row per request) and a 5-row chunk with an idle slot:
    clean, each compute-site SEU (correct mode, top exponent bit) and a
    resident flip; outputs within 1e-5, detection vectors and bad planes
    equal. The engine's stride makes s_out 7 at head_dim 112."""
    case = _make_case(hd + grp, B=2, mb=3, bs=16, hkv=1, grp=grp, hd=hd,
                      cs=8, C=chunk)
    q_lens = None
    if chunk:
        q_lens = np.minimum(chunk, case["lens"]).astype(np.int32)
        q_lens[0] = 0
    kw = dict(stride=128, q_lens=q_lens)
    ref, got = _run_both(case, **kw)
    _assert_parity(ref, got)
    assert got[1].sum() == 0
    row = 0 if chunk is None else 2 * chunk + 1      # query head 2
    for site in SITES:
        desc = [int(site), 0, 1, 0, row, 3, 30, 1]
        ref, got = _run_both(case, fault=desc, **kw)
        _assert_parity(ref, got)
        if site != Site.ROWMAX:   # rowmax may cancel analytically (Case 1)
            assert got[1][1].sum() >= 1, site.name
    pk = case["pk"].copy()
    blk = int(case["bt"][1, 0])
    flip_bit_at(torch.from_numpy(pk), (blk * 16 + 2) * hd + 7, 30)
    ref, got = _run_both(case, pk=pk, **kw)
    _assert_parity(ref, got)
    assert got[2][1, 0] and got[1][1, 5] >= 1


@pytest.mark.parametrize("hd,grp", REGIMES)
def test_b2_plain_matches_pallas_at_full_head_shapes(hd, grp):
    """Causal prefill, grp query heads on one KV head, two KV blocks:
    clean and each compute-site SEU in correct mode."""
    q, k, v = _qkv(1, grp, 1, 64, 64, hd, seed=hd)
    cfg = dict(mode="correct", stride=128, block_kv=32)
    ref, got = _both(q, k, v, cfg=cfg, causal=True, block_q=32)
    _assert_same(ref, got)
    assert got[1].sum() == 0
    for site in SITES:
        fault = np.asarray([int(site), 1, grp - 1, 63, 9,
                            seu_bit("correct"), 1, 0], np.int32)
        ref, got = _both(q, k, v, cfg=cfg, fault=fault, causal=True,
                         block_q=32)
        _assert_same(ref, got)
        assert got[1].sum() >= 1, site.name


# ---------------------------------------------------------------------------
# conversion and the CLI
# ---------------------------------------------------------------------------

F32_LEAVES = {"kimi-k2-1t-a32b-smoke": ("moe/router",),
              "rwkv6-7b-smoke": ("time_mix/w_base", "time_mix/u",
                                 "time_mix/ln_x"),
              "hymba-1.5b-smoke": ("mamba/A_log", "mamba/D")}


@pytest.mark.parametrize("arch", sorted(F32_LEAVES))
def test_bf16_conversion_keeps_the_reference_dtypes(arch):
    """A bf16 tree carried across keeps the leaves the reference stores in
    f32 in f32 (the router would otherwise round and routing could move);
    every other leaf stays bf16. The logits: each package rounds its own
    bf16 intermediates in its own order, so both are held to an f32 forward
    of the same (bf16-valued) weights: the port's rms error is at most 1.5x
    the reference's, and the two differ by at most twice that error."""
    jcfg = dataclasses.replace(jget(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_reference_params(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    blocks = tp["blocks"]
    for path in F32_LEAVES[arch]:
        a, b = path.split("/")
        assert blocks[a][b].dtype == torch.float32, path
    assert blocks["norm1"]["w"].dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = build_model(tcfg, device="cpu").logits(
        tp, {"tokens": to_torch(toks).long()})
    truth, _ = jbuild(dataclasses.replace(jcfg, dtype="float32")).logits(
        jax.tree.map(lambda t: t.astype(jnp.float32), jp),
        {"tokens": jnp.asarray(toks)})
    jl, tl, truth = np.asarray(jl, np.float32), to_np(tl), np.asarray(truth)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))
    ref_err = rms(jl - truth)
    assert 0 < ref_err < 0.05 * rms(truth)
    assert rms(tl - truth) <= 1.5 * ref_err
    assert rms(tl - jl) <= 2 * ref_err


@pytest.mark.parametrize("extra", [[], ["--paged", "--kernel", "fused"],
                                   ["--paged"]])
def test_cli_serves_moe_through_the_engines(capsys, extra):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCHS[1], "--device", "cpu", "--requests", "3",
                "--slots", "2", "--gen", "4"] + extra)
    out = capsys.readouterr().out
    assert out.strip().startswith("{0: [")
    assert len(re.findall(r"\[([\d, ]+)\]", out)) == 3
