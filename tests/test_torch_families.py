"""The encoder and encoder-decoder families, and ``ff_abft`` projections,
of the port against the JAX package, on the CPU.

* ``Model.logits`` of ``bert-base-smoke``, ``bert-large-smoke`` (encoder,
  non-causal), ``t5-small-smoke`` (token encoder) and ``whisper-base-smoke``
  (frontend frames) against the reference's, under ``efta`` and
  ``efta_pallas`` (the fused kernel's plain version here, the reference's
  Pallas kernel in interpret mode), within 1e-4, detections equal.
* Prefill plus 3 decode steps equal the full forward for the causal
  decoders (as ``tests/test_serve.py`` holds the reference); the encoder
  family's prefill attends non-causally and its decode causally, in both
  packages, so there the port's steps are held to the reference's steps.
  Under ``efta_pallas`` the cross-attention decode runs the fused kernel at
  ``Sq = 1``.
* ``greedy_generate`` emits the reference's tokens.
* ``ff_abft=True`` logits of ``gpt2-smoke`` and ``t5-small-smoke`` against
  the reference's ``ff_abft=True`` forward, and a fused paged serve run of
  ``gpt2-smoke`` with ``ff_abft=True`` against the JAX paged engine's
  tokens.
* Weight conversion carries the ``encoder``, ``enc_norm``, ``norm_x`` and
  ``cross`` trees across; the CLI's static-batch route serves
  ``t5-small-smoke`` and ``bert-base-smoke`` on ``--device cpu``;
  ``_check_family`` refuses a family it does not know, and a VLM whose
  cross-attention cadence does not divide its layers.
* Whisper's 1,500 frames do not divide ``block_kv`` 512: both packages
  raise under ``efta_pallas`` (ROADMAP, Queue C).
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
from repro.core.fault import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.fault import Site as JSite  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa: E402
from repro_torch.serve import PagedServeEngine, greedy_generate  # noqa: E402

ARCHS = ["bert-base-smoke", "bert-large-smoke", "t5-small-smoke",
         "whisper-base-smoke"]
IMPLS = ["efta", "efta_pallas"]


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
    """Reference parameters per arch, drawn once, with their port copy."""
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


def _inputs(cfg, b, s, seed=0):
    """Decoder tokens (B, S) and the encoder's inputs of the family, as
    (reference kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.family == "audio":
        fe = (rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model))
              * 0.1).astype(np.float32)
        jkw["frontend"], tkw["frontend"] = jnp.asarray(fe), to_torch(fe)
    if cfg.family == "encdec":
        et = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
        jkw["enc_tokens"] = jnp.asarray(et)
        tkw["enc_tokens"] = to_torch(et).long()
    return toks, jkw, tkw


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(weights, arch, impl):
    jm, tm, jp, tp = _pair(weights, arch, attn_impl=impl)
    toks, jkw, tkw = _inputs(tm.cfg, 2, 16)
    jl, jrep = jm.logits(jp, dict(tokens=jnp.asarray(toks), **jkw))
    tl, trep = tm.logits(tp, dict(tokens=to_torch(toks).long(), **tkw))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["bert-base-smoke", "t5-small-smoke",
                                  "whisper-base-smoke"])
def test_prefill_decode(weights, arch, impl):
    """Prefill 16 tokens, decode 3. The causal decoders equal their full
    forward (32 tokens, so the fused kernel's blocks divide it; causality
    keeps the first 19 rows free of the rest); every step equals the
    reference's step."""
    jm, tm, jp, tp = _pair(weights, arch, attn_impl=impl)
    toks, jkw, tkw = _inputs(tm.cfg, 2, 32, seed=1)
    full, _ = tm.logits(tp, dict(tokens=to_torch(toks).long(), **tkw))
    jc = jm.init_cache(2, cache_len=24)
    tc = tm.init_cache(2, cache_len=24)
    jl, _, jc = jm.prefill(jp, jnp.asarray(toks[:, :16]), jc, **jkw)
    tl, _, tc = tm.prefill(tp, to_torch(toks[:, :16]).long(), tc, **tkw)
    steps = [(tl, jl, 15)]
    for t in range(3):
        tok = toks[:, 16 + t:17 + t]
        jl, _, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, trep, tc = tm.decode_step(tp, to_torch(tok).long(), tc)
        assert int(trep.detected.sum()) == 0
        steps.append((tl, jl, 16 + t))
    for tl, jl, pos in steps:
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        if tm.cfg.family != "encoder":
            np.testing.assert_allclose(to_np(tl), to_np(full[:, pos]),
                                       rtol=0, atol=2e-5)
    if tm.cfg.family != "encoder":
        m = 16 if tm.cfg.family == "encdec" else tm.cfg.frontend_tokens
        assert tc.ck.shape == (tm.cfg.num_layers, 2, 2, m, 16)
    else:
        assert tc.ck is None
    assert tc.pos.tolist() == [19, 19]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["bert-base-smoke", "t5-small-smoke",
                                  "whisper-base-smoke"])
def test_greedy_generate_matches_reference(weights, arch, impl):
    jm, tm, jp, tp = _pair(weights, arch, attn_impl=impl)
    toks, jkw, tkw = _inputs(tm.cfg, 2, 16, seed=2)
    jout, jrep = jgreedy(jm, jp, jnp.asarray(toks), steps=6, **jkw)
    tout, trep = greedy_generate(tm, tp, to_torch(toks).long(), steps=6,
                                 **tkw)
    np.testing.assert_array_equal(to_np(tout), np.asarray(jout))
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))


def test_encdec_prefill_seu_matches_reference(weights):
    """A decoder self-attention SEU at prefill (plain EFTA, every decoder
    layer struck; the encoder and the cross-attention take none), detection
    vectors equal to the reference's and the corrected logits within
    1e-4."""
    jm, tm, jp, tp = _pair(weights, "t5-small-smoke")
    toks, jkw, tkw = _inputs(tm.cfg, 2, 16, seed=3)
    f = dict(block=0, batch=1, head=1, row=9, col=3, bit=27)
    jl, jrep, _ = jm.prefill(jp, jnp.asarray(toks),
                             jm.init_cache(2, cache_len=24),
                             fault=JFaultSpec.single(JSite.EXP, **f), **jkw)
    tl, trep, _ = tm.prefill(tp, to_torch(toks).long(),
                             tm.init_cache(2, cache_len=24),
                             fault=FaultSpec.single(Site.EXP, **f), **tkw)
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))
    assert int(trep.detected.sum()) >= tm.cfg.num_layers
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["gpt2-smoke", "t5-small-smoke"])
def test_ff_abft_logits_match_reference(weights, arch):
    jm, tm, jp, tp = _pair(weights, arch, ff_abft=True)
    toks, jkw, tkw = _inputs(tm.cfg, 2, 16, seed=4)
    jl, _ = jm.logits(jp, dict(tokens=jnp.asarray(toks), **jkw))
    tl, _ = tm.logits(tp, dict(tokens=to_torch(toks).long(), **tkw))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=1e-4)
    # and the protection is transparent on clean input
    plain, _ = build_model(get_config(arch), device="cpu").logits(
        tp, dict(tokens=to_torch(toks).long(), **tkw))
    np.testing.assert_allclose(to_np(tl), to_np(plain), rtol=0, atol=1e-5)


def test_ff_abft_fused_paged_serve_matches_reference(weights):
    jm, tm, jp, tp = _pair(weights, "gpt2-smoke", ff_abft=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (t,)).astype(np.int32)
               for t in (5, 17, 26, 9)]
    ref_eng = JPagedServeEngine(jm, jp, n_slots=2, cache_len=48,
                                block_size=16, kernel="fused", chunk_size=16)
    eng = PagedServeEngine(tm, tp, n_slots=2, cache_len=48, block_size=16,
                           kernel="fused", chunk_size=16)
    for p in prompts:
        ref_eng.submit(p, max_new_tokens=5)
        eng.submit(p, max_new_tokens=5)
    ref, got = ref_eng.run(), eng.run()
    assert set(got) == set(ref)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], np.asarray(ref[rid]))
    assert eng.telemetry.summary()["detected"] == 0


def test_weight_conversion_carries_the_new_trees(weights):
    for arch in ("t5-small-smoke", "whisper-base-smoke"):
        jp, tp = weights(arch)
        cfg = get_config(arch)
        for key in ("encoder", "enc_norm"):
            assert key in tp
        for key in ("norm_x", "cross"):
            assert key in tp["blocks"]
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            t = tp
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape
            np.testing.assert_array_equal(to_np(t), np.asarray(leaf))
        # a port model drawn from a generator has the same tree
        gen = torch.Generator().manual_seed(0)
        own = build_model(cfg, device="cpu").init(gen)
        assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, jp))
        assert own["encoder"]["attn"]["wq"].shape[0] == cfg.encoder_layers


@pytest.mark.parametrize("arch", ["t5-small-smoke", "bert-base-smoke"])
def test_cli_static_batch_route(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--max-prompt", "16", "--gen", "4", "--attn-impl",
                "efta_pallas"])
    out = capsys.readouterr().out      # the (requests, gen) token array
    assert len(re.findall(r"-?\d+", out)) == 2 * 4
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu", "--paged"])
    if not torch.cuda.is_available():
        # the entry point runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b-smoke"])
def test_unported_families_are_refused(arch):
    """Every family of the JAX package is ported now (the VLM last): what
    the port cannot assemble is a family it does not know, or a VLM whose
    cross-attention cadence does not divide its layers."""
    cfg = get_config(arch)
    build_model(cfg, device="cpu").init(torch.Generator())
    with pytest.raises(NotImplementedError, match="'vision'"):
        build_model(dataclasses.replace(cfg, family="vision"),
                    device="cpu").init(torch.Generator())
    with pytest.raises(NotImplementedError, match="cross_attn_every"):
        build_model(dataclasses.replace(cfg, num_layers=5),
                    device="cpu").init(torch.Generator())


def test_whisper_frames_do_not_divide_block_kv():
    """Whisper's 1,500 frames against block_kv 512 (the configs' default):
    the fused kernel's divisibility rule refuses the encoder in both
    packages. Shown at smoke widths with the frame count and block size of
    the full config."""
    arch = "whisper-base-smoke"
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, frontend_tokens=1500,
                              ft=dataclasses.replace(
                                  cfg.ft, attn_impl="efta_pallas",
                                  block_kv=512))
    jcfg = jget(arch)
    jcfg = dataclasses.replace(jcfg, frontend_tokens=1500,
                               ft=dataclasses.replace(
                                   jcfg.ft, attn_impl="efta_pallas",
                                   block_kv=512))
    fe = np.zeros((1, 1500, cfg.d_model), np.float32)
    toks = np.zeros((1, 16), np.int32)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="must divide blocks"):
        jm.logits(jp, {"tokens": jnp.asarray(toks),
                       "frontend": jnp.asarray(fe)})
    tm = build_model(cfg, device="cpu")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    with pytest.raises(ValueError, match="must divide blocks"):
        tm.logits(tp, {"tokens": to_torch(toks).long(),
                       "frontend": to_torch(fe)})
