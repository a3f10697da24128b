"""The ``vlm`` family (llama-3.2-vision-11b) of the port against the JAX
package, on the CPU, at ``-smoke`` size (4 layers in 2 superblocks of one
dense block and one cross block, 8 frontend rows, block_kv 16).

* ``Model.logits`` equal the reference's under ``efta`` and
  ``efta_pallas`` (B2's plain version here, the reference's Pallas kernel
  in interpret mode), within 1e-4, detections equal.
* Prefill plus 3 decode steps equal the reference's steps and the full
  forward; the cross blocks' cache holds the frontend's K/V.
* ``greedy_generate`` emits the reference's tokens under both.
* A frontend that does not divide ``block_kv`` (40 rows at 16) makes
  ``efta_pallas`` raise in both packages; ``efta`` pads it.
* The SEU strikes the dense blocks' self-attention only, as in the
  reference: equal detection vectors, and only those layers see it.
* Weight conversion carries the nested stacks; the CLI serves the VLM on
  the static-batch route and refuses ``--paged``.
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
from repro.serve import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.models import (VLMCache, build_model,  # noqa: E402
                                from_reference_params)
from repro_torch.serve import greedy_generate  # noqa: E402

ARCH = "llama-3.2-vision-11b-smoke"
IMPLS = ["efta", "efta_pallas"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with(cfg, **kw):
    ft = {k: kw.pop(k) for k in list(kw) if hasattr(cfg.ft, k)}
    return dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, **ft),
                               **kw)


@pytest.fixture(scope="module")
def weights():
    jp = jbuild(jget(ARCH)).init(jax.random.PRNGKey(0))
    tp = from_reference_params(jax.tree.map(np.asarray, jp),
                               get_config(ARCH), device="cpu")
    return jp, tp


def _pair(weights, **kw):
    return (jbuild(_with(jget(ARCH), **kw)),
            build_model(_with(get_config(ARCH), **kw), device="cpu")
            ) + weights


def _inputs(cfg, b, s, seed=0, m=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    fe = (rng.standard_normal((b, m or cfg.frontend_tokens, cfg.d_model))
          * 0.1).astype(np.float32)
    return toks, fe


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_match_reference(weights, impl):
    jm, tm, jp, tp = _pair(weights, attn_impl=impl)
    toks, fe = _inputs(tm.cfg, 2, 16)
    jl, jrep = jm.logits(jp, {"tokens": jnp.asarray(toks),
                              "frontend": jnp.asarray(fe)})
    tl, trep = tm.logits(tp, {"tokens": to_torch(toks).long(),
                              "frontend": to_torch(fe)})
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode(weights, impl):
    """Prefill 16 tokens, decode 3: every step equals the reference's step
    and the full forward over 32 tokens (causality keeps the first 19 rows
    free of the rest); the cross K/V sit in the cross blocks' cache."""
    jm, tm, jp, tp = _pair(weights, attn_impl=impl)
    toks, fe = _inputs(tm.cfg, 2, 32, seed=1)
    full, _ = tm.logits(tp, {"tokens": to_torch(toks).long(),
                             "frontend": to_torch(fe)})
    jc = jm.init_cache(2, cache_len=24)
    tc = tm.init_cache(2, cache_len=24)
    assert isinstance(tc, VLMCache)
    jl, _, jc = jm.prefill(jp, jnp.asarray(toks[:, :16]), jc,
                           frontend=jnp.asarray(fe))
    tl, _, tc = tm.prefill(tp, to_torch(toks[:, :16]).long(), tc,
                           frontend=to_torch(fe))
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
        np.testing.assert_allclose(to_np(tl), to_np(full[:, pos]), rtol=0,
                                   atol=2e-5)
    cfg = tm.cfg
    ns, ce, a = cfg.num_layers // cfg.cross_attn_every, \
        cfg.cross_attn_every, cfg.attn
    assert tc.dense.k.shape == (ns, ce - 1, 2, a.num_kv_heads, 24,
                                a.head_dim)
    assert tc.cross_blk.ck.shape == (ns, 2, a.num_kv_heads,
                                     cfg.frontend_tokens, a.head_dim)
    np.testing.assert_allclose(to_np(tc.cross_blk.ck),
                               np.asarray(jc["cross_blk"]["attn"].ck),
                               rtol=0, atol=1e-5)
    assert tc.pos.tolist() == [19, 19]


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_generate_matches_reference(weights, impl):
    jm, tm, jp, tp = _pair(weights, attn_impl=impl)
    toks, fe = _inputs(tm.cfg, 2, 16, seed=2)
    jout, jrep = jgreedy(jm, jp, jnp.asarray(toks), steps=6,
                         frontend=jnp.asarray(fe))
    tout, trep = greedy_generate(tm, tp, to_torch(toks).long(), steps=6,
                                 frontend=to_torch(fe))
    np.testing.assert_array_equal(to_np(tout), np.asarray(jout))
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))


def test_frontend_that_does_not_divide_block_kv(weights):
    """40 frontend rows at block_kv 16: the fused kernel's divisibility
    rule refuses the cross-attention in both packages (the published
    config's 1,600 rows at 512 are the same case); plain EFTA pads the
    rows and agrees with the reference."""
    toks, fe = _inputs(get_config(ARCH), 1, 16, seed=3, m=40)
    for impl in IMPLS:
        jm, tm, jp, tp = _pair(weights, attn_impl=impl, frontend_tokens=40)
        jb = {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)}
        tb = {"tokens": to_torch(toks).long(), "frontend": to_torch(fe)}
        if impl == "efta_pallas":
            with pytest.raises(ValueError, match="must divide blocks"):
                jm.logits(jp, jb)
            with pytest.raises(ValueError, match="must divide blocks"):
                tm.logits(tp, tb)
        else:
            np.testing.assert_allclose(to_np(tm.logits(tp, tb)[0]),
                                       np.asarray(jm.logits(jp, jb)[0]),
                                       rtol=0, atol=1e-4)


def test_seu_strikes_the_dense_blocks_only(weights, monkeypatch):
    """An EXP SEU at prefill: the detection vectors equal the reference's,
    every dense block detects it, and no cross block's self-attention or
    cross-attention is handed the fault."""
    import repro_torch.models.attention as attn_mod
    jm, tm, jp, tp = _pair(weights)
    toks, fe = _inputs(tm.cfg, 2, 16, seed=4)
    f = dict(block=0, batch=1, head=1, row=9, col=3, bit=27)
    calls = []
    orig = attn_mod.attention_op

    def spy(*a, fault=None, **kw):
        calls.append(fault is not None)
        return orig(*a, fault=fault, **kw)
    monkeypatch.setattr(attn_mod, "attention_op", spy)
    jl, jrep, _ = jm.prefill(jp, jnp.asarray(toks),
                             jm.init_cache(2, cache_len=24),
                             fault=JFaultSpec.single(JSite.EXP, **f),
                             frontend=jnp.asarray(fe))
    tl, trep, _ = tm.prefill(tp, to_torch(toks).long(),
                             tm.init_cache(2, cache_len=24),
                             fault=FaultSpec.single(Site.EXP, **f),
                             frontend=to_torch(fe))
    cfg = tm.cfg
    ns = cfg.num_layers // cfg.cross_attn_every
    n_dense = ns * (cfg.cross_attn_every - 1)
    # per superblock: the dense blocks' self-attention (struck), the cross
    # block's self-attention and its cross-attention (not)
    assert calls == ([True] * (cfg.cross_attn_every - 1) + [False, False]
                     ) * ns
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))
    assert int(trep.detected.sum()) >= n_dense
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=1e-4)


def test_weight_conversion_carries_the_nested_stacks(weights):
    jp, tp = weights
    cfg = get_config(ARCH)
    ns, ce = cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every
    assert set(tp["blocks"]) == {"dense", "cross_blk"}
    assert tp["blocks"]["dense"]["attn"]["wq"].shape[:2] == (ns, ce - 1)
    assert {"norm_x", "cross"} <= set(tp["blocks"]["cross_blk"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(to_np(t), np.asarray(leaf))
    gen = torch.Generator().manual_seed(0)
    own = build_model(cfg, device="cpu").init(gen)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jp))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape


def test_cli_static_batch_route(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--max-prompt", "16", "--gen", "4", "--attn-impl",
                "efta_pallas"])
    out = capsys.readouterr().out      # the (requests, gen) token array
    assert len(re.findall(r"-?\d+", out)) == 2 * 4
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--paged"])
