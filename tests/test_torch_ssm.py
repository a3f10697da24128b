"""The ``ssm`` (rwkv6) and ``hybrid`` (hymba: attention and mamba heads in
parallel) families of the port against the JAX package, on the CPU, with
the reference's weights carried across by ``from_reference_params``.

* ``mamba_apply``, ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` against the
  reference's, over a whole sequence and token by token with the states
  carried (f32 within 1e-5, states too). The reference's init leaves
  ``conv_b``, ``dt_bias`` and ``w_lora_b`` at zero; here they are drawn at
  random, so their terms count.
* ``Model.logits``, prefill plus 3 decode steps and ``greedy_generate`` of
  ``rwkv6-7b-smoke`` and ``hymba-1.5b-smoke`` (under ``efta``: the
  reference's fused contiguous kernel cannot run windowed layers) against
  the reference: f32 within 1e-5, tokens identical, and prefill plus decode
  equal to the full forward.
* hymba's per-layer flags: full attention at the first, middle and last
  layers only.
* The CLI serves both families through the static-batch route on
  ``--device cpu`` and refuses ``--paged`` for them.
"""
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import layer_flags as j_layer_flags  # noqa: E402
from repro.serve import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import layer_flags  # noqa: E402
from repro_torch.serve import greedy_generate  # noqa: E402

ARCHS = ["rwkv6-7b-smoke", "hymba-1.5b-smoke"]
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jp = jbuild(jget(arch)).init(jax.random.PRNGKey(0))
        tp = from_reference_params(jax.tree.map(np.asarray, jp),
                                   get_config(arch), device="cpu")
        out[arch] = (jp, tp)
    return out


def _layer0(tree, perturb, seed):
    """Layer 0 of a stacked reference subtree as numpy, with the leaves in
    ``perturb`` redrawn from N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v[0], np.float32)
        if k in perturb:
            a = (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: to_torch(v) for k, v in out.items()})


def _close_states(t_state, j_state):
    for a, b in zip(t_state, j_state):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)


def test_mamba_apply_matches_reference_whole_and_stepwise(weights):
    arch = "hymba-1.5b-smoke"
    cfg = get_config(arch)
    jp, _ = weights[arch]
    jpar, tpar = _layer0(jp["blocks"]["mamba"], ("conv_b", "dt_bias"), 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jy, jst = jssm.mamba_apply(jpar, jnp.asarray(x), jget(arch).ssm)
    ty, tst = tssm.mamba_apply(tpar, to_torch(x), cfg.ssm)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
    _close_states(tst, jst)
    # token by token from a zero state: the same outputs and final state
    jst = jssm.mamba_state_init(2, cfg.d_model, jget(arch).ssm, jnp.float32)
    tst = tssm.mamba_state_init(2, cfg.d_model, cfg.ssm, torch.float32,
                                "cpu")
    for t in range(x.shape[1]):
        jy_t, jst = jssm.mamba_apply(jpar, jnp.asarray(x[:, t:t + 1]),
                                     jget(arch).ssm, state=jst)
        ty_t, tst = tssm.mamba_apply(tpar, to_torch(x[:, t:t + 1]), cfg.ssm,
                                     state=tst)
        np.testing.assert_allclose(to_np(ty_t), np.asarray(jy_t), **TOL)
        np.testing.assert_allclose(to_np(ty_t[:, 0]), to_np(ty[:, t]),
                                   **TOL)
        _close_states(tst, jst)


def test_rwkv6_mixes_match_reference_whole_and_stepwise(weights):
    arch = "rwkv6-7b-smoke"
    cfg = get_config(arch)
    scfg, jscfg = cfg.ssm, jget(arch).ssm
    jp, _ = weights[arch]
    jpar, tpar = _layer0(jp["blocks"]["time_mix"], ("w_lora_b",), 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)

    def both(xs, jst, tst):
        jy, jst = jssm.rwkv6_time_mix(jpar, jnp.asarray(xs), jscfg,
                                      state=jst)
        ty, tst = tssm.rwkv6_time_mix(tpar, to_torch(xs), scfg, state=tst)
        np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
        jc, jst = jssm.rwkv6_channel_mix(jpar, jnp.asarray(xs), state=jst)
        tc, tst = tssm.rwkv6_channel_mix(tpar, to_torch(xs), state=tst)
        np.testing.assert_allclose(to_np(tc), np.asarray(jc), **TOL)
        _close_states(tst, jst)
        return ty, tc, jst, tst

    def zero():
        return (jssm.rwkv_state_init(2, cfg.d_model, jscfg, jnp.float32),
                tssm.rwkv_state_init(2, cfg.d_model, scfg, torch.float32,
                                     "cpu"))

    ty, tc, _, _ = both(x, *zero())
    jst, tst = zero()
    for t in range(x.shape[1]):
        ty_t, tc_t, jst, tst = both(x[:, t:t + 1], jst, tst)
        np.testing.assert_allclose(to_np(ty_t[:, 0]), to_np(ty[:, t]), **TOL)
        np.testing.assert_allclose(to_np(tc_t[:, 0]), to_np(tc[:, t]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_decode_match_reference(weights, arch):
    jp, tp = weights[arch]
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    tl, trep = tm.logits(tp, {"tokens": to_torch(toks).long()})
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    assert int(trep.detected.sum()) == 0
    jc, tc = jm.init_cache(2, cache_len=24), tm.init_cache(2, cache_len=24)
    jlog, _, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tlog, _, tc = tm.prefill(tp, to_torch(toks).long(), tc)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), **TOL)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    seq = np.concatenate([toks, tok], axis=1)
    for _ in range(3):
        jlog, _, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tlog, trep, tc = tm.decode_step(tp, to_torch(tok).long(), tc)
        np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), **TOL)
        assert int(trep.detected.sum()) == 0
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
        seq = np.concatenate([seq, tok], axis=1)
    # the carried states: prefill plus decode equal the full forward
    full, _ = tm.logits(tp, {"tokens": to_torch(seq[:, :-1]).long()})
    np.testing.assert_allclose(to_np(tlog), to_np(full[:, -1]), **TOL)
    if arch.startswith("hymba"):
        assert tc.pos.tolist() == [19, 19]
        _close_states(tc.mamba, jc["mamba"])
    else:
        _close_states(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(weights, arch):
    jp, tp = weights[arch]
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="cpu")
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (3, 12)).astype(np.int32)
    want, _ = jgreedy(jm, jp, jnp.asarray(toks), steps=8)
    got, rep = greedy_generate(tm, tp, to_torch(toks).long(), steps=8)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert int(rep.detected.sum()) == 0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "hymba-1.5b-smoke"])
def test_hybrid_full_attention_at_first_middle_last(arch):
    flags = layer_flags(get_config(arch))
    ref = j_layer_flags(jget(arch))
    n = get_config(arch).num_layers
    assert np.flatnonzero(flags["is_global"]).tolist() == sorted(
        {0, n // 2, n - 1})
    for k in ("is_global", "theta"):
        np.testing.assert_array_equal(flags[k], ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_static_batch_route(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--max-prompt", "8", "--gen", "4"])
    out = capsys.readouterr().out      # the (requests, gen) token array
    assert len(re.findall(r"-?\d+", out)) == 2 * 4
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu", "--paged"])
