"""The ring-cache serving slice against the JAX package, on the CPU.

* ``Model.logits`` / ``prefill`` / ``decode_step`` of the port against the
  reference's (``fault=None``) on ``gpt2-smoke`` and ``gemma3-1b-smoke``,
  with ``attn_impl`` ``efta_pallas`` (the fused kernel's plain version on
  the CPU) and ``efta``, within 1e-4. The reference cannot run
  ``gemma3-1b-smoke`` through its Pallas kernel (its per-layer window is a
  traced value the kernel captures; ROADMAP.md, Queue C), so there the
  port's ``efta_pallas`` is held against the reference's ``efta``, which
  computes the same function.
* The port's ring ``ServeEngine`` on ``efta_pallas`` emits the JAX ring
  engine's greedy tokens (``attn_impl="efta"``: the reference's Pallas
  route crashes at admission) and, per request, the port's own
  ``greedy_generate`` at prompt lengths the kernel takes.
* A decode SEU in one slot, in detect mode, is retried: the tokens do not
  change, and only the struck request's detection counts move.
* ``Model.prefill`` under a kernel SEU at each compute site, in correct
  mode, against the reference's under the equivalent descriptor; the
  shadow-corrected sites give the clean logits bit for bit.
"""
import dataclasses
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
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.kernels.efta_attention import fault_descriptor  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa: E402
from repro_torch.serve import (ServeEngine, batch_faults,  # noqa: E402
                               greedy_generate)


def _with(cfg, **ft):
    return dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, **ft))


@pytest.fixture(scope="module")
def weights():
    """Reference parameters per arch, drawn once, with their port copy."""
    out = {}
    for arch in ("gpt2-smoke", "gemma3-1b-smoke"):
        jp = jbuild(jget(arch)).init(jax.random.PRNGKey(0))
        tp = from_reference_params(jax.tree.map(np.asarray, jp),
                                   get_config(arch), device="cpu")
        out[arch] = (jp, tp)
    return out


def _pair(weights, arch, impl, ref_impl=None, mode="correct"):
    jm = jbuild(_with(jget(arch), attn_impl=ref_impl or impl, mode=mode))
    tm = build_model(_with(get_config(arch), attn_impl=impl, mode=mode),
                     device="cpu")
    jp, tp = weights[arch]
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch,impl,ref_impl", [
    ("gpt2-smoke", "efta_pallas", "efta_pallas"),
    ("gpt2-smoke", "efta", "efta"),
    ("gemma3-1b-smoke", "efta_pallas", "efta"),
    ("gemma3-1b-smoke", "efta", "efta"),
])
def test_model_prefill_decode_logits_match_reference(weights, arch, impl,
                                                     ref_impl):
    jm, jp, tm, tp = _pair(weights, arch, impl, ref_impl)
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jrep = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    tl, trep = tm.logits(tp, {"tokens": to_torch(toks).long()})
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(to_np(trep.detected).sum(0),
                                  np.asarray(jrep.detected))

    jc = jm.init_cache(2, cache_len=24)
    tc = tm.init_cache(2, cache_len=24)
    jlog, _, jc = jm.prefill(jp, jnp.asarray(toks), jc,
                             lengths=jnp.asarray([16, 11]))
    tlog, _, tc = tm.prefill(tp, to_torch(toks).long(), tc, lengths=[16, 11])
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for _ in range(10):                     # 16 + 10 > 24: the ring wraps
        jlog, jrep, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tlog, trep, tc = tm.decode_step(tp, to_torch(tok).long(), tc)
        np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-4,
                                   rtol=0)
        assert int(trep.detected.sum()) == 0
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    assert tc.pos.tolist() == [26, 26]


def test_reference_pallas_route_cannot_run_windowed_layers(weights):
    jm, jp, _, _ = _pair(weights, "gemma3-1b-smoke", "efta_pallas")
    with pytest.raises(ValueError, match="captures constants"):
        jm.logits(jp, {"tokens": jnp.zeros((1, 16), jnp.int32)})


PROMPT_LENS = [5, 16, 9, 12, 3, 32, 7]


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _run(engine, prompts, n_new, faults=None):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    return engine.run(faults)


def test_ring_engine_matches_reference_engine_and_greedy(weights):
    jm, jp, tm, tp = _pair(weights, "gpt2-smoke", "efta_pallas",
                           ref_impl="efta")
    prompts = _prompts(tm.cfg.vocab_size)
    want = _run(JServeEngine(jm, jp, n_slots=3, cache_len=48), prompts, 7)
    eng = ServeEngine(tm, tp, n_slots=3, cache_len=48)
    got = _run(eng, prompts, 7)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert eng.telemetry.summary()["detected"] == 0
    assert eng.stats.prefill_forwards == len(prompts)
    # the oracle prefills unpadded prompts: lengths the kernel takes
    # (block_kv = min(16, S) must divide S and hold one stride of 4)
    for rid, p in enumerate(prompts):
        if len(p) < 4 or (len(p) > 16 and len(p) % 16):
            continue
        toks, rep = greedy_generate(tm, tp, to_torch(p)[None].long(),
                                    steps=7, cache_len=48)
        np.testing.assert_array_equal(to_np(toks[0]), got[rid])
        assert int(rep.detected.sum()) == 0


def test_ring_engine_retries_a_decode_seu_in_one_slot(weights):
    _, _, tm, tp = _pair(weights, "gpt2-smoke", "efta_pallas",
                         mode="detect")
    prompts = _prompts(tm.cfg.vocab_size)
    clean = _run(ServeEngine(tm, tp, n_slots=3, cache_len=48), prompts, 7)
    eng = ServeEngine(tm, tp, n_slots=3, cache_len=48)
    # step 3: every slot decodes; the SEU strikes slot 1 only (row-relative
    # coordinates: head 2, query row 0, in KV block 0 of every layer)
    spec = FaultSpec.single(Site.EXP, block=0, head=2, row=0, col=1, bit=27)
    got = _run(eng, prompts, 7, {3: batch_faults(3, {1: spec})})
    for rid in clean:
        np.testing.assert_array_equal(got[rid], clean[rid])
    assert eng.stats.retries == 1
    struck = [rid for rid, st in eng.telemetry.requests.items()
              if sum(st.detected)]
    assert len(struck) == 1
    st = eng.telemetry.requests[struck[0]]
    assert st.detected[1] == tm.cfg.num_layers      # exp, in every layer
    assert sum(st.detected) == st.detected[1]
    assert sum(st.corrected) == 0                   # detect mode


@pytest.mark.parametrize("site", [Site.GEMM1, Site.ROWMAX, Site.EXP,
                                  Site.ROWSUM, Site.GEMM2])
def test_prefill_kernel_seu_matches_reference(weights, site):
    """The port's prefill takes the SEU as a FaultSpec; the reference's
    Pallas route takes only the kernel's int32[8] descriptor, so it gets
    the equivalent one. Rowmax, EXP and rowsum SEUs are undone exactly
    (shadows and the EXP recompute): the clean logits, bit for bit. GEMM
    SEUs are undone by checksum arithmetic, within its rounding (a top-bit
    flip of a score below 1 is clipped to 1e6 first, so the restored score
    carries an error of order ulp(1e6)), as in the reference."""
    jm, jp, tm, tp = _pair(weights, "gpt2-smoke", "efta_pallas")
    p = _prompts(tm.cfg.vocab_size)[5]                          # 32 tokens
    toks = to_torch(p)[None].long()
    clean, rep0, _ = tm.prefill(tp, toks, tm.init_cache(1, cache_len=48))
    spec = FaultSpec.single(site, block=1, head=1, row=31, col=3, bit=30)
    got, rep, _ = tm.prefill(tp, toks, tm.init_cache(1, cache_len=48),
                             fault=spec)
    desc = fault_descriptor(spec, tm.cfg.attn.num_heads)
    want, jrep, _ = jm.prefill(jp, jnp.asarray(p)[None],
                               jm.init_cache(1, cache_len=48),
                               fault=jnp.asarray(desc))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(to_np(rep.detected).sum(0),
                                  np.asarray(jrep.detected))
    assert int(rep0.detected.sum()) == 0
    assert int(rep.detected.sum()) >= 1
    if site in (Site.ROWMAX, Site.EXP, Site.ROWSUM):
        assert torch.equal(got, clean)


def test_launch_serve_cli_ring_engine_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "gpt2-smoke", "--attn-impl", "efta_pallas",
          "--device", "cpu", "--requests", "3", "--slots", "2", "--gen", "4",
          "--inject-faults", "1", "--ft-mode", "detect"])
    out = capsys.readouterr().out
    assert out.strip().startswith("{0: [")
