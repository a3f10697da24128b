"""Fault campaigns through the port's speculative paths on ``gpt2-smoke``,
against the JAX package's engine under the same SEUs: a detect-mode compute
SEU on the target's scoring pass, one on the draft model's pass (through
``fault_next``), a resident flip between the scoring step and the KV
rollback (through ``_pre_rollback_hook``), and a resident flip read by a
speculative step. On both backends the port must detect what the JAX
engine detects — per-request detection vectors, retries and
``paged_stats`` equal — and emit the clean run's tokens: zero silent
corruptions.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import FaultSpec as JFaultSpec  # noqa: E402
from repro.core import Site as JSite  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import batch_faults as jbatch_faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fault import FaultSpec, Site  # noqa: E402
from repro_torch.models import build_model, from_reference_params  # noqa
from repro_torch.serve import PagedServeEngine, batch_faults  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_mode(cfg, mode):
    return dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, mode=mode))


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("gpt2-smoke")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jcold = jbuild(jcfg).init(jax.random.PRNGKey(7))
    cfg = get_config("gpt2-smoke")
    tp = from_reference_params(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    tcold = from_reference_params(jax.tree.map(np.asarray, jcold), cfg,
                                  device="cpu")
    rng = np.random.default_rng(0)
    prompts = []
    for i, t in enumerate((6, 17, 21)):
        if i % 2 == 0:
            pat = rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32)
            prompts.append(np.tile(pat, -(-t // 3))[:t])
        else:
            prompts.append(rng.integers(0, cfg.vocab_size,
                                        (t,)).astype(np.int32))
    models = {}
    for mode in ("correct", "detect"):
        models[mode] = (jbuild(_with_mode(jcfg, mode)),
                        build_model(_with_mode(cfg, mode), device="cpu"))
    return dict(jp=jp, jcold=jcold, tp=tp, tcold=tcold, prompts=prompts,
                models=models)


def _pair(s, kernel, *, mode="correct", draft="self", draft_len=3):
    """The JAX engine and the port's, on the same weights and settings."""
    jm, tm = s["models"][mode]
    out = []
    for cls, m, p, cold in ((JPagedServeEngine, jm, s["jp"], s["jcold"]),
                            (PagedServeEngine, tm, s["tp"], s["tcold"])):
        out.append(cls(m, p, n_slots=2, cache_len=64, block_size=16,
                       chunk_size=16, kernel=kernel, speculate="draft",
                       draft_len=draft_len, draft_model=m,
                       draft_params=p if draft == "self" else cold))
    return out


def _drive(eng, prompts, gen, faults=None, before_step=None):
    rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    i = 0
    while eng.scheduler.has_work:
        if before_step is not None:
            before_step(eng, i)
        eng.step(faults=(faults or {}).get(i))
        i += 1
    outs = {r.rid: [int(t) for t in r.generated]
            for r in eng.scheduler.finished}
    return [outs[r] for r in rids]


def _telemetry(eng):
    return {rid: dataclasses.asdict(st)
            for rid, st in sorted(eng.telemetry.requests.items())}


def _assert_same_detections(eng, jeng):
    assert _telemetry(eng) == _telemetry(jeng)
    assert dataclasses.asdict(eng.paged_stats) == \
        dataclasses.asdict(jeng.paged_stats)
    assert eng.stats.retries == jeng.stats.retries


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_target_pass_seu_during_speculation(setup, kernel):
    """A detect-mode GEMM2 SEU on the scoring pass of the first steps:
    detected, retried clean (nothing re-detected), tokens of the clean
    run."""
    s = setup
    _, clean = _pair(s, kernel, mode="detect")
    ref = _drive(clean, s["prompts"][:2], 6)
    jeng, eng = _pair(s, kernel, mode="detect")
    f = dict(block=0, batch=0, head=1, row=0, col=3, bit=28)
    faults = {i: batch_faults(2, {0: FaultSpec.single(Site.GEMM2, **f),
                                  1: FaultSpec.single(Site.GEMM2, **f)})
              for i in (0, 1, 2)}
    jfaults = {i: jbatch_faults(2, {0: JFaultSpec.single(JSite.GEMM2, **f),
                                    1: JFaultSpec.single(JSite.GEMM2, **f)})
               for i in (0, 1, 2)}
    assert _drive(eng, s["prompts"][:2], 6, faults) == ref
    assert _drive(jeng, s["prompts"][:2], 6, jfaults) == ref
    assert eng.stats.retries >= 1
    hit = [st for st in eng.telemetry.requests.values()
           if sum(st.detected[:5])]
    assert hit and all(sum(st.redetected) == 0 and st.retries >= 1
                       for st in hit)
    assert eng.paged_stats.spec_steps > 0
    _assert_same_detections(eng, jeng)


def test_draft_pass_seu_detected_and_harmless(setup):
    """A detect-mode SEU in the draft model's forward: the draft's own EFTA
    check detects it, the proposal retries clean, tokens are unchanged."""
    s = setup
    _, clean = _pair(s, "fused", mode="detect")
    ref = _drive(clean, s["prompts"][:2], 6)

    def strike(fault_cls, site):
        def hook(eng, i):
            if eng.stats.steps == 2 and not hook.fired:
                eng._proposer.fault_next = fault_cls.single(
                    site, block=0, batch=0, head=1, row=0, col=2, bit=28)
                hook.fired = True
        hook.fired = False
        return hook

    jeng, eng = _pair(s, "fused", mode="detect")
    assert _drive(eng, s["prompts"][:2], 6,
                  before_step=strike(FaultSpec, Site.GEMM1)) == ref
    assert _drive(jeng, s["prompts"][:2], 6,
                  before_step=strike(JFaultSpec, JSite.GEMM1)) == ref
    assert eng._proposer.stats.detected >= 1
    assert eng._proposer.stats.retries >= 1
    assert dataclasses.asdict(eng._proposer.stats) == \
        dataclasses.asdict(jeng._proposer.stats)
    hit = [st for st in eng.telemetry.requests.values()
           if sum(st.draft_detected[:5])]
    assert hit and all(st.draft_retries >= 1 for st in hit)
    _assert_same_detections(eng, jeng)


def _mid_rollback_strike(e):
    """Flip a committed row of the slot's tail block after the scoring step
    committed and before the rollback restamps it."""
    if e._struck:
        return
    req = [r for r in e.scheduler.active_rows() if not r.is_done()][0]
    pos = int(e._pos[req.slot])          # already rewound to keep_pos
    j = pos // e.block_size
    if j < len(req.block_ids) and pos % e.block_size > 0:
        e.inject_kv_fault(layer=0, block=req.block_ids[j], head=0,
                          row=(pos % e.block_size) - 1, col=2, bit=27,
                          into="k")
        e._struck = True


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_mid_rollback_corruption_is_never_laundered(setup, kernel):
    """A resident flip between the scoring step's verify and the rollback's
    restamp is caught by the rollback's pre-restamp verify and repaired;
    the tokens are the plain engine's."""
    s = setup
    _, tm = s["models"]["correct"]
    plain = PagedServeEngine(tm, s["tp"], n_slots=2, cache_len=64,
                             block_size=16, chunk_size=16, kernel=kernel)
    ref = _drive(plain, [s["prompts"][1]], 8)
    jeng, eng = _pair(s, kernel, draft="cold", draft_len=4)
    for e in (jeng, eng):
        e._struck = False
        e._pre_rollback_hook = _mid_rollback_strike
    assert _drive(eng, [s["prompts"][1]], 8) == ref
    assert _drive(jeng, [s["prompts"][1]], 8) == ref
    assert eng._struck
    assert eng.paged_stats.rollback_detected_blocks >= 1
    assert eng.paged_stats.kv_repaired_blocks >= 1
    _assert_same_detections(eng, jeng)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_resident_kv_seu_during_speculation(setup, kernel):
    """A resident flip in a live block while the engine speculates: caught
    at read time by the scoring step, repaired, token-identical."""
    s = setup
    _, clean = _pair(s, kernel)
    ref = _drive(clean, [s["prompts"][1]], 16)

    def flip(eng, i):
        if i == 2:
            req = next(r for r in eng.scheduler.active_rows())
            assert not req.is_done()
            eng.inject_kv_fault(layer=1, block=req.block_ids[0], head=0,
                                row=3, col=5, bit=27, into="v")

    jeng, eng = _pair(s, kernel)
    assert _drive(eng, [s["prompts"][1]], 16, before_step=flip) == ref
    assert _drive(jeng, [s["prompts"][1]], 16, before_step=flip) == ref
    assert eng.paged_stats.kv_detected_blocks >= 1
    assert eng.paged_stats.kv_repaired_blocks >= 1
    _assert_same_detections(eng, jeng)
