"""Training in the port against the JAX package, on the CPU, at ``-smoke``
size (f32).

* ``Model.loss`` and its metrics equal the reference's for every arch, to
  1e-5 relative (with a ``loss_mask``).
* The loss's gradients equal ``jax.grad``'s per leaf, to 1e-5 of the
  leaf's largest, for gpt2, hymba, arctic and the VLM at ``remat`` "full"
  and "none" (and gpt2 at "dots").
* The train step's loss trajectory equals the reference's jitted
  ``make_train_step`` (20 steps), with microbatches 2, with bf16 moments
  and clipping active, and at gpt2's vocab, every loss to 1e-4 relative.
* ``warmup_cosine``, ``plan_mesh`` and the data batches equal the
  reference's; checkpoints round-trip (bf16 leaves, async), carry a train
  state across the packages both ways, and keep the reference's errors.
* ``pod_sync="int8_ef"`` draws the reference's bf16 zero residuals and,
  without a pod axis, steps as ``dense``; the distributed steps are held in
  ``tests/test_torch_distributed.py``.
* End to end: train, checkpoint, crash, resume, serve; the train CLI, and
  its ``--mesh pod`` raising RuntimeError in one process (too few ranks).
* ``efta_pallas`` under autograd raises in both packages; the serve entry
  points build no autograd graph.
"""
import dataclasses
import json
import socket
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_util import to_np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.data import make_pipeline as jpipeline  # noqa: E402
from repro.ft_runtime import checkpoint as jckpt  # noqa: E402
from repro.ft_runtime.elastic import plan_mesh as jplan_mesh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.utils.tree import tree_flatten_with_names as jnames  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import as_tensors, make_pipeline  # noqa: E402
from repro_torch.ft_runtime import (  # noqa: E402
    AsyncCheckpointer, latest_step, plan_mesh, restore, save)
from repro_torch.models import (build_model,  # noqa: E402
                                from_reference_params,
                                from_reference_train_state)
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.serve import ServeEngine, greedy_generate  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.utils import (global_norm,  # noqa: E402
                               tree_flatten_with_names, tree_leaves,
                               tree_map)

GRAD_ARCHS = ["gpt2-smoke", "hymba-1.5b-smoke", "arctic-480b-smoke",
              "llama-3.2-vision-11b-smoke"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _batch(arch, seed=0, b=2, s=16):
    """A pipeline batch of the arch (``frontend`` for vlm/audio), plus
    ``enc_tokens`` for t5 and a ``loss_mask`` with zeros; as (reference,
    port) dicts."""
    cfg = get_config(arch)
    nb = make_pipeline(cfg, global_batch=b, seq_len=s, seed=seed).batch(0)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        nb["enc_tokens"] = rng.integers(0, cfg.vocab_size, (b, 16)).astype(
            np.int32)
    nb["loss_mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            as_tensors(nb, "cpu"))


@pytest.mark.parametrize("arch", [a + "-smoke" for a in list_archs()])
def test_loss_matches_reference(weights, arch):
    jp, tp = weights(arch)
    jb, tb = _batch(arch)
    jloss, jm = jbuild(jget(arch)).loss(jp, jb)
    tloss, tm = build_model(get_config(arch), device="cpu").loss(tp, tb)
    assert set(tm) == set(jm) == {"loss", "ce", "z_loss", "aux",
                                  "ft_detected", "ft_corrected"}
    for k in ("loss", "ce", "z_loss", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in ("ft_detected", "ft_corrected"):
        np.testing.assert_array_equal(to_np(tm[k]), np.asarray(jm[k]))
    assert float(tloss) == float(tm["loss"])


@pytest.fixture(scope="module")
def ref_grads(weights):
    cache = {}

    def get(arch):
        if arch not in cache:
            jp, _ = weights(arch)
            jb, _ = _batch(arch, seed=1)
            jm = jbuild(jget(arch))
            g = jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
            cache[arch] = {n: np.asarray(x) for n, x in jnames(g)}
        return cache[arch]
    return get


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_grads_match_reference(weights, ref_grads, arch, remat):
    _check_grads(weights, ref_grads, arch, remat)


def test_grads_match_reference_remat_dots(weights, ref_grads):
    _check_grads(weights, ref_grads, "gpt2-smoke", "dots")


def _check_grads(weights, ref_grads, arch, remat):
    _, tp = weights(arch)
    _, tb = _batch(arch, seed=1)
    model = build_model(dataclasses.replace(get_config(arch), remat=remat),
                        device="cpu")
    _, _, grads = value_and_grad(model, tp, tb)
    ref = ref_grads(arch)
    got = dict(tree_flatten_with_names(grads))
    assert set(got) == set(ref)
    for name, g in got.items():
        r = ref[name]
        tol = 1e-5 * max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(to_np(g), r, rtol=0, atol=tol,
                                   err_msg=name)
    # the parameters passed in come out untouched and off the graph
    assert not any(p.requires_grad for p in tree_leaves(tp))


TRAJECTORIES = {
    "plain": dict(steps=20, microbatches=1, opt={}),
    # gpt2's vocab of 50,257 token ids: the packages stay on one trajectory
    # there too (at full width the pipeline's eval loss stays near ln V
    # for 100 steps on the card: PERF.md, Findings)
    "gpt2_vocab": dict(steps=6, microbatches=1, opt={}, vocab=50257),
    "microbatches2": dict(steps=6, microbatches=2, opt={}),
    "bf16_moments_clipped": dict(steps=8, microbatches=1,
                                 opt=dict(state_dtype="bfloat16",
                                          clip_norm=0.25)),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_trajectory_matches_reference(case):
    """The reference's jitted train step and the port's from the same
    state (the reference's, carried across) on the same batches: every
    step's loss within 1e-4 relative, the final parameters close."""
    c = TRAJECTORIES[case]
    arch, steps = "gpt2-smoke", c["steps"]
    vocab = {"vocab_size": c["vocab"]} if "vocab" in c else {}
    jm = jbuild(dataclasses.replace(jget(arch), **vocab))
    tm = build_model(dataclasses.replace(get_config(arch), **vocab),
                     device="cpu")
    jopt = JAdamW(lr=jwarmup_cosine(8e-3, warmup=5, total=steps), **c["opt"])
    topt = AdamW(lr=warmup_cosine(8e-3, warmup=5, total=steps), **c["opt"])
    js = jinit_state(jm, jopt, jax.random.PRNGKey(0))
    ts = from_reference_train_state(jax.tree.map(np.asarray, js), tm.cfg,
                                    device="cpu")
    jstep = jax.jit(jmake_train_step(jm, jopt,
                                     microbatches=c["microbatches"]))
    tstep = make_train_step(tm, topt, microbatches=c["microbatches"])
    data = make_pipeline(tm.cfg, global_batch=8, seq_len=32, seed=0)
    clipped = []
    for i in range(steps):
        nb = data.batch(i)
        if "clip_norm" in c["opt"]:
            _, _, g = value_and_grad(tm, ts.params, as_tensors(nb, "cpu"))
            clipped.append(float(global_norm(g)) > c["opt"]["clip_norm"])
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in nb.items()})
        ts, tmet = tstep(ts, as_tensors(nb, "cpu"))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    if "clip_norm" in c["opt"]:
        assert all(clipped)
        assert ts.opt.m["embed"]["table"].dtype == torch.bfloat16
    assert int(ts.step) == int(js.step) == steps
    assert int(ts.opt.count) == steps
    jflat = dict(jnames(js.params))
    for name, p in tree_flatten_with_names(ts.params):
        np.testing.assert_allclose(to_np(p), np.asarray(jflat[name]),
                                   rtol=0, atol=2e-4, err_msg=name)


def test_warmup_cosine_and_plan_mesh_match_reference():
    for kw in (dict(warmup=5, total=20), dict(warmup=100, total=10000,
                                               floor=0.05)):
        js, ts = jwarmup_cosine(3e-3, **kw), warmup_cosine(3e-3, **kw)
        for step in list(range(0, 25)) + [99, 100, 101, 5000, 9999, 10000,
                                           20000]:
            np.testing.assert_allclose(
                float(ts(torch.tensor(step, dtype=torch.int32))),
                float(js(jnp.int32(step))), rtol=1e-6, atol=1e-12)
    for n in (3, 16, 17, 256, 511, 512, 1024, 4096, 4100):
        for mp in (1, 4, 16):
            for pods in (True, False):
                assert plan_mesh(n, model_parallel=mp, prefer_pods=pods) == \
                    _as_port_plan(jplan_mesh(n, model_parallel=mp,
                                             prefer_pods=pods))


def _as_port_plan(p):
    from repro_torch.ft_runtime import MeshPlan
    return None if p is None else MeshPlan(p.shape, p.axes,
                                           p.dropped_devices, p.world)


@pytest.mark.parametrize("arch", ["gpt2-smoke", "llama-3.2-vision-11b-smoke",
                                  "whisper-base-smoke"])
def test_data_batches_are_bit_equal(arch):
    for seed in (0, 7):
        jd = jpipeline(jget(arch), global_batch=4, seq_len=24, seed=seed)
        td = make_pipeline(get_config(arch), global_batch=4, seq_len=24,
                           seed=seed)
        for step in (0, 1, 13, 10_000):
            a, b = jd.batch(step), td.batch(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        if get_config(arch).family in ("vlm", "audio"):
            assert "frontend" in b


def _state(seed=0, **opt):
    model = build_model(get_config("gpt2-smoke"), device="cpu")
    optimizer = AdamW(**opt)
    return model, optimizer, init_state(
        model, optimizer, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("how", ["sync", "async"])
def test_checkpoint_round_trip(tmp_path, how):
    """Every leaf back bit for bit, bf16 leaves (parameters and moments)
    included, through ``save`` and through ``AsyncCheckpointer``."""
    _, _, st = _state()
    st = st._replace(params=tree_map(lambda t: t.to(torch.bfloat16)
                                     if t.dim() >= 2 else t, st.params))
    st = st._replace(opt=st.opt._replace(
        m=tree_map(lambda t: torch.randn(t.shape).to(torch.bfloat16),
                   st.opt.m), count=torch.tensor(3, dtype=torch.int32)),
        step=torch.tensor(3, dtype=torch.int32))
    if how == "sync":
        save(tmp_path / "step_3", st, step=3, extra={"note": "x"})
    else:
        ck = AsyncCheckpointer()
        ck.save_async(tmp_path / "step_3", st, step=3, extra={"note": "x"})
        ck.wait()
    assert not (tmp_path / "step_3.tmp").exists()
    _, _, template = _state(seed=1)
    template = template._replace(params=tree_map(
        lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t,
        template.params), opt=template.opt._replace(m=tree_map(
            lambda t: t.to(torch.bfloat16), template.opt.m)))
    got, step, extra = restore(tmp_path / "step_3", template)
    assert step == 3 and extra == {"note": "x"}
    for (n, a), (_, b) in zip(tree_flatten_with_names(got),
                              tree_flatten_with_names(st)):
        assert a.dtype == b.dtype, n
        assert torch.equal(a, b), n
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["leaves"][".params/blocks/attn/wq"]["dtype"] == \
        "bfloat16"
    assert ".opt/.count" in manifest["leaves"] and ".step" in \
        manifest["leaves"]


def test_latest_step_and_shape_mismatch(tmp_path):
    model, opt, st = _state()
    assert latest_step(tmp_path / "none") is None
    assert latest_step(tmp_path) is None
    for step in (4, 12, 8):
        save(tmp_path / f"step_{step}", st, step=step)
    (tmp_path / "junk").mkdir()
    assert latest_step(tmp_path).name == "step_12"
    cfg = dataclasses.replace(get_config("gpt2-smoke"), d_ff=128)
    other = build_model(cfg, device="cpu")
    bad = init_state(other, opt, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore(tmp_path / "step_4", bad)
    # the reference raises the same on its own format
    jm = jbuild(dataclasses.replace(jget("gpt2-smoke"), d_ff=128))
    with pytest.raises(ValueError, match="checkpoint shape"):
        jckpt.restore(tmp_path / "step_4", jinit_state(
            jm, JAdamW(), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_training_across(tmp_path, direction):
    """Four steps in one package, a checkpoint, four more in the other:
    the losses stay on the trajectory of eight steps in the first."""
    arch, steps = "gpt2-smoke", 8
    jm, tm = jbuild(jget(arch)), build_model(get_config(arch), device="cpu")
    jopt = JAdamW(lr=jwarmup_cosine(8e-3, warmup=2, total=steps))
    topt = AdamW(lr=warmup_cosine(8e-3, warmup=2, total=steps))
    jstep = jax.jit(jmake_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    data = make_pipeline(tm.cfg, global_batch=8, seq_len=32, seed=3)

    def jb(i):
        return {k: jnp.asarray(v) for k, v in data.batch(i).items()}
    js = jinit_state(jm, jopt, jax.random.PRNGKey(1))
    ref = []
    j_run = js
    for i in range(steps):
        j_run, m = jstep(j_run, jb(i))
        ref.append(float(m["loss"]))
    ts0 = from_reference_train_state(jax.tree.map(np.asarray, js), tm.cfg,
                                     device="cpu")
    got = []
    if direction == "jax_to_port":
        for i in range(4):
            js, m = jstep(js, jb(i))
            got.append(float(m["loss"]))
        jckpt.save(tmp_path / "step_4", js, step=4)
        ts, step, _ = restore(latest_step(tmp_path), ts0)
        for i in range(step, steps):
            ts, m = tstep(ts, as_tensors(data.batch(i), "cpu"))
            got.append(float(m["loss"]))
    else:
        ts = ts0
        for i in range(4):
            ts, m = tstep(ts, as_tensors(data.batch(i), "cpu"))
            got.append(float(m["loss"]))
        save(tmp_path / "step_4", ts, step=4)
        js, step, _ = jckpt.restore(jckpt.latest_step(tmp_path), js)
        for i in range(step, steps):
            js, m = jstep(js, jb(i))
            got.append(float(m["loss"]))
    assert step == 4
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_train_checkpoint_crash_resume_serve(tmp_path):
    """The port's counterpart of the JAX package's end-to-end system test:
    train 6 steps with a checkpoint after 4, "crash", restore into a fresh
    state, replay steps 4-5 (the data is a function of the step): the
    next step's loss is the first run's to rtol 1e-5; then serve from the
    trained parameters, greedy and through the ring engine."""
    model, opt, st = _state()
    step_fn = make_train_step(model, opt)
    data = make_pipeline(model.cfg, global_batch=4, seq_len=32, seed=1)
    for i in range(6):
        st, _ = step_fn(st, as_tensors(data.batch(i), "cpu"))
        if i == 3:
            save(tmp_path / "step_4", st, step=4)
    b6 = as_tensors(data.batch(6), "cpu")
    _, m_a = step_fn(st, b6)
    _, _, template = _state()
    st_b, step0, _ = restore(latest_step(tmp_path), template)
    assert step0 == 4 and int(st_b.step) == 4
    for i in range(4, 6):
        st_b, _ = step_fn(st_b, as_tensors(data.batch(i), "cpu"))
    _, m_b = step_fn(st_b, b6)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-5)
    prompt = torch.ones((2, 8), dtype=torch.long)
    out, rep = greedy_generate(model, st_b.params, prompt, steps=4)
    assert out.shape == (2, 4)
    assert bool(((out >= 0) & (out < model.cfg.vocab_size)).all())
    eng = ServeEngine(model, st_b.params, n_slots=2, cache_len=32)
    for r in range(2):
        eng.submit(np.ones((8,), np.int32), max_new_tokens=4)
    outs = eng.run()
    for rid in outs:
        np.testing.assert_array_equal(np.asarray(outs[rid]),
                                      to_np(out[0]))


def test_efta_pallas_under_autograd_raises(weights):
    """Both packages' fused kernels are forward only: a gradient through
    ``efta_pallas`` raises NotImplementedError (the port's plain version
    on the CPU included); without gradients it runs."""
    arch = "gpt2-smoke"
    jp, tp = weights(arch)
    jb, tb = _batch(arch)

    def pallas(cfg):
        return dataclasses.replace(cfg, ft=dataclasses.replace(
            cfg.ft, attn_impl="efta_pallas"))
    jm = jbuild(pallas(jget(arch)))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
    tm = build_model(pallas(get_config(arch)), device="cpu")
    with pytest.raises(NotImplementedError, match="efta_pallas"):
        value_and_grad(tm, tp, tb)
    loss, _ = tm.loss(tp, tb)                 # no gradient asked: runs
    np.testing.assert_allclose(float(loss), float(jm.loss(jp, jb)[0]),
                               rtol=1e-5)


def test_serving_builds_no_graph(weights):
    """With parameters that require gradients, the serve entry points
    (prefill, decode_step, score, extend, greedy_generate and the engine's
    step) return tensors off the autograd graph; the loss does not."""
    _, tp = weights("gpt2-smoke")
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    model = build_model(get_config("gpt2-smoke"), device="cpu")
    toks = torch.randint(0, 128, (2, 8))
    cache = model.init_cache(2, cache_len=16)
    logits, _, cache = model.prefill(live, toks, cache)
    outs = [logits]
    for fn in (model.decode_step, model.score, model.extend):
        lg, _, cache = fn(live, toks[:, :1], cache)
        outs.append(lg)
    gen, _ = greedy_generate(model, live, toks, steps=2)
    eng = ServeEngine(model, live, n_slots=2, cache_len=16)
    eng.submit(np.ones((4,), np.int32), max_new_tokens=2)
    eng.run()
    assert all(not t.requires_grad and t.grad_fn is None for t in outs)
    assert not cache.k.requires_grad
    loss, _ = model.loss(live, {"tokens": toks, "targets": toks})
    assert loss.requires_grad


def test_pod_sync_int8_ef_without_pods_is_dense():
    """``int8_ef`` draws the reference's bf16 zero residuals and, without a
    pod axis of size above 1, steps as ``dense`` does (the reference's
    condition); an unknown sync raises."""
    model, opt, st = _state()
    ef_state = init_state(model, opt, torch.Generator().manual_seed(0),
                          pod_sync="int8_ef")
    jst = jinit_state(jbuild(jget("gpt2-smoke")), JAdamW(),
                      jax.random.PRNGKey(0), pod_sync="int8_ef")
    jef = dict(jnames(jst.ef))
    for name, e in tree_flatten_with_names(ef_state.ef):
        assert e.dtype == torch.bfloat16 and not e.any()
        assert tuple(e.shape) == jef[name].shape
        assert jef[name].dtype == jnp.bfloat16
    batch = as_tensors(make_pipeline(get_config("gpt2-smoke"),
                                     global_batch=2, seq_len=16,
                                     seed=0).batch(0), "cpu")
    dense, _ = make_train_step(model, opt)(st, batch)
    ef, _ = make_train_step(model, opt, pod_sync="int8_ef")(ef_state, batch)
    for (n, a), (_, b) in zip(tree_flatten_with_names(dense._replace(ef=None)),
                              tree_flatten_with_names(ef._replace(ef=None))):
        assert torch.equal(a, b), n
    assert ef.ef is ef_state.ef
    with pytest.raises(ValueError, match="pod_sync"):
        make_train_step(model, opt, pod_sync="int4")


def test_cli_train(tmp_path, caplog, monkeypatch):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    st, metrics = train.main(["--arch", "gpt2-smoke", "--device", "cpu",
                              "--steps", "3", "--batch", "4", "--seq", "16",
                              "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert int(st.step) == 3 and np.isfinite(float(metrics["loss"]))
    assert latest_step(ck).name == "step_2"
    st, _ = train.main(["--arch", "gpt2-smoke", "--device", "cpu",
                        "--steps", "4", "--batch", "4", "--seq", "16",
                        "--ckpt-dir", ck, "--ckpt-every", "2", "--resume"])
    assert int(st.step) == 4 and latest_step(ck).name == "step_4"
    # --mesh pod in one process: the group forms, the 16 x 16 mesh does not
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
        train.main(["--device", "cpu", "--mesh", "pod"])
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        # the entry point runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--steps", "1"])
