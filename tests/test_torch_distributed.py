"""The port's distributed training against the JAX package's, on the CPU.

The reference runs in one subprocess with 4 forced host devices (as
``tests/test_distributed.py`` runs it); the port runs on 4 gloo ranks
(``tests/_torch_dist.py``) at the same time. Both start from the same
reference-initialised states, written as reference checkpoints, and take
the same batches.

* ``spec_for_param``, ``param_shardings`` and ``cache_shardings`` give the
  reference's specs on every leaf of all 14 smoke archs, on meshes (2, 2),
  (2, 2, 2) and (16, 16) (the reference on an ``AbstractMesh``).
* ``quantize_int8`` equals the reference bit for bit; ``compressed_psum``
  over 4 ranks equals the reference's ``shard_map`` over 4 devices: the
  mean and ``new_err`` bit for bit.
* Two train steps: gpt2-smoke on (pod 2, data 2) under ``dense`` with an
  uneven ``loss_mask`` and under ``int8_ef``; arctic-smoke on (pod 2, model
  2) under ``dense`` with expert parallelism. Losses to 1e-5 relative;
  parameters and moments element by element to 1e-5 of the leaf's largest
  value, or to ``ADAM_SLACK`` where f32 reduction order may flip the sign
  of a gradient that cancels (see the constant). The reference's
  ``int8_ef`` step cannot place activations inside its own ``shard_map``
  on this jax (``shard_act`` raises on manual axes), so its subprocess
  runs that step with ``shard_act`` an identity: a placement, no value.
  Replicated blocks are bit-equal across ranks after every step.
* ``_moe_inference_ep`` on (data 2, model 2), decode, capacity factor 0.5
  (tokens dropped): y within 1e-6 of max|y|, aux to 1e-6 relative, the
  same drops.
* Checkpoints: the reference's initial states restore onto the meshes;
  the final dense state, written from (pod 2, data 2), restores on (data
  2, model 2), in one process of the port and in the reference, bit for
  bit.
* ``build_mesh`` and the mesh's groups.
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_dist import REPO, launch  # noqa: E402
from _torch_util import to_np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.distributed.collectives import quantize_int8 as jquantize  # noqa: E402,E501
from repro.ft_runtime import checkpoint as jckpt  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.moe import moe_init as jmoe_init  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.utils.tree import tree_flatten_with_names as jnames  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.collectives import quantize_int8  # noqa: E402
from repro_torch.ft_runtime import restore  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import init_state  # noqa: E402
from repro_torch.utils import tree_flatten_with_names  # noqa: E402

ARCHS = [a + "-smoke" for a in list_archs()]
MESHES = [((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model"))]
LR = 1e-3
# An AdamW step moves a weight by at most lr (1 + weight_decay |p|) / (1 -
# b1) in the worst case and by about lr where m / sqrt(v) is +-1: a gradient
# element that f32 reduction order leaves with either sign can end a step
# 2 lr apart. Two steps: 4 lr.
ADAM_SLACK = 4 * LR


class _ShapeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


# ---------------------------------------------------------------------------
# specs: no ranks needed
# ---------------------------------------------------------------------------

def _norm(pspec, nd):
    """A spec (a reference PartitionSpec or the port's tuple) as ``nd``
    entries, a one-axis tuple as its axis."""
    spec = tuple(pspec) + (None,) * (nd - len(tuple(pspec)))
    return tuple((a[0] if len(a) == 1 else tuple(a))
                 if isinstance(a, (tuple, list)) else a for a in spec)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shape, axes):
    jshapes = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    jleaves = dict(jnames(jshapes))
    jspecs = {n: _norm(ns.spec, len(jleaves[n].shape)) for n, ns in jnames(
        jsharding.param_shardings(jshapes, AbstractMesh(shape, axes)))}
    tshapes = build_model(get_config(arch), device="cpu").init(
        torch.Generator())
    names = [n for n, _ in tree_flatten_with_names(tshapes)]
    assert sorted(names) == sorted(jleaves)
    specs = sharding.spec_leaves(tshapes, sharding.param_shardings(
        tshapes, _ShapeMesh(shape, axes)))
    for name, spec in zip(names, specs):
        assert _norm(spec, len(spec)) == jspecs[name], name
        nd = len(jleaves[name].shape)
        for inference in (False, True):
            assert sharding.spec_for_param(name, nd, inference=inference) \
                == _norm(jsharding.spec_for_param(name, nd,
                                                  inference=inference),
                         nd), (name, inference)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, shape, axes):
    jm = AbstractMesh(shape, axes)
    pm = _ShapeMesh(shape, axes)
    for batch in (4, 32):
        jcache = jax.eval_shape(lambda: jbuild(jget(arch)).init_cache(batch))
        jspecs = {n.replace("attn/", ""): _norm(s.spec, len(l.shape))
                  for (n, s), (_, l) in zip(
                      jnames(jsharding.cache_shardings(jcache, jm,
                                                       batch=batch)),
                      jnames(jcache))}
        tcache = build_model(get_config(arch), device="cpu").init_cache(batch)
        tspecs = sharding.cache_shardings(tcache, pm, batch=batch)
        assert tspecs
        for name, spec in tspecs.items():
            key = name.replace("attn/", "")
            if key.endswith("pos"):
                # the port keeps a position per row, the reference one
                # per layer: both whole
                assert set(spec) == set(jspecs[key]) == {None}, name
                continue
            assert _norm(spec, len(spec)) == jspecs[key], (name, batch)


def test_quantize_int8_is_bit_equal():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((128,)) * 3,
              np.zeros((7,)),
              np.array([0.5, -0.5, 1.5, 2.5, 127.0, -127.0, 254.0])):
        x = x.astype(np.float32)
        jq, js = jquantize(jnp.asarray(x))
        tq, ts = quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
        assert float(ts) == float(js)


# ---------------------------------------------------------------------------
# the multi-rank runs: the reference and the port side by side
# ---------------------------------------------------------------------------

REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.collectives import compressed_psum
    from repro.distributed.sharding import batch_sharding, param_shardings
    from repro.ft_runtime import checkpoint as ckpt
    from repro.models import build_model
    from repro.models import transformer
    from repro.models.moe import moe_apply
    from repro.optim import AdamW
    from repro.train import init_state, make_train_step
    from repro.utils.compat import shard_map

    D = sys.argv[1]
    out = {}

    def mesh_of(shape, axes):
        return Mesh(np.array(jax.devices()).reshape(shape), axes)

    def train(name, arch, init, axes, pod_sync):
        mesh = mesh_of((2, 2), axes)
        model = build_model(get_config(arch))
        opt = AdamW(lr=%(lr)r)
        target = init_state(model, opt, jax.random.PRNGKey(1),
                            pod_sync=pod_sync)
        state, _, _ = ckpt.restore(f"{D}/{init}", target)
        if pod_sync == "dense":
            ps = param_shardings(jax.eval_shape(lambda: state.params), mesh)
            state = state._replace(
                params=jax.device_put(state.params, ps),
                opt=state.opt._replace(m=jax.device_put(state.opt.m, ps),
                                       v=jax.device_put(state.opt.v, ps)))
        nb = dict(np.load(f"{D}/batch_{arch}.npz"))
        batch = {k: jax.device_put(v, batch_sharding(mesh, v.ndim))
                 for k, v in nb.items()}
        saved = transformer.shard_act
        if pod_sync == "int8_ef":
            transformer.shard_act = lambda x, mesh, spec=None: x
        try:
            step = jax.jit(make_train_step(model, opt, mesh=mesh,
                                           pod_sync=pod_sync))
            losses, pods = [], []
            with mesh:
                for i in (1, 2):
                    pods.append([float(model.loss(state.params, {
                        k: v[4 * p:4 * p + 4] for k, v in nb.items()})[0])
                        for p in range(2)])
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                    ckpt.save(f"{D}/ref_{name}_{i}", jax.device_get(state),
                              step=i)
        finally:
            transformer.shard_act = saved
        out[name] = {"losses": losses, "pod_losses": pods}

    train("gpt2_dense", "gpt2-smoke", "init_gpt2", ("pod", "data"), "dense")
    train("gpt2_ef", "gpt2-smoke", "init_gpt2_ef", ("pod", "data"),
          "int8_ef")
    train("arctic", "arctic-480b-smoke", "init_arctic", ("pod", "model"),
          "dense")

    z = np.load(f"{D}/psum.npz")
    mesh = mesh_of((4,), ("pod",))
    mean, err = shard_map(
        lambda x, e: compressed_psum(x, "pod", e), mesh=mesh,
        in_specs=(P("pod"), P("pod")), out_specs=(P(), P("pod")),
        check_vma=False)(jnp.asarray(z["x"]),
                         jnp.asarray(z["err"]).astype(jnp.bfloat16))
    np.savez(f"{D}/ref_psum.npz", mean=np.asarray(mean),
             err=np.asarray(err.astype(jnp.float32)))

    z = dict(np.load(f"{D}/moe.npz"))
    cfg = get_config("arctic-480b-smoke")
    m = dataclasses.replace(cfg.moe, inference_ep=True, capacity_factor=0.5)
    mesh = mesh_of((2, 2), ("data", "model"))
    params = {k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_apply(
            p, x, m, act=cfg.act, mesh=mesh, mode="decode"))(
                params, jnp.asarray(z["x"]))
    x2 = z["x"].reshape(-1, z["x"].shape[-1])
    probs = jax.nn.softmax(jnp.asarray(x2) @ params["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=m.num_experts)
    cap = max(4, int(np.ceil(x2.shape[0] * m.top_k / m.num_experts
                             * m.capacity_factor)))
    np.save(f"{D}/ref_moe_y.npy", np.asarray(y))
    out["moe"] = {"aux": float(aux),
                  "dropped": int(np.maximum(counts - cap, 0).sum())}
    print(json.dumps(out))
""") % {"lr": LR}

RANKS = textwrap.dedent("""
    import dataclasses, hashlib
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.distributed import Mesh, gather_tree, shard_tree
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import (local_block,
                                                  replicas_disagree)
    from repro_torch.ft_runtime import build_mesh, plan_mesh, restore, save
    from repro_torch.models import build_model
    from repro_torch.models.moe import count_dropped, expert_spec, moe_apply
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step, state_specs
    from repro_torch.utils import tree_flatten_with_names

    D = sys.argv[4]
    out = {}

    def tree_hash(tree):
        h = hashlib.sha256()
        for name, t in tree_flatten_with_names(tree):
            h.update(name.encode())
            h.update(t.detach().reshape(-1).contiguous().view(
                torch.uint8).numpy().tobytes())
        return h.hexdigest()

    def train(name, arch, init, axes, pod_sync):
        mesh = Mesh((2, 2), axes)
        model = build_model(get_config(arch), device="cpu")
        opt = AdamW(lr=%(lr)r)
        specs = state_specs(model, mesh, pod_sync=pod_sync)
        target = shard_tree(init_state(model, opt, torch.Generator(),
                                       pod_sync=pod_sync), specs, mesh)
        state, _, _ = restore(f"{D}/{init}", target, mesh=mesh,
                              shardings=specs)
        nb = np.load(f"{D}/batch_{arch}.npz")
        batch = {k: torch.from_numpy(nb[k]) for k in nb.files}
        step = make_train_step(model, opt, mesh=mesh, pod_sync=pod_sync)
        losses, bad = [], []
        for i in (1, 2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            # replicated blocks bit-equal; each pod's own ef residual
            # alike within the pod
            bad += replicas_disagree(state._replace(ef=None), specs, mesh)
            if state.ef is not None:
                h = torch.tensor(list(bytes.fromhex(tree_hash(state.ef))),
                                 dtype=torch.uint8)
                if any(not torch.equal(p, h) for p in coll.all_gather(
                        h, mesh.group(axes[1]))):
                    bad.append("ef")
            save(f"{D}/port_{name}_{i}", state, step=i, mesh=mesh,
                 shardings=specs)
        out[name] = {"losses": losses, "bad": bad,
                     "hash": tree_hash(gather_tree(state._replace(ef=None),
                                                   specs, mesh))}
        return mesh, model, opt, state, specs

    train("gpt2_dense", "gpt2-smoke", "init_gpt2", ("pod", "data"), "dense")
    train("gpt2_ef", "gpt2-smoke", "init_gpt2_ef", ("pod", "data"),
          "int8_ef")
    train("arctic", "arctic-480b-smoke", "init_arctic", ("pod", "model"),
          "dense")

    # the dense state written from (pod, data), restored on (data, model)
    mesh = Mesh((2, 2), ("data", "model"))
    model = build_model(get_config("gpt2-smoke"), device="cpu")
    opt = AdamW(lr=%(lr)r)
    specs = state_specs(model, mesh)
    target = shard_tree(init_state(model, opt, torch.Generator()), specs,
                        mesh)
    state, step_no, _ = restore(f"{D}/port_gpt2_dense_2", target, mesh=mesh,
                                shardings=specs)
    out["reshard"] = {"hash": tree_hash(gather_tree(state, specs, mesh)),
                      "step": step_no,
                      "split": [list(t.shape) for _, t in
                                tree_flatten_with_names(state.params)][:3]}

    # compressed_psum over 4 ranks
    z = np.load(f"{D}/psum.npz")
    pods = Mesh((4,), ("pod",))
    mean, err = coll.compressed_psum(
        torch.from_numpy(z["x"][RANK]), pods.group("pod"),
        torch.from_numpy(z["err"][RANK]).to(torch.bfloat16))
    np.savez(f"{D}/port_psum_{RANK}.npz", mean=mean.numpy(),
             err=err.float().numpy())

    # _moe_inference_ep on (data 2, model 2), decode, tokens dropped
    z = np.load(f"{D}/moe.npz")
    cfg = get_config("arctic-480b-smoke")
    m = dataclasses.replace(cfg.moe, inference_ep=True, capacity_factor=0.5)
    spec = expert_spec(mesh, m, mode="decode")
    params = {k: local_block(torch.from_numpy(z[k]), spec.get(k), mesh)
              for k in ("router", "wg", "wu", "wd")}
    x = torch.from_numpy(z["x"])
    xb = local_block(x, ("data", None, None), mesh)
    y, aux = moe_apply(params, xb, m, act=cfg.act, mesh=mesh, mode="decode")
    np.save(f"{D}/port_moe_y_{RANK}.npy", y.numpy())
    x2 = x.reshape(-1, x.shape[-1])
    from repro_torch.models.moe import capacity
    out["moe"] = {"aux": float(aux), "coords": mesh.coords,
                  "dropped": count_dropped(x2, params["router"], m,
                                           capacity(x2.shape[0], m))}

    # build_mesh: all four ranks, then the first two of a plan for three
    full = build_mesh(plan_mesh(4, model_parallel=2))
    half = build_mesh(plan_mesh(3, model_parallel=2))
    ranks = dist.get_process_group_ranks
    out["mesh"] = {
        "shape": full.shape, "coords": full.coords,
        "data": ranks(full.group("data")),
        "model": ranks(full.group("model")),
        "both": ranks(full.group(("data", "model"))),
        "half_shape": half.shape, "half_coords": half.coords,
        "half_model": (ranks(half.group("model"))
                       if half.coords is not None else None)}
    print(json.dumps(out))
""") % {"lr": LR}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    for name, arch, sync in (("init_gpt2", "gpt2-smoke", "dense"),
                             ("init_gpt2_ef", "gpt2-smoke", "int8_ef"),
                             ("init_arctic", "arctic-480b-smoke", "dense")):
        st = jinit_state(jbuild(jget(arch)), JAdamW(lr=LR),
                         jax.random.PRNGKey(0), pod_sync=sync)
        jckpt.save(d / name, jax.device_get(st), step=0)
    for arch in ("gpt2-smoke", "arctic-480b-smoke"):
        tok = rng.integers(0, 128, (8, 16)).astype(np.int32)
        # uneven: the two pods' blocks keep different counts
        mask = (rng.random((8, 16)) < np.linspace(0.2, 0.9, 8)[:, None]
                ).astype(np.float32)
        np.savez(d / f"batch_{arch}.npz", tokens=tok,
                 targets=np.roll(tok, -1, 1).astype(np.int32),
                 loss_mask=mask)
    err = rng.standard_normal((4, 8, 37)).astype(np.float32) * 0.05
    err = np.asarray(jnp.asarray(err).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.savez(d / "psum.npz", x=rng.standard_normal((4, 8, 37)).astype(
        np.float32) * np.float32(3.0), err=err)
    cfg = jget("arctic-480b-smoke")
    mp = jmoe_init(jax.random.PRNGKey(3), cfg.d_model, cfg.moe, jnp.float32)
    np.savez(d / "moe.npz", x=rng.standard_normal((16, 1, cfg.d_model)
                                                  ).astype(np.float32),
             **{k: np.asarray(v) for k, v in mp.items()})

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=str(REPO))
    try:
        port = launch(RANKS, 4, d / "ranks", timeout=150, pg_timeout=120,
                      args=(d,))
        out, err_txt = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait(timeout=30)
    assert ref.returncode == 0, err_txt[-3000:]
    return {"dir": d, "ref": json.loads(out.strip().splitlines()[-1]),
            "port": port}


# the last bits of the f32 update (1e-3 of one step)
PARAM_TIGHT = 1e-3 * LR


def _compare_states(d, name, arch, sync="dense", *, moments=True):
    """The port's state against the reference's: parameters within
    ``ADAM_SLACK``, all but 0.1% of each leaf within ``PARAM_TIGHT``;
    moments (where compared) within 1e-5 of the leaf's largest (under
    ``int8_ef`` all but 0.1%: a quantization step apart where f32 noise
    moved an element across a rounding boundary); the bf16 ``ef``
    residuals within one bf16 ulp of the leaf's largest, all but 0.1%."""
    model = build_model(get_config(arch), device="cpu")
    target = init_state(model, AdamW(lr=LR), torch.Generator(),
                        pod_sync=sync)
    got, gstep, _ = restore(d / f"port_{name}", target)
    want, wstep, _ = restore(d / f"ref_{name}", target)
    assert gstep == wstep
    for (n, g), (_, w) in zip(tree_flatten_with_names(got),
                              tree_flatten_with_names(want)):
        g, w = g.double().numpy(), w.double().numpy()
        diff = np.abs(g - w)
        top = np.abs(w).max()
        if n.startswith("params/"):
            assert diff.max() <= ADAM_SLACK, (n, diff.max())
            assert np.mean(diff > PARAM_TIGHT) <= 1e-3, n
        elif n.startswith("opt/") and moments and sync == "dense":
            assert diff.max() <= 1e-5 * top, (n, diff.max(), top)
        elif n.startswith("opt/") and moments:
            # a gradient element whose quantization flipped moves by a
            # step / n
            assert np.mean(diff > 1e-5 * top) <= 1e-3, n
        elif n.startswith("ef/") and moments:
            assert np.mean(diff > 2 ** -7 * top) <= 1e-3, n
        elif not n.startswith(("opt/", "ef/")):
            np.testing.assert_array_equal(g, w, err_msg=n)


def test_dense_step_matches_reference(runs):
    """gpt2-smoke on (pod 2, data 2), an uneven mask: the global mean."""
    ref, port = runs["ref"]["gpt2_dense"], runs["port"][0]["gpt2_dense"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    # the global mean is not the mean of the pods' means here
    assert abs(ref["losses"][0] - np.mean(ref["pod_losses"][0])) > 1e-4
    for r in runs["port"]:
        assert r["gpt2_dense"]["bad"] == []
        assert r["gpt2_dense"]["hash"] == port["hash"]
    for i in (1, 2):
        _compare_states(runs["dir"], f"gpt2_dense_{i}", "gpt2-smoke")


def test_int8_ef_step_matches_reference(runs):
    """The mean of the pods' means, compressed gradients, replicated
    update; the reference reports device 0's pod loss as its metric."""
    ref, port = runs["ref"]["gpt2_ef"], runs["port"][0]["gpt2_ef"]
    np.testing.assert_allclose(port["losses"],
                               np.mean(ref["pod_losses"], axis=1), rtol=1e-5)
    np.testing.assert_allclose(ref["losses"],
                               np.asarray(ref["pod_losses"])[:, 0], rtol=1e-5)
    for r in runs["port"]:
        assert r["gpt2_ef"]["bad"] == []
        assert r["gpt2_ef"]["hash"] == port["hash"]
    _compare_states(runs["dir"], "gpt2_ef_1", "gpt2-smoke", "int8_ef")
    # step 2: the reference fed pod 0's residual to both pods (see
    # repro_torch.train.step), so only the parameters are held
    _compare_states(runs["dir"], "gpt2_ef_2", "gpt2-smoke", "int8_ef",
                    moments=False)


def test_expert_parallel_step_matches_reference(runs):
    """arctic-smoke on (pod 2, model 2): experts split over model, the
    capacity and the aux loss per data-parallel rank."""
    ref, port = runs["ref"]["arctic"], runs["port"][0]["arctic"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    for r in runs["port"]:
        assert r["arctic"]["bad"] == []
        assert r["arctic"]["hash"] == port["hash"]
    for i in (1, 2):
        _compare_states(runs["dir"], f"arctic_{i}", "arctic-480b-smoke")


def test_compressed_psum_matches_reference(runs):
    d = runs["dir"]
    ref = np.load(d / "ref_psum.npz")
    x = np.load(d / "psum.npz")
    for r in range(4):
        got = np.load(d / f"port_psum_{r}.npz")
        np.testing.assert_array_equal(got["mean"], ref["mean"][0])
        np.testing.assert_array_equal(got["err"], ref["err"][r])
        # the residual is within half a quantization step (and its bf16
        # rounding)
        amax = np.abs(x["x"] + x["err"]).max()
        assert np.abs(got["err"]).max() <= amax / 127 / 2 * (1 + 2 ** -7)


def test_moe_inference_ep_matches_reference(runs):
    d = runs["dir"]
    ref_y = np.load(d / "ref_moe_y.npy")
    ref = runs["ref"]["moe"]
    rows = {}
    for r, res in enumerate(runs["port"]):
        rows[res["moe"]["coords"]["data"]] = np.load(d / f"port_moe_y_{r}.npy")
        np.testing.assert_allclose(res["moe"]["aux"], ref["aux"], rtol=1e-6)
        assert res["moe"]["dropped"] == ref["dropped"] > 0
    got = np.concatenate([rows[0], rows[1]])
    scale = np.abs(ref_y).max()
    np.testing.assert_allclose(got, ref_y, rtol=0, atol=1e-6 * scale)


def test_checkpoint_crosses_meshes_and_packages(runs):
    d = runs["dir"]
    written = runs["port"][0]["gpt2_dense"]["hash"]
    for r in runs["port"]:
        assert r["reshard"]["hash"] == written and r["reshard"]["step"] == 2
    # one process of the port
    model = build_model(get_config("gpt2-smoke"), device="cpu")
    target = init_state(model, AdamW(lr=LR), torch.Generator())
    state, step, _ = restore(d / "port_gpt2_dense_2", target)
    h = hashlib.sha256()
    for name, t in tree_flatten_with_names(state):
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().view(
            torch.uint8).numpy().tobytes())
    assert h.hexdigest() == written and step == 2
    # the reference
    jtarget = jinit_state(jbuild(jget("gpt2-smoke")), JAdamW(lr=LR),
                          jax.random.PRNGKey(1))
    jstate, jstep, _ = jckpt.restore(d / "port_gpt2_dense_2", jtarget)
    assert jstep == 2
    for (n, t), (jn, j) in zip(tree_flatten_with_names(state),
                               jnames(jstate)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j), err_msg=n)


def test_build_mesh_and_groups(runs):
    for r, res in enumerate(runs["port"]):
        m = res["mesh"]
        assert m["shape"] == {"data": 2, "model": 2}
        d, mo = divmod(r, 2)
        assert m["coords"] == {"data": d, "model": mo}
        assert m["data"] == [mo, 2 + mo] and m["model"] == [2 * d, 2 * d + 1]
        assert m["both"] == [0, 1, 2, 3]
        assert m["half_shape"] == {"data": 1, "model": 2}
        if r < 2:
            assert m["half_coords"] == {"data": 0, "model": r}
            assert m["half_model"] == [0, 1]
        else:
            assert m["half_coords"] is None and m["half_model"] is None
