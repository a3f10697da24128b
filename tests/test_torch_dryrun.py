"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``repro_torch.utils.opcount``) on the CPU.

* Shapes against the reference: on a (2, 2) mesh, for gpt2-smoke and
  kimi-k2-smoke at a train and a decode shape cut to smoke size (B 8, S
  32), every input leaf's global and rank-0 shape equals the reference's
  ``input_specs`` (``ShapeDtypeStruct.shape`` and
  ``sharding.shard_shape``): parameters, moments, the step, the cache's K/V,
  tokens and targets. Two cache leaves differ by design of the port and
  are left out: ``pos`` (one position per row, (B,), where the reference
  keeps one a layer) and the decoder-only families' empty cross-memory
  placeholders (``ck``/``cv``, absent in the port).
* ``cell_config``, ``cell_applicable`` and ``model_flops_estimate`` equal
  the reference's for every assigned arch and shape.
* The meta pass against a CPU pass: a gpt2-smoke train step on a (2, 2)
  mesh and a prefill, each traced on meta and run on CPU tensors, count
  the same FLOPs, ops (by class and by aten op), bytes, collective bytes
  and peak live bytes, but for the copies of host data (a Python or
  numpy scalar becomes a tensor in place on the CPU and is copied,
  ``_to_copy``, to any other device: meta counts these as the card does,
  which ``chip_smoke.py``'s phase ``dryrun`` holds exactly).
* ``collective_bytes`` of all-reduces and all-gathers on a fake group
  equals the bytes reckoned by hand.
* Kernel B2's meta branch: the CPU route's shapes and dtypes, one launch
  recorded with ``efta_attention_work``'s bytes and FLOPs.
* The CLI on one production cell (gpt2 train_4k, 256 fake ranks).

Each case that opens a process group (the fake one, or the reference's
forced host devices) runs in a subprocess of its own with a timeout, so
no pytest worker holds a process group.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("gpt2-smoke", "kimi-k2-1t-a32b-smoke")


def _run(code: str, *args, timeout: int = 240, jax_env: bool = False):
    """Run ``code`` in a fresh interpreter; its last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    if jax_env:
        env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


REF_SHAPES = """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import repro.launch.dryrun as d
    from repro.configs.shapes import ShapeCfg
    from repro.launch.mesh import make_debug_mesh

    def name(path):
        out = []
        for p in path:
            for attr in ("key", "name", "idx"):
                if hasattr(p, attr):
                    out.append(str(getattr(p, attr)))
                    break
        return "/".join(out)

    mesh = make_debug_mesh((2, 2))
    res = {}
    for arch in sys.argv[1].split(","):
        for kind in ("train", "decode"):
            sname = "train_4k" if kind == "train" else "decode_32k"
            d.SHAPES[sname] = ShapeCfg(sname, 32, 8, kind)
            spec = d.input_specs(d.cell_config(arch, sname), sname, mesh)
            keys = (("state", "batch") if kind == "train" else
                    ("params", "cache", "tokens", "extra"))
            table = {}
            for k in keys:
                flat = jax.tree_util.tree_flatten_with_path(spec[k])[0]
                for path, leaf in flat:
                    n = k + ("/" + name(path) if path else "")
                    table[n] = [list(leaf.shape),
                                list(leaf.sharding.shard_shape(leaf.shape)),
                                str(leaf.dtype)]
            res[arch + "/" + kind] = table
    print(json.dumps(res))
"""

PORT_SHAPES = """
    import sys, json
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.distributed.sharding import _cache_leaves, full_shape
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.utils.tree import path_str, tree_flatten_with_path

    d.open_fake_world(4)
    mesh = make_debug_mesh((2, 2))

    def spec_at(specs, path):
        for kind, k in path:
            specs = getattr(specs, k) if kind == "attr" else specs[k]
        return specs

    res = {}
    for arch in sys.argv[1].split(","):
        for kind in ("train", "decode"):
            sname = "train_4k" if kind == "train" else "decode_32k"
            spec = d.input_specs(d.cell_config(arch, sname),
                                 ShapeCfg(sname, 32, 8, kind), mesh)
            table = {}

            def add(name, t, s):
                table[name] = [list(full_shape(t.shape, s, mesh)),
                               list(t.shape),
                               str(t.dtype).replace("torch.", "")]

            trees = (("state", "state_specs"), ("batch", "batch_specs"),
                     ("params", "param_specs"), ("extra", "extra_specs"))
            for key, skey in trees:
                for path, t in tree_flatten_with_path(spec.get(key)):
                    add(key + "/" + path_str(path), t,
                        spec_at(spec[skey], path))
            if kind == "decode":
                for n, t in _cache_leaves(spec["cache"]):
                    add("cache/" + n, t, spec["cache_specs"][n])
                add("tokens", spec["tokens"], spec["token_spec"])
            res[arch + "/" + kind] = table
    print(json.dumps(res))
"""


def _ref_name(port_name: str, ref_names) -> str:
    """The reference's name of a port leaf: the decoder-only port cache
    is the reference's ``attn`` entry."""
    if port_name.startswith("cache/") and port_name not in ref_names:
        return "cache/attn/" + port_name[len("cache/"):]
    return port_name


@pytest.fixture(scope="module")
def shape_tables():
    archs = ",".join(ARCHS)
    return (_run(REF_SHAPES, archs, jax_env=True, timeout=400),
            _run(PORT_SHAPES, archs))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_input_shapes_match_reference(shape_tables, arch, kind):
    ref, port = (t[f"{arch}/{kind}"] for t in shape_tables)
    seen = set()
    for name, got in port.items():
        if name.endswith("/pos"):
            continue                    # (B,) in the port, (L,) there
        rname = _ref_name(name, ref)
        assert rname in ref, (name, sorted(ref))
        assert got == ref[rname], name
        seen.add(rname)
    left = {n for n in ref if n not in seen}
    # what the port has not: the step's position per layer and the
    # decoder-only placeholders of a cross memory
    assert all(n.endswith(("/pos", "/ck", "/cv")) for n in left), left
    assert any(n.split("/")[:2] in (["state", "opt"], ["params", "blocks"])
               for n in seen)
    assert any(n.startswith(("batch/tokens", "tokens")) for n in seen)
    if kind == "decode":
        assert {n for n in seen if n.startswith("cache/")}


PLAIN_REF = """
    import dataclasses, json
    import repro.launch.dryrun as d
    from repro.configs import ASSIGNED_ARCHS
    from repro.configs.shapes import SHAPES, cell_applicable
    out = {}
    for arch in ASSIGNED_ARCHS:
        for s in SHAPES:
            cfg = d.cell_config(arch, s)
            out[arch + "/" + s] = {
                "cfg": dataclasses.asdict(cfg),
                "applicable": list(cell_applicable(arch, s)),
                "flops": d.model_flops_estimate(cfg, SHAPES[s])}
    print(json.dumps(out))
"""


def test_plain_functions_match_reference():
    import dataclasses
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.configs.shapes import SHAPES, cell_applicable
    from repro_torch.launch import dryrun as d
    ref = _run(PLAIN_REF, jax_env=True)
    assert len(ref) == len(ASSIGNED_ARCHS) * len(SHAPES) == 40
    n_ok = 0
    for arch in ASSIGNED_ARCHS:
        for s in SHAPES:
            want = ref[f"{arch}/{s}"]
            cfg = d.cell_config(arch, s)
            got_cfg = json.loads(json.dumps(dataclasses.asdict(cfg)))
            assert got_cfg == want["cfg"], (arch, s)
            assert list(cell_applicable(arch, s)) == want["applicable"]
            assert d.model_flops_estimate(cfg, SHAPES[s]) == want["flops"]
            n_ok += cell_applicable(arch, s)[0]
    assert n_ok == 33


META_VS_CPU = """
    import json
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_debug_mesh

    d.open_fake_world(4)
    mesh = make_debug_mesh((2, 2))
    out = {}
    for kind, m in (("train", mesh), ("prefill", None)):
        shape = ShapeCfg(kind, 32, 8, kind)
        for dev in ("meta", "cpu"):
            spec = d.input_specs(d.cell_config("gpt2-smoke", kind), shape, m,
                                 device=dev)
            c, _, _ = d.trace_call(spec, m)
            out[kind + "/" + dev] = {
                "flops": c.flops, "bytes": c.bytes, "ops": c.count_ops(),
                "aten": c.aten, "aten_bytes": c.aten_bytes,
                "coll": c.collective_bytes(),
                "args": c.argument_bytes[dev], "peak": c.peak_bytes[dev]}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def meta_vs_cpu():
    return _run(META_VS_CPU)


# a tensor made from host data: wrapped in place on the CPU (lift_fresh,
# which opcount does not count), copied to the device elsewhere
# (_to_copy), on meta as on the card
HOST = ("_to_copy",)


def _off_host(r):
    """``r`` without the ops that take host data."""
    host = sum(r["aten"].get(k, 0) for k in HOST)
    return {"flops": r["flops"], "coll": r["coll"], "args": r["args"],
            "peak": r["peak"],
            "ops": dict(r["ops"], fusion=r["ops"]["fusion"] - host),
            "aten": {k: v for k, v in r["aten"].items() if k not in HOST},
            "bytes": r["bytes"] - sum(r["aten_bytes"].get(k, 0)
                                      for k in HOST)}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_pass_counts_what_a_cpu_pass_does(meta_vs_cpu, kind):
    meta, cpu = meta_vs_cpu[f"{kind}/meta"], meta_vs_cpu[f"{kind}/cpu"]
    assert _off_host(meta) == _off_host(cpu)
    assert meta["flops"] > 0 and meta["ops"]["dot"] > 0
    assert meta["peak"] > meta["args"] > 0
    if kind == "train":
        # the ZeRO-3 gathers and the gradient sums of the step
        assert meta["coll"]["all-gather"] > 0
        assert meta["coll"]["all-reduce"] > 0


COLLECTIVES = """
    import json
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import dryrun as d
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.utils.opcount import opcount

    d.open_fake_world(4)
    mesh = make_debug_mesh((2, 2))
    a = torch.zeros((3, 5), device="meta")
    b = torch.zeros((2, 7), dtype=torch.bfloat16, device="meta")
    coll.all_reduce(a, mesh.group("data"))       # counted before: reset
    with opcount() as c:
        coll.all_reduce(a, mesh.group("data"))
        coll.all_reduce(b, mesh.group(("data", "model")), op="max")
        coll.all_gather(a, mesh.group("model"))
        coll.all_gather(b, mesh.group(("data", "model")))
    print(json.dumps(c.collective_bytes()))
"""


def test_collective_bytes_by_hand():
    got = _run(COLLECTIVES)
    # all-reduce: the reduced tensor's bytes; all-gather: all it received
    assert got == {"all-reduce": 3 * 5 * 4 + 2 * 7 * 2,
                   "all-gather": 2 * 3 * 5 * 4 + 4 * 2 * 7 * 2}


@pytest.mark.parametrize("causal", [False, True])
def test_b2_meta_branch_shapes_and_recorded_work(causal):
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_rows,
                                                    efta_attention_work)
    from repro_torch.utils.opcount import opcount
    cfg = EFTAConfig(block_kv=16, stride=8)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 32, 16), generator=g)
    k, v = (torch.randn((2, 2, 32, 16), generator=g) for _ in range(2))
    meta = [t.to("meta") for t in (q, k, v)]
    for fn in (efta_attention, efta_attention_rows):
        want = fn(q, k, v, cfg=cfg, causal=causal)
        with opcount() as c:
            got = fn(*meta, cfg=cfg, causal=causal)
        for a, b in zip(got, want):
            assert a.is_meta and a.shape == b.shape and a.dtype == b.dtype
        nbytes, flops = efta_attention_work(q, k, causal=causal)
        assert c.launches == {"efta_attention": {"calls": 1,
                                                 "bytes": nbytes,
                                                 "flops": flops}}
        assert c.count_ops()["custom-call"] == 1
        assert c.flops == flops and c.count_ops()["dot"] == 0
    pairs = 32 * 33 // 2 if causal else 32 * 32
    assert efta_attention_work(q, k, causal=causal) == (
        (2 * q.numel() + 2 * k.numel()) * 4, 2 * 4 * pairs * 4 * 16)


def test_record_launch_reckons_work_only_when_counted():
    from repro_torch.utils.opcount import opcount, record_launch
    asked = []

    def work():
        asked.append(1)
        return 10, 20

    record_launch("k", work)
    assert asked == []
    with opcount() as c:
        record_launch("k", work)
        record_launch("k")
    assert asked == [1]
    assert c.launches == {"k": {"calls": 2, "bytes": 10, "flops": 20}}
    assert c.count_ops()["custom-call"] == 2


def test_cli_runs_a_production_cell_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gpt2",
         "--shape", "train_4k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK gpt2 x train_4k x 16x16")
    r = json.loads((tmp_path / "gpt2__train_4k__16x16.json").read_text())
    assert r["n_devices"] == 256 and "probe_plan" not in r
    assert {"trace_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "roofline", "dominant",
            "model_flops", "useful_flops_ratio",
            "roofline_fraction"} <= set(r)
    m = r["memory"]
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"] > 0
    assert m["fits_80gb"] == (m["peak_bytes"] <= 80e9)
    assert r["collective_bytes_per_device"]["all-gather"] > 0
    assert r["dominant"] in r["roofline"]
