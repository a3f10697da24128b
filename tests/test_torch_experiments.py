"""The port's hillclimb (``experiments_torch/hillclimb.py``) and its render
(``experiments_torch/render_experiments.py``) on the meta device, at smoke
archs, small shapes of the cells' kinds and a (2, 2) mesh of a fake
process group (run in a subprocess, as the dry run's own tests do, so no
pytest worker holds a group):

* cell A (kimi-k2 smoke decode) writes the baseline and ``infer_layout``;
* cell B (arctic smoke train) writes ``mb4``, ``seqpar`` (whose counts
  equal ``mb4``'s: the port's sequence parallelism is a placement) and the
  two stride ablations;
* cell C (deepseek-coder smoke prefill, 2,048 tokens) writes the
  reference's keys for ``kernelized``, with B2 at ``block_kv`` 2,048 (fold
  stride 8 at the smoke config's stride, 256 segments: the kernel's wide
  path) launched once a layer, and a peak below the plain-EFTA
  baseline's;
* the render produces every section from those files.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

RUN = """
    import json, sys
    from pathlib import Path
    sys.path.insert(0, "experiments_torch")
    import hillclimb, render_experiments
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.launch import dryrun
    out = Path(sys.argv[1])
    dryrun.open_fake_world(4)
    mesh = hillclimb.mesh_of("2x2")
    a = hillclimb.cell_a(out, arch="kimi-k2-1t-a32b-smoke",
                         shape=ShapeCfg("decode_32k", 64, 8, "decode"),
                         mesh=mesh)
    b = hillclimb.cell_b(out, arch="arctic-480b-smoke",
                         shape=ShapeCfg("train_4k", 32, 8, "train"),
                         mesh=mesh)
    c = hillclimb.cell_c(out, arch="deepseek-coder-33b-smoke",
                         shape=ShapeCfg("prefill_32k", 2048, 2, "prefill"),
                         mesh=mesh)
    text = render_experiments.main(["--dir", str(out)])
    print(json.dumps({"a": [r.get("tag") for r in a],
                      "b": [r.get("tag") for r in b], "c": c,
                      "files": sorted(p.name for p in out.glob("*.json")),
                      "text": text}))
"""


@pytest.fixture(scope="module")
def hill(tmp_path_factory):
    out = tmp_path_factory.mktemp("hillclimb")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["dir"] = out
    return res


def test_cells_a_and_b_write_their_iterations(hill):
    assert hill["a"] == ["", "infer_layout"]
    assert hill["b"] == ["", "mb4", "seqpar", "s8_paper", "s128_lane"]
    for arch, shape, tags in (
            ("kimi-k2-1t-a32b-smoke", "decode_32k", ["infer_layout"]),
            ("arctic-480b-smoke", "train_4k",
             ["mb4", "seqpar", "s8_paper", "s128_lane"])):
        assert f"{arch}__{shape}__2x2.json" in hill["files"]
        for tag in tags:
            r = json.loads((hill["dir"] / f"{arch}__{shape}__2x2__{tag}.json"
                            ).read_text())
            assert r["tag"] == tag and r["mesh"] == "2x2"
            assert {"roofline", "memory", "dominant", "flops_per_device",
                    "roofline_fraction"} <= set(r)
    seqpar = json.loads((hill["dir"] / "arctic-480b-smoke__train_4k__2x2__"
                         "seqpar.json").read_text())
    assert seqpar["note"].endswith("counts equal mb4's")


def test_cell_c_kernelized_keeps_the_reference_keys_and_a_lower_peak(hill):
    base, k = hill["c"]
    assert base["tag"] == "" and base["launches"] == {}
    assert {"memory_s_baseline", "memory_s_fused", "tile_bytes",
            "flops_per_device", "compute_s"} <= set(k)
    assert k["tag"] == "kernelized" and k["mesh"] == "2x2"
    assert k["b2_launches"] == 2          # one a layer
    assert k["peak_bytes_fused"] < k["peak_bytes_baseline"]
    assert k["memory_s_fused"] < k["memory_s_baseline"]
    assert k["tile_bytes"] > 0 and k["fits_80gb"] in (True, False)
    on_disk = json.loads((hill["dir"] / "deepseek-coder-33b-smoke__"
                          "prefill_32k__2x2__kernelized.json").read_text())
    assert on_disk == k


def test_render_has_every_section(hill):
    text = hill["text"]
    sys.path.insert(0, str(REPO / "experiments_torch"))
    import render_experiments
    for section in render_experiments.SECTIONS:
        assert section in text
    for key in "ABC":
        assert f"### Cell {key} — " in text
    assert "### mesh 2x2 (4 ranks)" in text
    for tag in ("infer_layout", "mb4", "seqpar", "s8_paper", "s128_lane",
                "kernelized"):
        assert f"`{tag}`" in text
    # the H100's data-sheet rates, no TPU's
    assert "989 TFLOP/s" in text and "TPU" not in text
