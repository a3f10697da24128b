"""Render the port's dry-run and hillclimb results as markdown: the
sections of ``experiments/render_experiments.py``, from the JSON that
``repro_torch.launch.dryrun`` and ``experiments_torch/hillclimb.py``
write, with the NVIDIA H100's data-sheet rates of ``launch/dryrun.py``.

  PYTHONPATH=src python experiments_torch/render_experiments.py \\
      [--dir build/experiments_torch] > build/EXPERIMENTS_TORCH.md

Every number below is read from those files; the text states none of its
own.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import HBM_BW, HBM_BYTES, NET_BW, PEAK_FLOPS

OUT = Path("build/experiments_torch")
CELLS = {"A": ("kimi-k2-1t-a32b", "decode_32k", "the most collective-bound"),
         "B": ("arctic-480b", "train_4k", "the worst memory pressure"),
         "C": ("deepseek-coder-33b", "prefill_32k",
               "the paper's case: EFTA on long-prefill attention")}
SECTIONS = ("## §Dry-run", "## §Perf — hillclimb log",
            "### Hillclimb result table", "### Perf summary")
# the hillclimb's iterations in the order it runs them
TAGS = ("infer_layout", "mb4", "seqpar", "s8_paper", "s128_lane",
        "kernelized")


def header():
    return f"""# EXPERIMENTS — FT-Transformer port (PyTorch + CUDA), dry run

Hardware model: one NVIDIA H100 SXM a rank (NVIDIA's data sheet, dense):
{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s HBM,
{HBM_BYTES / 1e9:.0f} GB a card, {NET_BW / 1e9:.0f} GB/s of network a card
(one 400 Gb/s port). The terms below are rank 0's counts over those
rates: a trace on the meta device (`repro_torch.launch.dryrun`, one rank
of a fake process group of the mesh's ranks, `utils/opcount.py`), not a
timing. The memory term is eager bytes (each op's inputs and outputs), an
upper bound; kernel B2's launches count their own bytes and FLOPs
(`efta_attention_work`)."""


def _gb(x):
    return f"{x / 1e9:.1f}"


def row(r):
    t = r.get("roofline")
    if t is None:      # the kernelized record of cell C
        return (f"| {r['arch']} | {r['shape']} | {r['tag']} "
                f"| {r['compute_s']:.2e} | {r['memory_s_fused']:.2e} "
                f"| {r['collective_s']:.2e} | {_gb(r['peak_bytes_fused'])} "
                f"| memory term {r['memory_s_baseline']:.2e} -> "
                f"{r['memory_s_fused']:.2e}; {r['b2_launches']} B2 launches; "
                f"fits 80 GB: {r['fits_80gb']} |")
    rf = r.get("roofline_fraction")
    return (f"| {r['arch']} | {r['shape']} | {r.get('tag') or 'baseline'} "
            f"| {t['compute_s']:.2e} | {t['memory_s']:.2e} "
            f"| {t['collective_s']:.2e} | {_gb(r['memory']['peak_bytes'])} "
            f"| rf={rf and round(rf, 4)} dom={r['dominant'][:-2]}"
            f"{'; ' + r['note'] if r.get('note') else ''} |")


def _ratio(a, b):
    return f"{a / b:.2f}x" if b else "-"


def cell_text(key, base, tagged):
    arch, shape, why = CELLS[key]
    lines = [f"\n### Cell {key} — {arch} x {shape} ({why})\n"]
    if base is None:
        return lines + ["(no baseline traced)"]
    t0, p0 = base["roofline"], base["memory"]["peak_bytes"]
    lines.append(f"Baseline: dominant {base['dominant'][:-2]}; compute "
                 f"{t0['compute_s']:.2e} s, memory {t0['memory_s']:.2e} s, "
                 f"collective {t0['collective_s']:.2e} s; peak {_gb(p0)} GB"
                 f" (fits 80 GB: {base['memory']['fits_80gb']}).\n")
    for i, r in enumerate(tagged, 1):
        if r.get("roofline") is None:
            lines.append(
                f"{i}. `{r['tag']}`: {r['b2_launches']} B2 launches; eager "
                f"bytes {r['tile_bytes'] / 1e12:.1f} TB a rank fewer; "
                f"dominant {r['dominant_fused'][:-2]}; memory term "
                f"{r['memory_s_baseline']:.2e} -> {r['memory_s_fused']:.2e} "
                f"s ({_ratio(r['memory_s_baseline'], r['memory_s_fused'])} "
                f"down); peak {_gb(r['peak_bytes_baseline'])} -> "
                f"{_gb(r['peak_bytes_fused'])} GB; fits 80 GB: "
                f"{r['fits_80gb']}.")
            continue
        t, p = r["roofline"], r["memory"]["peak_bytes"]
        lines.append(
            f"{i}. `{r['tag']}`: compute {t['compute_s']:.2e} s "
            f"({_ratio(t['compute_s'], t0['compute_s'])}), memory "
            f"{t['memory_s']:.2e} s ({_ratio(t['memory_s'], t0['memory_s'])}"
            f"), collective {t['collective_s']:.2e} s "
            f"({_ratio(t['collective_s'], t0['collective_s'])}), peak "
            f"{_gb(p)} GB ({_ratio(p, p0)}); dominant "
            f"{r['dominant'][:-2]}."
            + (f" {r['note']}." if r.get("note") else ""))
    return lines


def render(rows):
    base = [r for r in rows if not r.get("tag")]
    tagged = sorted((r for r in rows if r.get("tag")), key=lambda r: (
        TAGS.index(r["tag"]) if r["tag"] in TAGS else len(TAGS), r["tag"]))
    out = [header(), "", SECTIONS[0]]
    for mesh in sorted({r["mesh"] for r in base}, key=len):
        sel = sorted((r for r in base if r["mesh"] == mesh),
                     key=lambda r: (r["arch"], r["shape"]))
        out += [f"\n### mesh {mesh} ({sel[0]['n_devices']} ranks)\n",
                "| arch | shape | kind | compute_s | memory_s | collective_s "
                "| dominant | peak GB | fits 80GB | useful-FLOPs ratio "
                "| roofline fraction |",
                "|---|---|---|---|---|---|---|---|---|---|---|"]
        for r in sel:
            t, u, f = (r["roofline"], r["useful_flops_ratio"],
                       r["roofline_fraction"])
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['kind']} "
                f"| {t['compute_s']:.2e} | {t['memory_s']:.2e} "
                f"| {t['collective_s']:.2e} | {r['dominant'][:-2]} "
                f"| {_gb(r['memory']['peak_bytes'])} "
                f"| {r['memory']['fits_80gb']} | {u and round(u, 3)} "
                f"| {f and round(f, 4)} |")
    out += ["", SECTIONS[1]]
    picked = {}
    for key, (arch, shape, _) in CELLS.items():
        # by name, a "-smoke" variant of the arch included
        b = next((r for r in base if r["arch"].startswith(arch)
                  and r["shape"] == shape), None)
        ts = [r for r in tagged if r["arch"].startswith(arch)
              and r["shape"] == shape]
        picked[key] = (b, ts)
        out += cell_text(key, b, ts)
    out += ["", SECTIONS[2], "",
            "| arch | shape | variant | compute_s | memory_s | collective_s "
            "| peak GB | note |", "|---|---|---|---|---|---|---|---|"]
    for b, ts in picked.values():
        out += [row(r) for r in ([b] if b else []) + ts]
    out += ["", SECTIONS[3], ""]
    fits = [r for r in base if r["memory"]["fits_80gb"]]
    best = max((r for r in base if r.get("roofline_fraction")),
               key=lambda r: r["roofline_fraction"], default=None)
    out.append(f"{len(fits)} of {len(base)} baseline cells fit one 80 GB "
               f"card.")
    if best is not None:
        out.append(f"Best roofline fraction: {best['roofline_fraction']:.4f}"
                   f" ({best['arch']} x {best['shape']} x {best['mesh']}).")
    for key, (b, ts) in picked.items():
        for r in ts:
            pb = b["memory"]["peak_bytes"] if b else None
            p = (r["peak_bytes_fused"] if r.get("roofline") is None
                 else r["memory"]["peak_bytes"])
            out.append(f"Cell {key} `{r['tag']}`: peak {_gb(p)} GB"
                       + (f" against {_gb(pb)} GB at baseline" if pb
                          else "") + ".")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=str(OUT))
    args = ap.parse_args(argv)
    rows = [json.loads(p.read_text())
            for p in sorted(Path(args.dir).glob("*.json"))]
    text = render(rows)
    print(text, end="")
    return text


if __name__ == "__main__":
    main()
