#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi); TF32 off.
2. build   — every ``src/repro_torch/kernels/csrc/*.cu`` compiled with nvcc
             for sm_90a, one process per source, all started together.
3. kernel  — the fused paged EFTA kernel (``efta_paged.cu``) against its
             plain PyTorch version on the same CUDA tensors, at gpt2 shapes
             (B 8, H 12, D 64, C 1 and 64, f32 and bf16) and gemma3-1b
             attention shapes (H 4, Hkv 1, D 256, C 64, window 512 and
             none, bf16): outputs within tolerance, detection vectors and
             bad planes exactly equal, zero detections on clean input, each
             compute-site SEU and a resident KV flip detected alike and
             corrected back to the clean output.
4. serve   — the port's PagedServeEngine(kernel="fused") on gpt2 at full
             width in bf16 with random weights from the seed: 8 slots, 16
             requests of 64-512 prompt tokens, 32 new tokens each. Every
             request finishes, the kernel's launch counter equals 12 x the
             forward passes, the clean run detects nothing, and a second run
             with one compute SEU and one resident KV flip detects, repairs
             or retries both and emits the clean run's tokens.
5. numbers — tokens/s and step times of the clean run; per-launch time of
             the kernel at the serve run's decode (C 1) and prefill (C 64)
             inputs beside its bound, its plain version and
             scaled_dot_product_attention on a contiguous copy (a yardstick
             the port never calls).
6. profile — the clean run again under torch.profiler: device time by
             kernel group and the device's busy share of the wall time.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises: the script exits non-zero and prints no result line.
It exits non-zero as well where no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
DEVICE = "cuda"
ARCH = "gpt2"                    # the paper's Table 3 model, full width
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/efta_paged.cu"
KERNEL_REPLACES = "src/repro/kernels/efta_paged.py:100"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise CheckFailed(msg)


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    procs = [_build.start_build(name, extra=["-Xptxas", "-v"])
             for name in _build.sources()]
    logs = {p.repro_name: _build.finish_build(p) for p in procs}
    dt = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(dt, 3), "sources": sorted(logs),
          "ptxas": regs})


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version on the card
# ---------------------------------------------------------------------------

def top_exponent_bit(t) -> int:
    """The highest exponent bit of ``t``'s storage type (14 in bf16, 30 in
    f32). Setting it scales a value below 2 by 2^128 (bf16 has f32's
    exponent range), so the resident block verify must flag it; a flip that
    shrinks a small value can stay under the verify's relative threshold
    (see ROADMAP.md, Queue C)."""
    return 14 if t.element_size() == 2 else 30


def make_case(torch, cks, *, dtype, B, H, Hkv, D, C, seed, bs=16, mb=64,
              max_kv=1024):
    g = torch.Generator().manual_seed(seed)
    kv_lens = torch.randint(max(C, 1), max_kv + 1, (B,), generator=g)
    q_lens = torch.full((B,), C, dtype=torch.long)
    if C > 1:
        q_lens[0] = C // 2          # ragged chunk
        q_lens[-1] = 0              # idle slot: streamed, verified, no rows
    need = [-(-int(t) // bs) for t in kv_lens]
    nb = sum(need) + 3
    ids = torch.randperm(nb, generator=g) + 1   # fragmented tables
    bt = torch.zeros((B, mb), dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[used:used + n].int()
        used += n
    k = torch.randn((nb + 1, Hkv, bs, D), generator=g)
    v = torch.randn((nb + 1, Hkv, bs, D), generator=g)
    q = torch.randn((B, H, C, D), generator=g)
    dev = torch.device(DEVICE)
    k, v, q = (x.to(dev, dtype) for x in (k, v, q))
    return dict(q=q, k=k, v=v, kc=cks.encode_kv(k, 8),
                vc=cks.encode_kv(v, 8), bt=bt.to(dev),
                kv_lens=kv_lens.int().to(dev), q_lens=q_lens.int().to(dev))


def call(fn, case, cfg, **kw):
    return fn(case["q"], case["k"], case["v"], case["kc"], case["vc"],
              case["bt"], case["kv_lens"], case["q_lens"], cfg=cfg, **kw)


def out_tol(torch, ref_out):
    if ref_out.dtype == torch.float32:
        return 1e-4           # f32: only the summation order differs
    # bf16 keeps ~3 digits and both versions round p to bf16 before GEMM II
    return 2e-2 * float(ref_out.float().abs().max())


def compare(torch, got, ref, what):
    tol = out_tol(torch, ref.out)
    err = float((got.out.float() - ref.out.float()).abs().max())
    check(math.isfinite(err) and err <= tol,
          f"{what}: max |kernel - plain| = {err:.3e} > {tol:.3e}")
    check(torch.equal(got.detected, ref.detected),
          f"{what}: detected {got.detected.tolist()} != plain "
          f"{ref.detected.tolist()}")
    check(torch.equal(got.bad_blocks, ref.bad_blocks),
          f"{what}: bad plane differs from the plain version")
    return err


def phase_kernel(torch):
    from repro_torch.core import checksum as cks
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (NO_WINDOW,
                                                efta_paged_attention,
                                                efta_paged_attention_torch)
    # the engine's EFTAConfig at block 16: s_kv 4, s_out D // 16
    cfg = EFTAConfig(mode="correct", stride=128, block_kv=512)
    shapes = []
    for dtype in (torch.float32, torch.bfloat16):
        for C in (1, 64):
            shapes.append(dict(name=f"gpt2 C{C} {str(dtype)[6:]}",
                               dtype=dtype, B=8, H=12, Hkv=12, D=64, C=C,
                               window=None))
    for win in (512, NO_WINDOW):
        shapes.append(dict(name=f"gemma3-1b C64 window {win}",
                           dtype=torch.bfloat16, B=8, H=4, Hkv=1, D=256,
                           C=64, window=win))
    results = []
    for si, sh in enumerate(shapes):
        case = make_case(torch, cks, seed=100 + si, **{
            k: sh[k] for k in ("dtype", "B", "H", "Hkv", "D", "C")})
        kw = {"window": sh["window"]}
        got = call(efta_paged_attention, case, cfg, **kw)
        ref = call(efta_paged_attention_torch, case, cfg, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, ref, f"{sh['name']} clean")
        check(int(got.detected.sum()) == 0 and not bool(got.bad_blocks.any()),
              f"{sh['name']}: detections on clean input "
              f"{got.detected.tolist()}")
        clean_out = ref.out
        tol = out_tol(torch, clean_out)
        eps_out = cfg.thresholds(sh["dtype"])[2]
        b, h = 1, min(1, sh["Hkv"] - 1)
        base = int(case["kv_lens"][b]) - int(case["q_lens"][b])
        j = base // 16              # the block holding chunk row 0
        site_counts = {}
        for site in (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM,
                     Site.GEMM2):
            desc = [int(site), j, b, h, 0, 3, 27, 1]
            got_f = call(efta_paged_attention, case, cfg, fault=desc, **kw)
            ref_f = call(efta_paged_attention_torch, case, cfg, fault=desc,
                         **kw)
            compare(torch, got_f, ref_f, f"{sh['name']} {site.name}")
            n = int(got_f.detected[b, :5].sum())
            # the shadows and the exact EXP recompute catch every flip at
            # their sites; a GEMM flip whose effect stays under the ABFT
            # threshold (e.g. an output the NVR clamp zeroes while it was
            # below eps_out) may go uncounted, leaving an error < eps
            check(n >= 1 or site in (Site.GEMM1, Site.GEMM2),
                  f"{sh['name']} {site.name}: SEU not detected")
            fix = float((got_f.out.float() - clean_out.float()).abs().max())
            fix_tol = max(tol, eps_out)
            check(fix <= fix_tol, f"{sh['name']} {site.name}: corrected "
                  f"output off the clean output by {fix:.3e} > "
                  f"{fix_tol:.3e}")
            site_counts[site.name] = got_f.detected[b].tolist()
        # a resident flip in the block holding request 2's last token
        b2 = 2
        jl = (int(case["kv_lens"][b2]) - 1) // 16
        blk = int(case["bt"][b2, jl])
        kf = case["k"].clone()
        hkv, bs, d = kf.shape[1:]
        flip_bit_at(kf, ((blk * hkv + 0) * bs + 0) * d + 1,
                    top_exponent_bit(kf))
        flipped = dict(case, k=kf)
        got_k = call(efta_paged_attention, flipped, cfg, **kw)
        ref_k = call(efta_paged_attention_torch, flipped, cfg, **kw)
        compare(torch, got_k, ref_k, f"{sh['name']} resident flip")
        check(bool(got_k.bad_blocks[b2, jl]) and
              int(got_k.bad_blocks.sum()) == 1 and
              int(got_k.detected[b2, 5]) >= 1,
              f"{sh['name']}: resident flip not flagged at its block")
        results.append({"shape": sh["name"], "max_abs_err": err,
                        "tol": tol, "seu_counts": site_counts,
                        "kv_flip_det": got_k.detected[b2].tolist()})
    emit({"phase": "kernel", "ok": True, "cases": results})
    return max(r["max_abs_err"] for r in results)


# ---------------------------------------------------------------------------
# phase 4: the port's main path end to end
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps ``Model.score`` to keep, per slot, the top-2 logit margin at
    the row each slot samples from, and captures the kernel's inputs at one
    decode and one prefill launch of layer 0 for phase 5."""

    def __init__(self, torch, model, attn_mod):
        self.torch = torch
        self.margins = None
        self.captured = {}
        orig_score = model.score
        orig_kernel = attn_mod.efta_paged_attention

        def score(params, tokens, cache, fault=None):
            out = orig_score(params, tokens, cache, fault=fault)
            logits = out[0]
            idx = (cache.q_len.long() - 1).clamp(min=0)
            rows = logits[torch.arange(logits.shape[0],
                                       device=logits.device), idx]
            top2 = rows.topk(2, dim=-1).values
            self.margins = (top2[:, 0] - top2[:, 1]).tolist()
            return out

        def kernel(q, k_pool, *args, **kw):
            c = q.shape[2]
            key = "decode" if c == 1 else "prefill"
            load = int(args[5].sum())          # sum of q_lens
            if key not in self.captured or \
                    load >= self.captured[key]["load"]:
                # pools by reference (same shapes later), the rest copied
                self.captured[key] = {
                    "load": load, "q": q.clone(), "k": k_pool,
                    "args": list(args[:3]) + [a.clone() for a in args[3:]],
                    "kw": dict(kw)}
            return orig_kernel(q, k_pool, *args, **kw)

        model.score = score
        self.restore = lambda: (setattr(attn_mod, "efta_paged_attention",
                                        orig_kernel),
                                model.__dict__.pop("score", None))
        attn_mod.efta_paged_attention = kernel


def serve_run(torch, np, model, params, prompts, *, n_new, faulted, seed):
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.kernels.efta_paged import efta_paged_attention
    from repro_torch.serve import PagedServeEngine, batch_faults
    eng = PagedServeEngine(model, params, n_slots=8, block_size=16,
                           chunk_size=64, chunk_budget=256, kernel="fused")
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    rng = np.random.default_rng(seed + 7)
    seu_step, kv_step = 2, 9
    faults = {}
    if faulted:
        # an EXP SEU on slot 0's chunk in a prefill step, striking every
        # layer: the checksum-reuse check or the exact recompute catches it
        # in each, and correction restores p bit for bit
        faults[seu_step] = batch_faults(8, {0: FaultSpec.single(
            Site.EXP, block=0, head=1, row=0, col=3, bit=27)})
    origin = {}
    step_ms = []
    efta_paged_attention.launches = 0
    i = 0
    t_start = time.perf_counter()
    while eng.scheduler.has_work:
        if faulted and i == kv_step:
            live = [r for r in eng.scheduler.active_rows()
                    if not r.is_done() and eng._pos[r.slot] > 16]
            check(live, "no live request to strike with a KV flip")
            req = live[int(rng.integers(0, len(live)))]
            eng.inject_kv_fault(layer=5, block=req.block_ids[0], head=3,
                                row=2, col=7,
                                bit=top_exponent_bit(eng.pool.state.k),
                                into="k")
        before = {r.rid: (r.num_generated, r.slot)
                  for r in eng.scheduler.active_rows()}
        t0 = time.perf_counter()
        eng.step(faults=faults.get(i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        margins = model.recorder.margins
        for r in eng.scheduler.active_rows() + list(eng.scheduler.finished):
            if r.rid in before and r.num_generated > before[r.rid][0]:
                slot = before[r.rid][1]
                origin[(r.rid, r.num_generated - 1)] = (
                    i, slot, None if margins is None else margins[slot])
        i += 1
    wall = time.perf_counter() - t_start
    outs = {r.rid: np.asarray(r.generated, np.int32)
            for r in eng.scheduler.finished}
    return dict(eng=eng, outs=outs, origin=origin, step_ms=step_ms,
                wall=wall, launches=efta_paged_attention.launches)


def phase_serve(torch, np, seed):
    import repro_torch.models.attention as attn_mod
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(ARCH)
    check(ARCH != "gpt2" or (cfg.d_model == 768 and cfg.num_layers == 12
                             and cfg.vocab_size == 50257
                             and cfg.dtype == "bfloat16"),
          "gpt2 is not at full width")
    model = build_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    params = model.init(gen)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            (int(rng.integers(64, 513)),)).astype(np.int32)
               for _ in range(16)]
    n_new = 32
    model.recorder = Recorder(torch, model, attn_mod)
    clean = serve_run(torch, np, model, params, prompts, n_new=n_new,
                      faulted=False, seed=seed)
    captured = model.recorder.captured
    model.recorder.captured = {}
    faulted = serve_run(torch, np, model, params, prompts, n_new=n_new,
                        faulted=True, seed=seed)
    model.recorder.restore()
    L = cfg.num_layers
    for tag, run in (("clean", clean), ("faulted", faulted)):
        eng = run["eng"]
        check(len(run["outs"]) == 16 and all(
            len(t) == n_new for t in run["outs"].values()),
            f"{tag}: not every request finished")
        check(run["launches"] > 0 and
              run["launches"] == L * eng.stats.forwards,
              f"{tag}: {run['launches']} kernel launches for "
              f"{eng.stats.forwards} forward passes")
        check(eng.chunk_widths <= {1, 64}, f"{tag}: chunk widths "
              f"{sorted(eng.chunk_widths)}")
    ce, fe = clean["eng"], faulted["eng"]
    check(ce.telemetry.summary()["detected"] == 0 and
          ce.paged_stats.kv_detected_blocks == 0,
          f"clean run detected faults: {ce.telemetry.summary()}")
    det = [0] * 6
    for st in fe.telemetry.requests.values():
        det = [a + b for a, b in zip(det, st.detected)]
    check(sum(det[:5]) >= 1, f"compute SEU not detected: {det}")
    check(fe.paged_stats.kv_detected_blocks >= 1 and
          fe.paged_stats.kv_repaired_blocks >= 1,
          f"KV flip not detected and repaired: {fe.paged_stats}")
    for rid in sorted(clean["outs"]):
        a, b = clean["outs"][rid], faulted["outs"][rid]
        if not np.array_equal(a, b):
            i = int(np.flatnonzero(a != b)[0])
            step, slot, margin = clean["origin"].get((rid, i),
                                                     (None, None, None))
            raise CheckFailed(
                f"faulted run's tokens differ: request {rid} token {i} "
                f"(clean step {step}, slot {slot}, clean top-2 logit margin "
                f"{margin}); clean {a[i]} vs faulted {b[i]}")
    tokens = sum(len(t) for t in clean["outs"].values())
    emit({"phase": "serve", "ok": True, "arch": cfg.name,
          "requests": 16, "tokens": tokens,
          "steps": ce.stats.steps, "forwards": ce.stats.forwards,
          "launches": clean["launches"],
          "chunk_widths": sorted(ce.chunk_widths),
          "faulted_detected": det, "faulted_retries": fe.stats.retries,
          "kv_detected_blocks": fe.paged_stats.kv_detected_blocks,
          "kv_repaired_blocks": fe.paged_stats.kv_repaired_blocks,
          "faulted_forwards": fe.stats.forwards})
    return dict(clean=clean, captured=captured, tokens=tokens, model=model,
                params=params, prompts=prompts, n_new=n_new)


# ---------------------------------------------------------------------------
# phase 5: numbers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_work(torch, cap):
    """Bytes the launch must move (each input read once, each output written
    once) and the operations it does, counted for these inputs: only the KV
    blocks the ragged lengths make it stream."""
    q, k_pool = cap["q"], cap["k"]
    k_checks, v_checks, bt, kv_lens, q_lens = cap["args"][1:6]
    B, H, C, D = q.shape
    _, hkv, bs, _ = k_pool.shape
    cs = k_checks.c1.shape[-2]
    win = cap["kw"].get("window")
    win = 1 << 30 if win is None else int(win)
    elt = k_pool.element_size()
    kvl, ql = kv_lens.tolist(), q_lens.tolist()
    blocks = rows_blocks = 0
    for b in range(B):
        base = kvl[b] - ql[b]
        n = sum(1 for j in range(bt.shape[1])
                if j * bs < kvl[b] and base - (j * bs + bs - 1) < win)
        blocks += n
        rows_blocks += n * (H // hkv) * ql[b]
    nbytes = (blocks * hkv * (2 * bs * D + 4 * cs * D) * elt   # K V planes
              + 2 * q.numel() * elt                             # q in, out
              + bt.numel() * 4 + 2 * B * 4 + B * 6 * 4)
    # GEMM I + GEMM II over the valid rows (2 flops per multiply-add)
    flops = hkv * rows_blocks * 4 * bs * D
    return nbytes, flops


def library_call(torch, cap):
    """scaled_dot_product_attention on a contiguous copy of the same K/V
    (set-up, not timed): each request's blocks gathered, padded to the
    longest, with the same causal-in-chunk + ragged mask."""
    import torch.nn.functional as F
    q, k_pool = cap["q"], cap["k"]
    v_pool, _, _, bt, kv_lens, q_lens = cap["args"][:6]
    B, H, C, D = q.shape
    _, hkv, bs, _ = k_pool.shape
    L = int(kv_lens.max())
    nbl = -(-L // bs)
    idx = bt[:, :nbl].long()
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, nbl * bs, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, nbl * bs, D)
    k = k.repeat_interleave(H // hkv, dim=1).contiguous()
    v = v.repeat_interleave(H // hkv, dim=1).contiguous()
    pos = (kv_lens - q_lens).long()[:, None] + torch.arange(C, device=q.device)
    cols = torch.arange(nbl * bs, device=q.device)
    mask = (cols[None, None, :] <= pos[:, :, None])[:, None]
    qc = q.contiguous()
    return lambda: F.scaled_dot_product_attention(qc, k, v, attn_mask=mask)


def phase_numbers(torch, serve, max_err_phase3):
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)
    clean = serve["clean"]
    step_ms = sorted(clean["step_ms"])
    per = {}
    for key in ("decode", "prefill"):
        cap = serve["captured"][key]

        def run(fn, cap=cap):
            return fn(cap["q"], cap["k"], *cap["args"], **cap["kw"])

        got, ref = run(efta_paged_attention), run(efta_paged_attention_torch)
        torch.cuda.synchronize()
        err = float((got.out.float() - ref.out.float()).abs().max())
        check(torch.equal(got.detected, ref.detected),
              f"{key}: kernel and plain counts differ on main-path inputs")
        check(err <= out_tol(torch, ref.out), f"{key}: max err {err:.3e}")
        ms = time_ms(torch, lambda: run(efta_paged_attention), reps=50)
        plain_ms = time_ms(torch, lambda: run(efta_paged_attention_torch),
                           reps=3, warmup=1)
        lib = library_call(torch, cap)
        lib_ms = time_ms(torch, lib, reps=50)
        nbytes, flops = launch_work(torch, cap)
        peak = PEAK_FLOPS[str(cap["q"].dtype)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        per[key] = {
            "shape": list(cap["q"].shape), "q_lens_sum": cap["load"],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "max_abs_err": err}
    tok_s = serve["tokens"] / clean["wall"]
    emit({"phase": "numbers", "tokens_per_s": tok_s,
          "wall_s": clean["wall"], "steps": len(step_ms),
          "step_ms_median": statistics.median(step_ms),
          "step_ms_p90": step_ms[int(0.9 * (len(step_ms) - 1))],
          "kernel": per})
    d = per["decode"]
    return {
        "name": "efta_paged", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": clean["launches"],
        "max_abs_err": max(d["max_abs_err"], per["prefill"]["max_abs_err"],
                           max_err_phase3),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "shape": "serve decode, C 1",
        "prefill": {k: per["prefill"][k] for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
    }


def phase_profile(torch, np, serve, seed):
    """Where the clean serve run's time goes: the same run again under
    torch.profiler (CUDA activity), device time summed by kernel name over
    the run's wall time. Kernels run on one stream and do not overlap, so
    their sum over the wall time is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve_run(torch, np, serve["model"], serve["params"],
                        serve["prompts"], n_new=serve["n_new"],
                        faulted=False, seed=seed)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kern)
    groups = {"efta_paged": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        name = e.key.lower()
        g = ("efta_paged" if "efta_paged" in name else
             "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass",
                                               "cublas")) else "other")
        groups[g] += e.self_device_time_total
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "wall_ms": run["wall"] * 1e3,
          "device_ms": total_us / 1e3,
          "device_busy_share": total_us / 1e3 / (run["wall"] * 1e3),
          "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
          "kernel_launches": sum(e.count for e in kern),
          "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total
                           / 1e3, "count": e.count} for e in top]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    phase_device(torch)
    phase_build()
    max_err = phase_kernel(torch)
    serve = phase_serve(torch, np, args.seed)
    entry = phase_numbers(torch, serve, max_err)
    phase_profile(torch, np, serve, args.seed)
    emit({"kernels": [entry]})             # the line before the last
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
