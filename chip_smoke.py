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
             none, bf16): outputs within ``out_bound`` element by element,
             detection vectors and bad planes exactly equal, zero detections on clean input, each
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
7. kernel_b2 — the fused contiguous EFTA kernel (``efta_attention.cu``)
             against its plain PyTorch version on the same CUDA tensors:
             gpt2 prefill (H 12, D 64, Sq = Skv 64 and 512, causal, f32
             and bf16), a multi-block ragged case (block_kv 16, stride 8,
             kv_len 100, causal and not) and gemma3-1b shapes (H 4, Hkv 1,
             D 256, Skv 1024, window 512 and none, bf16 and f32); each
             clean, under each compute-site SEU in correct and in detect
             mode, with per-step output verification and with mode off.
             Outputs within ``out_bound`` element by element (f32: 1e-5 of
             the largest output; bf16: about one bf16 ulp), detection
             vectors exactly equal.
8. ring_serve — the port's ring-cache ServeEngine on gpt2 at full width in
             bf16 with attn_impl="efta_pallas" (prefill on the fused
             contiguous kernel, decode on plain-PyTorch EFTA): 8 slots,
             cache_len 1024, 16 requests of 64-512 prompt tokens, 32 new
             tokens each. Every request finishes, the kernel's launches
             equal 12 x the prefill forwards, the clean run detects
             nothing, a detect-mode run with a decode SEU in one slot
             retries and emits the clean tokens, Model.prefill under a
             kernel SEU at each site gives the clean logits; agreement with
             per-request greedy_generate is reported.
9. numbers_b2 — tokens/s and step times of the clean ring run; per-launch
             time of the kernel on the run's own prefill inputs (buckets 64
             and 512) beside its bound, its plain version and
             scaled_dot_product_attention(is_causal=True) on the same q/k/v
             (a yardstick the port never calls): CUDA events around 50
             back-to-back calls, and the profiler's device time per call.
10. ring_profile — the clean ring run under torch.profiler.

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
B2_SOURCE = "src/repro_torch/kernels/csrc/efta_attention.cu"
B2_REPLACES = "src/repro/kernels/efta_attention.py:100"


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the script's elapsed
    seconds (host clock), to show where the time limit goes."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T_START, 1))
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
    diff = (got.out.float() - ref.out.float()).abs()
    err = float(diff.max())
    ratio = float((diff / out_bound(torch, ref.out)).max())
    check(math.isfinite(err) and ratio <= 1.0,
          f"{what}: |kernel - plain| over its bound {ratio:.3f} > 1 (max "
          f"|kernel - plain| = {err:.3e})")
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


def device_ms(torch, fn, reps, name=None):
    """Device time per call from torch.profiler: the kernels' own time,
    without the host's gaps between back-to-back calls that CUDA events
    include once a kernel is shorter than its Python launch path. ``name``
    keeps only the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (name is None or name in e.key))
    return us / 1e3 / reps


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
        check(float((got.out.float() - ref.out.float()).abs().div(
            out_bound(torch, ref.out)).max()) <= 1.0,
            f"{key}: max err {err:.3e} over its bound")
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
    torch.profiler (CUDA activity only: the kernels' times are the same with
    or without the host-side events, which would cost minutes to parse),
    device time summed by kernel name over the run's wall time. Kernels run
    on one stream and do not overlap, so their sum over the wall time is the
    device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# ---------------------------------------------------------------------------
# phase 7: the fused contiguous EFTA kernel (B2) against its plain version
# ---------------------------------------------------------------------------

def seu_bit(mode: str) -> int:
    """The bit a compute-site SEU flips in an f32 tile: the top exponent
    bit (30) in correct mode. In detect mode nothing is corrected, and a
    top-bit flip of a rowsum or accumulator in [2, 4) leaves a subnormal
    that keeps only its low mantissa bits, so the uncorrected row (and
    whether its output check fires) hangs on the last bits of a sum that the
    kernel and its plain version order differently; bit 27 (a factor 2^16
    either way) keeps the struck value normal."""
    return 30 if mode == "correct" else 27


def b2_cases(torch):
    cases = []
    for S in (64, 512):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(dict(name=f"gpt2 prefill S{S} {str(dtype)[6:]}",
                              dtype=dtype, B=1, H=12, Hkv=12, D=64, Sq=S,
                              Skv=S, cfg={}, kw=dict(causal=True)))
    for causal in (True, False):
        cases.append(dict(name=f"multi-block kv_len 100 causal {causal}",
                          dtype=torch.float32, B=2, H=4, Hkv=2, D=64,
                          Sq=128, Skv=128, cfg=dict(stride=8, block_kv=16),
                          kw=dict(causal=causal, kv_len=100)))
    for dtype in (torch.bfloat16, torch.float32):
        for win in (512, None):
            cases.append(dict(name=f"gemma3-1b window {win} "
                              f"{str(dtype)[6:]}", dtype=dtype, B=1, H=4,
                              Hkv=1, D=256, Sq=1024, Skv=1024, cfg={},
                              kw=dict(causal=True, window=win)))
    return cases


def out_bound(torch, ref_out):
    """The largest difference allowed at each output element. f32: 1e-5 of
    the largest finite output. bf16: about one bf16 ulp of the element,
    2^-7 |b| + 2^-8 rms(b) — both versions round the same f32 result to
    bf16 once, and the rms term covers elements near zero."""
    b = ref_out.float()
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return torch.zeros_like(b)
    if ref_out.dtype == torch.float32:
        big = float(b[fin].abs().max())
        return torch.full_like(b, 1e-5 * max(big, 1.0))
    rms = float(b[fin].square().mean().sqrt())
    return 2.0 ** -7 * b.abs() + 2.0 ** -8 * rms


def b2_compare(torch, got, ref, what):
    """Outputs within ``out_bound`` element by element, non-finite values
    where they are, detection vectors exactly. Returns the largest absolute
    error and the largest error over its element's bound."""
    out, det = got
    ref_out, ref_det = ref
    a, b = out.float(), ref_out.float()
    fin = torch.isfinite(b)
    check(torch.equal(torch.isfinite(a), fin) and
          torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()),
          f"{what}: non-finite outputs differ")
    diff = (a[fin] - b[fin]).abs()
    bound = out_bound(torch, ref_out)[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    ratio = float((diff / bound).max()) if diff.numel() else 0.0
    check(ratio <= 1.0, f"{what}: |kernel - plain| over its bound "
          f"{ratio:.3f} > 1 (max |kernel - plain| = {err:.3e})")
    check(torch.equal(det, ref_det), f"{what}: detected {det.tolist()} != "
          f"plain {ref_det.tolist()}")
    return err, ratio


def phase_kernel_b2(torch):
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.core.fault import Site
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_torch)
    dev = torch.device(DEVICE)
    results = []
    for ci, c in enumerate(b2_cases(torch)):
        g = torch.Generator().manual_seed(200 + ci)
        q = torch.randn((c["B"], c["H"], c["Sq"], c["D"]), generator=g)
        k = torch.randn((c["B"], c["Hkv"], c["Skv"], c["D"]), generator=g)
        v = torch.randn((c["B"], c["Hkv"], c["Skv"], c["D"]), generator=g)
        q, k, v = (x.to(dev, c["dtype"]) for x in (q, k, v))

        def both(cfg, fault=None, c=c, q=q, k=k, v=v):
            got = efta_attention(q, k, v, cfg=cfg, fault=fault, **c["kw"])
            ref = efta_attention_torch(q, k, v, cfg=cfg, fault=fault,
                                       **c["kw"])
            torch.cuda.synchronize()
            return got, ref

        correct = EFTAConfig(mode="correct", **c["cfg"])
        got, ref = both(correct)
        err, worst = b2_compare(torch, got, ref, f"{c['name']} clean")
        clean_ratio = worst   # worst: the largest error over bound, any run
        check(int(got[1].sum()) == 0,
              f"{c['name']}: detections on clean input {got[1].tolist()}")
        clean = ref[0].float()
        counts = {}
        # head 1 of batch 0, the last query row, column 3 of the KV block
        # that holds the row's last visible key (a block the row attends)
        row = c["Sq"] - 1
        bkv = min(correct.block_kv, c["Skv"])
        blk = min(row, c["kw"].get("kv_len", c["Skv"]) - 1) // bkv
        for mode in ("correct", "detect"):
            cfg = EFTAConfig(mode=mode, **c["cfg"])
            for site in (Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM,
                         Site.GEMM2):
                desc = [int(site), blk, 1, row, 3, seu_bit(mode), 1, 0]
                g_f, r_f = both(cfg, desc)
                what = f"{c['name']} {site.name} {mode}"
                worst = max(worst, b2_compare(torch, g_f, r_f, what)[1])
                n = int(g_f[1].sum())
                # shadows catch every change of their value; in correct mode
                # the EXP recompute catches every flip of p, and a top-bit
                # GEMM I flip moves the score by at least 2 or to 1e6/0
                need = site in (Site.ROWMAX, Site.ROWSUM) or (
                    mode == "correct" and site in (Site.GEMM1, Site.EXP))
                check(n >= 1 or not need, f"{what}: SEU not detected")
                entry = {"detected": g_f[1].tolist()}
                if mode == "correct":
                    entry["off_clean"] = float(
                        (g_f[0].float() - clean).abs().max())
                counts[f"{site.name} {mode}"] = entry
        for name, cfg, desc in (
                ("per-step verify", EFTAConfig(unified=False, **c["cfg"]),
                 [int(Site.GEMM2), blk, 1, row, 3, 30, 1, 0]),
                ("mode off", EFTAConfig(mode="off", **c["cfg"]),
                 [int(Site.EXP), blk, 1, row, 3, 30, 1, 0])):
            g_f, r_f = both(cfg, desc)
            worst = max(worst, b2_compare(torch, g_f, r_f,
                                          f"{c['name']} {name}")[1])
            counts[name] = {"detected": g_f[1].tolist()}
        results.append({"case": c["name"], "max_abs_err": err,
                        "err_over_bound": clean_ratio,
                        "worst_err_over_bound": worst, "seu": counts})
    emit({"phase": "kernel_b2", "ok": True, "cases": results})
    return max(r["max_abs_err"] for r in results)


# ---------------------------------------------------------------------------
# phase 8: the ring-cache ServeEngine at gpt2 full width (prefill on B2)
# ---------------------------------------------------------------------------

def ring_model(torch, mode="correct", impl="efta_pallas"):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, ft=dataclasses.replace(
        cfg.ft, attn_impl=impl, mode=mode))
    return build_model(cfg, device=DEVICE)


class B2Recorder:
    """Keeps copies of layer 0's fused-kernel inputs at the prefill buckets
    the numbers phase times."""

    def __init__(self, buckets):
        import repro_torch.kernels.ops as ops_mod
        self.captured = {}
        orig = ops_mod.efta_attention_rows
        seen = set()

        def rows(q, k, v, **kw):
            sq = q.shape[2]
            if sq in buckets and sq not in seen:
                seen.add(sq)
                self.captured[sq] = {"q": q.clone(), "k": k.clone(),
                                     "v": v.clone(), "kw": dict(kw)}
            return orig(q, k, v, **kw)

        ops_mod.efta_attention_rows = rows
        self.restore = lambda: setattr(ops_mod, "efta_attention_rows", orig)


def ring_run(torch, np, model, params, prompts, *, n_new, faults=None):
    from repro_torch.kernels.efta_attention import efta_attention
    from repro_torch.kernels.efta_paged import efta_paged_attention
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, n_slots=8, cache_len=1024)
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    efta_attention.launches = 0
    efta_paged_attention.launches = 0
    step_ms = []
    i = 0
    t_start = time.perf_counter()
    while eng.scheduler.has_work:
        t0 = time.perf_counter()
        eng.step(faults=(faults or {}).get(i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        i += 1
    wall = time.perf_counter() - t_start
    outs = {r.rid: np.asarray(r.generated, np.int32)
            for r in eng.scheduler.finished}
    return dict(eng=eng, outs=outs, step_ms=step_ms, wall=wall,
                launches=efta_attention.launches,
                paged_launches=efta_paged_attention.launches)


def phase_ring_serve(torch, np, serve, seed):
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.serve import batch_faults, greedy_generate
    params = serve["params"]
    model = ring_model(torch)
    cfg = model.cfg
    L = cfg.num_layers
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(64, 513, 16)
    lens[0], lens[-1] = 64, 512     # the buckets phase 9 times
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    n_new = 32
    rec = B2Recorder({64, 512})
    clean = ring_run(torch, np, model, params, prompts, n_new=n_new)
    rec.restore()
    # a decode SEU in slot 3 at step 5 (EXP, top exponent bit, every
    # layer), in detect mode: detected, the step retried, tokens unchanged
    spec = FaultSpec.single(Site.EXP, block=0, head=1, row=0, col=3, bit=30)
    faulted = ring_run(torch, np, ring_model(torch, mode="detect"), params,
                       prompts, n_new=n_new,
                       faults={5: batch_faults(8, {3: spec})})
    for tag, run in (("clean", clean), ("faulted", faulted)):
        eng = run["eng"]
        check(len(run["outs"]) == 16 and all(
            len(t) == n_new for t in run["outs"].values()),
            f"ring {tag}: not every request finished")
        check(run["launches"] > 0 and
              run["launches"] == L * eng.stats.prefill_forwards,
              f"ring {tag}: {run['launches']} B2 launches for "
              f"{eng.stats.prefill_forwards} prefill forwards")
        check(run["paged_launches"] == 0, f"ring {tag}: B1 launched")
    ce, fe = clean["eng"], faulted["eng"]
    check(ce.telemetry.summary()["detected"] == 0,
          f"ring clean run detected faults: {ce.telemetry.summary()}")
    struck = {rid: st.detected for rid, st in fe.telemetry.requests.items()
              if sum(st.detected)}
    check(len(struck) == 1 and fe.stats.retries >= 1,
          f"ring faulted run: detections {struck}, retries "
          f"{fe.stats.retries}")
    for rid in sorted(clean["outs"]):
        a, b = clean["outs"][rid], faulted["outs"][rid]
        check(np.array_equal(a, b), f"ring faulted run's tokens differ for "
              f"request {rid}")

    # Model.prefill of the 512-token prompt under a B2 SEU at each site
    toks = torch.as_tensor(prompts[-1][None], device=DEVICE).long()
    base, rep0, _ = model.prefill(params, toks, model.init_cache(
        1, cache_len=1024))
    check(int(rep0.detected.sum()) == 0, "prefill: clean detections")
    prefill_seu = {}
    for site in (Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM,
                 Site.GEMM2):
        f = FaultSpec.single(site, block=0, head=1, row=511, col=3, bit=30)
        got, rep, _ = model.prefill(params, toks, model.init_cache(
            1, cache_len=1024), fault=f)
        diff = float((got - base).abs().max())
        same_top = bool(torch.equal(got.argmax(-1), base.argmax(-1)))
        # shadows and the EXP recompute restore bit for bit; GEMM SEUs are
        # undone by checksum arithmetic, within its rounding
        if site in (Site.ROWMAX, Site.EXP, Site.ROWSUM):
            check(torch.equal(got, base) and int(rep.detected.sum()) >= 1,
                  f"prefill {site.name}: logits off the clean ones by "
                  f"{diff:.3e}, detected {rep.detected.tolist()}")
        else:
            check(same_top and diff <= 2e-2 * float(base.abs().max()),
                  f"prefill {site.name}: logits off the clean ones by "
                  f"{diff:.3e}")
        prefill_seu[site.name] = {"detected": rep.detected[0].tolist(),
                                  "max_abs_logit_diff": diff,
                                  "same_argmax": same_top}

    # per-request greedy_generate, reported: cuBLAS may round the batch of 8
    # and the batch of 1 differently. The oracle prefills unpadded prompts,
    # which the fused kernel refuses at most lengths, so it runs on efta.
    oracle = ring_model(torch, impl="efta")
    agree = 0
    for rid, p in enumerate(prompts):
        toks_r, _ = greedy_generate(
            oracle, params, torch.as_tensor(p[None], device=DEVICE).long(),
            steps=n_new, cache_len=1024)
        agree += bool(np.array_equal(toks_r[0].cpu().numpy(),
                                     clean["outs"][rid]))
    tokens = sum(len(t) for t in clean["outs"].values())
    emit({"phase": "ring_serve", "ok": True, "arch": cfg.name,
          "attn_impl": cfg.ft.attn_impl, "requests": 16, "tokens": tokens,
          "steps": ce.stats.steps, "prefill_forwards":
          ce.stats.prefill_forwards, "b2_launches": clean["launches"],
          "faulted_detected": struck, "faulted_retries": fe.stats.retries,
          "faulted_b2_launches": faulted["launches"],
          "prefill_seu": prefill_seu,
          "greedy_generate_agree": f"{agree}/16"})
    return dict(clean=clean, captured=rec.captured, tokens=tokens,
                model=model, params=params, prompts=prompts, n_new=n_new)


# ---------------------------------------------------------------------------
# phase 9: numbers of B2 and of the ring serve run
# ---------------------------------------------------------------------------

def b2_work(cap):
    """Bytes the launch must move (q, k, v read once, out written once) and
    the operations the causal attention needs on these inputs: QK^T and PV
    over the visible (row, key) pairs, 2 flops per multiply-add."""
    q, k = cap["q"], cap["k"]
    B, H, S, D = q.shape
    elt = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * elt
    pairs = S * (S + 1) // 2
    return nbytes, B * H * pairs * 4 * D


def phase_numbers_b2(torch, np, ring, max_err):
    import torch.nn.functional as F
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_torch)
    clean = ring["clean"]
    step_ms = sorted(clean["step_ms"])
    per = {}
    for S in (64, 512):
        cap = ring["captured"][S]

        def run(fn, cap=cap):
            return fn(cap["q"], cap["k"], cap["v"], **cap["kw"])

        got, ref = run(efta_attention), run(efta_attention_torch)
        torch.cuda.synchronize()
        err, _ = b2_compare(torch, got, ref, f"B2 bucket {S}")
        ms = time_ms(torch, lambda: run(efta_attention), reps=50)
        plain_ms = time_ms(torch, lambda: run(efta_attention_torch), reps=3,
                           warmup=1)
        grp = cap["q"].shape[1] // cap["k"].shape[1]
        qc, kc, vc = (cap[x].repeat_interleave(1 if x == "q" else grp, dim=1)
                      .contiguous() for x in ("q", "k", "v"))
        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)

        lib_ms = time_ms(torch, sdpa, reps=50)
        dev_ms = device_ms(torch, lambda: run(efta_attention), 20,
                           name="efta_attention_kernel")
        lib_dev_ms = device_ms(torch, sdpa, 20)
        nbytes, flops = b2_work(cap)
        peak = PEAK_FLOPS[str(cap["q"].dtype)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        per[S] = {"shape": list(cap["q"].shape), "ms": ms,
                  "device_ms": dev_ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes": nbytes, "flops": flops, "max_abs_err": err}
    emit({"phase": "numbers_b2", "tokens_per_s": ring["tokens"] /
          clean["wall"], "wall_s": clean["wall"], "steps": len(step_ms),
          "step_ms_median": statistics.median(step_ms),
          "step_ms_p90": step_ms[int(0.9 * (len(step_ms) - 1))],
          "b2_launches": clean["launches"], "kernel": per})
    d = per[512]
    return {
        "name": "efta_attention", "route": "cuda", "source": B2_SOURCE,
        "replaces": B2_REPLACES, "launches": clean["launches"],
        "max_abs_err": max(max_err, per[64]["max_abs_err"],
                           per[512]["max_abs_err"]),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"],
        "device_ms": d["device_ms"],
        "library_device_ms": d["library_device_ms"],
        "shape": "ring prefill, bucket 512",
        "bucket_64": {k: per[64][k] for k in
                      ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "library_device_ms")},
    }


def phase_ring_profile(torch, np, ring):
    """The clean ring run again under torch.profiler: device time by kernel
    group over the run's wall time (the device's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = ring_run(torch, np, ring["model"], ring["params"],
                       ring["prompts"], n_new=ring["n_new"])
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kern)
    groups = {"efta_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        name = e.key.lower()
        g = ("efta_attention" if "efta_attention" in name else
             "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass",
                                               "cublas")) else "other")
        groups[g] += e.self_device_time_total
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "ring_profile", "wall_ms": run["wall"] * 1e3,
          "unprofiled_wall_ms": ring["clean"]["wall"] * 1e3,
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
    max_err_b2 = phase_kernel_b2(torch)
    ring = phase_ring_serve(torch, np, serve, args.seed)
    entry_b2 = phase_numbers_b2(torch, np, ring, max_err_b2)
    phase_ring_profile(torch, np, ring)
    emit({"kernels": [entry, entry_b2]})   # the line before the last
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
