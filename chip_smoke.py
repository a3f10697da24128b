#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
        [--only dist,vlm,train,dryrun,b2_wide,examples,b2_narrow,b1_chunk,
                b1_decode,b1_long]

Run from the root of a checkout. Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi); TF32 off.
2. build   — every ``src/repro_torch/kernels/csrc/*.cu`` compiled with nvcc
             for sm_90a, one process per source, all started together.
3. kernel  — the fused paged EFTA kernel (``efta_paged.cu``) against its
             plain PyTorch version on the same CUDA tensors, at gpt2 shapes
             (B 8, H 12, D 64, C 1 and 64, f32 and bf16) and gemma3-1b
             attention shapes (H 4, Hkv 1, D 256, C 64, window 512 and
             none, bf16), plus decode at grp 4 (gemma3-1b, C 1), a C 64
             step with decode rows, and requests that fill the 64-block
             table, each on the layout its rule gives it (C 1 on the
             decode layout; C 64 on the tile layout in bf16 up to D 128,
             else the first): outputs within ``out_bound`` element by
             element,
             detection vectors and bad planes exactly equal, zero detections
             on clean input, each compute-site SEU and a resident KV flip
             detected alike and corrected back to the clean output. Clean,
             the kernel also matches the plain version with its KV walk
             split over 4 warps and merged (``_paged_split_torch``).
4. serve   — the port's PagedServeEngine(kernel="fused") on gpt2 at full
             width in bf16 with random weights from the seed: 8 slots, 16
             requests of 64-512 prompt tokens, 32 new tokens each. Every
             request finishes, the kernel's launch counter equals 12 x the
             forward passes, every C 1 launch takes the decode layout, the
             clean run detects nothing, and a second run
             with one compute SEU and one resident KV flip detects, repairs
             or retries both and emits the clean run's tokens.
5. numbers — tokens/s and step times of the clean run; per-launch time of
             the kernel at the serve run's decode (C 1) and prefill (C 64)
             inputs beside its bound, its plain version and
             scaled_dot_product_attention on a contiguous copy (a yardstick
             the port never calls): CUDA events around 50 back-to-back calls,
             and the profiler's device time per call of both.
6. profile — the clean run's prompts again, ``PROFILED_NEW`` new tokens
             each, under torch.profiler: device time by
             kernel group and the device's busy share of the wall time.
7. kernel_b2 — the fused contiguous EFTA kernel (``efta_attention.cu``)
             against its plain PyTorch version on the same CUDA tensors:
             gpt2 prefill (H 12, D 64, Sq = Skv 64 and 512, causal, f32
             and bf16), a multi-block ragged case (block_kv 16, stride 8,
             kv_len 100, causal and not) and gemma3-1b shapes (H 4, Hkv 1,
             D 256, Skv 1024, window 512 and none, bf16 and f32); each
             clean, under each compute-site SEU in correct and in detect
             mode, with per-step output verification and with mode off;
             the bf16 bucket 512 at 64 rows a CTA (the tile layout, held
             to ``out_bound`` plus ``p_rounding_slack``) and, as both bf16
             buckets and gemma3-1b window 512, at 32 and at 16 rows (2 and
             1 groups of 4 warps) per thread block (the narrow layout).
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
             per-request greedy_generate is reported for the first 4.
9. numbers_b2 — tokens/s and step times of the clean ring run; per-launch
             time of the kernel on the run's own prefill inputs (buckets 64
             and 512) beside its bound, its plain version and
             scaled_dot_product_attention(is_causal=True) on the same q/k/v
             (a yardstick the port never calls): CUDA events around 50
             back-to-back calls, and the profiler's device time per call,
             with thread blocks of 32 and of 16 rows; the kernel against
             its plain version on those inputs, clean and under each
             compute-site SEU.
10. ring_profile — the clean ring run's prompts, ``PROFILED_NEW`` new
             tokens each, under torch.profiler.
11. spec_serve — speculative decoding on the fused backend: the n-gram
             proposer at K 4, 8 slots, 16 requests of 64-512 tokens (half a
             tiled 3-token pattern, half random), 32 new tokens, greedy, in
             f32 (the config's dtype replaced) and in bf16. B1 launches 12 x
             the forward passes with chunk widths 64 and 1; the f32 tokens
             equal the plain fused run's except at near ties (the plain
             run's top-2 gap under 1e-4 of max|logit| at the first
             differing token); the bf16 share of equal tokens is reported.
             Each dtype's faulted twin (EXP SEUs until one lands on a
             speculating slot's scoring row, a resident flip, a flip
             between the scoring step and the KV rollback through
             ``_pre_rollback_hook``) detects and repairs all three and
             emits its clean twin's tokens exactly.
12. draft_serve — the draft-model proposer in f32: a self-draft on 4
             requests x 16 tokens (acceptance > 0.9) and a cold draft on
             2 x 8 (rolled-back rows > 0), tokens as the plain run's under
             the near-tie rule.
13. gather_serve — the gather backend in f32 on the first 8 of phase 4's
             prompts (``GATHER_REQUESTS``; 16 before PR 21): under
             kv_verify "always" its tokens equal a fused f32 run's (near
             ties aside); a resident flip under "always", and one in the
             block the scrub folds next under "stamped" with a scrub every
             4 steps, are detected and repaired with the clean tokens;
             stamped verification skips folds. No kernel launches there.

14. abft_linear — ``tensor_abft_matmul`` and ``abft_matmul`` at gpt2's
             projection shapes (x 4096 x 768 against 768 x 768, 768 x 3072;
             4096 x 3072 against 3072 x 768), bf16 and f32: clean they
             detect nothing and give the plain projection within one bf16
             ulp (f32: 1e-5 of the largest); a GEMM1 SEU at the top
             exponent bit of the largest output is detected once and
             repaired (the classic rank-1 check in bf16 is reported, not
             held: see the phase); device time of both against the plain
             product.
15. ff_abft_serve — phase 4's fused paged run with ``ff_abft`` off and on,
             f32 and bf16: f32 tokens equal (near ties aside), B1 12 per
             forward, tokens/s of both.
16. encoder — bert-large at full width (24 layers, d_model 1024, 16 heads),
             ``Model.logits`` on B 8, S 512 under ``efta_pallas`` (B2
             non-causal, 24 launches): logits against plain ``efta`` in
             f32 and bf16; an ``ft.mode`` off/detect/correct sweep with
             ``ff_abft`` off and on (device and wall time per forward); a
             GEMM II SEU corrected; B2 at this shape against its plain
             version (clean and five SEUs), its bound and SDPA.
17. encdec — t5-small at full width, ``greedy_generate`` on B 8 with 512
             encoder tokens, 64-token prompts, 32 new tokens, f32 and bf16
             under ``efta_pallas``: f32 tokens equal plain ``efta``'s
             (near ties aside); B2 launches by regime (encoder, decoder
             prefill, cross prefill Sq 64 -> 512, cross decode Sq 1 ->
             512) and, counted by the wrapper, by layout (every Sq 1
             launch on the decode layout); each regime against the plain
             version (clean and five SEUs), timed with its bound and SDPA.
18. decoupled — the decoupled baseline against B2 (B 1, H 12, D 64, causal,
             bf16) at S 512-4096: both against ``reference_attention``,
             GEMM1/EXP/GEMM2 SEUs at S 512, device times and their ratio,
             ``decoupled_memory_bytes``, and where memory would stop it.

19. kernel_regimes — B1 and B2 at the moe family's attention shapes
             against their plain versions, f32 and bf16: B1 at kimi-k2's
             heads (64 on 8 KV heads of 112: 8 a group, output stride 7)
             and arctic's (56 on 8 of 128: 7 a group), decode (C 1) and a
             C 64 step with decode rows, clean, five SEUs and a resident
             flip; B2 at the same heads, causal, bucket 512, clean and five
             SEUs; each timed as phases 5 and 9 time theirs. bf16 outputs
             within one ulp plus ``p_rounding_slack``; the plain version's
             own spread under a reordered GEMM I is reported beside.
20. moe_paged — kimi-k2 and arctic at published width, two layers (one
             H100 holds no more), bf16, random weights from the seed,
             through the fused paged engine with phase 4's traffic: B1 at
             D 112 / grp 8 and D 128 / grp 7 once per layer of every
             forward, nothing detected; a twin with an EXP SEU on a decode
             row and a resident flip emits the clean tokens; device time
             of a mixed and of a decode window split by part (B1, experts,
             rest of attention, dense MLPs, LM head, other). kimi also runs
             the ring engine under ``efta_pallas`` first (B2 prefill at D
             112, buckets 64 and 512, against its plain version and timed),
             the bf16 run on B1's plain version (share of equal tokens
             reported), and (moe_f32) one f32 layer through the fused
             engine on B1 and on its plain version: equal tokens but at
             near ties of the logits or the router. Then (moe_long) kimi's
             bf16 model through the engine at its default cache (no
             ``cache_len``: max_seq, 4,096 tokens, 256-block tables):
             every C 1 launch on B1's long-table layout, nothing detected,
             the faulted twin emitting the clean tokens, step time and a
             profiled decode window beside the 1,024-token run's, and the
             run's largest decode launch held to the plain version and
             timed for the kernels line.
21. ssm — rwkv6-7b and hymba-1.5b at full width, 8 of their 32 layers,
             ``greedy_generate`` on B 8 x 512-token prompts, 32 new tokens:
             bf16 tokens/s and the device time of the prefill and of a
             decode step; f32 (8 new tokens) equal the argmax of the
             full-sequence forward (near ties aside).

22. vlm    — llama-3.2-vision-11b at published width and depth (40 layers
             in 8 superblocks, d 4096, 32 heads of 128 on 8, vocab
             128256), bf16, ``greedy_generate`` on B 8 x 512 prompt tokens
             + 16 new with a random frontend of 1,600 rows: under
             ``efta_pallas`` at the published ``block_kv`` 512 the
             cross-attention raises (1,600 rows do not divide the block);
             under ``efta`` and under ``efta_pallas`` with ``block_kv`` 64,
             B2 launches 40 at the self prefill, 8 at the cross prefill
             (512 -> 1600) and 8 a decode step at the cross decode (1 ->
             1600; counted by layout: every one on the decode layout),
             nothing detected; each regime against its plain
             version (clean and five SEUs) and timed, in bf16 and f32;
             tokens/s, step times, busy share of a profiled prefill and
             decode, peak memory; f32 at 10 layers: tokens equal plain
             ``efta``'s except at near ties.
23. train  — gpt2 training at published width and depth (bf16, remat
             full, B 8 x S 1,024, AdamW with ``warmup_cosine``, the
             synthetic pipeline): the card's f32 loss and gradients at 2
             layers equal the CPU's (1e-5 relative, 1e-4 of each leaf's
             max); ``efta_pallas`` under autograd raises; the loss of one
             batch trained on falls under 0.92x within 100 steps, and the
             eval loss over 40 steps of fresh batches is reported (at
             gpt2's vocab it does not fall that fast); a crash after an
             async checkpoint at step 10 of the fresh-batch run resumes to
             its loss at step 20 (rtol 1e-5); step time, tokens/s, MFU,
             peak memory, a profiled step's busy share and top kernels,
             plain EFTA's share of the step.

dryrun   — the dry run (``repro_torch.launch.dryrun``) against the card:
             (a) a gpt2 train step at phase 23's config and (b) a gpt2
             ``Model.prefill`` under ``efta_pallas`` (B 8 x 512), each
             traced on meta (one rank) and counted on the card under the
             same ``opcount``: FLOPs, ops by class and by aten op, kernel
             launches (12 B2 in (b)) and argument bytes equal; the
             predicted peak against ``max_memory_allocated`` plus the
             arguments (reported, within 10% expected); (c) the three
             production cells of ``experiments/hillclimb.py`` (16x16,
             rank 0 of 256 fake ranks) through the dry run's CLI, side by
             side: dominant term, the three terms, peak, ``fits_80gb``.
b2_wide  — kernel B2 at the dry run's wide KV blocks (past its narrow
             layout: the cluster layout, a cluster of CTAs that share a
             tile's rows and split its fold residues, and the workspace
             layout, scores in a global workspace on a persistent grid):
             (a) block_kv 2,048 (two blocks, causal) and 4,096 (two
             blocks, ragged kv_len) on the cluster layout, 32,768 (Sq 16)
             on the workspace one, at D 128 and 256, f32 and bf16, 2 query
             heads on one KV head, against the plain version clean and
             under each compute-site SEU (as phase 19's regimes: counts
             equal, outputs within ``out_bound`` plus
             ``p_rounding_slack``), timed with bound and SDPA, with each
             case's tiling, cluster size, registers and spills; (b) the
             Python tiling mirror (the meta route's rule) against the
             kernel's ``efta_attention_tiles`` on 12,672 shapes (block_q
             1 to 128, with and without unified verification); (c)
             deepseek-coder-33b at
             full width, 2 of 62 layers, bf16, ``Model.prefill`` of 32,768
             tokens under ``efta_pallas`` at block_kv 2,048 (2 B2
             launches, cluster layout): the dry run's one-rank prediction
             equal to the card's ``opcount`` (FLOPs, ops, launches) with
             the peak within 5%; time, tokens/s, peak, B2's device time
             per launch, its bound, SDPA; that launch against the plain
             version on the first and last KV heads' 7 query heads, clean
             and under each compute-site SEU on head 52 (counts equal,
             within ``out_bound`` plus ``p_rounding_slack``, the other
             heads bit-equal to the clean call); one SEU per compute site
             gives the clean logits, detected at every site but GEMM II.
examples — the five ``examples_torch/`` scripts as subprocesses on the
             card, side by side: each exits 0; ``paged_prefix_serving``
             launches B1. That example then runs once more in this
             process with every B1 call held against the plain version
             on the same inputs (head_dim 16, block 16: a regime no other
             phase reaches): outputs within the bound, counts equal.
b1_chunk — kernel B1's chunk path (``B1_CHUNK``: arctic's and kimi's C
             64 steps with decode rows, phase 19's inputs, and a gpt2
             prefill step), bf16, on the tile layout (a fold pass, then 64
             rows a CTA on wgmma): W, G, ST and the layout; against the
             plain version clean, under each compute-site SEU and a
             resident flip (counts and bad planes equal, outputs within
             ``out_bound`` plus ``p_rounding_slack``); device time a launch
             with the fold pass and alone, the bound, SDPA in a CUDA graph;
             and the launches the tile and decode layouts leave on the
             first layout (``B1_KEPT``: f32 C 64, the per-step check),
             hashed and timed, to hold two checkouts to each other (run in
             both, parent, change, change, parent).
b1_decode — only under ``--only b1_decode``: kernel B1's decode path
             (``B1_DECODE``: the C 1 decode step at gpt2, kimi and arctic,
             bf16 and f32, B 8 over 64-block tables) on the decode layout
             (a cluster of 8 CTAs a (request, KV head), a span of the
             blocks each, exchanges over distributed shared memory): the
             layout, its step width and shared bytes, registers and
             spills; against the plain version clean, under each
             compute-site SEU and a resident flip (counts and bad planes
             equal, outputs within ``out_bound``); device time a launch,
             the bound, SDPA in a CUDA graph; and hashes of the clean and
             an EXP-faulted output, to hold two checkouts to each other
             (parent, change, change, parent).
b1_long  — only under ``--only b1_long``: kernel B1's decode step over
             tables wider than the decode layout holds (``B1_LONG``:
             kimi's and arctic's heads at 256-block tables with 2,048-4,096
             tokens, bf16 and f32; phase 20's lengths in a 256-block
             table; a 32,768-token context in 2,048 blocks) on the
             long-table layout (a score, an EXP and a state pass over a
             workspace): the layout, its tiling, registers and spills;
             against the plain version clean, under each compute-site SEU
             and a resident flip (32k: clean and an EXP SEU); device time
             a launch and a pass, the bound and beside it the workspace's
             traffic, SDPA in a CUDA graph (padded and expanded, and a
             call a request with ``enable_gqa``); hashes to hold two
             checkouts to each other (parent, change, change, parent).
b2_narrow — only under ``--only b2_narrow``: B2's narrow-path regimes of
             earlier phases and its two cross-attention decode regimes
             (t5, the VLM) timed and hashed with each one's layout (bf16
             on the tile layout where it holds the shapes, Sq 1 on the
             decode layout), and a hash of
             the narrow and the tile kernels' SASS (``cuobjdump -sass``),
             to hold two checkouts' kernels to each other
             (``phase_b2_narrow``).

dist     — distributed training on two gloo ranks that share the card
             (subprocesses of this script on cuda:0; nccl refuses two
             ranks on one device, so its path is written but not run):
             (a) gpt2 at full width and depth, f32, on mesh (pod 2), 3
             steps under ``dense`` (against a one-process run of the same
             global batch) and under ``int8_ef``, replicated blocks
             bit-equal after every step; (c) a ZeRO-3 state saved from
             (data 2) and restored on (pod 2) and in one process, bit for
             bit both ways; (b) one MoE layer at arctic-480b's published
             width, 64 experts a rank: ``_moe_apply_ep`` on (model 2) and
             ``_moe_inference_ep`` on (data 2) against the one-device
             layer. Step times and the bytes of each collective.

Phases 11-13 report tokens/s, steps, forwards, B1 launches and the
acceptance rate of runs without the profiler, and the device's busy share
over a window of steps (profiler, CUDA activity) of one run each that is
not timed: the bf16 faulted twin after its faults, the cold draft, the
gather run with a flip after its repair. The kernels line carries B2's
numbers in the regimes of phases 16-20, b2_wide and 22, each with its
layout (narrow, tile, cluster or workspace), and B1's in those of phase 19
under ``regimes``.

The phases run in the order 1, 2, dist (while this process holds next
to nothing on the card), 3-5, 7-9, 14-19, b1_chunk, b2_wide, 22, 20, 23,
dryrun, examples, 6, 10, 21, 11-13:
after profiled runs of a few hundred thousand launches the profiler
drops kernel records from later windows (seen on the card), so the
whole-run profiles (6, 10) and the profiled windows of 11-13 and 20-23
come after every per-kernel timing (phase 22's B2 timings came back
unmeasured after phase 20's windows, so phase 22 runs first and profiles
last), and phase 21's profiled prefills after 6 and 10; each of phases
20-23 frees its models before the next and reports its peak memory;
phase 21 runs 8 of rwkv6's and hymba's 32 layers (``SSM_LAYERS``), to stay
inside the time limit;
``device_ms`` brackets its timed calls with spin kernels and reports a
window whose record count does not check out as not measured.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``. Any
failed check raises: the script exits non-zero and prints no result line.
It exits non-zero as well where no CUDA device is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's data-sheet rates, as the dry run's roofline takes them
from repro_torch.launch.dryrun import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.dryrun import (  # noqa: E402
    PEAK_FLOPS_BY_DTYPE as PEAK_FLOPS)
DEVICE = "cuda"
ARCH = "gpt2"                    # the paper's Table 3 model, full width
ORACLE_REQUESTS = 4              # ring requests replayed on greedy_generate
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


# phase 2's ``ptxas_summary`` of each source, for the kernels line
PTXAS = {}


def ptxas_summary(log):
    """Registers, stack and spills per kernel instantiation, from nvcc's
    ``-Xptxas -v`` output: {"bf16" | "f32" [+ " workspace" | " cluster
    D<=128" | " cluster D<=256"] | "bf16 tile" | "bf16 fold": "N registers,
    ..."} (B2's ``efta_attention_kernel_wide`` and ``..._kernel_cluster``,
    whose two instantiations hold 4 and 8 GEMM II n-tiles a warp, and the
    tile layout's two bf16 kernels, ``..._kernel_tile`` and its fold pass
    ``..._kernel_fold``; and the decode layout's three passes, {"bf16" |
    "f32"} + " decode score" | " decode exp" | " decode state"; B1's
    decode layout, ``efta_paged_kernel_decode``: {"bf16" | "f32"} +
    " decode"; B1's long-table layout's three passes, {"bf16" | "f32"} +
    " long score" | " long exp" | " long state")."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            dt = "bf16" if "bfloat16" in ln else "f32"
            dec = next((k for k in ("score", "exp", "state")
                        if f"kernel_d{k}" in ln), None)
            lng = next((k for k in ("score", "exp", "state")
                        if f"kernel_l{k}" in ln), None)
            name = ("bf16 tile" if "kernel_tile" in ln else
                    f"{dt} long {lng}" if lng else
                    "bf16 fold" if "kernel_fold" in ln else
                    f"{dt} decode {dec}" if dec else
                    f"{dt} decode" if "kernel_decode" in ln else
                    dt + (" workspace" if "kernel_wide" in ln else
                          (" cluster D<=128" if "Li4E" in ln
                           else " cluster D<=256")
                          if "kernel_cluster" in ln else ""))
        elif name and ("spill" in ln or "registers" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":")[-1].strip()
                         ).strip()
    return out


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    procs = [_build.start_build(name, extra=["-Xptxas", "-v"])
             for name in _build.sources()]
    logs = {p.repro_name: _build.finish_build(p) for p in procs}
    dt = time.perf_counter() - t0
    regs = {n: ptxas_summary(log) for n, log in logs.items()}
    PTXAS.update(regs)
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
              max_kv=1024, decode_rows=False, full_ctx=False, min_kv=None):
    g = torch.Generator().manual_seed(seed)
    kv_lens = torch.randint(max(C, 1) if min_kv is None else min_kv,
                            max_kv + 1, (B,), generator=g)
    if full_ctx:
        kv_lens[:2] = mb * bs       # the whole table: 64 blocks of 16
    q_lens = torch.full((B,), C, dtype=torch.long)
    if C > 1:
        q_lens[0] = C // 2          # ragged chunk
        q_lens[-1] = 0              # idle slot: streamed, verified, no rows
        if decode_rows:
            q_lens[1:4] = 1         # decode rows in a chunked step: their
            #                         other 63 rows are padding
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


def compare(torch, got, ref, what, slack=None):
    """B1 against its plain version: outputs within ``out_bound`` (plus
    ``slack`` per element where given), detection vectors and bad planes
    exactly equal. Returns the largest absolute error."""
    diff = (got.out.float() - ref.out.float()).abs()
    err = float(diff.max())
    bound = out_bound(torch, ref.out)
    if slack is not None:
        bound = bound + slack
    ratio = float((diff / bound).max())
    check(math.isfinite(err) and ratio <= 1.0,
          f"{what}: |kernel - plain| over its bound {ratio:.3f} > 1 (max "
          f"|kernel - plain| = {err:.3e})")
    check(torch.equal(got.detected, ref.detected),
          f"{what}: detected {got.detected.tolist()} != plain "
          f"{ref.detected.tolist()}")
    check(torch.equal(got.bad_blocks, ref.bad_blocks),
          f"{what}: bad plane differs from the plain version")
    return err


def split_compare(torch, got, split, what):
    """The kernel against the plain version with its KV walk split over 4
    warps and merged, on clean input: detection vectors and bad planes
    exactly equal; f32 outputs within ``out_bound``. In bf16 each span
    rounds p to bf16 at its own running max, not the sequential one, so
    the outputs move by about a bf16 ulp; their largest difference is
    returned and reported, not bounded."""
    check(torch.equal(got.detected, split.detected) and
          torch.equal(got.bad_blocks, split.bad_blocks),
          f"{what}: kernel and split plain version disagree on clean input")
    diff = float((got.out.float() - split.out.float()).abs().max())
    if got.out.dtype == torch.float32:
        compare(torch, got, split, f"{what} clean, split plain version")
    return diff


def phase_kernel(torch):
    from repro_torch.core import checksum as cks
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (NO_WINDOW,
                                                _paged_split_torch,
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
    # the redesign's cases: decode at grp 4 (one warp, 4 real rows), a
    # chunked step with decode rows (their padding rows computed and counted
    # as the reference counts them), and
    # requests that fill the 64-block table
    shapes += [
        dict(name="gemma3-1b C1 grp 4 window 512", dtype=torch.bfloat16, B=8,
             H=4, Hkv=1, D=256, C=1, window=512),
        dict(name="gpt2 C64 with decode rows bf16", dtype=torch.bfloat16,
             B=8, H=12, Hkv=12, D=64, C=64, window=None, decode_rows=True),
        dict(name="gpt2 C1 1024-token context bf16", dtype=torch.bfloat16,
             B=8, H=12, Hkv=12, D=64, C=1, window=None, full_ctx=True)]
    results = []
    for si, sh in enumerate(shapes):
        case = make_case(torch, cks, seed=100 + si, **{
            k: sh[k] for k in ("dtype", "B", "H", "Hkv", "D", "C",
                               "decode_rows", "full_ctx") if k in sh})
        kw = {"window": sh["window"]}
        got, launched = b1_launched(
            lambda: call(efta_paged_attention, case, cfg, **kw))
        want = {1: "decode", 64: "narrow" if sh["dtype"] == torch.float32
                or sh["D"] > 128 else "tile"}[sh["C"]]
        check(launched == [want], f"{sh['name']}: launched on {launched}, "
              f"not the {want} layout")
        ref = call(efta_paged_attention_torch, case, cfg, **kw)
        # the KV walk split over 4 warps and merged (clean: the same result)
        split = call(functools.partial(_paged_split_torch, warps=4), case,
                     cfg, **kw)
        torch.cuda.synchronize()
        err = compare(torch, got, ref, f"{sh['name']} clean")
        split_err = split_compare(torch, got, split, sh["name"])
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
        results.append({"shape": sh["name"], "layout": want,
                        "max_abs_err": err,
                        "split_max_abs_diff": split_err,
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

        def score(params, tokens, cache, fault=None, **kw):
            out = orig_score(params, tokens, cache, fault=fault, **kw)
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


def zero_b1_counts():
    """Zero B1's launch counts: the total and the wrapper's count by
    (layout, chunk width), both kept where the kernel launches."""
    from repro_torch.kernels.efta_paged import efta_paged_attention
    efta_paged_attention.launches = 0
    efta_paged_attention.launches_by_layout.clear()


def b1_by_layout():
    """B1's launches since :func:`zero_b1_counts` by the layout the wrapper
    launched and the chunk width, {"tile C64": n, ...}; checked to add up
    to the total."""
    from repro_torch.kernels.efta_paged import efta_paged_attention
    by = efta_paged_attention.launches_by_layout
    check(sum(by.values()) == efta_paged_attention.launches,
          f"B1 launches by layout {dict(by)} do not add up to "
          f"{efta_paged_attention.launches}")
    return {f"{lay} C{c}": n for (lay, c), n in sorted(by.items())}


def zero_b2_counts():
    """Zero B2's launch counts: the total and the wrapper's count by
    (layout, Sq), both kept where the kernel launches."""
    from repro_torch.kernels.efta_attention import efta_attention
    efta_attention.launches = 0
    efta_attention.launches_by_layout.clear()


def b2_by_layout():
    """B2's launches since :func:`zero_b2_counts` by the layout the wrapper
    launched and Sq, {"decode Sq1": n, ...}; checked to add up to the
    total."""
    from repro_torch.kernels.efta_attention import efta_attention
    by = efta_attention.launches_by_layout
    check(sum(by.values()) == efta_attention.launches,
          f"B2 launches by layout {dict(by)} do not add up to "
          f"{efta_attention.launches}")
    return {f"{lay} Sq{sq}": n for (lay, sq), n in sorted(by.items())}


def check_decode_launches(by, what):
    """Every Sq 1 launch of B2 in ``by`` (:func:`b2_by_layout`) took the
    decode layout."""
    other = {k: n for k, n in by.items()
             if k.endswith(" Sq1") and not k.startswith("decode ")}
    check(not other and by.get("decode Sq1", 0) > 0,
          f"{what}: B2's Sq 1 launches {by} did not all take the decode "
          f"layout")


def check_b1_decode_launches(by, what, need=True, layouts=("decode",)):
    """Every C 1 launch of B1 in ``by`` (:func:`b1_by_layout`; the serve
    engines verify with the unified output check) took one of ``layouts``
    (the decode layout; where a run's tables may be wide, the long-table
    layout too), and (``need``) there was one."""
    other = {k: n for k, n in by.items()
             if k.endswith(" C1") and k.split(" ")[0] not in layouts}
    check(not other and (sum(by.get(f"{lay} C1", 0) for lay in layouts) > 0
                         or not need),
          f"{what}: B1's C 1 launches {by} did not all take the "
          f"{' or '.join(layouts)} layout")


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
    zero_b1_counts()
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
                wall=wall, launches=efta_paged_attention.launches,
                b1_by_layout=b1_by_layout())


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
        by = run["b1_by_layout"]
        check(cfg.dtype != "bfloat16" or (by.get("tile C64", 0) > 0 and
                                          "narrow C64" not in by),
              f"{tag}: B1's width-64 launches not all on the tile layout: "
              f"{by}")
        check_b1_decode_launches(by, tag)
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
          "b1_by_layout": clean["b1_by_layout"],
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


PRE_CALLS = 3            # untimed calls at the start of a profiled window
# new tokens a request in the whole-run profiles of phases 6 and 10 (the
# timed runs make 32): post-processing costs ~0.24 ms a kernel record, and
# 32 made phase 10 parse ~391k of them
PROFILED_NEW = 8
LEAD_CYCLES = 10_000_000  # ~5 ms spin kernel opening a profiled window
MARK_CYCLES = 100_000    # ~0.05 ms spin kernels bracketing the timed calls


def device_ms(torch, fn, reps, name=None):
    """Device time per call of ``fn``, without the host's gaps between
    back-to-back calls that CUDA events include once a call's kernels are
    shorter than its Python launch path.

    With ``name`` (one of this repository's kernels, launched by its
    wrapper): torch.profiler's time of the kernels whose name contains it.
    The profiler drops kernel records at the start of a window (seen on
    the card: none of a one-call window's records, 16 of 20 calls' in a
    twenty-call one), so a window opens with a ~5 ms spin kernel and
    ``PRE_CALLS`` untimed calls, then runs a short spin, the timed calls
    and a second short spin; only the records that start between the two
    short spins count (both must be recorded), and they must number
    exactly ``reps`` times those of one call measured the same way, else
    both are profiled again, up to three times.

    Without ``name`` (a library call, a product, a whole forward): ``reps``
    calls captured in one CUDA graph and replayed between two CUDA events.
    The profiler was not used for these: on the card it lost every record
    of some cuBLAS kernels late in the run while its counts still checked
    out for others.

    A time that cannot be taken this way (it never checks out, or the call
    cannot be captured) is None ("not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if name is None:
        return graph_ms(torch, fn, reps)

    def window(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_CYCLES)
            for _ in range(PRE_CALLS):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(n):
                fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = sorted((e.time_range for e in ev if "spin_kernel" in e.name
                        and e.time_range.elapsed_us() < 1000),
                       key=lambda t: t.start)
        if len(marks) != 2:
            return 0.0, 0
        # by start time: a kernel may overlap the next one's start
        # (programmatic dependent launch), never its own launch order
        t0, t1 = marks[0].start, marks[1].start
        timed = [e.time_range for e in ev
                 if t0 < e.time_range.start < t1
                 and "spin_kernel" not in e.name and name in e.name]
        return sum(t.elapsed_us() for t in timed), len(timed)

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, per_call = window(1)
        us, count = window(reps)
        if per_call > 0 and count == per_call * reps:
            return us / 1e3 / reps
    return None


def graph_ms(torch, fn, reps):
    """Time per call of ``reps`` calls of ``fn`` captured in one CUDA graph,
    between CUDA events around one replay; None where ``fn`` cannot be
    captured (it waits for the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_ratio(a, b):
    """a / b, or None where either time was not measured."""
    return None if a is None or b is None else a / b


def streamed_blocks(cap):
    """The KV blocks a launch streams for these ragged lengths (summed over
    requests, a block a KV head) and those blocks times their query rows."""
    q, k_pool = cap["q"], cap["k"]
    bt, kv_lens, q_lens = cap["args"][3:6]
    H, bs = q.shape[1], k_pool.shape[2]
    hkv = k_pool.shape[1]
    win = cap["kw"].get("window")
    win = 1 << 30 if win is None else int(win)
    kvl, ql = kv_lens.tolist(), q_lens.tolist()
    blocks = rows_blocks = 0
    for b in range(q.shape[0]):
        base = kvl[b] - ql[b]
        n = sum(1 for j in range(bt.shape[1])
                if j * bs < kvl[b] and base - (j * bs + bs - 1) < win)
        blocks += n
        rows_blocks += n * (H // hkv) * ql[b]
    return blocks, rows_blocks


def launch_work(torch, cap):
    """Bytes the launch must move (each input read once, each output written
    once) and the operations it does, counted for these inputs: only the KV
    blocks the ragged lengths make it stream. A workspace a layout keeps
    between its passes is not counted: the function needs none."""
    q, k_pool = cap["q"], cap["k"]
    k_checks, bt = cap["args"][1], cap["args"][3]
    B, H, C, D = q.shape
    _, hkv, bs, _ = k_pool.shape
    cs = k_checks.c1.shape[-2]
    elt = k_pool.element_size()
    blocks, rows_blocks = streamed_blocks(cap)
    nbytes = (blocks * hkv * (2 * bs * D + 4 * cs * D) * elt   # K V planes
              + 2 * q.numel() * elt                             # q in, out
              + bt.numel() * 4 + 2 * B * 4 + B * 6 * 4)
    # GEMM I + GEMM II over the valid rows (2 flops per multiply-add)
    flops = hkv * rows_blocks * 4 * bs * D
    return nbytes, flops


def workspace_bytes(cap, floats):
    """The traffic of a workspace of ``floats`` f32 a (request, KV head,
    streamed block), each written once and read once (B1's long-table
    layout: ``PagedTiling.fold_floats``): the layout's own cost beyond
    :func:`launch_work`'s bound, reported beside it."""
    return 2 * streamed_blocks(cap)[0] * cap["k"].shape[1] * floats * 4


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


def library_call_gqa(torch, cap):
    """SDPA on each request's own K/V (set-up, not timed): a C 1 step's
    blocks gathered to its ``kv_len`` and no further, the KV heads not
    repeated (``enable_gqa``), no mask (one row sees every key before it),
    so SDPA may take its flash kernel; one call a request."""
    import torch.nn.functional as F
    q, k_pool = cap["q"], cap["k"]
    v_pool, _, _, bt, kv_lens = cap["args"][:5]
    bs, D = k_pool.shape[2], k_pool.shape[3]
    hkv = k_pool.shape[1]
    calls = []
    for b, n in enumerate(kv_lens.tolist()):
        idx = bt[b, :-(-n // bs)].long()
        k = (k_pool[idx].permute(1, 0, 2, 3).reshape(1, hkv, -1, D)
             [:, :, :n].contiguous())
        v = (v_pool[idx].permute(1, 0, 2, 3).reshape(1, hkv, -1, D)
             [:, :, :n].contiguous())
        calls.append((q[b:b + 1].contiguous(), k, v))

    def run():
        for qb, k, v in calls:
            F.scaled_dot_product_attention(qb, k, v, enable_gqa=True)
    return run


def b1_numbers(torch, cap, key, slack=None, layout="decode", ws_floats=0):
    """B1 on captured (or main-path-shaped) inputs: the kernel against its
    plain version (outputs within ``out_bound``, plus ``slack`` where
    given; a C 1 launch on ``layout``), its time per launch (CUDA events
    and the profiler's device time), its bound, beside it a workspace of
    ``ws_floats`` a (request, KV head, running block) written and read
    once (``ws_bytes``, ``ws_ms``: the layout's cost, not the function's),
    the plain version's time and SDPA's on a contiguous copy."""
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)

    def run(fn):
        return fn(cap["q"], cap["k"], *cap["args"], **cap["kw"])

    got, launched = b1_launched(lambda: run(efta_paged_attention))
    ref = run(efta_paged_attention_torch)
    torch.cuda.synchronize()
    if cap["q"].shape[2] == 1 and cap["kw"]["cfg"].unified:
        check(launched == [layout], f"{key}: a C 1 launch on {launched}, "
              f"not the {layout} layout")
    err = float((got.out.float() - ref.out.float()).abs().max())
    check(torch.equal(got.detected, ref.detected),
          f"{key}: kernel and plain counts differ on main-path inputs")
    bound = out_bound(torch, ref.out)
    if slack is not None:
        bound = bound + slack
    check(float((got.out.float() - ref.out.float()).abs().div(bound).max())
          <= 1.0, f"{key}: max err {err:.3e} over its bound")
    ms = time_ms(torch, lambda: run(efta_paged_attention), reps=50)
    plain_ms = time_ms(torch, lambda: run(efta_paged_attention_torch),
                       reps=3, warmup=1)
    lib = library_call(torch, cap)
    lib_ms = time_ms(torch, lib, reps=50)
    dev_ms = device_ms(torch, lambda: run(efta_paged_attention), 20,
                       name="efta_paged_kernel")
    lib_dev_ms = device_ms(torch, lib, 20)
    nbytes, flops = launch_work(torch, cap)
    ws_bytes = workspace_bytes(cap, ws_floats)
    peak = PEAK_FLOPS[str(cap["q"].dtype)]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"shape": list(cap["q"].shape), "q_lens_sum": cap["load"],
            "layout": launched, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "ws_bytes": ws_bytes,
            "ws_ms": ws_bytes / HBM_BYTES_PER_S * 1e3}


def phase_numbers(torch, serve, max_err_phase3):
    clean = serve["clean"]
    step_ms = sorted(clean["step_ms"])
    per = {key: b1_numbers(torch, serve["captured"][key], key)
           for key in ("decode", "prefill")}
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
        "device_ms": d["device_ms"],
        "library_device_ms": d["library_device_ms"],
        "shape": "serve decode, C 1",
        "prefill": {k: per["prefill"][k] for k in
                    ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "library_device_ms")},
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
                        serve["prompts"], n_new=PROFILED_NEW,
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
    """Each case with the 16-row groups per thread block it is run at (the
    kernel takes at most that many): the main path's buckets and gemma3-1b's
    D 256 at every choice; the bf16 bucket 512 takes the tile layout at 4
    (64 rows a CTA), the narrow one at 2 and 1 (bucket 64, 64 x 64 scores a
    tile's block, keeps the narrow one at any)."""
    cases = []
    for S in (64, 512):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(dict(name=f"gpt2 prefill S{S} {str(dtype)[6:]}",
                              dtype=dtype, B=1, H=12, Hkv=12, D=64, Sq=S,
                              Skv=S, cfg={}, kw=dict(causal=True),
                              groups=((4, 2, 1) if S == 512 else (2, 1))
                              if dtype == torch.bfloat16 else (2,)))
    for causal in (True, False):
        cases.append(dict(name=f"multi-block kv_len 100 causal {causal}",
                          dtype=torch.float32, B=2, H=4, Hkv=2, D=64,
                          Sq=128, Skv=128, cfg=dict(stride=8, block_kv=16),
                          kw=dict(causal=causal, kv_len=100), groups=(2,)))
    for dtype in (torch.bfloat16, torch.float32):
        for win in (512, None):
            cases.append(dict(name=f"gemma3-1b window {win} "
                              f"{str(dtype)[6:]}", dtype=dtype, B=1, H=4,
                              Hkv=1, D=256, Sq=1024, Skv=1024, cfg={},
                              kw=dict(causal=True, window=win),
                              groups=(2, 1) if dtype == torch.bfloat16
                              and win == 512 else (2,)))
    return cases


def b2_module():
    """The B2 wrapper's module (the package re-exports other names), whose
    private ``_MAX_GROUPS`` caps the 16-row groups per thread block."""
    return importlib.import_module("repro_torch.kernels.efta_attention")


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


def b2_compare(torch, got, ref, what, slack=None):
    """Outputs within ``out_bound`` (plus ``slack`` where given) element by
    element, non-finite values where they are, detection vectors exactly.
    Returns the largest absolute error and the largest error over its
    element's bound."""
    out, det = got
    ref_out, ref_det = ref
    a, b = out.float(), ref_out.float()
    fin = torch.isfinite(b)
    check(torch.equal(torch.isfinite(a), fin) and
          torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()),
          f"{what}: non-finite outputs differ")
    diff = (a[fin] - b[fin]).abs()
    bound = out_bound(torch, ref_out)
    if slack is not None:
        bound = bound + slack
    bound = bound[fin]
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
    mod = b2_module()
    dev = torch.device(DEVICE)
    results = []
    for ci, c in enumerate(b2_cases(torch)):
        g = torch.Generator().manual_seed(200 + ci)
        q = torch.randn((c["B"], c["H"], c["Sq"], c["D"]), generator=g)
        k = torch.randn((c["B"], c["Hkv"], c["Skv"], c["D"]), generator=g)
        v = torch.randn((c["B"], c["Hkv"], c["Skv"], c["D"]), generator=g)
        q, k, v = (x.to(dev, c["dtype"]) for x in (q, k, v))

        def both(cfg, fault=None, c=c, q=q, k=k, v=v):
            """The kernel at each row-group choice of the case, and the
            plain version once."""
            gots, default = {}, mod._MAX_GROUPS
            for ng in c["groups"]:
                mod._MAX_GROUPS = ng
                gots[ng] = efta_attention(q, k, v, cfg=cfg, fault=fault,
                                          **c["kw"])
            mod._MAX_GROUPS = default
            ref = efta_attention_torch(q, k, v, cfg=cfg, fault=fault,
                                       **c["kw"])
            torch.cuda.synchronize()
            return gots, ref

        # at 4 groups the bf16 buckets take the tile layout: held to
        # out_bound plus p_rounding_slack, as b2_regime_numbers holds it
        tile_slack = None
        bk = min(EFTAConfig(**c["cfg"]).block_kv, c["Skv"])
        if mod.kernel_tiling(
                mod.DTYPES[c["dtype"]], min(128, c["Sq"]), bk, c["D"],
                EFTAConfig(**c["cfg"]).kv_stride(bk),
                EFTAConfig(**c["cfg"]).out_stride(c["D"]), max(c["groups"]),
        ).layout == "tile":
            from repro_torch.core.efta import reference_attention
            tile_slack = 2.0 ** -7 * reference_attention(
                q, k, v.float().abs(), causal=c["kw"].get("causal", False),
                window=c["kw"].get("window"), kv_len=c["kw"].get("kv_len"))

        def compare_all(gots, ref, what, tile_slack=tile_slack):
            errs = [b2_compare(torch, got, ref, f"{what}, groups {ng}",
                               tile_slack if ng == 4 else None)
                    for ng, got in gots.items()]
            return max(e[0] for e in errs), max(e[1] for e in errs)

        correct = EFTAConfig(mode="correct", **c["cfg"])
        gots, ref = both(correct)
        err, worst = compare_all(gots, ref, f"{c['name']} clean")
        clean_ratio = worst   # worst: the largest error over bound, any run
        check(int(gots[2][1].sum()) == 0,
              f"{c['name']}: detections on clean input {gots[2][1].tolist()}")
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
                gots_f, r_f = both(cfg, desc)
                what = f"{c['name']} {site.name} {mode}"
                worst = max(worst, compare_all(gots_f, r_f, what)[1])
                n = int(gots_f[2][1].sum())
                # shadows catch every change of their value; in correct mode
                # the EXP recompute catches every flip of p, and a top-bit
                # GEMM I flip moves the score by at least 2 or to 1e6/0
                need = site in (Site.ROWMAX, Site.ROWSUM) or (
                    mode == "correct" and site in (Site.GEMM1, Site.EXP))
                check(n >= 1 or not need, f"{what}: SEU not detected")
                entry = {"detected": gots_f[2][1].tolist()}
                if mode == "correct":
                    entry["off_clean"] = float(
                        (gots_f[2][0].float() - clean).abs().max())
                counts[f"{site.name} {mode}"] = entry
        for name, cfg, desc in (
                ("per-step verify", EFTAConfig(unified=False, **c["cfg"]),
                 [int(Site.GEMM2), blk, 1, row, 3, 30, 1, 0]),
                ("mode off", EFTAConfig(mode="off", **c["cfg"]),
                 [int(Site.EXP), blk, 1, row, 3, 30, 1, 0])):
            gots_f, r_f = both(cfg, desc)
            worst = max(worst, compare_all(gots_f, r_f,
                                           f"{c['name']} {name}")[1])
            counts[name] = {"detected": gots_f[2][1].tolist()}
        results.append({"case": c["name"], "groups": list(c["groups"]),
                        "max_abs_err": err, "err_over_bound": clean_ratio,
                        "worst_err_over_bound": worst, "seu": counts})
    emit({"phase": "kernel_b2", "ok": True, "cases": results})
    return max(r["max_abs_err"] for r in results)


# ---------------------------------------------------------------------------
# phase 8: the ring-cache ServeEngine at gpt2 full width (prefill on B2)
# ---------------------------------------------------------------------------

def family_model(arch, dtype=None, **ft):
    """``arch`` at its configured width on the card, with the config's
    dtype and FT fields replaced where given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    return build_model(dataclasses.replace(
        cfg, dtype=dtype or cfg.dtype, ft=dataclasses.replace(cfg.ft, **ft)),
        device=DEVICE)


def ring_model(torch, mode="correct", impl="efta_pallas"):
    return family_model(ARCH, attn_impl=impl, mode=mode)


class RegimeRecorder:
    """Counts the fused contiguous kernel's calls by regime (Sq, Skv,
    causal) and keeps copies of the first call's inputs of each."""

    def __init__(self):
        import repro_torch.kernels.ops as ops_mod
        self.counts, self.captured = {}, {}
        orig = ops_mod.efta_attention_rows

        def rows(q, k, v, **kw):
            key = (q.shape[2], k.shape[2], bool(kw.get("causal")))
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.captured:
                self.captured[key] = {"q": q.clone(), "k": k.clone(),
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
    zero_b2_counts()
    zero_b1_counts()
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
    rec = RegimeRecorder()
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

    # per-request greedy_generate on the first requests, reported: cuBLAS
    # may round the batch of 8 and the batch of 1 differently. The oracle
    # prefills unpadded prompts, which the fused kernel refuses at most
    # lengths, so it runs on efta.
    oracle = ring_model(torch, impl="efta")
    agree = 0
    for rid, p in enumerate(prompts[:ORACLE_REQUESTS]):
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
          "greedy_generate_agree": f"{agree}/{ORACLE_REQUESTS}"})
    return dict(clean=clean, captured=rec.captured, tokens=tokens,
                model=model, params=params, prompts=prompts, n_new=n_new)


# ---------------------------------------------------------------------------
# phase 9: numbers of B2 and of the ring serve run
# ---------------------------------------------------------------------------

def regime_name(key):
    sq, skv, causal = key
    return f"Sq{sq}_Skv{skv}_{'causal' if causal else 'noncausal'}"


def b2_regime_work(cap):
    """Bytes and operations of a captured launch: the package's
    ``efta_attention_work``, which the dry run counts too."""
    from repro_torch.kernels.efta_attention import efta_attention_work
    return efta_attention_work(cap["q"], cap["k"],
                               causal=bool(cap["kw"].get("causal")))


def b2_regime_numbers(torch, cap, p_rounding=False, reps=(50, 20),
                      ragged_sdpa=False):
    """Kernel against its plain version on a captured launch (clean and
    under each compute-site SEU in correct mode, top exponent bit, on the
    last query row), its device time, bound, plain time and SDPA's device
    time on the same q/k/v, and the layout the kernel takes there.
    ``p_rounding``: bf16 outputs may also differ by ``p_rounding_slack``
    (phase 19's regimes); so may they wherever the launch takes the tile
    or the decode layout, whose GEMM I (wgmma; mma.sync on 8 rows) sums
    in another order than the narrow layout's, so that a p next to a bf16
    rounding boundary may round either way. ``reps``: the calls of the
    event and of the profiled windows."""
    import torch.nn.functional as F
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.core.fault import Site
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_torch)
    q, k, v, kw = cap["q"], cap["k"], cap["v"], dict(cap["kw"])
    kw.pop("fault", None)
    cfg = kw.pop("cfg")
    mod = b2_module()
    bkv = min(cfg.block_kv, k.shape[2])
    tiling = mod.kernel_tiling(mod.DTYPES[q.dtype],
                               min(kw.get("block_q", 128), q.shape[2]), bkv,
                               q.shape[3], cfg.kv_stride(bkv),
                               cfg.out_stride(q.shape[3]), mod._MAX_GROUPS,
                               cfg.unified)
    worst, seu = 0.0, {}
    slack = None
    if ((p_rounding or tiling.layout in ("tile", "decode"))
            and q.dtype == torch.bfloat16):
        from repro_torch.core.efta import reference_attention
        slack = 2.0 ** -7 * reference_attention(
            q, k, v.float().abs(), causal=bool(kw.get("causal")),
            window=kw.get("window"), kv_len=kw.get("kv_len"))
    for site in (None, Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM,
                 Site.GEMM2):
        desc = None if site is None else [int(site), 0, 1, q.shape[2] - 1,
                                          3, seu_bit("correct"), 1, 0]
        got = efta_attention(q, k, v, cfg=cfg, fault=desc, **kw)
        ref = efta_attention_torch(q, k, v, cfg=cfg, fault=desc, **kw)
        torch.cuda.synchronize()
        err, ratio = b2_compare(torch, got, ref, f"B2 {q.shape} {site}",
                                slack)
        worst = max(worst, ratio)
        if site is None:
            check(int(got[1].sum()) == 0, "B2: clean detections")
            max_err = err
        else:
            seu[site.name] = got[1].tolist()
            if site in (Site.ROWMAX, Site.ROWSUM, Site.EXP, Site.GEMM1):
                check(int(got[1].sum()) >= 1, f"B2 {q.shape}: {site.name} "
                      f"SEU not detected")

    def run(fn):
        return fn(q, k, v, cfg=cfg, **kw)

    grp = q.shape[1] // k.shape[1]
    kc, vc = (t.repeat_interleave(grp, dim=1).contiguous() for t in (k, v))
    causal = bool(kw.get("causal"))

    # ``ragged_sdpa``: a non-causal call's kv_len as SDPA's mask
    mask = (torch.arange(k.shape[2], device=q.device)[None]
            < int(kw["kv_len"]) if ragged_sdpa else None)

    def sdpa():
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                              is_causal=causal)

    nbytes, flops = b2_regime_work(cap)
    peak = PEAK_FLOPS[str(q.dtype)]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"shape": list(q.shape), "skv": k.shape[2], "causal": causal,
            "ms": time_ms(torch, lambda: run(efta_attention), reps=reps[0]),
            "device_ms": device_ms(torch, lambda: run(efta_attention),
                                   reps[1], name="efta_attention_kernel"),
            "plain_ms": time_ms(torch, lambda: run(efta_attention_torch),
                                reps=3, warmup=1),
            "library_ms": time_ms(torch, sdpa, reps=reps[0]),
            "library_device_ms": device_ms(torch, sdpa, reps[1]),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "max_abs_err": max_err,
            "worst_err_over_bound": worst, "seu_detected": seu,
            "layout": tiling.layout}


def phase_numbers_b2(torch, np, ring, max_err):
    from repro_torch.kernels.efta_attention import efta_attention
    clean = ring["clean"]
    step_ms = sorted(clean["step_ms"])
    per = {}
    for S in (64, 512):
        cap = ring["captured"][(S, S, True)]
        per[S] = b2_regime_numbers(torch, cap)
        kw = dict(cap["kw"], fault=None)
        by_groups = {}
        mod = b2_module()
        default = mod._MAX_GROUPS
        for ng in (4, 2, 1):
            mod._MAX_GROUPS = ng
            by_groups[ng] = device_ms(
                torch, lambda: efta_attention(cap["q"], cap["k"], cap["v"],
                                              **kw),
                20, name="efta_attention_kernel")
        mod._MAX_GROUPS = default
        per[S]["device_ms_by_max_groups"] = by_groups
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
                       ring["prompts"], n_new=PROFILED_NEW)
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


# ---------------------------------------------------------------------------
# phases 11-13: speculation, the draft model and the gather backend
# ---------------------------------------------------------------------------

NEAR_TIE = 1e-4      # a plain run's top-2 gap under this share of max|logit|
ROUTER_TIE = 1e-6    # k-th minus (k+1)-th router probability of a near tie


def paged_model(dtype, **ft):
    """gpt2 at full width with the config's dtype (and FT fields)
    replaced."""
    return family_model(ARCH, dtype, **ft)


def model_params(torch, model, seed):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return model.init(gen)


def mixed_prompts(np, vocab, seed):
    """16 prompts of 64-512 tokens: even ones tile a random 3-token pattern
    (the n-gram proposer's regime), odd ones are random."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(16):
        t = int(rng.integers(64, 513))
        if i % 2 == 0:
            pat = rng.integers(0, vocab, (3,)).astype(np.int32)
            out.append(np.tile(pat, -(-t // 3))[:t])
        else:
            out.append(rng.integers(0, vocab, (t,)).astype(np.int32))
    return out


def fused_engine(model, params, **kw):
    from repro_torch.serve import PagedServeEngine
    return PagedServeEngine(model, params, n_slots=8, block_size=16,
                            chunk_size=64, chunk_budget=256, **dict(
                                dict(kernel="fused"), **kw))


class Margins:
    """While installed, keeps for each slot the top-2 logit gap and max
    |logit| of the row the last fused step (``Model.score`` over the paged
    cache) sampled from; with ``router_ties``, also the number of the
    slot's real rows, over every MoE layer, whose k-th and (k+1)-th router
    probabilities differ by less than ``ROUTER_TIE``."""

    def __init__(self, torch, model, router_ties=False):
        self.last = None
        self.gaps, self.ties = [], None
        orig = model.score

        def score(params, tokens, cache, fault=None, **kw):
            self.gaps = []
            out = orig(params, tokens, cache, fault=fault, **kw)
            logits = out[0]
            idx = (cache.q_len.long() - 1).clamp(min=0)
            rows = logits[torch.arange(logits.shape[0],
                                       device=logits.device), idx]
            top2 = rows.topk(2, dim=-1).values
            self.last = list(zip((top2[:, 0] - top2[:, 1]).tolist(),
                                 rows.abs().amax(dim=-1).tolist()))
            if self.gaps:
                # router near ties of each slot's real rows, every layer
                c = tokens.shape[1]
                real = (torch.arange(c, device=logits.device)[None, :]
                        < cache.q_len[:, None]).reshape(-1)
                tie = torch.stack([(g < ROUTER_TIE) & real
                                   for g in self.gaps])
                self.ties = tie.view(len(self.gaps), -1, c).sum(
                    dim=(0, 2)).tolist()
            return out

        model.score = score
        restore = [lambda: model.__dict__.pop("score", None)]
        if router_ties:
            import repro_torch.models.moe as moe_mod
            orig_route = moe_mod.route

            def route(x2d, router, top_k):
                out = orig_route(x2d, router, top_k)
                top = out[0].topk(top_k + 1, dim=-1).values
                self.gaps.append(top[:, top_k - 1] - top[:, top_k])
                return out

            moe_mod.route = route
            restore.append(lambda: setattr(moe_mod, "route", orig_route))
        self.restore = lambda: [r() for r in restore]


def drive(torch, np, eng, prompts, n_new, *, faults_at=None,
          before_step=None, margins=False, profile_steps=None,
          step_times=False, split=False, router_ties=False):
    """Submit ``prompts`` and step ``eng`` to the end. Returns tokens per
    rid, wall seconds, steps, B1 launches (counted from 0 here) in all and
    by layout and chunk width, and, with
    ``margins``, (gap, max|logit|) of the row each token was sampled from;
    ``profile_steps`` (first, last) profiles that window of steps (CUDA
    activity) for the device's busy share, and with ``split`` (CPU activity
    too) its device time by model part (``Split``); a dict of such windows
    by name gives a dict of busy shares. ``step_times``
    synchronises after each step and keeps its wall time; ``router_ties``
    keeps, per token, how many router near ties its request met so far."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.efta_paged import efta_paged_attention
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    mg = Margins(torch, eng.model, router_ties) if margins else None
    labels = Split() if split else None
    origin, ties_at, ties = {}, {}, {}
    windows = (profile_steps if isinstance(profile_steps, dict)
               else {None: profile_steps} if profile_steps else {})
    prof = window = None
    busy = {}
    step_ms = []
    zero_b1_counts()
    i = 0
    t_start = time.perf_counter()
    while eng.scheduler.has_work:
        for name, steps in windows.items():
            if i == steps[0]:
                window = name
        if window is not None and prof is None:
            torch.cuda.synchronize()
            acts = [ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if split else [])
            prof = profile(activities=acts)
            prof.__enter__()
            t_prof = time.perf_counter()
        if before_step is not None:
            before_step(eng, i)
        before = {r.rid: (r.num_generated, r.slot)
                  for r in eng.scheduler.active_rows()}
        t0 = time.perf_counter()
        eng.step(faults=(faults_at or (lambda e, i: None))(eng, i))
        if step_times:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if mg is not None:
            for r in eng.scheduler.active_rows() + list(
                    eng.scheduler.finished):
                if r.rid not in before:
                    continue
                if mg.ties is not None and before[r.rid][1] is not None:
                    ties[r.rid] = ties.get(r.rid, 0) + int(
                        mg.ties[before[r.rid][1]])
                if r.num_generated == before[r.rid][0] + 1:
                    origin[(r.rid, r.num_generated - 1)] = \
                        mg.last[before[r.rid][1]]
                    ties_at[(r.rid, r.num_generated - 1)] = ties.get(r.rid,
                                                                     0)
        if prof is not None and i == windows[window][1]:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_prof) * 1e3
            prof.__exit__(None, None, None)
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.key not in Split.LABELS]
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            busy[window] = {"steps": list(windows[window]),
                            "wall_ms": wall_ms, "device_ms": dev_ms,
                            "device_busy_share": dev_ms / wall_ms}
            if labels is not None:
                busy[window]["device_ms_by_part"] = labels.parts(
                    prof, kern, dev_ms)
            prof = window = None
        i += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    if mg is not None:
        mg.restore()
    if labels is not None:
        labels.restore()
    check(prof is None, "profile window never closed")
    outs = {r.rid: np.asarray(r.generated, np.int32)
            for r in eng.scheduler.finished}
    check(len(outs) == len(prompts) and all(
        len(outs[r]) == n_new for r in rids), "not every request finished")
    if not isinstance(profile_steps, dict):
        busy = busy.get(None)
    return dict(eng=eng, outs=[outs[r] for r in rids], wall=wall, steps=i,
                launches=efta_paged_attention.launches,
                b1_by_layout=b1_by_layout(), origin=origin,
                ties_at=ties_at,
                busy=busy, tokens=len(prompts) * n_new, step_ms=step_ms)


class Split:
    """While installed, brackets the model's parts with profiler labels,
    so a profiled window (CPU and CUDA activity) splits its device time:
    B1 (its kernels by name), the routed experts (``moe_apply``: routing,
    dispatch, expert products, combine), the rest of attention (the
    label's kernels: projections, RoPE, KV append, checksums; B1 is
    launched from its ctypes wrapper, outside any PyTorch op, and the
    profiler ties its kernels to no label), the dense MLPs (kimi's shared
    expert, arctic's residual MLP), the LM head, and everything else."""

    LABELS = ("moe_experts", "attention", "dense_mlp", "lm_head")

    def __init__(self):
        import torch.profiler as tp
        import repro_torch.models.transformer as tr
        self.saved = []
        for label, name in zip(self.LABELS, ("moe_apply", "attn_apply",
                                             "mlp_apply", "unembed")):
            orig = getattr(tr, name)

            def wrapped(*a, orig=orig, label=label, **kw):
                with tp.record_function(label):
                    return orig(*a, **kw)
            setattr(tr, name, wrapped)
            self.saved.append((tr, name, orig))

    def restore(self):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)

    def parts(self, prof, kern, total_ms):
        """Device ms by part; a part whose label the profiler tied to no
        kernel is None (not measured)."""
        from torch.autograd import DeviceType
        by = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
              if e.key in self.LABELS and e.device_type == DeviceType.CPU}
        b1 = sum(e.self_device_time_total for e in kern
                 if "efta_paged" in e.key) / 1e3
        out = {"b1": b1}
        for label in self.LABELS:
            out[label] = by.get(label) or None
        known = [v for v in out.values() if v is not None]
        out["other"] = total_ms - sum(known)
        return out


def gate_tokens(np, ref, got, what):
    """``got``'s tokens against the plain run ``ref``'s: a divergence fails
    unless the plain run's top-2 gap at the first differing token is under
    ``NEAR_TIE`` of that row's max |logit| (f32 arithmetic that differs in
    its last bits may flip such a tie). Returns the near ties seen."""
    ties = []
    for rid, (a, b) in enumerate(zip(ref["outs"], got["outs"])):
        if np.array_equal(a, b):
            continue
        i = int(np.flatnonzero(a[:len(b)] != b[:len(a)])[0])
        gap, mx = ref["origin"][(rid, i)]
        check(gap < NEAR_TIE * mx,
              f"{what}: request {rid} token {i} differs from the plain run "
              f"({a[i]} vs {b[i]}), top-2 gap {gap:.3e} of max|logit| "
              f"{mx:.3e} is no near tie")
        ties.append({"request": rid, "token": i, "gap": gap,
                     "gap_over_max": gap / mx})
    return ties


def same_share(np, a_outs, b_outs):
    n = sum(len(a) for a in a_outs)
    return sum(int((a == b).sum()) for a, b in zip(a_outs, b_outs)) / n


def run_line(run):
    eng = run["eng"]
    return {"tokens_per_s": run["tokens"] / run["wall"], "wall_s": run["wall"],
            "steps": eng.stats.steps, "forwards": eng.stats.forwards,
            "b1_launches": run["launches"],
            "b1_by_layout": run["b1_by_layout"],
            "acceptance_rate": eng.acceptance_rate,
            "device_busy": run["busy"]}


def check_b1(run, L, what):
    """B1 launched once per layer of every forward, at widths 64 and 1,
    every launch at width 1 on the decode or the long-table layout (a
    speculative run may have none)."""
    eng = run["eng"]
    check(run["launches"] > 0 and run["launches"] == L * eng.stats.forwards,
          f"{what}: {run['launches']} B1 launches for {eng.stats.forwards} "
          f"forward passes")
    check(eng.chunk_widths <= {1, 64},
          f"{what}: chunk widths {sorted(eng.chunk_widths)}")
    check_b1_decode_launches(run["b1_by_layout"], what, need=False,
                             layouts=("decode", "long"))


def phase_spec_serve(torch, np, seed):
    """Speculative decoding on the fused backend at gpt2 full width: the
    n-gram proposer at K 4 on 16 mixed prompts. In f32 the tokens equal the
    plain fused run's (near ties aside); in bf16 their share is reported.
    Each dtype's faulted twin — EXP SEUs on a speculating slot's scoring
    row, a resident flip, a flip between the scoring step and the rollback —
    detects and repairs all three and emits its clean twin's tokens."""
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.serve import batch_faults
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = paged_model(dtype)
        params = model_params(torch, model, seed)
        L = model.cfg.num_layers
        prompts = mixed_prompts(np, model.cfg.vocab_size, seed + 11)
        plain = drive(torch, np, fused_engine(model, params), prompts, 32,
                      margins=True)
        check_b1(plain, L, f"{dtype} plain")
        spec = drive(torch, np, fused_engine(model, params, speculate="ngram",
                                             draft_len=4), prompts, 32)
        check_b1(spec, L, f"{dtype} spec")
        ps = spec["eng"].paged_stats
        check(ps.spec_steps > 0 and ps.spec_rolled_back_rows > 0,
              f"{dtype} spec: {ps}")
        check(spec["eng"].telemetry.summary()["detected"] == 0 and
              ps.kv_detected_blocks == 0, f"{dtype} spec clean detections")
        ties = (gate_tokens(np, plain, spec, f"{dtype} spec vs plain")
                if dtype == "float32" else None)

        # the faulted twin
        top = 30 if dtype == "float32" else 14
        state = {"seu_hit": None, "plan": None, "mid": False, "kv": False}

        def faults_at(eng, i, state=state):
            """An EXP SEU on row 0 of a decoding slot every step until one
            lands on a step where that slot speculated (row 0 then scores
            its first draft) and is detected."""
            t = state.pop("target", None)
            if t is not None:
                st = eng.telemetry.requests[t[0]]
                if st.draft_proposed > t[1] and \
                        sum(st.detected[:5]) > t[2]:
                    state["seu_hit"] = i - 1
            if state["seu_hit"] is not None:
                return None
            dec = [r for r in eng.scheduler.active_rows()
                   if not r.is_done() and r.slot is not None
                   and r.num_generated > 0]
            if not dec:
                return None
            r = dec[0]
            st = eng.telemetry.requests[r.rid]
            state["target"] = (r.rid, st.draft_proposed, sum(st.detected[:5]))
            return batch_faults(8, {r.slot: FaultSpec.single(
                Site.EXP, block=0, head=1, row=0, col=3, bit=27)})

        def before_step(eng, i, state=state):
            if i == 12:
                live = [r for r in eng.scheduler.active_rows()
                        if not r.is_done() and eng._pos[r.slot] > 16]
                check(live, "no live request to strike with a KV flip")
                eng.inject_kv_fault(layer=5, block=live[0].block_ids[0],
                                    head=3, row=2, col=7, bit=top, into="k")
                state["kv"] = True

        eng = fused_engine(model, params, speculate="ngram", draft_len=4)
        orig_rollback = eng._apply_rollback

        def apply_rollback(plan, by_slot, state=state):
            state["plan"] = plan
            return orig_rollback(plan, by_slot)

        def mid_rollback(e, state=state):
            if state["mid"]:
                return
            for slot, (keep, _) in sorted(state["plan"].items()):
                if keep % e.block_size:
                    req = next(r for r in e.scheduler.active_rows()
                               if r.slot == slot)
                    e.inject_kv_fault(
                        layer=2, block=req.block_ids[keep // e.block_size],
                        head=4, row=keep % e.block_size - 1, col=9, bit=top,
                        into="v")
                    state["mid"] = True
                    return

        eng._apply_rollback = apply_rollback
        eng._pre_rollback_hook = mid_rollback
        # the busy share is read in the faulted twin, after its faults, so
        # the profiler does not slow the clean runs whose tokens/s count
        faulted = drive(torch, np, eng, prompts, 32, faults_at=faults_at,
                        before_step=before_step, profile_steps=(20, 27))
        check_b1(faulted, L, f"{dtype} faulted spec")
        fps = eng.paged_stats
        check(state["seu_hit"] is not None and state["mid"] and state["kv"],
              f"{dtype}: not every fault struck: {state}")
        check(fps.rollback_detected_blocks >= 1 and
              fps.kv_detected_blocks >= 2 and fps.kv_repaired_blocks >= 2,
              f"{dtype} faulted: {fps}")
        for rid, (a, b) in enumerate(zip(spec["outs"], faulted["outs"])):
            check(np.array_equal(a, b), f"{dtype} faulted spec run's tokens "
                  f"differ from its clean twin's for request {rid}")
        out[dtype] = {
            "plain": run_line(plain), "spec": run_line(spec),
            "near_ties": ties,
            "spec_same_as_plain": same_share(np, plain["outs"],
                                             spec["outs"]),
            "spec_stats": dataclasses.asdict(ps),
            "faulted": {"seu_step": state["seu_hit"],
                        "stats": dataclasses.asdict(fps),
                        "forwards": eng.stats.forwards,
                        "retries": eng.stats.retries,
                        "device_busy": faulted["busy"]}}
        if dtype == "bfloat16":
            spec_b16 = spec
    emit({"phase": "spec_serve", "ok": True, "arch": ARCH, "requests": 16,
          "new_tokens": 32, "draft_len": 4, **out})
    return spec_b16


def phase_draft_serve(torch, np, seed):
    """The draft-model proposer in f32: a self-draft (the target's own
    weights) on 4 requests x 16 tokens, acceptance > 0.9, and a cold draft
    (other weights) on 2 x 8, whose rejections roll back; both give the
    plain run's tokens (near ties aside). The draft model runs plain EFTA on
    per-slot ring caches, the target B1."""
    model = paged_model("float32")
    params = model_params(torch, model, seed)
    cold = model_params(torch, model, seed + 1)
    L = model.cfg.num_layers
    prompts = mixed_prompts(np, model.cfg.vocab_size, seed + 11)[:4]
    res = {}
    for name, dparams, n_req, n_new in (("self", params, 4, 16),
                                        ("cold", cold, 2, 8)):
        plain = drive(torch, np, fused_engine(model, params),
                      prompts[:n_req], n_new, margins=True)
        eng = fused_engine(model, params, speculate="draft", draft_len=4,
                           draft_model=model, draft_params=dparams)
        run = drive(torch, np, eng, prompts[:n_req], n_new,
                    profile_steps=(2, 5) if name == "cold" else None)
        check_b1(run, L, f"draft {name}")
        ties = gate_tokens(np, plain, run, f"draft {name} vs plain")
        ps = eng.paged_stats
        if name == "self":
            check(eng.acceptance_rate > 0.9,
                  f"self-draft acceptance {eng.acceptance_rate:.3f}")
        else:
            check(ps.spec_rolled_back_rows > 0, f"cold draft: {ps}")
        check(eng.telemetry.summary()["detected"] == 0, "draft detections")
        res[name] = dict(run_line(run), near_ties=ties, plain=run_line(plain),
                         draft_forwards=eng._proposer.forwards,
                         rolled_back_rows=ps.spec_rolled_back_rows,
                         requests=n_req, new_tokens=n_new)
    emit({"phase": "draft_serve", "ok": True, "arch": ARCH, **res})


# requests of phase 13's runs: the first of phase 4's prompts (the phase
# waits on the host; 16 took it to 70-97 s of the script's time limit)
GATHER_REQUESTS = 8


def phase_gather_serve(torch, np, serve):
    """The gather backend in f32 on phase 4's first ``GATHER_REQUESTS``
    prompts (32 new tokens): under kv_verify "always" its tokens equal the
    fused backend's (near ties aside); its faulted twin with a resident
    flip detects, repairs and emits the same tokens; under "stamped" with
    a scrub every 4 steps a flip in the verified, untouched block the scrub
    folds next is caught and repaired, folds are skipped, and the tokens
    are the same. No kernel runs: the gather backend decodes with plain
    EFTA, as the JAX package's does."""
    from repro_torch.kernels.efta_attention import efta_attention
    model = paged_model("float32")
    params = model_params(torch, model, 0)
    prompts = serve["prompts"][:GATHER_REQUESTS]
    fused = drive(torch, np, fused_engine(model, params), prompts, 32,
                  margins=True)
    check_b1(fused, model.cfg.num_layers, "f32 fused")
    zero_b2_counts()
    always = drive(torch, np, fused_engine(model, params, kernel="gather"),
                   prompts, 32)
    ties = gate_tokens(np, fused, always, "gather vs fused")
    check(always["launches"] == 0 and efta_attention.launches == 0,
          "gather backend launched a kernel")
    check(always["eng"].paged_stats.kv_detected_blocks == 0,
          "gather clean detections")

    def flip_at(step, oldest):
        """Strike block 1 of a live request at ``step``; with ``oldest``,
        the live full block verified longest ago instead — the one the next
        scrub pass folds first (the stamped selector skips it: it is
        verified and untouched)."""
        def before_step(eng, i):
            if i != step:
                return
            live = [r for r in eng.scheduler.active_rows()
                    if not r.is_done() and eng._pos[r.slot] > 32]
            check(live, "no live request to strike")
            req, j = live[0], 1
            if oldest:
                bs = eng.block_size
                req, j = min(((r, j) for r in live
                              for j in range(int(eng._pos[r.slot]) // bs)),
                             key=lambda rj: eng.pool.blocks.verified_at(
                                 rj[0].block_ids[rj[1]]))
            eng.inject_kv_fault(layer=4, block=req.block_ids[j], head=2,
                                row=5, col=11, bit=30, into="k")
        return before_step

    runs = {}
    for name, kw, step, oldest in (
            ("always_flip", {}, 5, False),
            ("stamped_scrub", dict(kv_verify="stamped", scrub_interval=4),
             6, True)):
        eng = fused_engine(model, params, kernel="gather", **kw)
        run = drive(torch, np, eng, prompts, 32,
                    before_step=flip_at(step, oldest),
                    profile_steps=None if oldest else (20, 27))
        ps = eng.paged_stats
        check(ps.kv_detected_blocks >= 1 and ps.kv_repaired_blocks >= 1,
              f"gather {name}: flip not detected and repaired: {ps}")
        if name == "stamped_scrub":
            check(ps.kv_verify_skips > 0 and ps.kv_scrubbed_blocks > 0 and
                  ps.kv_verified_blocks < always["eng"].paged_stats.
                  kv_verified_blocks, f"gather {name}: {ps}")
        for rid, (a, b) in enumerate(zip(always["outs"], run["outs"])):
            check(np.array_equal(a, b), f"gather {name}: tokens differ from "
                  f"the clean always run for request {rid}")
        runs[name] = dict(run_line(run), stats=dataclasses.asdict(ps))
    emit({"phase": "gather_serve", "ok": True, "arch": ARCH,
          "requests": len(prompts),
          "new_tokens": 32, "fused_f32": run_line(fused),
          "always": dict(run_line(always),
                         stats=dataclasses.asdict(always["eng"].paged_stats)),
          "near_ties": ties, **runs})


# ---------------------------------------------------------------------------
# phases 14-18: linear-module ABFT, the encoder and encoder-decoder
# families on B2, and the decoupled baseline
# ---------------------------------------------------------------------------

def lin_compare(torch, got, ref, what, skip=None):
    """``got`` against ``ref`` element by element within ``out_bound`` (f32:
    1e-5 of the largest; bf16: about one bf16 ulp), apart from the element
    ``skip`` (row, column). Returns the largest error over its bound."""
    diff = (got.float() - ref.float()).abs()
    ratio = diff / out_bound(torch, ref)
    if skip is not None:
        ratio[skip] = 0.0
    worst = float(ratio.max())
    check(math.isfinite(worst) and worst <= 1.0,
          f"{what}: off the plain projection by {worst:.3f} of its bound")
    return worst


def phase_abft_linear(torch):
    """``tensor_abft_matmul`` and ``abft_matmul`` at gpt2's projection
    shapes, x (8 * 512, K) against K x N weights, in bf16 and f32: clean,
    no detection and the plain projection's output within one bf16 ulp
    (f32: 1e-5 of the largest); a GEMM1 SEU at the top exponent bit of the
    output of largest magnitude (it shrinks the value to ~0) is detected
    once and repaired, every other element within the clean bound. The
    repaired element is the struck value plus a checksum difference, so it
    carries the rounding of the checksum weights, stored in the operands'
    dtype: in bf16 it is held to 2^-8 |x_row| . |checksum column| beyond
    its clean bound (f32: the clean bound). The classic rank-1 check of a
    bf16 row is reported, not held: its threshold (5e-2 of a row sum over
    N columns) can miss the flip, and its index-weighted checksum, rounded
    to bf16 at weights up to N, can locate it to the wrong column — in the
    JAX package alike (``tests/test_torch_abft.py``). Device times of the
    plain product and both variants (profiler)."""
    from repro_torch.core import abft_gemm
    from repro_torch.core import checksum as cks
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.models.layers import matmul
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            g = torch.Generator(device=DEVICE).manual_seed(1400 + k + n)
            x = torch.randn((8 * 512, k), generator=g, device=DEVICE
                            ).to(dtype)
            w = (torch.randn((k, n), generator=g, device=DEVICE)
                 / math.sqrt(k)).to(dtype)
            plain = matmul(x, w)
            r, c = divmod(int(abft_gemm.product_f32(x, w).abs().argmax()), n)
            s = min(128, max(n // 2, 4))
            checks = {"tensor_abft_matmul": cks.encode_cols(w, s).c1[:, c % s],
                      "abft_matmul": cks.traditional_encode_cols(w)[:, 0]}
            spec = FaultSpec.single(Site.GEMM1, batch=r, head=c, bit=30)
            row = {"dtype": str(dtype)[6:], "x": [8 * 512, k], "w": [k, n],
                   "plain_device_ms": device_ms(torch, lambda: matmul(x, w),
                                                10),
                   "plain_ms": time_ms(torch, lambda: matmul(x, w), 20)}
            clean_tol = float(out_bound(torch, plain)[r, c])
            for name in ("tensor_abft_matmul", "abft_matmul"):
                fn = getattr(abft_gemm, name)
                y, nd = fn(x, w)
                what = f"{name} {row['dtype']} {k}x{n}"
                check(int(nd) == 0, f"{what}: {int(nd)} clean detections")
                clean_ratio = lin_compare(torch, y, plain, f"{what} clean")
                yf, ndf = fn(x, w, fault=spec)
                fix_err = abs(float(yf[r, c]) - float(plain[r, c]))
                fix_tol = clean_tol + (2.0 ** -8 * float(
                    x[r].float().abs() @ checks[name].float().abs())
                    if dtype == torch.bfloat16 else 0.0)
                off = ((yf.float() - plain.float()).abs()
                       > out_bound(torch, plain)).nonzero().tolist()
                if name == "abft_matmul" and dtype == torch.bfloat16:
                    # the rank-1 check of a wide bf16 row: reported, as
                    # the JAX package does the same (ROADMAP, Queue C)
                    pass
                else:
                    check(int(ndf) == 1, f"{what}: SEU detected {int(ndf)}x")
                    lin_compare(torch, yf, plain, f"{what} SEU", skip=(r, c))
                    check(fix_err <= fix_tol, f"{what}: repaired element off "
                          f"by {fix_err:.3e} > {fix_tol:.3e}")
                dev = device_ms(torch, lambda fn=fn: fn(x, w), 10)
                row[name] = {
                    "device_ms": dev, "ms": time_ms(torch, lambda fn=fn:
                                                    fn(x, w), 20),
                    "over_plain": time_ratio(dev, row["plain_device_ms"]),
                    "clean_err_over_bound": clean_ratio,
                    "struck": [r, c], "struck_value": float(plain[r, c]),
                    "seu_detected": int(ndf), "seu_off_clean_bound": off[:4],
                    "repaired_err": fix_err, "repaired_tol": fix_tol,
                    "repaired_within_clean_bound": fix_err <= clean_tol}
            rows.append(row)
    emit({"phase": "abft_linear", "ok": True, "cases": rows})


def phase_ff_abft_serve(torch, np, serve):
    """Phase 4's fused paged run (gpt2 full width, 8 slots, phase 4's 16
    prompts, 32 new tokens) with ``ff_abft`` off and on, in f32 and bf16,
    in one call: f32 tokens equal (near ties aside), the bf16 share of
    equal tokens reported, B1 at 12 launches per forward, tokens/s of
    both."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for ff in (False, True):
            model = paged_model(dtype, ff_abft=ff)
            params = model_params(torch, model, 0)
            run = drive(torch, np, fused_engine(model, params),
                        serve["prompts"], 32, margins=not ff)
            check_b1(run, model.cfg.num_layers, f"{dtype} ff_abft {ff}")
            check(run["eng"].telemetry.summary()["detected"] == 0,
                  f"{dtype} ff_abft {ff}: clean detections")
            runs[ff] = run
        ties = (gate_tokens(np, runs[False], runs[True],
                            f"{dtype} ff_abft vs plain")
                if dtype == "float32" else None)
        out[dtype] = {"plain": run_line(runs[False]),
                      "ff_abft": run_line(runs[True]),
                      "tokens_per_s_ratio": runs[False]["wall"]
                      / runs[True]["wall"],
                      "same_tokens": same_share(np, runs[False]["outs"],
                                                runs[True]["outs"]),
                      "near_ties": ties}
    emit({"phase": "ff_abft_serve", "ok": True, "arch": ARCH,
          "requests": len(serve["prompts"]), "new_tokens": 32, **out})


def forward_times(torch, fn, reps=3):
    """Host-clock wall time per call (ends synchronised) and the
    profiler's device time per call (all kernels of the call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    return {"wall_ms": wall, "device_ms": device_ms(torch, fn, 2)}


def phase_encoder(torch, np, seed):
    """bert-large at full width (24 layers, d_model 1024, 16 heads of 64),
    ``Model.logits`` on B 8, S 512 under ``efta_pallas``: logits against
    the same weights under plain-PyTorch ``efta``, in f32 (within 1e-4 of
    the largest logit: only the summation order differs) and in bf16
    (rms difference within 5e-2 of the logits' rms: each layer rounds the
    attention output to bf16 in its own order, over 24 layers); B2 24
    launches per forward; an ``ft.mode`` off/detect/correct sweep with
    ``ff_abft`` off and on (bf16), device and wall time per forward; a
    GEMM II SEU in correct mode (every layer, top exponent bit) detected,
    the logits within 2e-2 of the largest clean logit with the same
    argmax; B2 at this shape against its plain version, its bound and
    SDPA (non-causal)."""
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.kernels.efta_attention import efta_attention
    from repro_torch.models.transformer import forward
    arch = "bert-large"
    model = family_model(arch, attn_impl="efta_pallas")
    cfg = model.cfg
    check(cfg.d_model == 1024 and cfg.num_layers == 24 and
          cfg.attn.num_heads == 16 and cfg.family == "encoder",
          "bert-large is not at full width")
    rng = np.random.default_rng(seed + 16)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                           device=DEVICE).long()
    batch = {"tokens": toks}
    res = {}
    for dtype in ("float32", "bfloat16"):
        m_k = family_model(arch, attn_impl="efta_pallas", dtype=dtype)
        params = model_params(torch, m_k, seed)
        m_p = family_model(arch, attn_impl="efta", dtype=dtype)
        rec = RegimeRecorder() if dtype == "bfloat16" else None
        zero_b2_counts()
        got, rep = m_k.logits(params, batch)
        torch.cuda.synchronize()
        launches = efta_attention.launches
        if rec is not None:
            rec.restore()
        ref, rep_p = m_p.logits(params, batch)
        check(launches == cfg.num_layers, f"bert-large {dtype}: {launches} "
              f"B2 launches for {cfg.num_layers} layers")
        check(int(rep.detected.sum()) == 0 and int(rep_p.detected.sum()) == 0,
              f"bert-large {dtype}: clean detections")
        diff = (got - ref).abs()
        big = float(ref.abs().max())
        rms_rel = float(diff.square().mean().sqrt() / ref.square().mean()
                        .sqrt())
        if dtype == "float32":
            check(float(diff.max()) <= 1e-4 * big, f"bert-large f32: "
                  f"logits off plain EFTA by {float(diff.max()):.3e}")
        else:
            check(rms_rel <= 5e-2, f"bert-large bf16: rms off plain EFTA "
                  f"{rms_rel:.3e}")
        res[dtype] = {"b2_launches": launches,
                      "max_abs_diff_vs_efta": float(diff.max()),
                      "max_abs_logit": big, "rms_rel_diff": rms_rel,
                      "argmax_same": float((got.argmax(-1) == ref.argmax(-1))
                                           .float().mean())}
        del ref, diff, m_p
    # the sweep (bf16): the paper's Fig. 15 overhead on this card
    sweep = {}
    for ff in (False, True):
        for mode in ("off", "detect", "correct"):
            m = family_model(arch, attn_impl="efta_pallas", mode=mode,
                             ff_abft=ff)
            sweep[f"{mode}{' ff_abft' if ff else ''}"] = forward_times(
                torch, lambda m=m: m.logits(params, batch))
    base = sweep["off"]["device_ms"]
    for v in sweep.values():
        v["device_over_off"] = time_ratio(v["device_ms"], base)
    # a GEMM II SEU in every layer, correct mode
    clean, _ = model.logits(params, batch)
    spec = FaultSpec.single(Site.GEMM2, block=0, batch=1, head=3, row=511,
                            col=5, bit=30)
    struck, rep_f, _ = forward(params, cfg, toks, mode="train", fault=spec)
    d = float((struck - clean).abs().max())
    same_top = bool(torch.equal(struck[1, 511].argmax(), clean[1, 511]
                                .argmax()))
    check(int(rep_f.detected.sum()) >= 1 and same_top and
          d <= 2e-2 * float(clean.abs().max()),
          f"bert-large GEMM II SEU: detected {rep_f.detected.sum(0).tolist()},"
          f" logits off by {d:.3e}")
    key = (512, 512, False)
    numbers = b2_regime_numbers(torch, rec.captured[key])
    emit({"phase": "encoder", "ok": True, "arch": arch, "batch": [8, 512],
          **res, "sweep": sweep,
          "gemm2_seu": {"detected": rep_f.detected.sum(0).tolist(),
                        "max_abs_logit_diff": d, "same_argmax": same_top},
          "b2": numbers})
    return {"encoder_bert_large": dict(numbers, launches=res["bfloat16"][
        "b2_launches"], launches_per="forward")}


def phase_encdec(torch, np, seed):
    """t5-small at full width (6 + 6 layers, d_model 512, 8 heads),
    ``greedy_generate`` on B 8 with ``enc_tokens`` (8, 512) from the seed,
    64-token prompts and 32 new tokens, under ``efta_pallas``, in f32 and
    bf16: f32 tokens equal the ``efta`` run's except at near ties (top-2
    gap under 1e-4 of max|logit| at the first differing token); B2
    launches counted by regime (encoder 6, decoder prefill 6 self + 6
    cross, 6 cross at Sq 1 per decode step); every regime held against the
    plain version, clean and under each compute SEU; the Sq 1 cross launch
    timed with its bound and SDPA."""
    from repro_torch.kernels.efta_attention import efta_attention
    from repro_torch.serve import greedy_generate
    arch = "t5-small"
    out, entries = {}, {}
    n_new = 32
    for dtype in ("float32", "bfloat16"):
        m_k = family_model(arch, attn_impl="efta_pallas", dtype=dtype)
        cfg = m_k.cfg
        check(cfg.d_model == 512 and cfg.num_layers == 6 and
              cfg.encoder_layers == 6 and cfg.attn.num_heads == 8,
              "t5-small is not at full width")
        params = model_params(torch, m_k, seed)
        rng = np.random.default_rng(seed + 17)
        enc = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                              device=DEVICE).long()
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 64)),
                                 device=DEVICE).long()
        rec = RegimeRecorder()
        zero_b2_counts()
        t0 = time.perf_counter()
        toks, rep = greedy_generate(m_k, params, prompt, steps=n_new,
                                    enc_tokens=enc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = efta_attention.launches
        by_layout = b2_by_layout()
        rec.restore()
        L = cfg.num_layers
        want = {(512, 512, False): cfg.encoder_layers, (64, 64, True): L,
                (64, 512, False): L, (1, 512, False): L * n_new}
        check(rec.counts == want and launches == sum(want.values()),
              f"t5 {dtype}: B2 launches {rec.counts} (kernel {launches}), "
              f"want {want}")
        check_decode_launches(by_layout, f"t5 {dtype}")
        check(by_layout["decode Sq1"] == L * n_new,
              f"t5 {dtype}: {by_layout} decode launches, want {L * n_new}")
        check(int(rep.detected.sum()) == 0, f"t5 {dtype}: clean detections")
        # the plain-EFTA oracle, its logits' top-2 gaps kept per token
        m_p = family_model(arch, attn_impl="efta", dtype=dtype)
        gaps = []
        for meth in ("prefill", "decode_step"):
            orig = getattr(m_p, meth)

            def wrapped(*a, orig=orig, **kw):
                res = orig(*a, **kw)
                top2 = res[0].topk(2, dim=-1).values
                gaps.append(((top2[:, 0] - top2[:, 1]).tolist(),
                             res[0].abs().amax(dim=-1).tolist()))
                return res
            setattr(m_p, meth, wrapped)
        t0 = time.perf_counter()
        ref, _ = greedy_generate(m_p, params, prompt, steps=n_new,
                                 enc_tokens=enc)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        a, b = toks.cpu().numpy(), ref.cpu().numpy()
        ties = []
        for r in range(8):
            if np.array_equal(a[r], b[r]):
                continue
            i = int(np.flatnonzero(a[r] != b[r])[0])
            gap, mx = gaps[i][0][r], gaps[i][1][r]
            check(dtype != "float32" or gap < NEAR_TIE * mx,
                  f"t5 f32: row {r} token {i} differs from plain EFTA "
                  f"({a[r][i]} vs {b[r][i]}), top-2 gap {gap:.3e} of "
                  f"{mx:.3e} is no near tie")
            ties.append({"row": r, "token": i, "gap_over_max": gap / mx})
        regimes = {regime_name(k): b2_regime_numbers(torch, cap)
                   for k, cap in sorted(rec.captured.items())}
        out[dtype] = {"b2_launches": launches, "b2_by_layout": by_layout,
                      "by_regime": {regime_name(k): n
                                    for k, n in rec.counts.items()},
                      "per_decode_step": rec.counts[(1, 512, False)] / n_new,
                      "tokens_per_s": 8 * n_new / wall,
                      "plain_efta_tokens_per_s": 8 * n_new / wall_p,
                      "same_tokens": float((a == b).mean()),
                      "differing_rows": ties, "regimes": regimes}
        if dtype == "bfloat16":
            for key, name in (((1, 512, False), "cross_decode_t5"),
                              ((64, 512, False), "cross_prefill_t5"),
                              ((512, 512, False), "encoder_t5")):
                entries[name] = dict(regimes[regime_name(key)],
                                     launches=rec.counts[key],
                                     launches_per=f"{n_new}-token greedy run")
    emit({"phase": "encdec", "ok": True, "arch": arch, "batch": 8,
          "enc_tokens": 512, "prompt": 64, "new_tokens": n_new, **out})
    return entries


def phase_decoupled(torch):
    """The decoupled baseline (``core.decoupled``) against B2 at gpt2 heads
    (B 1, H 12, D 64, causal, bf16), S 512 to 4096: both round each entry
    of P to bf16 before the P.V product and the output once, so both are
    held to 2^-8 (|r| + P.|V|) of ``reference_attention`` in f32;
    at S 512 GEMM1, EXP and GEMM2 SEUs on row 400 of head 3, in the column
    of that row's largest clean B2 output (the decoupled side's FaultSpec
    flips bit 27, as the JAX package's test; B2's descriptors flip bit 30,
    the top exponent bit): the decoupled scheme detects and corrects the
    GEMM ones in f32 (in bf16 its rank-1 threshold, 5e-2 of a 512-wide row
    sum, may miss them: reported) and counts nothing at EXP in either (P
    is struck between its stages, where nothing checks it); B2 (bf16)
    equals its plain version under each (counts equal, outputs within
    ``out_bound``), detects all three and recomputes EXP bit for bit (a
    GEMM II flip of an output under eps_out would go uncounted, in the JAX
    package alike: ROADMAP standing item 2); device
    time of both (profiler), their ratio and ``decoupled_memory_bytes``;
    stops at the first S whose S, P and the f32 softmax copies would pass
    half the card's memory."""
    from repro_torch.core.decoupled import (decoupled_ft_attention,
                                            decoupled_memory_bytes)
    from repro_torch.core.efta import EFTAConfig, reference_attention
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_torch)
    half = torch.cuda.get_device_properties(0).total_memory / 2
    cfg = EFTAConfig()
    rows, stopped = [], None
    for S in (512, 1024, 2048, 4096):
        # S and P in f32, the two softmax copies, P in bf16
        need = 4 * decoupled_memory_bytes(1, 12, S, S, torch.float32) // 2 \
            + decoupled_memory_bytes(1, 12, S, S) // 2
        if need > half:
            stopped = S
            break
        g = torch.Generator(device=DEVICE).manual_seed(1800 + S)
        q, k, v = (torch.randn((1, 12, S, 64), generator=g, device=DEVICE)
                   .bfloat16() for _ in range(3))
        ref = reference_attention(q.float(), k.float(), v.float(),
                                  causal=True)
        bound = 2.0 ** -8 * (ref.abs() + reference_attention(
            q.float(), k.float(), v.float().abs(), causal=True)) + 1e-6
        torch.cuda.reset_peak_memory_stats()
        dec, rep_d = decoupled_ft_attention(q, k, v, causal=True)
        peak = torch.cuda.max_memory_allocated()
        b2, det_b2 = efta_attention(q, k, v, cfg=cfg, causal=True)
        for name, o in (("decoupled", dec), ("B2", b2)):
            ratio = float(((o.float() - ref).abs() / bound).max())
            check(ratio <= 1.0, f"S {S} {name}: off reference_attention by "
                  f"{ratio:.3f} of its bound")
        check(int(rep_d.detected.sum()) == 0 and int(det_b2.sum()) == 0,
              f"S {S}: clean detections")
        row = {"S": S, "decoupled_memory_bytes": decoupled_memory_bytes(
            1, 12, S, S), "decoupled_peak_bytes": peak,
            "decoupled_device_ms": device_ms(
                torch, lambda: decoupled_ft_attention(q, k, v, causal=True),
                5),
            "decoupled_ms": time_ms(
                torch, lambda: decoupled_ft_attention(q, k, v, causal=True),
                5),
            "b2_device_ms": device_ms(
                torch, lambda: efta_attention(q, k, v, cfg=cfg, causal=True),
                10, name="efta_attention_kernel"),
            "b2_ms": time_ms(
                torch, lambda: efta_attention(q, k, v, cfg=cfg, causal=True),
                10)}
        row["decoupled_over_b2"] = time_ratio(row["decoupled_device_ms"],
                                         row["b2_device_ms"])
        if S == 512:
            seu = {}
            # row 400 of head 3, at its largest clean output: a column of D
            # 64 on both sides, where a GEMM II flip passes eps_out
            s_row = 400
            s_col = int(b2[0, 3, s_row].float().abs().argmax())
            for site in (Site.GEMM1, Site.EXP, Site.GEMM2):
                spec = FaultSpec.single(site, block=0, head=3, row=s_row,
                                        col=s_col, bit=27)
                for dt in (torch.float32, torch.bfloat16):
                    qd, kd, vd = (t.to(dt) for t in (q, k, v))
                    clean_d, _ = decoupled_ft_attention(qd, kd, vd,
                                                        causal=True)
                    o, rep = decoupled_ft_attention(qd, kd, vd, causal=True,
                                                    fault=spec)
                    n = rep.detected.tolist()
                    err = float((o.float() - clean_d.float()).abs().max())
                    what = f"decoupled {site.name} SEU {str(dt)[6:]}"
                    if site == Site.EXP:
                        check(sum(n) == 0 and err > 0, f"{what}: detected "
                              f"{n}, output moved {err:.3e}")
                    elif dt == torch.float32:
                        check(n[0 if site == Site.GEMM1 else 4] == 1 and
                              err <= 1e-4 * float(clean_d.abs().max()),
                              f"{what}: detected {n}, off the clean output "
                              f"by {err:.3e}")
                    seu[f"{site.name} {str(dt)[6:]}"] = {
                        "decoupled_detected": n, "decoupled_off_clean": err}
                desc = [int(site), 0, 3, s_row, s_col, 30, 1, 0]
                ob, db = efta_attention(q, k, v, cfg=cfg, causal=True,
                                        fault=desc)
                b2_compare(torch, (ob, db), efta_attention_torch(
                    q, k, v, cfg=cfg, causal=True, fault=desc),
                    f"B2 {site.name} SEU against its plain version")
                eb = float((ob.float() - b2.float()).abs().max())
                if site == Site.EXP:
                    check(torch.equal(ob, b2) and int(db.sum()) >= 1,
                          f"B2 EXP SEU: detected {db.tolist()}, off {eb}")
                else:
                    check(eb <= 2e-2 * float(b2.float().abs().max()) and
                          int(db.sum()) >= 1,
                          f"B2 {site.name} SEU: detected {db.tolist()}, off "
                          f"the clean output by {eb:.3e}")
                seu[f"{site.name} B2 bf16"] = {"b2_detected": db.tolist(),
                                               "b2_off_clean": eb}
            row["seu"] = seu
        rows.append(row)
        del q, k, v, ref, bound, dec, b2
        torch.cuda.empty_cache()
    emit({"phase": "decoupled", "ok": True, "shape": "B 1, H 12, D 64, "
          "causal, bf16", "rows": rows, "stopped_at": stopped,
          "half_memory_bytes": half})
    return {"decoupled_" + str(r["S"]): {
        "device_ms": r["b2_device_ms"], "ms": r["b2_ms"],
        "decoupled_device_ms": r["decoupled_device_ms"],
        "decoupled_over_b2": r["decoupled_over_b2"]} for r in rows}


# ---------------------------------------------------------------------------
# phases 19-22: B1 and B2 in the moe family's attention regimes, the moe
# family through both engines, and the ssm and hybrid families on the
# static-batch route
# ---------------------------------------------------------------------------

MOE_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b")
MOE_LAYERS = 2          # of 61 (kimi) and 35 (arctic): one H100 holds two
KIMI_F32_LAYERS = 1     # two layers of kimi in f32 would be 141 GB
SSM_ARCHS = ("rwkv6-7b", "hymba-1.5b")
SSM_PROFILED_STEPS = 2  # decode steps in the profiled window (hymba's
#                         plain-EFTA decode launches ~19k kernels a step)
SSM_F32_STEPS = 8       # new tokens of the f32 check against the forward
SSM_LAYERS = 8          # of 32: keeps the script inside its time limit


def free(torch):
    """Return the freed models' memory to the card before the next one."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def moe_model(arch, dtype, layers, **ft):
    """``arch`` at its published width with ``layers`` layers (the only
    cut), in ``dtype``, with FT fields replaced where given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    check(cfg.family == "moe" and cfg.d_model == 7168 and
          cfg.attn.num_kv_heads == 8, f"{arch} is not at full width")
    return build_model(dataclasses.replace(
        cfg, dtype=dtype, num_layers=layers,
        ft=dataclasses.replace(cfg.ft, **ft)), device=DEVICE)


def p_rounding_slack(torch, case):
    """2^-7 (P |V|) per output element of a B1 case, P the masked softmax
    in f32 (each request's causal-in-chunk, ragged rows): the most by which
    rounding the probabilities to bf16 for the P V product can move an
    output when the kernel and its plain version round some p differently.
    Their f32 scores differ in the last bits (tensor-core GEMM I against
    sequential sums), so a p next to a bf16 rounding boundary may round
    either way; in bf16 a one-ulp change of p is up to 2^-7 of it. Phase 19
    reports how far the plain version moves from itself when only its GEMM
    I is summed in another order (``reordered_plain``): at the moe heads'
    C 64 steps that spread passes one output ulp too (PERF.md §6)."""
    q, k_pool, v_pool = case["q"], case["k"], case["v"]
    B, H, C, D = q.shape
    _, hkv, bs, _ = k_pool.shape
    kv_lens, q_lens = case["kv_lens"].long(), case["q_lens"].long()
    nbl = -(-int(kv_lens.max()) // bs)
    idx = case["bt"][:, :nbl].long()
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, nbl * bs, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, hkv, nbl * bs, D)
    k = k.repeat_interleave(H // hkv, dim=1).float()
    v = v.repeat_interleave(H // hkv, dim=1).float().abs()
    c = torch.arange(C, device=q.device)
    pos = (kv_lens - q_lens)[:, None] + c                      # (B, C)
    cols = torch.arange(nbl * bs, device=q.device)
    mask = ((cols[None, None, :] <= pos[:, :, None])
            & (cols[None, None, :] < kv_lens[:, None, None])
            & (c[None, :, None] < q_lens[:, None, None]))[:, None]
    s = torch.matmul(q.float(), k.transpose(-1, -2)) / math.sqrt(D)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return 2.0 ** -7 * torch.matmul(p.nan_to_num(0.0), v)


def reordered_plain(torch, case, cfg):
    """B1's plain version on ``case`` with only its GEMM I summed in another
    order: exactly rounded (in f64, then rounded to f32). The same
    arithmetic; how far its bf16 outputs move from the plain version's is
    the spread the kernel's own summation order may show."""
    from repro_torch.kernels.efta_paged import efta_paged_attention_torch
    d, bs = case["q"].shape[-1], case["k"].shape[2]
    matmul = torch.matmul

    def gemm1_exact(x, y, *a, **kw):
        if (x.dtype == torch.float32 and x.shape[-1] == d
                and tuple(y.shape[-2:]) == (d, bs)):
            return matmul(x.double(), y.double()).float()
        return matmul(x, y, *a, **kw)

    torch.matmul = gemm1_exact
    try:
        return call(efta_paged_attention_torch, case, cfg)
    finally:
        torch.matmul = matmul


def phase_kernel_regimes(torch):
    """B1 and B2 at the moe family's attention shapes, against their plain
    versions on the same CUDA tensors, in f32 and bf16: B1 at kimi-k2's
    (64 query heads on 8 KV heads of 112: 8 a group, output stride 7) and
    arctic's (56 on 8 of 128: 7 a group), at decode (C 1) and at a C 64
    step with decode rows, 8 requests over 64-block tables, clean, under
    each compute-site SEU (correct mode, top exponent bit) and a resident
    flip; B2 at the same heads, causal, bucket 512, clean and under each
    SEU. Counts and bad planes equal, outputs within ``out_bound``, in bf16
    plus ``p_rounding_slack``; each case timed as phase 5 (B1) and phase 9
    (B2) time theirs."""
    from repro_torch.configs import get_config
    from repro_torch.core import checksum as cks
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)
    cfg = EFTAConfig(mode="correct", stride=128, block_kv=512)
    b1, b2 = {}, {}
    for ai, arch in enumerate(MOE_ARCHS):
        a = get_config(arch).attn
        H, Hkv, D = a.num_heads, a.num_kv_heads, a.head_dim
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            for C in (1, 64):
                name = f"{arch} D{D} grp{H // Hkv} C{C} {dt}"
                case = make_case(torch, cks, dtype=dtype, B=8, H=H, Hkv=Hkv,
                                 D=D, C=C, seed=1900 + 10 * ai + C,
                                 decode_rows=C > 1)
                slack = (p_rounding_slack(torch, case)
                         if dtype == torch.bfloat16 else None)
                got, launched = b1_launched(
                    lambda: call(efta_paged_attention, case, cfg))
                check(C != 1 or launched == ["decode"],
                      f"{name}: launched on {launched}, not the decode "
                      f"layout")
                ref = call(efta_paged_attention_torch, case, cfg)
                torch.cuda.synchronize()
                compare(torch, got, ref, f"{name} clean", slack)
                over_ulp = int(((got.out.float() - ref.out.float()).abs()
                                > out_bound(torch, ref.out)).sum())
                self_spread = None
                if dtype == torch.bfloat16:
                    alt = reordered_plain(torch, case, cfg)
                    check(torch.equal(alt.detected, ref.detected),
                          f"{name}: the reordered plain version's counts "
                          f"differ")
                    self_spread = float(((alt.out.float() - ref.out.float())
                                         .abs() / out_bound(torch, ref.out))
                                        .max())
                check(int(got.detected.sum()) == 0 and
                      not bool(got.bad_blocks.any()),
                      f"{name}: detections on clean input")
                tol = max(out_tol(torch, ref.out), cfg.thresholds(dtype)[2])
                b, h = 1, 1
                j = (int(case["kv_lens"][b]) - int(case["q_lens"][b])) // 16
                seu = {}
                for site in (Site.GEMM1, Site.EXP, Site.ROWMAX,
                             Site.ROWSUM, Site.GEMM2):
                    desc = [int(site), j, b, h, 0, 3, seu_bit("correct"), 1]
                    got_f = call(efta_paged_attention, case, cfg, fault=desc)
                    ref_f = call(efta_paged_attention_torch, case, cfg,
                                 fault=desc)
                    compare(torch, got_f, ref_f, f"{name} {site.name}",
                            slack)
                    n = int(got_f.detected[b, :5].sum())
                    check(n >= 1 or site in (Site.GEMM1, Site.GEMM2),
                          f"{name} {site.name}: SEU not detected")
                    fix = float((got_f.out.float() - ref.out.float()).abs()
                                .max())
                    check(fix <= tol, f"{name} {site.name}: corrected output"
                          f" off the clean one by {fix:.3e} > {tol:.3e}")
                    seu[site.name] = got_f.detected[b].tolist()
                jl = (int(case["kv_lens"][2]) - 1) // 16
                kf = case["k"].clone()
                blk = int(case["bt"][2, jl])
                flip_bit_at(kf, ((blk * Hkv + 0) * 16 + 0) * D + 1,
                            top_exponent_bit(kf))
                got_k = call(efta_paged_attention, dict(case, k=kf), cfg)
                ref_k = call(efta_paged_attention_torch, dict(case, k=kf),
                             cfg)
                compare(torch, got_k, ref_k, f"{name} resident flip", slack)
                check(bool(got_k.bad_blocks[2, jl]) and
                      int(got_k.bad_blocks.sum()) == 1,
                      f"{name}: resident flip not flagged at its block")
                cap = {"q": case["q"], "k": case["k"],
                       "args": [case["v"], case["kc"], case["vc"], case["bt"],
                                case["kv_lens"], case["q_lens"]],
                       "kw": {"cfg": cfg, "window": None},
                       "load": int(case["q_lens"].sum())}
                b1[name] = dict(b1_numbers(torch, cap, name, slack),
                                seu=seu, elements_over_one_ulp=over_ulp,
                                plain_reordered_over_bound=self_spread,
                                kv_flip_det=got_k.detected[2].tolist())
            g = torch.Generator().manual_seed(1950 + ai)
            q = torch.randn((1, H, 512, D), generator=g)
            k = torch.randn((1, Hkv, 512, D), generator=g)
            v = torch.randn((1, Hkv, 512, D), generator=g)
            q, k, v = (x.to(DEVICE, dtype) for x in (q, k, v))
            b2[f"{arch} D{D} grp{H // Hkv} S512 {dt}"] = b2_regime_numbers(
                torch, {"q": q, "k": k, "v": v,
                        "kw": {"cfg": EFTAConfig(), "causal": True}},
                p_rounding=True)
    emit({"phase": "kernel_regimes", "ok": True, "b1": b1, "b2": b2})
    return b1, b2


# phase b1_chunk's regimes, the chunk path that B1's tile layout takes:
# (query heads, KV heads, head_dim, seed, decode rows) at C 64, B 8 and
# 64-block tables; the moe heads' are phase 19's bf16 C 64 inputs
B1_CHUNK = {"arctic_c64": (56, 8, 128, 1974, True),
            "kimi_c64": (64, 8, 112, 1964, True),
            "gpt2_prefill": (12, 12, 64, 1990, False)}
# and the launches the tile and decode layouts leave on the first layout:
# (heads, KV heads, head_dim, seed, C, dtype, unified output
# verification); the moe heads' are phase 19's inputs
B1_KEPT = {"kimi_c64_f32": (64, 8, 112, 1964, 64, "float32", True),
           "arctic_c64_per_step": (56, 8, 128, 1974, 64, "bfloat16",
                                   False)}
# phase b1_decode's regimes, the decode step (C 1) that B1's decode layout
# takes: (heads, KV heads, head_dim, seed, dtype) at B 8 and 64-block
# tables; the seeds are those the three ran under in ``B1_KEPT`` before
B1_DECODE = {"gpt2_decode": (12, 12, 64, 1991, "bfloat16"),
             "kimi_decode": (64, 8, 112, 1901, "bfloat16"),
             "arctic_decode": (56, 8, 128, 1911, "bfloat16"),
             "gpt2_decode_f32": (12, 12, 64, 1991, "float32"),
             "kimi_decode_f32": (64, 8, 112, 1901, "float32"),
             "arctic_decode_f32": (56, 8, 128, 1911, "float32")}
# phase b1_long's regimes, the decode step (C 1) over tables wider than the
# decode layout holds, which B1's long-table layout takes: (heads, KV heads,
# head_dim, seed, dtype, table blocks, least and most kv_len) at B 8.
# kimi_long_4k: the serve CLI's default cache (max_seq, 4,096 tokens) at
# kimi's heads; arctic_long_4k: arctic's published context; kimi_wide_short:
# phase 20's lengths in the default cache's table; kimi_long_32k: a
# 32,768-token cache
B1_LONG = {"kimi_long_4k": (64, 8, 112, 1921, "bfloat16", 256, 2048, 4096),
           "arctic_long_4k": (56, 8, 128, 1931, "bfloat16", 256, 2048, 4096),
           "kimi_wide_short": (64, 8, 112, 1941, "bfloat16", 256, 64, 576),
           "kimi_long_32k": (64, 8, 112, 1951, "bfloat16", 2048, 16384,
                             32768),
           "kimi_long_4k_f32": (64, 8, 112, 1921, "float32", 256, 2048,
                                4096),
           "arctic_long_4k_f32": (56, 8, 128, 1931, "float32", 256, 2048,
                                  4096)}


def b1_chunk_case(torch, name):
    """The inputs and config of a ``B1_CHUNK``, ``B1_KEPT``, ``B1_DECODE``
    or ``B1_LONG`` regime."""
    from repro_torch.core import checksum as cks
    from repro_torch.core.efta import EFTAConfig
    if name in B1_LONG:
        H, Hkv, D, seed, dtype, mb, lo, hi = B1_LONG[name]
        case = make_case(torch, cks, dtype=getattr(torch, dtype), B=8, H=H,
                         Hkv=Hkv, D=D, C=1, seed=seed, mb=mb, max_kv=hi,
                         min_kv=lo)
        return case, EFTAConfig(mode="correct", stride=128, block_kv=512)
    if name in B1_CHUNK:
        H, Hkv, D, seed, rows = B1_CHUNK[name]
        C, dtype, unified = 64, "bfloat16", True
    elif name in B1_DECODE:
        H, Hkv, D, seed, dtype = B1_DECODE[name]
        C, unified, rows = 1, True, False
    else:
        H, Hkv, D, seed, C, dtype, unified = B1_KEPT[name]
        rows = C > 1
    case = make_case(torch, cks, dtype=getattr(torch, dtype), B=8, H=H,
                     Hkv=Hkv, D=D, C=C, seed=seed, decode_rows=rows)
    return case, EFTAConfig(mode="correct", stride=128, block_kv=512,
                            unified=unified)


def b1_chunk_tiling(case, cfg):
    """B1's tiling of a case (the built kernel's rule), or None in a
    checkout from before the tile layout, whose wrapper has no rule to
    ask (its kernel then runs the first layout). A checkout from before
    the decode layout has a rule without the chunk width."""
    import inspect
    from repro_torch.kernels import efta_paged as ep
    rule = getattr(ep, "kernel_tiling", None)
    if rule is None:
        return None
    q, k = case["q"], case["k"]
    _, H, C, D = q.shape
    hkv, bs = k.shape[1], k.shape[2]
    kw = ({"chunk": C} if "chunk" in inspect.signature(rule).parameters
          else {})
    return rule(ep.DTYPES[q.dtype], H // hkv * C, D, bs,
                case["kc"].c1.shape[-2], cfg.kv_stride(bs),
                cfg.out_stride(D), case["bt"].shape[1], cfg.unified, **kw)


def b1_hash(torch, case, cfg):
    """The clean output and an EXP-faulted one (request 1, KV head 1, row
    0) hashed, with both detection vectors and the bad plane's sum."""
    import hashlib
    from repro_torch.kernels.efta_paged import efta_paged_attention
    j = (int(case["kv_lens"][1]) - int(case["q_lens"][1])) // 16
    got = call(efta_paged_attention, case, cfg)
    got_f = call(efta_paged_attention, case, cfg,
                 fault=[2, j, 1, 1, 0, 3, seu_bit("correct"), 1])
    h = hashlib.sha1(got.out.float().cpu().numpy().tobytes() +
                     got_f.out.float().cpu().numpy().tobytes())
    return {"hash": h.hexdigest()[:16], "detected": got.detected.tolist(),
            "detected_exp_seu": got_f.detected.tolist(),
            "bad_blocks": int(got.bad_blocks.sum())}


def b1_launched(fn):
    """``fn()`` and the layouts of the B1 launches that the wrapper counted
    in it, or None for them in a checkout whose wrapper does not count by
    layout (from before the tile layout)."""
    from repro_torch.kernels.efta_paged import efta_paged_attention
    by = getattr(efta_paged_attention, "launches_by_layout", None)
    n0 = dict(by or {})
    out = fn()
    if by is None:
        return out, None
    return out, sorted({k[0] for k, n in by.items() if n != n0.get(k, 0)})


def phase_b1_chunk(torch, np, seed):
    """B1's chunk path (``B1_CHUNK``: arctic's and kimi's C 64 steps with
    decode rows, a gpt2 prefill step), bf16, correct mode: the layout the
    kernel takes (the tile layout: a fold pass, then 64 rows a CTA on
    wgmma) with W, G and ST; against the plain version clean, under each
    compute-site SEU and a resident flip (counts and bad planes equal,
    outputs within ``out_bound`` plus ``p_rounding_slack``); the
    profiler's device time a launch (the fold pass included, and alone),
    the bound, and SDPA in a CUDA graph; and the launches the tile layout
    leaves on the first layout (``B1_KEPT``: f32 C 64, the per-step
    check), hashed and timed. Run in two checkouts in turns (this file
    copied into the other's root; parent, change, change, parent), the
    kept launches' hashes must agree and the times stand side by side."""
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)
    res = {}
    for name in B1_CHUNK:
        case, cfg = b1_chunk_case(torch, name)
        t = b1_chunk_tiling(case, cfg)
        check(t is None or t.layout == "tile",
              f"b1_chunk {name}: the {t and t.layout} layout, not the tile "
              f"layout")
        slack = p_rounding_slack(torch, case)
        got, launched = b1_launched(
            lambda: call(efta_paged_attention, case, cfg))
        check(launched in (None, ["tile"]),
              f"b1_chunk {name}: launched on {launched}, not the tile layout")
        ref = call(efta_paged_attention_torch, case, cfg)
        torch.cuda.synchronize()
        err = compare(torch, got, ref, f"b1_chunk {name} clean", slack)
        check(int(got.detected.sum()) == 0 and not bool(got.bad_blocks.any()),
              f"b1_chunk {name}: detections on clean input")
        tol = max(out_tol(torch, ref.out), cfg.thresholds(torch.bfloat16)[2])
        b, h = 1, 1
        j = (int(case["kv_lens"][b]) - int(case["q_lens"][b])) // 16
        seu = {}
        for site in (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM,
                     Site.GEMM2):
            desc = [int(site), j, b, h, 0, 3, seu_bit("correct"), 1]
            got_f = call(efta_paged_attention, case, cfg, fault=desc)
            ref_f = call(efta_paged_attention_torch, case, cfg, fault=desc)
            err = max(err, compare(torch, got_f, ref_f,
                                   f"b1_chunk {name} {site.name}", slack))
            check(int(got_f.detected[b, :5].sum()) >= 1
                  or site in (Site.GEMM1, Site.GEMM2),
                  f"b1_chunk {name} {site.name}: SEU not detected")
            fix = float((got_f.out.float() - ref.out.float()).abs().max())
            check(fix <= tol, f"b1_chunk {name} {site.name}: corrected "
                  f"output off the clean one by {fix:.3e} > {tol:.3e}")
            seu[site.name] = got_f.detected[b].tolist()
        jl = (int(case["kv_lens"][2]) - 1) // 16
        kf = case["k"].clone()
        hkv, D = kf.shape[1], kf.shape[3]
        blk = int(case["bt"][2, jl])
        flip_bit_at(kf, ((blk * hkv + 0) * 16 + 0) * D + 1,
                    top_exponent_bit(kf))
        got_k = call(efta_paged_attention, dict(case, k=kf), cfg)
        ref_k = call(efta_paged_attention_torch, dict(case, k=kf), cfg)
        err = max(err, compare(torch, got_k, ref_k,
                               f"b1_chunk {name} resident flip", slack))
        check(bool(got_k.bad_blocks[2, jl]) and
              int(got_k.bad_blocks.sum()) == 1,
              f"b1_chunk {name}: resident flip not flagged at its block")
        kv_det = got_k.detected[2].tolist()
        del kf, got_k, ref_k

        def fn():
            return call(efta_paged_attention, case, cfg)

        cap = {"q": case["q"], "k": case["k"],
               "args": [case["v"], case["kc"], case["vc"], case["bt"],
                        case["kv_lens"], case["q_lens"]],
               "kw": {"cfg": cfg, "window": None}}
        nbytes, flops = launch_work(torch, cap)
        peak = PEAK_FLOPS[str(case["q"].dtype)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        lib = library_call(torch, cap)
        res[name] = dict(
            layout=t.layout if t else "narrow (no rule: a checkout from "
                                      "before the tile layout)",
            launched=launched, tiling=t._asdict() if t else None,
            rows=int(case["q"].shape[1] // case["k"].shape[1]
                     * case["q"].shape[2]),
            q_lens_sum=int(case["q_lens"].sum()),
            device_ms=device_ms(torch, fn, 20, name="efta_paged_kernel"),
            fold_ms=(device_ms(torch, fn, 20, name="efta_paged_kernel_fold")
                     if t and t.tile else None),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_device_ms=graph_ms(torch, lib, 20), max_abs_err=err,
            seu=seu, kv_flip_det=kv_det, **b1_hash(torch, case, cfg))
        res[name]["sdpa_ratio"] = time_ratio(res[name]["device_ms"],
                                             res[name]["library_device_ms"])
        del case, lib
    kept = {}
    for name in B1_KEPT:
        case, cfg = b1_chunk_case(torch, name)
        t = b1_chunk_tiling(case, cfg)
        check(t is None or t.layout == "narrow",
              f"b1_chunk {name}: the {t and t.layout} layout, not the first")
        _, launched = b1_launched(
            lambda: call(efta_paged_attention, case, cfg))
        check(launched in (None, ["narrow"]),
              f"b1_chunk {name}: launched on {launched}, not the first "
              f"layout")
        kept[name] = dict(
            layout="narrow", launched=launched,
            tiling=t._asdict() if t else None,
            device_ms=device_ms(
                torch, lambda: call(efta_paged_attention, case, cfg), 20,
                name="efta_paged_kernel"), **b1_hash(torch, case, cfg))
        del case
    emit({"phase": "b1_chunk", "ok": True, "regimes": res, "kept": kept})
    return res


def phase_b1_decode(torch, np, seed):
    """B1's decode path (``B1_DECODE``: the C 1 decode step at gpt2's,
    kimi's and arctic's heads, bf16 and f32), correct mode, on the layout
    the rule gives it (the decode layout; a checkout from before it runs
    the first layout): the tiling, the kernel's registers and spills;
    against the plain version clean, under each compute-site SEU at the
    decode row's block and a resident flip (counts and bad planes equal,
    outputs within ``out_bound``); the profiler's device time a launch,
    the bound and SDPA in a CUDA graph; and :func:`b1_hash`. Run in two
    checkouts in turns (this file copied into the other's root; parent,
    change, change, parent), the times stand side by side."""
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)
    res = {}
    for name in B1_DECODE:
        case, cfg = b1_chunk_case(torch, name)
        t = b1_chunk_tiling(case, cfg)
        layout = t.layout if t else "narrow"
        got, launched = b1_launched(
            lambda: call(efta_paged_attention, case, cfg))
        check(launched in (None, [layout]),
              f"b1_decode {name}: launched on {launched}, not the {layout} "
              f"layout")
        ref = call(efta_paged_attention_torch, case, cfg)
        torch.cuda.synchronize()
        err = compare(torch, got, ref, f"b1_decode {name} clean")
        check(int(got.detected.sum()) == 0 and not bool(got.bad_blocks.any()),
              f"b1_decode {name}: detections on clean input")
        b, h = 1, 1
        j = (int(case["kv_lens"][b]) - 1) // 16
        seu = {}
        for site in (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM,
                     Site.GEMM2):
            desc = [int(site), j, b, h, 0, 3, seu_bit("correct"), 1]
            got_f = call(efta_paged_attention, case, cfg, fault=desc)
            ref_f = call(efta_paged_attention_torch, case, cfg, fault=desc)
            err = max(err, compare(torch, got_f, ref_f,
                                   f"b1_decode {name} {site.name}"))
            check(int(got_f.detected[b, :5].sum()) >= 1
                  or site in (Site.GEMM1, Site.GEMM2),
                  f"b1_decode {name} {site.name}: SEU not detected")
            seu[site.name] = got_f.detected[b].tolist()
        jl = (int(case["kv_lens"][2]) - 1) // 16
        kf = case["k"].clone()
        hkv, D = kf.shape[1], kf.shape[3]
        blk = int(case["bt"][2, jl])
        flip_bit_at(kf, ((blk * hkv + 0) * 16 + 0) * D + 1,
                    top_exponent_bit(kf))
        got_k = call(efta_paged_attention, dict(case, k=kf), cfg)
        ref_k = call(efta_paged_attention_torch, dict(case, k=kf), cfg)
        err = max(err, compare(torch, got_k, ref_k,
                               f"b1_decode {name} resident flip"))
        check(bool(got_k.bad_blocks[2, jl]) and
              int(got_k.bad_blocks.sum()) == 1,
              f"b1_decode {name}: resident flip not flagged at its block")
        kv_det = got_k.detected[2].tolist()
        del kf, got_k, ref_k

        def fn():
            return call(efta_paged_attention, case, cfg)

        cap = {"q": case["q"], "k": case["k"],
               "args": [case["v"], case["kc"], case["vc"], case["bt"],
                        case["kv_lens"], case["q_lens"]],
               "kw": {"cfg": cfg, "window": None}}
        nbytes, flops = launch_work(torch, cap)
        peak = PEAK_FLOPS[str(case["q"].dtype)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        lib = library_call(torch, cap)
        dt = "bf16" if case["q"].dtype == torch.bfloat16 else "f32"
        res[name] = dict(
            layout=layout, launched=launched,
            tiling=t._asdict() if t else None,
            ptxas=PTXAS.get("efta_paged", {}).get(
                f"{dt} decode" if layout == "decode" else dt),
            device_ms=device_ms(torch, fn, 20, name="efta_paged_kernel"),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_device_ms=graph_ms(torch, lib, 20), max_abs_err=err,
            seu=seu, kv_flip_det=kv_det, **b1_hash(torch, case, cfg))
        res[name]["sdpa_ratio"] = time_ratio(res[name]["device_ms"],
                                             res[name]["library_device_ms"])
        del case, lib
    emit({"phase": "b1_decode", "ok": True, "regimes": res})
    return res


def phase_b1_long(torch, np, seed):
    """B1's decode step over wide tables (``B1_LONG``: kimi's and arctic's
    heads at 256-block tables, bf16 and f32, phase 20's lengths in a
    256-block table, a 32,768-token context), correct mode, on the layout
    the rule gives it (the long-table layout; a checkout from before it
    runs the first layout): the tiling, the kernel's registers and spills;
    against the plain version clean, and at the 4,096-token regimes under
    each compute-site SEU at the last block of request 1 and a resident V
    flip, at 32k under an EXP SEU at the last block (counts and bad planes
    equal, outputs within ``out_bound``); the profiler's device time a
    launch (the long-table layout: each pass's too), the launch's time in
    a CUDA graph (which must capture it), the bound (beside it the traffic
    of the long-table layout's workspace, written and read once), SDPA in a
    CUDA graph (padded and expanded as :func:`library_call` makes it, and
    :func:`library_call_gqa`'s, a call a request at its own length), and
    :func:`b1_hash`. Run in two checkouts in turns (this file copied into
    the other's root; parent, change, change, parent), the times stand
    side by side."""
    from repro_torch.core.fault import Site, flip_bit_at
    from repro_torch.kernels.efta_paged import (efta_paged_attention,
                                                efta_paged_attention_torch)
    res = {}
    for name in B1_LONG:
        case, cfg = b1_chunk_case(torch, name)
        t = b1_chunk_tiling(case, cfg)
        layout = t.layout if t else "narrow"
        got, launched = b1_launched(
            lambda: call(efta_paged_attention, case, cfg))
        check(launched in (None, [layout]),
              f"b1_long {name}: launched on {launched}, not the {layout} "
              f"layout")
        ref = call(efta_paged_attention_torch, case, cfg)
        torch.cuda.synchronize()
        err = compare(torch, got, ref, f"b1_long {name} clean")
        check(int(got.detected.sum()) == 0 and not bool(got.bad_blocks.any()),
              f"b1_long {name}: detections on clean input")
        del got, ref
        b, h = 1, 1
        j = (int(case["kv_lens"][b]) - 1) // 16
        long_ctx = case["bt"].shape[1] > 256
        seu = {}
        for site in ((Site.EXP,) if long_ctx else
                     (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM,
                      Site.GEMM2)):
            desc = [int(site), j, b, h, 0, 3, seu_bit("correct"), 1]
            got_f = call(efta_paged_attention, case, cfg, fault=desc)
            ref_f = call(efta_paged_attention_torch, case, cfg, fault=desc)
            err = max(err, compare(torch, got_f, ref_f,
                                   f"b1_long {name} {site.name}"))
            check(int(got_f.detected[b, :5].sum()) >= 1
                  or site in (Site.GEMM1, Site.GEMM2),
                  f"b1_long {name} {site.name}: SEU not detected")
            seu[site.name] = got_f.detected[b].tolist()
            del got_f, ref_f
        kv_det = None
        if not long_ctx:
            # a V element of magnitude 2 or more in request 2's last block
            # shrunk by 2^-128 (a K element grown by 2^128 overflows GEMM I
            # in both versions at some of these inputs)
            jl = (int(case["kv_lens"][2]) - 1) // 16
            vf = case["v"].clone()
            hkv, D = vf.shape[1], vf.shape[3]
            blk = int(case["bt"][2, jl])
            tile = vf[blk, 0].float().abs().flatten()
            flip_bit_at(vf, blk * hkv * 16 * D +
                        int(torch.nonzero(tile >= 2)[0]),
                        top_exponent_bit(vf))
            got_k = call(efta_paged_attention, dict(case, v=vf), cfg)
            ref_k = call(efta_paged_attention_torch, dict(case, v=vf), cfg)
            err = max(err, compare(torch, got_k, ref_k,
                                   f"b1_long {name} resident flip"))
            check(bool(got_k.bad_blocks[2, jl]) and
                  int(got_k.bad_blocks.sum()) == 1,
                  f"b1_long {name}: resident flip not flagged at its block")
            kv_det = got_k.detected[2].tolist()
            del vf, got_k, ref_k

        def fn():
            return call(efta_paged_attention, case, cfg)

        cap = {"q": case["q"], "k": case["k"],
               "args": [case["v"], case["kc"], case["vc"], case["bt"],
                        case["kv_lens"], case["q_lens"]],
               "kw": {"cfg": cfg, "window": None}}
        ws_bytes = workspace_bytes(
            cap, t.fold_floats if layout == "long" else 0)
        nbytes, flops = launch_work(torch, cap)
        peak = PEAK_FLOPS[str(case["q"].dtype)]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        lib = library_call(torch, cap)
        lib_gqa = library_call_gqa(torch, cap)
        dt = "bf16" if case["q"].dtype == torch.bfloat16 else "f32"
        ptx = PTXAS.get("efta_paged", {})
        res[name] = dict(
            layout=layout, launched=launched,
            tiling=t._asdict() if t else None,
            blocks=int(sum(-(-int(n) // 16) for n in case["kv_lens"])),
            ptxas=({k: ptx.get(f"{dt} long {k}")
                    for k in ("score", "exp", "state")}
                   if layout == "long" else ptx.get(dt)),
            device_ms=device_ms(torch, fn, 20, name="efta_paged_kernel"),
            passes_ms=({k: device_ms(torch, fn, 20,
                                     name=f"efta_paged_kernel_l{k}")
                        for k in ("score", "exp", "state")}
                       if layout == "long" else None),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ws_bytes=ws_bytes,
            ws_ms=ws_bytes / HBM_BYTES_PER_S * 1e3,
            graph_ms=graph_ms(torch, fn, 20),
            library_device_ms=graph_ms(torch, lib, 20),
            library_gqa_ms=graph_ms(torch, lib_gqa, 20), max_abs_err=err,
            seu=seu, kv_flip_det=kv_det, **b1_hash(torch, case, cfg))
        res[name]["sdpa_ratio"] = time_ratio(res[name]["device_ms"],
                                             res[name]["library_device_ms"])
        res[name]["sdpa_gqa_ratio"] = time_ratio(res[name]["device_ms"],
                                                 res[name]["library_gqa_ms"])
        # the launch waits for the host nowhere and allocates its workspace
        # on the caller's stream: a CUDA graph captures it
        check(layout != "long" or res[name]["graph_ms"] is not None,
              f"b1_long {name}: the launch cannot be captured in a CUDA "
              f"graph")
        del case, lib, lib_gqa, cap
        free(torch)
    emit({"phase": "b1_long", "ok": True, "regimes": res})
    return res


def exp_seu_on_decode_row(state):
    """faults_at for ``drive``: an EXP SEU (bit 27, KV block 0, query head
    1, row 0) on a decoding slot's row, every step until one is detected;
    ``state["hit"]`` is then its step."""
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.serve import batch_faults

    def faults_at(eng, i):
        t = state.pop("target", None)
        if t is not None and sum(
                eng.telemetry.requests[t[0]].detected[:5]) > t[1]:
            state["hit"] = i - 1
        if state.get("hit") is not None:
            return None
        dec = [r for r in eng.scheduler.active_rows()
               if not r.is_done() and r.slot is not None
               and r.num_generated > 0]
        if not dec:
            return None
        r = dec[0]
        state["target"] = (r.rid, sum(eng.telemetry.requests[r.rid]
                                      .detected[:5]))
        return batch_faults(eng.n_slots, {r.slot: FaultSpec.single(
            Site.EXP, block=0, head=1, row=0, col=3, bit=27)})
    return faults_at


def flip_lowest_slot(state, step, layer):
    """before_step for ``drive``: at ``step``, a top-exponent flip in block
    0 of the live request in the lowest slot. A repair re-prefills the block
    as a one-slot chunk whose other slots are padding rows; in the lowest
    slot its rows come first in the MoE dispatch order, before any padding
    row, as they did when the block was first written, so no capacity drop
    differs between the two."""
    def before_step(eng, i):
        if i != step:
            return
        live = sorted((r for r in eng.scheduler.active_rows()
                       if not r.is_done() and eng._pos[r.slot] > 16),
                      key=lambda r: r.slot)
        check(live, "no live request to strike with a KV flip")
        eng.inject_kv_fault(layer=layer, block=live[0].block_ids[0], head=3,
                            row=2, col=7, bit=top_exponent_bit(
                                eng.pool.state.k), into="k")
        state["slot"] = live[0].slot
    return before_step


def moe_run_line(run):
    eng = run["eng"]
    st = sorted(run["step_ms"]) if run["step_ms"] else None
    return {"tokens_per_s": run["tokens"] / run["wall"],
            "wall_s": run["wall"], "steps": eng.stats.steps,
            "forwards": eng.stats.forwards, "b1_launches": run["launches"],
            "b1_by_layout": run["b1_by_layout"],
            "b1_per_forward": run["launches"] / max(eng.stats.forwards, 1),
            "step_ms_median": statistics.median(st) if st else None,
            "step_ms_p90": st[int(0.9 * (len(st) - 1))] if st else None,
            "chunk_widths": sorted(eng.chunk_widths),
            "device_busy": run["busy"]}


def moe_ring(torch, np, arch, params, seed):
    """kimi on the ring engine under ``efta_pallas``: B2 prefill at D 112
    (GQA 8, not expanded: the JAX package expands K/V heads only under
    tensor parallelism), 16 requests of 64-512 tokens with exactly 64 and
    512 among them, 32 new tokens; B2 against its plain version and timed
    at buckets 64 and 512 on the run's own inputs."""
    model = moe_model(arch, "bfloat16", MOE_LAYERS, attn_impl="efta_pallas")
    L = model.cfg.num_layers
    rng = np.random.default_rng(seed + 21)
    lens = rng.integers(64, 513, 16)
    lens[0], lens[-1] = 64, 512
    prompts = [rng.integers(0, model.cfg.vocab_size, (int(n),))
               .astype(np.int32) for n in lens]
    rec = RegimeRecorder()
    run = ring_run(torch, np, model, params, prompts, n_new=32)
    rec.restore()
    eng = run["eng"]
    check(len(run["outs"]) == 16 and all(
        len(t) == 32 for t in run["outs"].values()),
        f"{arch} ring: not every request finished")
    check(run["launches"] > 0 and
          run["launches"] == L * eng.stats.prefill_forwards and
          run["paged_launches"] == 0, f"{arch} ring: {run['launches']} B2 "
          f"launches for {eng.stats.prefill_forwards} prefill forwards")
    check(eng.telemetry.summary()["detected"] == 0,
          f"{arch} ring: clean detections")
    regimes = {S: b2_regime_numbers(torch, rec.captured[(S, S, True)])
               for S in (64, 512)}
    st = sorted(run["step_ms"])
    line = {"tokens_per_s": 16 * 32 / run["wall"], "wall_s": run["wall"],
            "steps": eng.stats.steps,
            "prefill_forwards": eng.stats.prefill_forwards,
            "b2_launches": run["launches"],
            "b2_by_regime": {regime_name(k): n
                             for k, n in sorted(rec.counts.items())},
            "step_ms_median": statistics.median(st),
            "step_ms_p90": st[int(0.9 * (len(st) - 1))],
            "b2": {f"bucket_{S}": r for S, r in regimes.items()}}
    return line, {f"ring_prefill_{arch}_bucket_{S}": dict(
        r, launches=rec.counts[(S, S, True)], launches_per="ring run")
        for S, r in regimes.items()}


def gate_moe_tokens(np, ref, got, what):
    """``gate_tokens`` for the moe family: a divergence also passes where
    the plain run's request met a router near tie (k-th and (k+1)-th
    router probabilities within ``ROUTER_TIE``) up to that token."""
    ties = []
    for rid, (a, b) in enumerate(zip(ref["outs"], got["outs"])):
        if np.array_equal(a, b):
            continue
        i = int(np.flatnonzero(a[:len(b)] != b[:len(a)])[0])
        gap, mx = ref["origin"][(rid, i)]
        router = ref["ties_at"].get((rid, i), 0)
        check(gap < NEAR_TIE * mx or router > 0,
              f"{what}: request {rid} token {i} differs from the plain run "
              f"({a[i]} vs {b[i]}): top-2 gap {gap:.3e} of max|logit| "
              f"{mx:.3e}, no router near tie")
        ties.append({"request": rid, "token": i, "gap_over_max": gap / mx,
                     "router_near_ties": router})
    return ties


def phase_moe(torch, np, seed):
    """The moe family at published width, two layers (kimi-k2 d 7168, 64
    heads of 112 on 8 KV heads, 384 experts top-8 + a shared expert, vocab
    163840; arctic d 7168, 56 heads of 128 on 8, 128 experts top-2 + a
    dense residual MLP), random bf16 weights from the seed. For each, the
    gpt2 paged run's traffic through the fused paged engine (8 slots, 16
    requests of 64-512 tokens, 32 new, block 16, chunk 64, budget 256):
    every request finishes, B1 launches once per layer of every forward at
    widths 64 and 1, nothing detected; a twin with an EXP SEU on a decode
    row and a resident flip detects, repairs and emits the clean tokens; two
    profiled windows of one run (mixed prefill steps, decode steps) split
    the device time. kimi also runs the ring engine (``moe_ring``, first:
    its timings come before any profile) and, in f32 at one layer, the
    fused run against the same run on B1's plain version: equal tokens
    except at near ties of the logits or the router. kimi's bf16 model also
    runs the engine at its default cache (``moe_long``), which puts its
    decode launches on B1's long-table layout."""
    out, b1_runs, b2_entries, long_entries = {}, {}, {}, {}
    for arch in MOE_ARCHS:
        free(torch)
        out[arch], b1_runs[arch], ring_b2, lng = moe_paged(torch, np, arch,
                                                          seed)
        b2_entries.update(ring_b2)
        long_entries.update(lng)
    free(torch)
    moe_f32(torch, np, MOE_ARCHS[0], seed)
    free(torch)
    return out, b1_runs, b2_entries, long_entries


def moe_paged(torch, np, arch, seed):
    """Phase 20's runs of one arch (see ``phase_moe``); its models are
    freed when it returns. Returns (the phase line's numbers, B1 launches
    of the clean run, kimi's ring B2 entries and its default-cache B1 entry
    for the kernels line)."""
    torch.cuda.reset_peak_memory_stats()
    model = moe_model(arch, "bfloat16", MOE_LAYERS)
    params = model_params(torch, model, seed)
    L = model.cfg.num_layers
    res = {"layers": L, "weights_bytes": tree_bytes(params),
           "after_init_bytes": torch.cuda.memory_allocated()}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            (int(rng.integers(64, 513)),)).astype(np.int32)
               for _ in range(16)]
    b2_entries = {}
    if arch == MOE_ARCHS[0]:
        res["ring"], b2_entries = moe_ring(torch, np, arch, params, seed)

    def engine():
        return fused_engine(model, params, cache_len=1024)

    clean = drive(torch, np, engine(), prompts, 32, step_times=True)
    check_b1(clean, L, f"{arch} clean")
    check_b1_decode_launches(clean["b1_by_layout"], f"{arch} clean")
    check(clean["eng"].telemetry.summary()["detected"] == 0 and
          clean["eng"].paged_stats.kv_detected_blocks == 0,
          f"{arch}: clean detections")
    # the faulted twin: an EXP SEU on a decode row, then a resident flip
    st_exp, st_flip = {}, {}
    twin = drive(torch, np, engine(), prompts, 32,
                 faults_at=exp_seu_on_decode_row(st_exp),
                 before_step=flip_lowest_slot(st_flip, 9, L - 1))
    check_b1(twin, L, f"{arch} faulted twin")
    check_b1_decode_launches(twin["b1_by_layout"], f"{arch} faulted twin")
    ps = twin["eng"].paged_stats
    check(st_exp.get("hit") is not None, f"{arch}: EXP SEU not detected")
    check(ps.kv_detected_blocks >= 1 and ps.kv_repaired_blocks >= 1,
          f"{arch}: resident flip not detected and repaired: {ps}")
    for rid, (a, b) in enumerate(zip(clean["outs"], twin["outs"])):
        check(np.array_equal(a, b), f"{arch} faulted twin: request {rid}'s "
              f"tokens differ from the clean run's")
    if arch == MOE_ARCHS[0]:
        # the same run on B1's plain version: the share of equal tokens
        plain = plain_b1_drive(torch, np, engine(), prompts, 32)
        res["bf16_same_tokens_as_plain_b1"] = same_share(
            np, plain["outs"], clean["outs"])
        del plain
    n = clean["steps"]
    windows = drive(torch, np, engine(), prompts, 32, split=True,
                    profile_steps={"mixed": (8, 12),
                                   "decode": (n - 8, n - 4)})["busy"]
    res.update(bf16=moe_run_line(clean), windows=windows,
               faulted_twin={"seu_step": st_exp["hit"],
                             "flip_slot": st_flip.get("slot"),
                             "detected": twin["eng"].telemetry.summary()[
                                 "detected"],
                             "stats": dataclasses.asdict(ps),
                             "forwards": twin["eng"].stats.forwards},
               peak_bytes=torch.cuda.max_memory_allocated())
    emit({"phase": "moe_paged", "ok": True, "arch": arch, **res})
    long_entries = {}
    if arch == MOE_ARCHS[0]:
        long_entries = moe_long(torch, np, model, params, prompts, res)
    return res, clean["launches"], b2_entries, long_entries


def moe_long(torch, np, model, params, prompts, short):
    """kimi through the fused engine at its default cache: no
    ``cache_len``, so the CLI's default, ``max_seq`` (4,096 tokens: 256-block
    tables), phase 20's traffic. Every C 1 launch must take B1's long-table
    layout; the clean run detects nothing; the faulted twin (phase 20's
    EXP SEU on a decode row, then a resident flip) detects, repairs and
    emits the clean run's tokens; step time and B1's device time in a
    profiled decode window, beside phase 20's 1,024-token run (``short``).
    The run's largest decode launch is held to the plain version and timed
    (``b1_numbers``) for the kernels line."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels import efta_paged as b1_mod
    L = model.cfg.num_layers
    arch = model.cfg.name

    def engine():
        return fused_engine(model, params)

    rec = Recorder(torch, model, attn_mod)
    try:
        clean = drive(torch, np, engine(), prompts, 32, step_times=True)
    finally:
        rec.restore()
    eng = clean["eng"]
    check(eng.cache_len == model.cfg.max_seq == 4096,
          f"{arch} default cache: cache_len {eng.cache_len}, not 4,096")
    cap = rec.captured["decode"]
    mb = int(cap["args"][3].shape[1])
    check(mb == 256, f"{arch} default cache: {mb}-block tables, not 256")
    check_b1(clean, L, f"{arch} default cache clean")
    check_b1_decode_launches(clean["b1_by_layout"],
                             f"{arch} default cache clean", layouts=("long",))
    check(eng.telemetry.summary()["detected"] == 0 and
          eng.paged_stats.kv_detected_blocks == 0,
          f"{arch} default cache: clean detections")
    st_exp, st_flip = {}, {}
    twin = drive(torch, np, engine(), prompts, 32,
                 faults_at=exp_seu_on_decode_row(st_exp),
                 before_step=flip_lowest_slot(st_flip, 9, L - 1))
    check_b1(twin, L, f"{arch} default cache faulted twin")
    check_b1_decode_launches(twin["b1_by_layout"],
                             f"{arch} default cache faulted twin",
                             layouts=("long",))
    ps = twin["eng"].paged_stats
    check(st_exp.get("hit") is not None,
          f"{arch} default cache: EXP SEU not detected")
    check(ps.kv_detected_blocks >= 1 and ps.kv_repaired_blocks >= 1,
          f"{arch} default cache: resident flip not detected and repaired: "
          f"{ps}")
    for rid, (a, b) in enumerate(zip(clean["outs"], twin["outs"])):
        check(np.array_equal(a, b), f"{arch} default cache faulted twin: "
              f"request {rid}'s tokens differ from the clean run's")
    n = clean["steps"]
    windows = drive(torch, np, engine(), prompts, 32, split=True,
                    profile_steps={"decode": (n - 8, n - 4)})["busy"]
    t = b1_mod.tiling(b1_mod.DTYPES[cap["q"].dtype],
                      cap["q"].shape[1] // cap["k"].shape[1], cap["q"].shape[3],
                      16, cap["args"][1].c1.shape[-2],
                      cap["kw"]["cfg"].kv_stride(16),
                      cap["kw"]["cfg"].out_stride(cap["q"].shape[3]), mb,
                      cap["kw"]["cfg"].unified, chunk=1)
    key = f"{arch} decode, default cache (256-block tables)"
    numbers = b1_numbers(torch, cap, key, layout="long",
                         ws_floats=t.fold_floats)
    line = moe_run_line(clean)
    emit({"phase": "moe_long", "ok": True, "arch": arch, "layers": L,
          "cache_len": eng.cache_len, "table_blocks": mb,
          "bf16": line, "windows": windows,
          "faulted_twin": {"seu_step": st_exp["hit"],
                           "flip_slot": st_flip.get("slot"),
                           "detected": twin["eng"].telemetry.summary()[
                               "detected"],
                           "stats": dataclasses.asdict(ps)},
          "b1": numbers,
          "beside_cache_1024": {
              "step_ms_median": short["bf16"]["step_ms_median"],
              "b1_by_layout": short["bf16"]["b1_by_layout"],
              "decode_window": short["windows"].get("decode")}})
    return {key: dict(numbers, launches=clean["launches"],
                      launches_by_layout=clean["b1_by_layout"],
                      launches_per=f"bf16 paged run of {arch} at its "
                                   f"default cache, {L} layers")}


def plain_b1_drive(torch, np, eng, prompts, n_new, **kw):
    """``drive`` with B1's plain version patched in where the model calls
    the wrapper (no kernel launches)."""
    from repro_torch.kernels import efta_paged as b1_mod
    import repro_torch.models.attention as attn_mod
    wrapper = attn_mod.efta_paged_attention
    attn_mod.efta_paged_attention = b1_mod.efta_paged_attention_torch
    try:
        run = drive(torch, np, eng, prompts, n_new, **kw)
    finally:
        attn_mod.efta_paged_attention = wrapper
    check(run["launches"] == 0, "the plain run launched B1")
    return run


def moe_f32(torch, np, arch, seed):
    """kimi in f32 at one layer through the fused engine on B1 and on B1's
    plain version: equal tokens except at near ties of the logits or the
    router."""
    torch.cuda.reset_peak_memory_stats()
    model = moe_model(arch, "float32", KIMI_F32_LAYERS)
    params = model_params(torch, model, seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            (int(rng.integers(64, 513)),)).astype(np.int32)
               for _ in range(16)]
    kern = drive(torch, np, fused_engine(model, params, cache_len=1024),
                 prompts, 32, margins=True, router_ties=True)
    check_b1(kern, KIMI_F32_LAYERS, f"{arch} f32")
    plain = plain_b1_drive(torch, np,
                           fused_engine(model, params, cache_len=1024),
                           prompts, 32, margins=True, router_ties=True)
    ties = gate_moe_tokens(np, plain, kern, f"{arch} f32 B1 vs plain")
    emit({"phase": "moe_f32", "ok": True, "arch": arch,
          "layers": KIMI_F32_LAYERS, "weights_bytes": tree_bytes(params),
          "kernel": moe_run_line(kern),
          "plain_b1": moe_run_line(plain),
          "same_tokens": same_share(np, plain["outs"], kern["outs"]),
          "differing": ties,
          "router_near_tie_tokens": sum(
              1 for v in plain["ties_at"].values() if v),
          "peak_bytes": torch.cuda.max_memory_allocated()})


def profiled_device_ms(torch, fn):
    """Wall ms of one call of ``fn`` (ends synchronised) and the device time
    of its kernels (profiler, CUDA activity); returns (result, wall, device,
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (res, wall, sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern))


def phase_ssm(torch, np, seed):
    """rwkv6-7b (d 4096, attention-free) and hymba-1.5b (d 1600, attention
    and mamba heads in parallel, window 1024 except the first, middle and
    last layers; plain ``efta``) at full width, ``SSM_LAYERS`` of their 32
    layers, on the static-batch route: ``greedy_generate`` on B 8 with
    512-token prompts and 32 new tokens. bf16: tokens/s, and the device
    time of the prefill and of a decode step (profiled apart: the prefill,
    and ``SSM_PROFILED_STEPS`` decode steps, each beside the wall time of
    its part). f32: ``SSM_F32_STEPS`` greedy tokens equal the argmax of the
    same model's full-sequence forward over the prompt and the generated
    tokens (prefill plus decode equal the forward), except at near ties
    (top-2 gap under 1e-4 of max|logit|)."""
    out = {}
    for arch in SSM_ARCHS:
        out[arch] = {}
        for dtype in ("bfloat16", "float32"):
            free(torch)
            out[arch][dtype] = ssm_run(torch, np, arch, dtype, seed)
    free(torch)
    emit({"phase": "ssm", "ok": True, "batch": 8, "prompt": 512,
          "new_tokens": 32, "layers": SSM_LAYERS, **out})
    return out


def ssm_run(torch, np, arch, dtype, seed):
    """One model and dtype of ``phase_ssm``; freed when it returns."""
    from repro_torch.serve import greedy_generate
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    check(cfg.num_layers == 32 and cfg.d_model in (4096, 1600) and
          cfg.family in ("ssm", "hybrid"), f"{arch} is not at full width")
    model = build_model(dataclasses.replace(cfg, dtype=dtype,
                                            num_layers=SSM_LAYERS),
                        device=DEVICE)
    cfg = model.cfg
    params = model_params(torch, model, seed)
    rng = np.random.default_rng(seed + 22)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                           device=DEVICE).long()
    res = {"weights_bytes": tree_bytes(params)}
    if dtype == "bfloat16":
        t0 = time.perf_counter()
        _, rep = greedy_generate(model, params, toks, steps=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(int(rep.detected.sum()) == 0, f"{arch}: clean detections")
        cache = model.init_cache(8, cache_len=545)
        (logits, _, cache), p_wall, p_dev, p_n = profiled_device_ms(
            torch, lambda: model.prefill(params, toks, cache))

        def decode(tok=logits.argmax(-1)[:, None], cache=cache):
            for _ in range(SSM_PROFILED_STEPS):
                lg, _, cache = model.decode_step(params, tok, cache)
                tok = lg.argmax(-1)[:, None]
            return tok
        _, d_wall, d_dev, d_n = profiled_device_ms(torch, decode)
        n = SSM_PROFILED_STEPS
        res.update(tokens_per_s=8 * 32 / wall, wall_s=wall,
                   prefill={"wall_ms": p_wall, "device_ms": p_dev,
                            "kernels": p_n},
                   decode_step={"wall_ms": d_wall / n,
                                "device_ms": d_dev / n, "kernels": d_n / n,
                                "steps_profiled": n})
    else:
        gen, _ = greedy_generate(model, params, toks, steps=SSM_F32_STEPS)
        seq = torch.cat([toks, gen[:, :-1]], dim=1)
        full, _ = model.logits(params, {"tokens": seq})
        rows = full[:, 511:]                               # (8, steps, V)
        top2 = rows.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        mx = rows.abs().amax(dim=-1).cpu().numpy()
        a, b = rows.argmax(-1).cpu().numpy(), gen.cpu().numpy()
        ties = []
        for r in range(8):
            if np.array_equal(a[r], b[r]):
                continue
            i = int(np.flatnonzero(a[r] != b[r])[0])
            check(gap[r, i] < NEAR_TIE * mx[r, i],
                  f"{arch} f32: row {r} token {i}: greedy {b[r, i]} vs "
                  f"forward {a[r, i]}, gap {gap[r, i]:.3e} of "
                  f"{mx[r, i]:.3e}")
            ties.append({"row": r, "token": i,
                         "gap_over_max": float(gap[r, i] / mx[r, i])})
        res.update(same_tokens=float((a == b).mean()), near_ties=ties)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


VLM_ARCH = "llama-3.2-vision-11b"
VLM_BLOCK_KV = 64       # divides its 1,600 frontend rows (512 does not)
VLM_NEW = 16            # new tokens of its greedy runs (32 until the
#                         script neared its time limit)
VLM_F32_LAYERS = 10     # two superblocks: the f32 check against efta
VLM_PROFILED_STEPS = 1  # decode steps in the profiled window (~36k kernels)


def vlm_model(dtype, layers=None, **ft):
    """llama-3.2-vision-11b at its published width (and depth unless
    ``layers`` cuts it), in ``dtype``, with FT fields replaced where
    given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(VLM_ARCH)
    a = cfg.attn
    check(cfg.family == "vlm" and cfg.num_layers == 40 and
          cfg.d_model == 4096 and cfg.d_ff == 14336 and
          cfg.vocab_size == 128256 and a.num_heads == 32 and
          a.num_kv_heads == 8 and a.head_dim == 128 and
          cfg.frontend_tokens == 1600 and cfg.cross_attn_every == 5,
          f"{VLM_ARCH} is not at full width")
    return build_model(dataclasses.replace(
        cfg, dtype=dtype, num_layers=layers or cfg.num_layers,
        ft=dataclasses.replace(cfg.ft, **ft)), device=DEVICE)


def timed_greedy(torch, model, params, toks, fe, n_new, gaps=None):
    """``greedy_generate`` with the wall time of its prefill and of each
    decode step (each ends synchronised); with ``gaps`` a list, each
    step's top-2 logit gap and max|logit| per row are appended to it.
    Returns (tokens, report, {"prefill_ms", "step_ms"}, wall s)."""
    from repro_torch.serve import greedy_generate
    times = {"prefill_ms": None, "step_ms": []}
    for meth in ("prefill", "decode_step"):
        orig = getattr(model, meth)

        def wrapped(*a, orig=orig, meth=meth, **kw):
            t0 = time.perf_counter()
            res = orig(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if meth == "prefill":
                times["prefill_ms"] = ms
            else:
                times["step_ms"].append(ms)
            if gaps is not None:
                top2 = res[0].topk(2, dim=-1).values
                gaps.append(((top2[:, 0] - top2[:, 1]).tolist(),
                             res[0].abs().amax(dim=-1).tolist()))
            return res
        setattr(model, meth, wrapped)
    t0 = time.perf_counter()
    out, rep = greedy_generate(model, params, toks, steps=n_new,
                               frontend=fe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for meth in ("prefill", "decode_step"):
        delattr(model, meth)
    return out, rep, times, wall


def near_tie_rows(np, got, ref, gaps, what, hold=True):
    """Rows where ``got`` differs from the plain run's ``ref``: each must
    first differ at a near tie of the plain run (top-2 gap under
    ``NEAR_TIE`` of max|logit|) when ``hold``. Returns the rows' records."""
    a, b = got.cpu().numpy(), ref.cpu().numpy()
    ties = []
    for r in range(a.shape[0]):
        if np.array_equal(a[r], b[r]):
            continue
        i = int(np.flatnonzero(a[r] != b[r])[0])
        gap, mx = gaps[i][0][r], gaps[i][1][r]
        check(not hold or gap < NEAR_TIE * mx,
              f"{what}: row {r} token {i} differs from plain EFTA "
              f"({a[r][i]} vs {b[r][i]}), top-2 gap {gap:.3e} of {mx:.3e} "
              f"is no near tie")
        ties.append({"row": r, "token": i, "gap_over_max": gap / mx})
    return ties


def phase_vlm(torch, np, seed):
    """llama-3.2-vision-11b at published width and depth (40 layers: 8
    superblocks of 4 dense blocks and a cross block; d 4096, 32 heads of
    128 on 8, d_ff 14336, vocab 128256), random bf16 weights from the
    seed, on the static-batch route: ``greedy_generate`` on B 8 x 512
    prompt tokens + ``VLM_NEW`` (16) new, with a random frontend (B, 1600,
    4096).

    * Under ``efta_pallas`` at the published ``block_kv`` 512 the
      cross-attention's 1,600 rows do not divide the block: it raises.
    * Under ``efta`` (the published config) and under ``efta_pallas`` with
      ``block_kv`` 64: B2 launches 40 times at the self-attention prefill
      (Sq = Skv 512, causal), 8 at the cross prefill (512 -> 1600) and 8
      per decode step at the cross decode (1 -> 1600); the self-attention
      decode runs plain EFTA, as in the JAX package. Nothing detected.
      tokens/s, median and p90 decode step, the prefill's wall time, the
      busy share of a profiled prefill and of ``VLM_PROFILED_STEPS``
      decode steps, peak memory; the bf16 share of tokens equal across the
      two.
    * B2 in each regime against its plain version (clean and five SEUs),
      timed beside its bound and SDPA, in bf16 (from this run) and f32
      (from the next).
    * f32 at ``VLM_F32_LAYERS`` layers: the tokens under ``efta_pallas``/
      64 equal those under ``efta`` except at near ties.
    """
    from repro_torch.kernels.efta_attention import efta_attention
    B, S, n_new, M = 8, 512, VLM_NEW, 1600
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 23)
    rng = np.random.default_rng(seed + 23)
    out, entries = {}, {}
    for dtype in ("bfloat16", "float32"):
        layers = None if dtype == "bfloat16" else VLM_F32_LAYERS
        m_e = vlm_model(dtype, layers)
        cfg = m_e.cfg
        L, ns = cfg.num_layers, cfg.num_layers // cfg.cross_attn_every
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               device=DEVICE).long()
        fe = torch.randn((B, M, cfg.d_model), generator=gen,
                         device=DEVICE) * 0.1
        params = model_params(torch, m_e, seed)
        res = {"layers": L, "weights_bytes": tree_bytes(params)}
        if dtype == "bfloat16":
            m_bad = vlm_model(dtype, attn_impl="efta_pallas")
            try:
                m_bad.prefill(params, toks[:1], m_bad.init_cache(1),
                              frontend=fe[:1])
                raised = ""
            except ValueError as e:
                raised = str(e)
            check("must divide blocks" in raised, f"{VLM_ARCH}: efta_pallas "
                  f"at block_kv 512 did not refuse the 1600 frontend rows")
            res["block_kv_512_raises"] = raised
        gaps = []
        ref, rep_e, t_e, wall_e = timed_greedy(torch, m_e, params, toks, fe,
                                               n_new, gaps)
        m_k = vlm_model(dtype, layers, attn_impl="efta_pallas",
                        block_kv=VLM_BLOCK_KV)
        rec = RegimeRecorder()
        zero_b2_counts()
        got, rep_k, t_k, wall_k = timed_greedy(torch, m_k, params, toks, fe,
                                               n_new)
        launches = efta_attention.launches
        by_layout = b2_by_layout()
        rec.restore()
        want = {(S, S, True): L, (S, M, False): ns, (1, M, False): ns * n_new}
        check(rec.counts == want and launches == sum(want.values()),
              f"{VLM_ARCH} {dtype}: B2 launches {rec.counts} (kernel "
              f"{launches}), want {want}")
        check_decode_launches(by_layout, f"{VLM_ARCH} {dtype}")
        check(by_layout["decode Sq1"] == ns * n_new,
              f"{VLM_ARCH} {dtype}: {by_layout} decode launches, want "
              f"{ns * n_new}")
        check(int(rep_e.detected.sum()) == 0 and
              int(rep_k.detected.sum()) == 0,
              f"{VLM_ARCH} {dtype}: clean detections")
        ties = near_tie_rows(np, got, ref, gaps, f"{VLM_ARCH} {dtype}",
                             hold=dtype == "float32")
        res.update(same_tokens=float((got == ref).float().mean()),
                   differing_rows=ties, b2_launches=launches,
                   b2_by_layout=by_layout,
                   b2_by_regime={regime_name(k): n
                                 for k, n in sorted(rec.counts.items())})
        for name, t, wall in (("efta", t_e, wall_e),
                              ("efta_pallas_64", t_k, wall_k)):
            st = sorted(t["step_ms"])
            res[name] = {"tokens_per_s": B * n_new / wall, "wall_s": wall,
                         "prefill_ms": t["prefill_ms"],
                         "step_ms_median": statistics.median(st),
                         "step_ms_p90": st[int(0.9 * (len(st) - 1))]}
        regimes = {regime_name(k): b2_regime_numbers(
            torch, cap, p_rounding=True)
            for k, cap in sorted(rec.captured.items())}
        res["b2"] = regimes
        if dtype == "bfloat16":
            for key, name in (((S, S, True), "vlm_self_prefill"),
                              ((S, M, False), "vlm_cross_prefill"),
                              ((1, M, False), "vlm_cross_decode")):
                entries[name] = dict(regimes[regime_name(key)],
                                     launches=rec.counts[key],
                                     launches_per=f"{n_new}-token greedy "
                                                  f"run, B {B}")
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
            # profiled after every B2 timing of the phase (a profiled
            # window of ~36k launches would cost later windows records)
            kept = (m_k, params, toks, fe)
        out[dtype] = res
        del params, m_e, m_k, rec
        free(torch)
    # busy share of the bf16 efta_pallas/64 run: a profiled prefill and
    # decode window
    m_k, params, toks, fe = kept
    cache = m_k.init_cache(B, cache_len=S + n_new + 1)
    (lg, _, cache), p_wall, p_dev, p_n = profiled_device_ms(
        torch, lambda: m_k.prefill(params, toks, cache, frontend=fe))

    def decode(tok=lg.argmax(-1)[:, None], cache=cache):
        for _ in range(VLM_PROFILED_STEPS):
            lg2, _, cache = m_k.decode_step(params, tok, cache)
            tok = lg2.argmax(-1)[:, None]
        return tok
    _, d_wall, d_dev, d_n = profiled_device_ms(torch, decode)
    n = VLM_PROFILED_STEPS
    out["bfloat16"]["efta_pallas_64"].update(
        prefill_profiled={"wall_ms": p_wall, "device_ms": p_dev,
                          "busy_share": p_dev / p_wall, "kernels": p_n},
        decode_profiled={"wall_ms": d_wall / n, "device_ms": d_dev / n,
                         "busy_share": d_dev / d_wall, "kernels": d_n / n,
                         "steps": n})
    del kept, m_k, params, cache, lg
    free(torch)
    emit({"phase": "vlm", "ok": True, "arch": VLM_ARCH, "batch": B,
          "prompt": S, "frontend_tokens": M, "new_tokens": n_new,
          "block_kv": VLM_BLOCK_KV, **out})
    return entries


TRAIN_ARCH = "gpt2"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_LR = 1e-3
TRAIN_MAX_STEPS = 100   # the one-batch loss must fall under 0.92x within
TRAIN_EVAL_EVERY = 10
TRAIN_EVAL_STEPS = 40   # the fresh-batch run (its eval loss reported)
RESUME_STEPS, RESUME_AT = 20, 10


def train_model(torch, dtype="bfloat16", layers=None, device=None, **kw):
    """gpt2 at its published width (and depth unless ``layers`` cuts it),
    in ``dtype``, with other config fields replaced where given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(TRAIN_ARCH)
    check(cfg.num_layers == 12 and cfg.d_model == 768 and
          cfg.vocab_size == 50257 and cfg.attn.num_heads == 12 and
          cfg.remat == "full", f"{TRAIN_ARCH} is not at full width")
    return build_model(dataclasses.replace(
        cfg, dtype=dtype, num_layers=layers or cfg.num_layers, **kw),
        device=device or DEVICE)


def train_steps(torch, step_fn, state, batch_of, steps, start=0,
                timed=None, detected=None):
    """Steps ``start..steps-1`` on ``batch_of(i)``; each step's wall ms
    into ``timed`` and its ``ft_detected`` into ``detected`` where given.
    Returns (state, the last step's metrics)."""
    metrics = None
    for i in range(start, steps):
        batch = batch_of(i)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append((time.perf_counter() - t0) * 1e3)
        if detected is not None:
            detected.append(int(metrics["ft_detected"].sum()))
    return state, metrics


def profiled_top(torch, fn, top=12):
    """One call of ``fn`` under the profiler (CUDA activity): wall ms,
    device ms, kernel count and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev = sum(e.self_device_time_total for e in kern) / 1e3
    return res, {"wall_ms": wall, "device_ms": dev,
                 "busy_share": dev / wall,
                 "kernels": sum(e.count for e in kern),
                 "top": [{"name": e.key[:90], "count": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                         for e in kern[:top]]}


def phase_train(torch, np, seed):
    """Training gpt2 at published width and depth (12 layers, d 768,
    vocab 50257; bf16, ``remat="full"``, plain EFTA) on B 8 x S 1024 of
    the port's synthetic pipeline, AdamW with ``warmup_cosine``:

    * card against CPU: at step 0 the f32 loss and gradients of 2 layers
      of full width (B 2 x S 256) equal the port's CPU path: the loss to
      1e-5 relative, each leaf's gradient to 1e-4 of the leaf's largest;
    * ``efta_pallas`` under autograd raises ``NotImplementedError``;
    * the loss falls: one batch trained on again and again falls under
      0.92x its start within ``TRAIN_MAX_STEPS`` steps (the factor of the
      JAX package's ``test_train_loop``), checked every
      ``TRAIN_EVAL_EVERY``. Its criterion proper, the eval loss of batch
      10,000 over fresh pipeline batches, is reported, not held: at
      gpt2's vocab of 50,257 random token ids it stays near ln V for
      hundreds of steps in both packages (PERF.md, Findings);
    * crash and resume: the fresh-batch run takes an async checkpoint
      after 10 steps; restored into a fresh state, steps 10-20 run again:
      the loss at step 20 equals the first run's to rtol 1e-5;
    * step time (median, p90), tokens/s, MFU (8 N T per step with full
      remat over the step time and the bf16 dense peak), peak memory, one
      profiled step's busy share and top kernels, and the share of the
      step taken by plain EFTA's forward (twice: the remat recomputes it)
      and backward pass, timed apart at the layer's shapes.
    """
    import shutil
    from repro_torch.core.efta import EFTAConfig, efta_attention as efta
    from repro_torch.data import as_tensors, make_pipeline
    from repro_torch.ft_runtime import (AsyncCheckpointer, latest_step,
                                        restore)
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils import param_count, tree_flatten_with_names
    from repro_torch.utils.tree import tree_map
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    res = {}
    # -- card against CPU, step 0, f32 at 2 layers
    m_c = train_model(torch, "float32", 2, device="cpu")
    m_g = train_model(torch, "float32", 2)
    gen = torch.Generator()
    gen.manual_seed(seed)
    p_c = m_c.init(gen)
    p_g = tree_map(lambda t: t.to(DEVICE), p_c)
    small = make_pipeline(m_c.cfg, global_batch=2, seq_len=256, seed=seed)
    nb = small.batch(0)
    l_c, _, g_c = value_and_grad(m_c, p_c, as_tensors(nb, "cpu"))
    l_g, _, g_g = value_and_grad(m_g, p_g, as_tensors(nb, DEVICE))
    rel = abs(float(l_g) - float(l_c)) / abs(float(l_c))
    check(rel <= 1e-5, f"train: card loss {float(l_g)} vs CPU "
          f"{float(l_c)} ({rel:.2e})")
    worst = 0.0
    pairs = list(zip(tree_flatten_with_names(g_g),
                     tree_flatten_with_names(g_c)))
    for (n, a), (_, b) in pairs:
        d = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
        check(d <= 1e-4, f"train: card gradient of {n} off the CPU's by "
              f"{d:.2e} of its max")
        worst = max(worst, d)
    res["card_vs_cpu"] = {"loss_rel": rel, "worst_grad_over_max": worst,
                          "leaves": len(pairs)}
    del m_c, p_c, g_c, p_g, g_g
    # -- efta_pallas under autograd raises on the card
    m_p = train_model(torch, "float32", 2,
                      ft=dataclasses.replace(m_g.cfg.ft,
                                             attn_impl="efta_pallas"))
    p_p = tree_map(lambda t: t.detach().requires_grad_(),
                   model_params(torch, m_p, seed))
    try:
        with torch.enable_grad():
            m_p.loss(p_p, as_tensors(nb, DEVICE))
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    check(bool(raised), "train: efta_pallas under autograd did not raise")
    res["efta_pallas_under_grad"] = raised
    del m_p, p_p, m_g
    free(torch)
    # -- the loss falls, at full width and depth in bf16
    model = train_model(torch)
    cfg = model.cfg
    data = make_pipeline(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         seed=seed)

    def pipeline(i):
        return as_tensors(data.batch(i), DEVICE)

    def loss_of(params, batch):
        with torch.no_grad():
            return float(model.loss(params, batch)[0])

    def fresh(seed_, total):
        opt = AdamW(lr=warmup_cosine(TRAIN_LR, warmup=10, total=total))
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed_)
        return init_state(model, opt, gen), make_train_step(model, opt)

    # (a) held: the loss of one batch, trained on again and again, falls
    # under 0.92x within TRAIN_MAX_STEPS (checked every TRAIN_EVAL_EVERY)
    state, step_fn = fresh(seed, TRAIN_MAX_STEPS)
    batch0 = pipeline(0)
    before = loss_of(state.params, batch0)
    after, steps, curve = before, 0, []
    while steps < TRAIN_MAX_STEPS and not after < 0.92 * before:
        n = steps + TRAIN_EVAL_EVERY
        state, _ = train_steps(torch, step_fn, state, lambda i: batch0, n,
                               start=steps)
        steps = n
        after = loss_of(state.params, batch0)
        curve.append({"step": steps, "loss": after})
    check(after < 0.92 * before, f"train: the loss of a batch trained on "
          f"{steps} times went {before:.4f} -> {after:.4f}, not under "
          f"0.92x")
    res["one_batch_loss_falls"] = {"before": before, "after": after,
                                   "steps": steps, "curve": curve}
    # (b) reported: fresh pipeline batches for TRAIN_EVAL_STEPS steps, the
    # eval loss (batch 10,000) every TRAIN_EVAL_EVERY, the step times; an
    # async checkpoint after RESUME_AT steps and the loss at RESUME_STEPS
    # for the crash and resume below
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    ckpt = AsyncCheckpointer()
    state, step_fn = fresh(seed, TRAIN_MAX_STEPS)
    n_params = param_count(state.params)
    eval_batch = pipeline(10_000)
    before = loss_of(state.params, eval_batch)
    step_ms, detected, evals = [], [], []
    for steps in range(TRAIN_EVAL_EVERY, TRAIN_EVAL_STEPS + 1,
                       TRAIN_EVAL_EVERY):
        state, metrics = train_steps(
            torch, step_fn, state, pipeline, steps,
            start=steps - TRAIN_EVAL_EVERY, timed=step_ms,
            detected=detected)
        if steps == RESUME_AT:
            ckpt.save_async(root / f"step_{steps}", state, step=steps)
        if steps == RESUME_STEPS:
            loss_a = float(metrics["loss"])
        evals.append({"step": steps, "eval_loss": loss_of(state.params,
                                                          eval_batch),
                      "train_loss": float(metrics["loss"])})
    ckpt.wait()
    check(all(math.isfinite(e["eval_loss"]) for e in evals),
          f"train: eval losses {evals}")
    st = sorted(step_ms[1:])                   # the first step warms up
    med = statistics.median(st)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = PEAK_FLOPS["torch.bfloat16"]
    res["pipeline_eval"] = {"before": before,
                            "after": evals[-1]["eval_loss"],
                            "ratio": evals[-1]["eval_loss"] / before,
                            "steps": TRAIN_EVAL_STEPS, "evals": evals,
                            "ft_detected_steps": sum(d > 0
                                                     for d in detected),
                            "ft_detected_total": sum(detected)}
    res["step"] = {"ms_median": med, "ms_p90": st[int(0.9 * (len(st) - 1))],
                   "tokens_per_s": tokens / med * 1e3,
                   "params": n_params,
                   "flops_per_step": 8 * n_params * tokens,
                   "mfu": 8 * n_params * tokens / (med / 1e3) / peak,
                   "bound_ms": 8 * n_params * tokens / peak * 1e3}
    steps = TRAIN_EVAL_STEPS
    batch = pipeline(steps)
    _, prof = profiled_top(torch, lambda: step_fn(state, batch))
    # plain EFTA at the layer's shapes: forward, and forward + backward
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    a = cfg.attn
    q, k, v = (torch.randn((TRAIN_BATCH, a.num_heads, TRAIN_SEQ,
                            a.head_dim), generator=g, device=DEVICE)
               .to(torch.bfloat16) for _ in range(3))
    ecfg = EFTAConfig(mode=cfg.ft.mode, stride=cfg.ft.stride,
                      block_kv=cfg.ft.block_kv)

    def fwd():
        with torch.no_grad():
            efta(q, k, v, cfg=ecfg, causal=True)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        with torch.enable_grad():
            out, _ = efta(qg, kg, vg, cfg=ecfg, causal=True)
            out.float().sum().backward()
    def device_per_call(fn, reps=3):
        """Profiler kernel time per call (CUDA events would add the host's
        gaps between these small kernels)."""
        fn()
        _, _, dev, _ = profiled_device_ms(
            torch, lambda: [fn() for _ in range(reps)])
        return dev / reps
    f_ms, fb_ms = device_per_call(fwd), device_per_call(fwd_bwd)
    # remat full: the forward runs twice, once more in the backward pass
    efta_ms = cfg.num_layers * (f_ms + fb_ms)
    prof["efta_fwd_device_ms_per_layer"] = f_ms
    prof["efta_fwd_bwd_device_ms_per_layer"] = fb_ms
    prof["efta_share_of_step"] = time_ratio(efta_ms, prof["device_ms"])
    res["profiled_step"] = prof
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, q, k, v, qg, kg, vg
    # -- crash and resume: the checkpoint restored into a fresh state,
    # steps RESUME_AT..RESUME_STEPS run again
    state_b, step0, _ = restore(latest_step(root),
                                fresh(seed, TRAIN_MAX_STEPS)[0])
    check(step0 == RESUME_AT, f"train: resumed at step {step0}")
    state_b, m_b = train_steps(torch, step_fn, state_b, pipeline,
                               RESUME_STEPS, start=step0)
    loss_b = float(m_b["loss"])
    check(abs(loss_a - loss_b) <= 1e-5 * abs(loss_a), f"train: resumed "
          f"run's loss {loss_b} vs {loss_a}")
    res["crash_resume"] = {"loss_a": loss_a, "loss_b": loss_b,
                           "resumed_at": step0, "steps": RESUME_STEPS}
    shutil.rmtree(root, ignore_errors=True)
    del state_b, model
    free(torch)
    emit({"phase": "train", "ok": True, "arch": TRAIN_ARCH,
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "dtype": "bfloat16",
          "remat": "full", "lr": TRAIN_LR, **res})
    return res


# ---------------------------------------------------------------------------
# phase dryrun: the dry run's predictions against the card's counts
# ---------------------------------------------------------------------------
# experiments/hillclimb.py's three cells, on the 16x16 production mesh
DRYRUN_BASELINES = (("kimi-k2-1t-a32b", "decode_32k"),
                    ("arctic-480b", "train_4k"),
                    ("deepseek-coder-33b", "prefill_32k"))
DRYRUN_PEAK_SLACK = 0.10   # predicted peak within 10% of the card's


def side_by_side(cmds, timeout=600):
    """Run the commands (argument lists) as subprocesses at once from the
    checkout's root with ``PYTHONPATH=src``; returns (exit code, stdout,
    stderr) of each, and kills any still running if one wait fails."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for c in cmds]
    try:
        done = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            done.append((p.returncode, out, err))
        return done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def dryrun_pair(torch, cfg, shape, seed, what):
    """One call predicted by the dry run on meta (one rank, no mesh) and
    counted on the card under the same ``opcount``: FLOPs, ops by class
    and by aten op, and launches must be equal; the predicted peak is
    reported against ``max_memory_allocated`` over the call plus the
    call's arguments. Returns (the line's numbers, the card's outputs)."""
    from repro_torch.launch import dryrun
    free(torch)
    pred, _, pred_s = dryrun.trace_call(dryrun.input_specs(cfg, shape, None),
                                        None)
    spec = dryrun.input_specs(cfg, shape, None, device=DEVICE, seed=seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, out, _ = dryrun.trace_call(spec, None)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    temp = torch.cuda.max_memory_allocated() - base
    dev = next(iter(got.argument_bytes))
    diff = {k: (pred.aten.get(k), got.aten.get(k))
            for k in set(pred.aten) | set(got.aten)
            if pred.aten.get(k) != got.aten.get(k)}
    check(pred.flops == got.flops, f"dryrun {what}: predicted FLOPs "
          f"{pred.flops} vs the card's {got.flops}")
    check(pred.count_ops() == got.count_ops() and not diff,
          f"dryrun {what}: ops {pred.count_ops()} vs {got.count_ops()}; "
          f"aten ops that differ (meta, card): {diff}")
    check(pred.launches == got.launches, f"dryrun {what}: launches "
          f"{pred.launches} vs {got.launches}")
    check(pred.argument_bytes["meta"] == got.argument_bytes[dev],
          f"dryrun {what}: argument bytes {pred.argument_bytes} vs "
          f"{got.argument_bytes}")
    peak_pred = pred.peak_bytes["meta"]
    peak_card = got.argument_bytes[dev] + temp
    line = {"flops": got.flops, "ops": got.count_ops(),
            "launches": got.launches, "bytes_pred": pred.bytes,
            "bytes_card": got.bytes,
            "argument_bytes": got.argument_bytes[dev],
            "peak_pred": peak_pred, "peak_card": peak_card,
            "peak_tracked_card": got.peak_bytes[dev],
            "peak_ratio": peak_pred / peak_card,
            "peak_within_10pct": abs(peak_pred / peak_card - 1)
            <= DRYRUN_PEAK_SLACK,
            "meta_s": pred_s, "card_s": card_s}
    return line, out


def phase_dryrun(torch, np, seed):
    """The dry run (``repro_torch.launch.dryrun``) against the card:

    (a) gpt2 training, phase 23's config (full width and depth, bf16,
        remat full, B 8 x 1,024): the one-rank prediction on meta of
        FLOPs, ops and peak bytes against the same step counted on the
        card (``opcount`` around the real step, ``max_memory_allocated``);
    (b) gpt2 ``Model.prefill`` under ``efta_pallas``, B 8 x 512: the
        same, with 12 B2 launches counted alike (the meta branch on meta,
        the kernel on the card, whose own counter moves by 12);
    (c) the three production cells of ``experiments/hillclimb.py`` on
        the 16x16 mesh through the dry run's CLI (a fake process group of
        256 ranks, rank 0's numbers; three processes side by side):
        ``dominant``, the three roofline terms, the peak a card and
        ``fits_80gb``.
    """
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.kernels.efta_attention import efta_attention
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="bfloat16")
    check(cfg.num_layers == 12 and cfg.d_model == 768 and
          cfg.remat == "full", f"dryrun: {TRAIN_ARCH} is not at full width")
    res = {}
    train, out = dryrun_pair(
        torch, cfg, ShapeCfg("gpt2_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        seed, "train")
    loss = float(out[1]["loss"])
    check(math.isfinite(loss), f"dryrun train: loss {loss}")
    res["train"] = dict(train, loss=loss)
    del out
    pcfg = dataclasses.replace(cfg, ft=dataclasses.replace(
        cfg.ft, attn_impl="efta_pallas"))
    n0 = efta_attention.launches
    prefill, out = dryrun_pair(
        torch, pcfg, ShapeCfg("gpt2_prefill", 512, 8, "prefill"), seed,
        "prefill")
    n_b2 = efta_attention.launches - n0
    calls = prefill["launches"].get("efta_attention", {}).get("calls")
    check(n_b2 == calls == cfg.num_layers, f"dryrun prefill: B2 launched "
          f"{n_b2} times, counted {calls}, for {cfg.num_layers} layers")
    logits = out[0]
    check(tuple(logits.shape) == (8, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()),
          f"dryrun prefill: logits {tuple(logits.shape)} not finite")
    check(int(out[1].detected.sum()) == 0, "dryrun prefill: detections")
    res["prefill"] = dict(prefill, b2_launches=n_b2)
    del out, logits
    free(torch)
    # the CLI, one process a cell, side by side (each opens its own fake
    # process group; the host's cores trace them)
    out_dir = ROOT / "build" / "dryrun_chip"
    shutil.rmtree(out_dir, ignore_errors=True)
    runs = side_by_side([[sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", arch, "--shape", shape, "--out",
                          str(out_dir)] for arch, shape in DRYRUN_BASELINES])
    cells = {}
    for (arch, shape), (rc, _, err) in zip(DRYRUN_BASELINES, runs):
        check(rc == 0, f"dryrun {arch} x {shape}: exit {rc}: "
              f"{err[-2000:]}")
        r = json.loads((out_dir / f"{arch}__{shape}__16x16.json")
                       .read_text())
        check(r["flops_per_device"] > 0, f"dryrun {arch}: no FLOPs")
        cells[f"{arch} x {shape} x 16x16"] = {
            "dominant": r["dominant"], "roofline": r["roofline"],
            "peak_bytes": r["memory"]["peak_bytes"],
            "fits_80gb": r["memory"]["fits_80gb"],
            "flops_per_device": r["flops_per_device"],
            "collective_total_per_device": r["collective_total_per_device"],
            "trace_s": r["trace_s"]}
    res["hillclimb_baselines"] = cells
    emit({"phase": "dryrun", "ok": True,
          "phase_s": time.perf_counter() - t_phase, **res})
    return res


# ---------------------------------------------------------------------------
# phase b2_wide: kernel B2 at the dry run's wide KV blocks, deepseek-coder's
# 32k prefill on it, and the dry run held to that prefill
# ---------------------------------------------------------------------------
# (name, block_kv, Sq, Skv, causal, kv_len, layout): two KV blocks of 2,048
# keys (fold stride 64) and two of 4,096 (stride 128) with a ragged tail on
# the cluster layout, and 32,768 keys a block (stride 128, 256 fold
# segments) at 16 query rows on the workspace layout
B2_WIDE_CASES = (("bkv2048 causal", 2048, 4096, 4096, True, None, "cluster"),
                 ("bkv4096 ragged", 4096, 256, 8192, False, 8092, "cluster"),
                 ("bkv32768 Sq16", 32768, 16, 65536, False, None,
                  "workspace"))
DEEPSEEK = "deepseek-coder-33b"
DEEPSEEK_LAYERS = 2      # of 62: one card holds the weights of a few
DEEPSEEK_SEQ = 32768
WIDE_PEAK_SLACK = 0.05   # the predicted peak within 5% of the card's


def b2_wide_kernel(torch):
    """(a) B2 against its plain version at each case of ``B2_WIDE_CASES``,
    at D 128 and 256 (2 query heads on one KV head), f32 and bf16, clean
    and under each compute-site SEU (``b2_regime_numbers``), each timed
    with its bound and SDPA; calls per timing window from one timed call,
    so that each case takes about a second. Each case takes the layout
    named (the built kernel's choice) and records its tiling, cluster size
    and the instantiation's registers and spills (phase 2)."""
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.kernels.efta_attention import efta_attention
    mod = b2_module()
    res = {}
    for ci, (name, bkv, sq, skv, causal, kv_len, layout) in enumerate(
            B2_WIDE_CASES):
        for d in (128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator().manual_seed(2300 + 10 * ci + d)
                q = torch.randn((1, 2, sq, d), generator=g)
                k = torch.randn((1, 1, skv, d), generator=g)
                v = torch.randn((1, 1, skv, d), generator=g)
                q, k, v = (x.to(DEVICE, dtype) for x in (q, k, v))
                cfg = EFTAConfig(block_kv=bkv)
                kw = {"cfg": cfg, "causal": causal}
                if kv_len is not None:
                    kw["kv_len"] = kv_len
                one = time_ms(torch, lambda: efta_attention(q, k, v, **kw),
                              reps=1, warmup=1)
                n = max(2, min(50, int(300 / max(one, 1e-3))))
                t = mod.kernel_tiling(mod.DTYPES[dtype], min(128, sq), bkv, d,
                                      cfg.kv_stride(bkv), cfg.out_stride(d))
                check(t.layout == layout, f"B2 {name} D{d}: the {t.layout} "
                      f"layout, not the {layout} one")
                dt = str(dtype)[6:]
                res[f"{name} D{d} {dt}"] = dict(
                    b2_regime_numbers(torch, {"q": q, "k": k, "v": v,
                                              "kw": kw}, p_rounding=True,
                                      reps=(n, max(2, n // 2)),
                                      ragged_sdpa=kv_len is not None),
                    block_kv=bkv, s_kv=cfg.kv_stride(bkv),
                    tiling=t._asdict(), layout=t.layout, cluster=t.cluster,
                    ptxas=b2_ptxas(dt, t.layout, d))
    return res


def b2_ptxas(dtype, layout, d):
    """Phase 2's registers, stack and spills of B2's instantiation for
    ``dtype`` ("bfloat16" or "float32"), ``layout`` and head dim ``d``."""
    if layout == "tile":
        return PTXAS.get("efta_attention", {}).get("bf16 tile")
    key = ("bf16" if dtype == "bfloat16" else "f32") + (
        "" if layout == "narrow" else " workspace" if layout == "workspace"
        else " cluster D<=128" if d <= 128 else " cluster D<=256")
    return PTXAS.get("efta_attention", {}).get(key)


def b2_wide_tiling():
    """(b) The Python mirror of the tiling rule against the built kernel's
    ``efta_attention_tiles`` over block_kv x D x dtype x s_kv x block_q x
    row groups x unified, refused shapes among them: equal in every
    field."""
    from collections import Counter
    from repro_torch.core.efta import EFTAConfig
    mod = b2_module()
    n, refused, layouts = 0, 0, Counter()
    for code in (0, 1):
        for bq in (1, 16, 64, 128):
            for mg in (1, 2, 4):
                for bkv in (16, 64, 512, 1024, 2048, 4096, 8192, 32768):
                    for d in (64, 72, 112, 128, 160, 256):
                        for skv in (4, 8, 16, 32, 64, 128):
                            if skv > bkv:
                                continue
                            for unified in (True, False):
                                shapes = (code, bq, bkv, d, skv,
                                          EFTAConfig().out_stride(d), mg,
                                          unified)
                                a = mod.tiling(*shapes)
                                b = mod.kernel_tiling(*shapes)
                                check(a == b, f"tiling {shapes}: mirror {a} "
                                      f"vs kernel {b}")
                                n += 1
                                refused += b is None
                                if b is not None:
                                    layouts[b.layout] += 1
    return {"shapes": n, "refused": refused, **layouts}


def deepseek_config():
    """deepseek-coder-33b at its published width with ``DEEPSEEK_LAYERS``
    layers, bf16, under ``efta_pallas`` at the dry run's prefill block."""
    from repro_torch.launch.dryrun import cell_config
    cfg = cell_config(DEEPSEEK, "prefill_32k")
    a = cfg.attn
    check(cfg.d_model == 7168 and cfg.d_ff == 19200 and
          cfg.vocab_size == 32256 and (a.num_heads, a.num_kv_heads,
                                       a.head_dim) == (56, 8, 128) and
          cfg.ft.block_kv == 2048, f"{DEEPSEEK} is not at full width")
    return dataclasses.replace(cfg, dtype="bfloat16",
                               num_layers=DEEPSEEK_LAYERS,
                               ft=dataclasses.replace(
                                   cfg.ft, attn_impl="efta_pallas"))


def one_call_device_ms(torch, fn, name):
    """``fn()`` once under the profiler (CUDA activity, opened by a spin
    kernel: the profiler drops the first records of a window); returns
    (its result, the device ms of each kernel record whose name holds
    ``name``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_CYCLES)
        res = fn()
        torch.cuda.synchronize()
    return res, [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]


def b2_deepseek_held(torch, q, k, v, kw, clean, ev):
    """Deepseek's B2 launch (56 query heads on 8 KV heads, grp 7, 16 causal
    KV blocks of 2,048; on the cluster layout 28,672 clusters of 8 CTAs,
    64 rows each) held to its plain version. The plain version holds (7,
    256, 128, 2,048) f32 temporaries for one KV head's query heads (all
    56: 15 GB each), so it runs a KV head at a time: the first and the
    last KV head against those heads of the kernel's clean 56-head call
    (``clean``), and under an SEU at each of the five compute sites
    (correct mode, top exponent bit, the last row, the last KV block, key
    or output column 3) on query head 3 of the last KV head, against the
    kernel's 56-head call with that fault: counts equal (at least one but
    at GEMM II), the heads within ``out_bound`` plus ``p_rounding_slack``,
    every other head bit-equal to the clean call. Returns the errors, the
    counts and the plain version's time on 7 heads (CUDA events ``ev``)."""
    from repro_torch.core.efta import reference_attention
    from repro_torch.core.fault import Site
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_torch)
    S, grp, nkv = q.shape[2], q.shape[1] // k.shape[1], k.shape[1]
    last_blk = S // kw["cfg"].block_kv - 1

    def group(j):
        return slice(j * grp, (j + 1) * grp)

    def slack(j):
        # 2^-7 (P |V|), P the causal softmax in f32, 2,048 rows at a time
        hs, kj, vj = group(j), k[:, j:j + 1], v[:, j:j + 1].float().abs()
        return 2.0 ** -7 * torch.cat([reference_attention(
            q[:, hs, a:a + 2048], kj, vj, causal=True, q_offset=a,
            sm_scale=kw.get("sm_scale")) for a in range(0, S, 2048)], dim=2)

    def plain(j, fault=None):
        return efta_attention_torch(q[:, group(j)], k[:, j:j + 1],
                                    v[:, j:j + 1], fault=fault, **kw)
    ev[0].record()
    ref0 = plain(0)
    ev[1].record()
    torch.cuda.synchronize()
    res = {"plain_ms": ev[0].elapsed_time(ev[1]), "clean": {}, "seu": {}}
    check(int(clean[1].sum()) == 0, "deepseek B2: clean detections")
    for j in (0, nkv - 1):
        ref = ref0 if j == 0 else plain(j)
        err, ratio = b2_compare(torch, (clean[0][:, group(j)], clean[1]), ref,
                                f"deepseek B2 KV head {j}", slack(j))
        res["clean"][f"kv_head_{j}"] = {"max_abs_err": err,
                                        "err_over_bound": ratio}
    del ref0, ref
    j, h = nkv - 1, min(3, grp - 1)
    rest = torch.ones(q.shape[1], dtype=torch.bool, device=q.device)
    rest[group(j)] = False
    for site in (Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM, Site.GEMM2):
        desc = [int(site), last_blk, 0, S - 1, 3, seu_bit("correct"), 1, 0]
        got = efta_attention(q, k, v, fault=[desc[0], desc[1], j * grp + h]
                             + desc[3:], **kw)
        ref = plain(j, fault=[desc[0], desc[1], h] + desc[3:])
        torch.cuda.synchronize()
        err, ratio = b2_compare(torch, (got[0][:, group(j)], got[1]), ref,
                                f"deepseek B2 {site.name}", slack(j))
        # a GEMM II flip goes uncounted (ROADMAP, standing item 2)
        check(int(got[1].sum()) >= 1 or site == Site.GEMM2,
              f"deepseek B2: {site.name} SEU not detected")
        check(torch.equal(got[0][:, rest], clean[0][:, rest]),
              f"deepseek B2 {site.name}: heads without the fault differ "
              f"from the clean call")
        res["seu"][site.name] = {"detected": got[1].tolist(),
                                 "max_abs_err": err, "err_over_bound": ratio}
        del got, ref
    return res


def b2_wide_deepseek(torch, seed):
    """(c) deepseek-coder-33b, 2 layers at full width, bf16, random weights
    from the seed: ``Model.prefill`` of B 1 x 32,768 tokens under
    ``efta_pallas`` at ``block_kv`` 2,048 (56 query heads on 8 KV heads of
    128, causal: 2 B2 launches on the wide path). The dry run's one-rank
    prediction on meta against the same call counted on the card (FLOPs,
    ops, launches equal; peak within 5%); the prefill's time, tokens/s and
    peak; B2's device time per launch (profiler, one launch on the first
    layer's inputs) beside its bound and SDPA on the same inputs, and that
    launch held to its plain version (``b2_deepseek_held``); nothing
    detected clean; under one SEU per compute site (correct mode, top
    exponent bit, last row, the last KV block, in every layer) the
    last-position logits of the clean run: exactly where a shadow or the
    EXP recompute restores the value, within 2e-2 of max |logit| with the
    same argmax where checksum arithmetic does (as phase 8 holds gpt2's),
    detected at every site but GEMM II."""
    import torch.nn.functional as F
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.core.fault import FaultSpec, Site
    from repro_torch.kernels.efta_attention import (efta_attention,
                                                    efta_attention_work)
    cfg = deepseek_config()
    shape = ShapeCfg("deepseek_prefill", DEEPSEEK_SEQ, 1, "prefill")
    n0 = efta_attention.launches
    line, out = dryrun_pair(torch, cfg, shape, seed, "deepseek prefill")
    n_b2 = efta_attention.launches - n0
    calls = line["launches"].get("efta_attention", {}).get("calls")
    check(n_b2 == calls == DEEPSEEK_LAYERS, f"deepseek prefill: B2 launched "
          f"{n_b2} times, counted {calls}, for {DEEPSEEK_LAYERS} layers")
    check(abs(line["peak_ratio"] - 1) <= WIDE_PEAK_SLACK, f"deepseek "
          f"prefill: predicted peak {line['peak_pred']} vs the card's "
          f"{line['peak_card']}")
    del out
    free(torch)
    from repro_torch.launch import dryrun
    spec = dryrun.input_specs(cfg, shape, None, device=DEVICE, seed=seed)
    model, params, toks = spec["model"], spec["params"], spec["tokens"]

    def prefill(fault=None):
        return model.prefill(params, toks, model.init_cache(
            1, cache_len=DEEPSEEK_SEQ), fault=fault)

    # the clean run, timed, keeping copies of the first B2 call's inputs
    rec = RegimeRecorder()
    try:
        torch.cuda.synchronize()
        n0 = efta_attention.launches
        t0 = time.perf_counter()
        base, rep0, _ = prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.restore()
    check(efta_attention.launches - n0 == DEEPSEEK_LAYERS,
          "deepseek prefill: B2 launches")
    check(tuple(base.shape) == (1, cfg.vocab_size) and
          bool(torch.isfinite(base).all()), "deepseek prefill: logits")
    check(int(rep0.detected.sum()) == 0, "deepseek prefill: clean "
          "detections")
    seu = {}
    last_blk = DEEPSEEK_SEQ // cfg.ft.block_kv - 1
    for site in (Site.GEMM1, Site.ROWMAX, Site.EXP, Site.ROWSUM,
                 Site.GEMM2):
        f = FaultSpec.single(site, block=last_blk, head=1,
                             row=DEEPSEEK_SEQ - 1, col=3,
                             bit=seu_bit("correct"))
        got, rep, _ = prefill(f)
        diff = float((got.float() - base.float()).abs().max())
        same_top = bool(torch.equal(got.argmax(-1), base.argmax(-1)))
        n = int(rep.detected.sum())
        if site in (Site.ROWMAX, Site.EXP, Site.ROWSUM):
            check(torch.equal(got, base) and n >= 1, f"deepseek prefill "
                  f"{site.name}: logits off the clean ones by {diff:.3e}, "
                  f"detected {rep.detected.tolist()}")
        else:
            # a GEMM II flip goes uncounted (ROADMAP, standing item 2)
            check(same_top and diff <= 2e-2 * float(base.abs().max()) and
                  (n >= 1 or site == Site.GEMM2), f"deepseek prefill "
                  f"{site.name}: logits off the clean ones by {diff:.3e}, "
                  f"detected {rep.detected.tolist()}")
        seu[site.name] = {"detected": rep.detected.sum(0).tolist(),
                          "max_abs_logit_diff": diff, "same_argmax": same_top}
        del got, rep
    # B2 once on the first layer's inputs: the profiler's device time and
    # CUDA events around the launch
    cap = rec.captured[(DEEPSEEK_SEQ, DEEPSEEK_SEQ, True)]
    q, k, v = cap["q"], cap["k"], cap["v"]
    kw = {n: x for n, x in cap["kw"].items() if n != "fault"}
    mod, c = b2_module(), kw["cfg"]
    check(c.block_kv == 2048 and kw.get("causal"), f"deepseek prefill: B2 "
          f"called with {kw}")
    nbytes, flops = efta_attention_work(q, k, causal=True)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype)] * 1e3
    kc, vc = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
              for t in (k, v))
    sdpa_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kc, vc, is_causal=True), 3)
    del kc, vc
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def b2_once():
        ev[0].record()
        got = efta_attention(q, k, v, **kw)
        ev[1].record()
        return got
    clean, b2_ms = one_call_device_ms(torch, b2_once, "efta_attention_kernel")
    kernel_ms = ev[0].elapsed_time(ev[1])
    held = b2_deepseek_held(torch, q, k, v, kw, clean, ev[2:])
    t = mod.tiling(mod.DTYPES[q.dtype], 128, c.block_kv, 128,
                   c.kv_stride(c.block_kv), c.out_stride(128))
    check(t.layout == "cluster", f"deepseek B2: the {t.layout} layout, not "
          f"the cluster one")
    b2_shape, q_dtype = list(q.shape), q.dtype
    del rec, cap, q, k, v, clean
    res = {"dryrun": line, "b2_launches": n_b2,
           "prefill_s": wall, "tokens_per_s": DEEPSEEK_SEQ / wall,
           "peak_bytes": line["peak_card"], "seu": seu,
           "b2": {"shape": b2_shape, "causal": True,
                  "block_kv": cfg.ft.block_kv, "tiling": t._asdict(),
                  "layout": t.layout, "cluster": t.cluster,
                  "ptxas": b2_ptxas(str(q_dtype)[6:], t.layout, 128),
                  "device_ms": b2_ms[0] if len(b2_ms) == 1 else None,
                  "ms": kernel_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes": nbytes, "flops": flops,
                  "library_ms": sdpa_ms, "held": held,
                  "max_abs_err": max(x["max_abs_err"] for x in [
                      *held["clean"].values(), *held["seu"].values()]),
                  "plain_ms_7_heads": held["plain_ms"]}}
    del model, params, spec
    free(torch)
    return res


def phase_b2_wide(torch, np, seed):
    """Kernel B2 at the dry run's wide KV blocks: (a) against its plain
    version and timed (``b2_wide_kernel``), (b) the tiling mirror against
    the kernel's rule (``b2_wide_tiling``), (c) deepseek-coder-33b's 32k
    prefill on it, held to the dry run (``b2_wide_deepseek``). Returns the
    regimes for the kernels line."""
    t0 = time.perf_counter()
    cases = b2_wide_kernel(torch)
    tiles = b2_wide_tiling()
    ds = b2_wide_deepseek(torch, seed)
    emit({"phase": "b2_wide", "ok": True, "phase_s": time.perf_counter() - t0,
          "cases": cases, "tiling": tiles, "deepseek_prefill": ds})
    regimes = {f"wide {k}": v for k, v in cases.items()}
    regimes["deepseek-coder-33b prefill 32k"] = dict(
        ds["b2"], launches=ds["b2_launches"],
        launches_per="Model.prefill of 32,768 tokens, 2 layers")
    return regimes


# (B, H, Hkv, Sq, Skv, D, causal, block_kv, window): B2's narrow-path
# regimes of earlier phases (gpt2's ring prefill buckets, the VLM's self
# and cross prefill at block_kv 64, bert-large's encoder, gemma3-1b's D 256
# under its 512 window, kimi-k2's D 112 and arctic's D 128 heads) and the
# cross-attention decode of t5 (one 512-key block) and of the VLM (25
# blocks of 64 keys, 4 query heads a KV head)
B2_NARROW_AB = {"gpt2_S512": (1, 12, 12, 512, 512, 64, True, 512, None),
                "gpt2_S64": (1, 12, 12, 64, 64, 64, True, 512, None),
                "vlm_self": (8, 32, 8, 512, 512, 128, True, 64, None),
                "bert": (8, 16, 16, 512, 512, 64, False, 512, None),
                "gemma3_w512": (1, 4, 1, 1024, 1024, 256, True, 512, 512),
                "kimi_512": (1, 64, 8, 512, 512, 112, True, 512, None),
                "arctic_512": (1, 56, 8, 512, 512, 128, True, 512, None),
                "vlm_cross": (8, 32, 8, 512, 1600, 128, False, 64, None),
                "t5_cross_decode": (8, 8, 8, 1, 512, 64, False, 512, None),
                "vlm_cross_decode": (8, 32, 8, 1, 1600, 128, False, 64,
                                     None)}


def narrow_sass(kinds=("efta_attention_kernelI",)):
    """Per instantiation of B2's narrow kernel (``efta_attention_kernel``,
    not ``_wide``, ``_cluster``, ``_tile``, ``_fold`` or the decode
    layout's ``_d*``; other ``kinds``: substrings of the kernels' mangled
    names) in the built library: the sha1 of its ``cuobjdump -sass`` text,
    encodings included, with the anonymous namespace's per-build
    ``_GLOBAL__N__<hash>_`` taken out and the branch labels (``.L_x_N``,
    numbered across the file, so kernels added to it shift them) numbered
    within the function, and its line count."""
    import hashlib
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass",
                           str(_build.library_path("efta_attention"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", text)
    funcs, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ln)

    def own_labels(body):
        names = {}
        return re.sub(r"\.L_x_\d+", lambda m: names.setdefault(
            m.group(0), f".L{len(names)}"), "\n".join(body))

    return {n: {"sha1": hashlib.sha1(own_labels(body).encode())
                .hexdigest()[:16], "lines": len(body)}
            for n, body in funcs.items() if any(k in n for k in kinds)}


def phase_b2_narrow(torch, np, seed):
    """B2 at ``B2_NARROW_AB`` in bf16 and f32: the layout the kernel takes,
    the profiler's device time per launch (20 calls; on the tile layout
    its fold pass and the tile kernel, and the fold pass alone; on the
    decode layout its three passes, and each alone), and a
    hash of the clean and an EXP-faulted output with both detection
    vectors; the SASS hashes of the narrow kernel (``narrow_sass``) and of
    the tile layout's two kernels, the workspace and the cluster layouts'
    kernels. Only under ``--only b2_narrow``: run in
    two checkouts in turns (this file copied into the other's root;
    parent, change, change, parent), it holds one kernel to the other
    (equal hashes and counts where both take the same layout) and puts
    their times side by side."""
    import hashlib
    from repro_torch.core.efta import EFTAConfig
    from repro_torch.kernels.efta_attention import efta_attention
    mod = b2_module()
    res = {}
    for name, (B, H, Hkv, Sq, Skv, D, causal, bkv, window) in \
            B2_NARROW_AB.items():
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator().manual_seed(5)
            q = torch.randn((B, H, Sq, D), generator=g).to(DEVICE, dt)
            k = torch.randn((B, Hkv, Skv, D), generator=g).to(DEVICE, dt)
            v = torch.randn((B, Hkv, Skv, D), generator=g).to(DEVICE, dt)
            kw = dict(cfg=EFTAConfig(block_kv=bkv), causal=causal,
                      window=window)
            o, d = efta_attention(q, k, v, **kw)
            of, df = efta_attention(q, k, v, fault=[
                2, 0, 1, Sq - 1, 3, seu_bit("correct"), 1, 0], **kw)
            h = hashlib.sha1(o.float().cpu().numpy().tobytes() +
                             of.float().cpu().numpy().tobytes())
            cfg = kw["cfg"]
            bk = min(bkv, Skv)
            layout = mod.kernel_tiling(
                mod.DTYPES[dt], min(128, Sq), bk, D, cfg.kv_stride(bk),
                cfg.out_stride(D)).layout
            res[f"{name} {str(dt)[6:]}"] = {
                "layout": layout,
                "device_ms": device_ms(torch, lambda: efta_attention(
                    q, k, v, **kw), 20, name="efta_attention_kernel"),
                "fold_ms": device_ms(torch, lambda: efta_attention(
                    q, k, v, **kw), 20, name="efta_attention_kernel_fold")
                if layout == "tile" else None,
                "decode_ms": {p: device_ms(torch, lambda: efta_attention(
                    q, k, v, **kw), 20, name=f"efta_attention_kernel_d{p}")
                    for p in ("score", "exp", "state")}
                if layout == "decode" else None,
                "hash": h.hexdigest()[:16], "detected": d.tolist(),
                "detected_exp_seu": df.tolist()}
    emit({"phase": "b2_narrow", "ok": True, "regimes": res,
          "sass": narrow_sass(),
          "tile_sass": narrow_sass(("efta_attention_kernel_tile",
                                    "efta_attention_kernel_fold")),
          "wide_sass": narrow_sass(("efta_attention_kernel_wide",
                                    "efta_attention_kernel_cluster"))})


# ---------------------------------------------------------------------------
# phase examples: the port's five examples on the card
# ---------------------------------------------------------------------------
EXAMPLES = ("quickstart", "fault_injection_campaign", "serve_fault_tolerant",
            "paged_prefix_serving", "train_with_restart")


def _snapshot(x):
    """A copy of a kernel argument: tensors cloned, (named) tuples of
    them copied through, anything else as it is."""
    import torch
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        parts = [_snapshot(y) for y in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def held_paged_example(torch, device=DEVICE):
    """``examples_torch/paged_prefix_serving.py`` run in this process on
    ``device`` with every B1 call it makes held against the plain version
    on the same inputs: the arguments are copied at the call (the engine
    writes the pool again later), and after the run each call's output
    must lie within ``out_bound`` of the plain version's, with equal
    detection vectors and bad planes (``compare``). This holds the kernel
    at the example's own regime (gpt2-smoke: head_dim 16, block 16, 2
    slots, its chunk widths, the resident flip and its retry), which no
    other phase reaches. Returns (calls held, the example's numbers,
    largest |kernel - plain|)."""
    import importlib.util
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.efta_paged import efta_paged_attention_torch
    spec = importlib.util.spec_from_file_location(
        "paged_prefix_serving",
        ROOT / "examples_torch" / "paged_prefix_serving.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    wrapper = attn_mod.efta_paged_attention
    calls = []

    def held(*args, **kw):
        snap = (_snapshot(args), {k: _snapshot(v) for k, v in kw.items()})
        rep = wrapper(*args, **kw)
        calls.append((snap, rep))
        return rep

    attn_mod.efta_paged_attention = held
    try:
        numbers = example.main(["--device", str(device)])
    finally:
        attn_mod.efta_paged_attention = wrapper
    err = 0.0
    for i, ((args, kw), rep) in enumerate(calls):
        ref = efta_paged_attention_torch(*args, **kw)
        err = max(err, compare(torch, rep, ref,
                               f"examples: paged_prefix_serving B1 call {i} "
                               f"(q {tuple(args[0].shape)})"))
    return len(calls), numbers, err


def phase_examples(torch):
    """Each script of ``examples_torch/`` as a subprocess on the card at
    its defaults, all five side by side: each exits 0 (a failed assertion
    exits non-zero); ``paged_prefix_serving`` launches B1. Then
    ``paged_prefix_serving`` once more in this process, every B1 launch
    held against the plain version (``held_paged_example``): the same
    launches as its subprocess, each within the bound, detections equal.
    Each script's last line, and the wall time of all five."""
    free(torch)
    t0 = time.perf_counter()
    # side by side: each holds a few MB of the card
    runs = side_by_side([[sys.executable,
                          str(ROOT / "examples_torch" / f"{name}.py")]
                         for name in EXAMPLES], timeout=300)
    wall = time.perf_counter() - t0
    res = {"wall_s": wall}
    for name, (rc, out, err) in zip(EXAMPLES, runs):
        lines = out.strip().splitlines()
        check(rc == 0, f"examples: {name} exited {rc}: {err[-3000:]}")
        res[name] = {"last_line": lines[-1] if lines else ""}
        if name == "paged_prefix_serving":
            n = int(next(x for x in lines if x.startswith(
                "kernel B1 launches:")).split(":")[1])
            check(n > 0, "examples: paged_prefix_serving launched no B1")
            res[name]["b1_launches"] = n
    t0 = time.perf_counter()
    n_held, numbers, max_err = held_paged_example(torch)
    n = res["paged_prefix_serving"]["b1_launches"]
    check(n_held == numbers["b1_launches"] == n,
          f"examples: paged_prefix_serving held {n_held} B1 calls, launched "
          f"{numbers['b1_launches']} in this process and {n} in its own")
    res["paged_prefix_serving"].update(
        b1_held=n_held, b1_max_abs_err=max_err,
        kv_detected_blocks=numbers["kv_detected_blocks"],
        kv_repaired_blocks=numbers["kv_repaired_blocks"],
        held_s=time.perf_counter() - t0)
    emit({"phase": "examples", "ok": True, **res})
    return res


# ---------------------------------------------------------------------------
# phase dist: distributed training on gloo ranks sharing the card
# ---------------------------------------------------------------------------
DIST_WORLD = 2           # ranks, both on cuda:0 (nccl refuses that: gloo)
DIST_WAIT_S = 600        # the ranks' deadline, and each collective's timeout
DIST_STEPS = 3
DIST_BATCH, DIST_SEQ = 4, 1024    # the global batch, split over 'pod'
DIST_LR = 1e-3
# An AdamW step moves a weight by about lr where m / sqrt(v) is +-1: a
# gradient element that f32 reduction order leaves with either sign can
# end a step 2 lr apart; elsewhere the weights agree to the update's last
# bits (1e-3 lr)
DIST_ADAM_SLACK = 2 * DIST_STEPS * DIST_LR
DIST_TIGHT = 1e-3 * DIST_LR
# After one step the two syncs' weights part: Adam's first steps follow
# sign(g), and the int8 rounding zeroes every gradient element under half
# a quantization step of its leaf (its share waits in the residual), so
# other weights move; the loss of the next batches is held to 3%
DIST_INT8_REL = 3e-2
MOE_ARCH = "arctic-480b"
MOE_TRAIN_TOKENS = 4096  # one rank's training tokens (B 8 x S 512)
MOE_DECODE_TOKENS = 64   # a decode batch, split over 'data'


def phase_dist(torch, np, seed, card):
    """Distributed training on ``DIST_WORLD`` gloo ranks that share the
    card, each a subprocess of this script (``--dist-rank``) on cuda:0,
    meeting through a ``file://`` store in a fresh directory under
    ``build/``; every wait has a deadline and a failure kills every rank.
    CUDA tensors cross gloo through host buffers (the collectives' rule
    for a gloo group); the nccl path is written but needs a card a rank,
    which this machine does not have.

    (a) gpt2 at full width and depth in f32 on mesh (pod 2), B 4 x 1,024
        (an uneven loss mask), ``DIST_STEPS`` steps under ``dense`` and
        under ``int8_ef``. ``dense`` against a one-process dense run of the
        same global batch on the card: the loss of each step to 1e-5
        relative, the final weights within ``DIST_ADAM_SLACK`` and all but
        0.1% of each leaf within ``DIST_TIGHT``, the moments within 1e-5
        of each leaf's largest (f32 reduction order is the only
        difference). ``int8_ef``: its loss is the mean of the pods' means
        (not the global mean: the reference's rule), held against that
        mean under ``dense``'s weights of the same step: to 1e-5 at step
        1 (the same weights), to ``DIST_INT8_REL`` after (the compressed
        gradients move other weights);
        ``|new_err| <= scale / 2`` (and bf16 rounding) on every leaf of
        every step. After every step of both, the blocks
        the spec replicates are bit-equal across ranks (all-gathered
        checksums). Step times and the bytes of each kind of collective.
    (c) checkpoint resharding: the dense state cut to ZeRO-3 blocks on
        mesh (data 2) is saved, restored on mesh (pod 2) and in one
        process, and a one-process save restored on (data 2): bit-equal
        each way.
    (b) one MoE layer at arctic-480b's published width (128 experts of
        7,168 x 4,864, top-2), bf16, each rank holding 64 experts (13.4
        GB): ``_moe_apply_ep`` on mesh (model 2) over 4,096 tokens and
        ``_moe_inference_ep`` on mesh (data 2) in decode over 64 tokens
        (32 a rank), against the one-device ``moe_apply`` (run by rank 0
        after rank 1 has freed its experts): y within about one bf16 ulp
        (2^-7 |ref| + 2^-8 rms(ref)), aux equal, the same dropped
        assignments.
    """
    import shutil
    import tempfile
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dist_", dir=build))
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(DIST_WORLD):
            err = open(tmp / f"rank{r}.err", "w+")
            logs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--seed", str(seed), "--dist-rank", str(r),
                 "--dist-dir", str(tmp)],
                stdout=err, stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.monotonic() + DIST_WAIT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            check(time.monotonic() < deadline,
                  f"dist: ranks ran past {DIST_WAIT_S} s")
            time.sleep(0.2)
        for r, (p, err) in enumerate(zip(procs, logs)):
            if p.poll() != 0:
                err.seek(0)
                check(False, f"dist: rank {r} exited {p.poll()}:\n"
                      + err.read()[-4000:])
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(DIST_WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for err in logs:
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = res[0]
    for r in res:
        check(r["a"]["dense"]["losses"] == r0["a"]["dense"]["losses"],
              "dist: the ranks' dense losses differ")
    emit({"phase": "dist", "ok": True, "card": card,
          "transport": "gloo, staged through host",
          "nccl": "written, not run: one card (nccl refuses two ranks on "
                  "one device)",
          "ranks": DIST_WORLD, "seconds": wall,
          "a_gpt2_pod2": r0["a"], "c_checkpoint": r0["c"],
          "b_moe_arctic": r0["b"],
          "rank1": {"a_step_ms": {k: v["step_ms"]
                                  for k, v in res[1]["a"].items()
                                  if isinstance(v, dict) and
                                  "step_ms" in v}}})
    return res


def dist_rank(args) -> int:
    """One rank of ``phase_dist``: (a), (c), (b) in that order, its
    numbers written to ``rank<r>.json``; any failed check raises."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    rank = args.dist_rank
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{args.dist_dir}/store", rank=rank,
        world_size=DIST_WORLD,
        timeout=datetime.timedelta(seconds=DIST_WAIT_S))
    try:
        out = {}
        out["a"], state = dist_train(torch, np, args.seed, rank)
        print(json.dumps({"a": out["a"]}), flush=True)   # into its log
        out["c"] = dist_checkpoint(torch, state, rank, Path(args.dist_dir))
        print(json.dumps({"c": out["c"]}), flush=True)
        del state
        free(torch)
        out["b"] = dist_moe(torch, np, args.seed, rank)
        (Path(args.dist_dir) / f"rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def dist_batches(torch, np, cfg, seed):
    """The global batches of (a): the synthetic pipeline with a loss mask
    of one density a row (0.2 .. 0.9), so the two pods' counts differ."""
    from repro_torch.data import as_tensors, make_pipeline
    pipe = make_pipeline(cfg, global_batch=DIST_BATCH, seq_len=DIST_SEQ,
                         seed=seed)
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.2, 0.9, DIST_BATCH)[:, None]
    out = []
    for i in range(DIST_STEPS):
        nb = pipe.batch(i)
        nb["loss_mask"] = (rng.random((DIST_BATCH, DIST_SEQ)) < dens
                           ).astype(np.float32)
        out.append(as_tensors(nb, DEVICE))
    return out


def dist_train(torch, np, seed, rank):
    """(a): returns (numbers, the final dense state, whole on each rank)."""
    import torch.distributed as dist
    from repro_torch.distributed import Mesh, shard_tree
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import (local_block,
                                                  replicas_disagree)
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step, state_specs
    from repro_torch.utils import tree_flatten_with_names
    model = train_model(torch, "float32")
    mesh = Mesh((DIST_WORLD,), ("pod",))
    opt = AdamW(lr=DIST_LR)
    batches = dist_batches(torch, np, model.cfg, seed)

    def fresh(sync):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        return init_state(model, opt, g, pod_sync=sync)

    worst_err = [0.0]
    orig = coll.compressed_psum

    def checked(x, group, err=None):
        mean, ne = orig(x, group, err)
        xf = x.float() + (err.float() if err is not None else 0.0)
        amax = xf.abs().max().cpu()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)  # a check
        scale = float(amax) / 127.0 if float(amax) > 0 else 1.0
        worst_err[0] = max(worst_err[0],
                           float(ne.float().abs().max()) / (scale / 2))
        return mean, ne

    def pod_mean(params, b):
        """The mean of the pods' mean losses of batch ``b`` (the
        compressed sync's rule), each pod's on its rank."""
        with torch.no_grad():
            mine = model.loss(params, {
                k: local_block(v, (("pod",),) + (None,) * (v.dim() - 1),
                               mesh) for k, v in b.items()})[0]
        return float(coll.all_reduce(mine, mesh.group("pod"))) / DIST_WORLD

    res, pods = {}, []
    for sync in ("dense", "int8_ef"):
        specs = state_specs(model, mesh, pod_sync=sync)
        st = shard_tree(fresh(sync), specs, mesh)
        step = make_train_step(model, opt, mesh=mesh, pod_sync=sync)
        losses, step_ms, moved, bad = [], [], [], []
        coll.compressed_psum = checked
        try:
            for b in batches:
                if sync == "dense":
                    pods.append(pod_mean(st.params, b))
                coll.reset_traffic()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = step(st, b)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                moved.append({k: dict(v) for k, v in coll.traffic.items()})
                bad += replicas_disagree(st._replace(ef=None), specs, mesh)
        finally:
            coll.compressed_psum = orig
        check(not bad, f"dist: {sync} replicas differ after a step: {bad}")
        check(all(math.isfinite(x) for x in losses),
              f"dist: {sync} losses {losses}")
        res[sync] = {"losses": losses, "step_ms": step_ms,
                     "collectives_per_step": moved[-1]}
        if sync == "dense":
            dense = st
    res["int8_ef"]["worst_new_err_over_half_scale"] = worst_err[0]
    check(worst_err[0] <= 1 + 2 ** -8, f"dist: |new_err| reached "
          f"{worst_err[0]} x scale / 2")
    # int8_ef's loss is the mean of the pods' means (the global mean
    # differs under the uneven mask): at step 1, of the same weights as
    # dense's; later, of weights the compressed gradients moved
    res["dense"]["pod_mean_losses"] = pods
    l8 = res["int8_ef"]["losses"]
    first = abs(l8[0] - pods[0]) / abs(pods[0])
    rel = max(abs(a - b) / abs(b) for a, b in zip(l8, pods))
    res["int8_ef"].update(step1_rel_to_pod_mean=first,
                          rel_to_dense_pod_mean=rel)
    check(first <= 1e-5 and rel <= DIST_INT8_REL, f"dist: int8_ef losses "
          f"{l8} vs the pods' means under dense {pods}")
    del st
    free(torch)
    # the one-process dense run of the same global batches, on rank 0
    if rank == 0:
        one = fresh("dense")
        step1 = make_train_step(model, opt)
        ref, ref_ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one, m = step1(one, b)
            ref.append(float(m["loss"]))
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
        lrel = max(abs(a - b) / abs(b) for a, b in
                   zip(res["dense"]["losses"], ref))
        check(lrel <= 1e-5, f"dist: dense losses {res['dense']['losses']} "
              f"vs one process {ref}")
        worst = {"params_max": 0.0, "params_past_tight": 0.0,
                 "moments_over_max": 0.0}
        for (n, a), (_, b) in zip(tree_flatten_with_names(dense),
                                  tree_flatten_with_names(one)):
            d = (a.double() - b.double()).abs()
            if n.startswith("params/"):
                past = float((d > DIST_TIGHT).double().mean())
                worst["params_max"] = max(worst["params_max"],
                                          float(d.max()))
                worst["params_past_tight"] = max(
                    worst["params_past_tight"], past)
                check(float(d.max()) <= DIST_ADAM_SLACK and past <= 1e-3,
                      f"dist: {n} off the one-process run by "
                      f"{float(d.max()):.3g} ({past:.2%} past "
                      f"{DIST_TIGHT})")
            elif n.startswith("opt/"):
                rel_m = float(d.max()) / max(float(b.abs().max()), 1e-30)
                worst["moments_over_max"] = max(worst["moments_over_max"],
                                                rel_m)
                check(rel_m <= 1e-5, f"dist: {n} off by {rel_m:.3g} of "
                      f"its max")
        res["dense"].update(one_process_losses=ref,
                            one_process_step_ms=ref_ms,
                            loss_rel_to_one_process=lrel, **worst)
        del one
        free(torch)
    dist.barrier()
    return res, dense


def dist_checkpoint(torch, dense, rank, tmp):
    """(c): ZeRO-3 blocks on (data 2) saved; restored on (pod 2) and in
    one process; a one-process save restored on (data 2)."""
    import torch.distributed as dist
    from repro_torch.distributed import Mesh, shard_tree
    from repro_torch.ft_runtime import restore, save
    from repro_torch.train import state_specs
    from repro_torch.utils import tree_flatten_with_names
    model = train_model(torch, "float32")
    data = Mesh((DIST_WORLD,), ("data",))
    pod = Mesh((DIST_WORLD,), ("pod",))
    specs_d = state_specs(model, data)
    zero = shard_tree(dense, specs_d, data)

    def equal(a, b, what):
        for (n, x), (_, y) in zip(tree_flatten_with_names(a),
                                  tree_flatten_with_names(b)):
            check(x.shape == y.shape and torch.equal(x, y),
                  f"dist: checkpoint {what}: {n} differs")

    t0 = time.perf_counter()
    save(tmp / "ckpt_data2", zero, step=DIST_STEPS, mesh=data,
         shardings=specs_d)
    save_ms = (time.perf_counter() - t0) * 1e3
    back, step, _ = restore(tmp / "ckpt_data2", dense, mesh=pod,
                            shardings=state_specs(model, pod))
    check(step == DIST_STEPS, f"dist: checkpoint step {step}")
    equal(back, dense, "data 2 -> pod 2")
    del back
    if rank == 0:
        one, _, _ = restore(tmp / "ckpt_data2", dense)
        equal(one, dense, "data 2 -> one process")
        save(tmp / "ckpt_one", one, step=DIST_STEPS)
        del one
    dist.barrier()
    again, _, _ = restore(tmp / "ckpt_one", zero, mesh=data,
                          shardings=specs_d)
    equal(again, zero, "one process -> data 2")
    leaves = sum(1 for _ in tree_flatten_with_names(dense))
    del again, zero
    free(torch)
    return {"leaves": leaves, "bit_equal": ["data 2 -> pod 2",
                                            "data 2 -> one process",
                                            "one process -> data 2"],
            "save_ms": save_ms}


def dist_moe(torch, np, seed, rank):
    """(b): one arctic MoE layer at published width, experts split over
    the two ranks, against the one-device layer on rank 0."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import Mesh
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.moe import (_moe_inference_ep, capacity,
                                        count_dropped, moe_apply)
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.expert_d_ff
    check((e, d, f, m.top_k) == (128, 7168, 4864, 2),
          f"{MOE_ARCH} is not at full width")
    half = e // DIST_WORLD

    def gen(s):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(s)
        return g

    def experts(lo, hi):
        """Experts lo..hi-1, each drawn from its own seed, bf16."""
        w = {"wg": torch.empty((hi - lo, d, f), dtype=torch.bfloat16,
                               device=DEVICE),
             "wu": torch.empty((hi - lo, d, f), dtype=torch.bfloat16,
                               device=DEVICE),
             "wd": torch.empty((hi - lo, f, d), dtype=torch.bfloat16,
                               device=DEVICE)}
        for i in range(hi - lo):
            g = gen(seed * 1000 + lo + i)
            for k, fan in (("wg", d), ("wu", d), ("wd", f)):
                w[k][i].copy_(torch.randn(w[k].shape[1:], generator=g,
                                          device=DEVICE) / math.sqrt(fan))
        w["router"] = torch.randn((d, e), generator=gen(seed), device=DEVICE
                                  ) / math.sqrt(d)
        return w

    x = torch.randn((1, MOE_TRAIN_TOKENS, d), generator=gen(seed + 1),
                    device=DEVICE).to(torch.bfloat16)
    xd = torch.randn((MOE_DECODE_TOKENS, 1, d), generator=gen(seed + 2),
                     device=DEVICE).to(torch.bfloat16)
    m_inf = dataclasses.replace(m, inference_ep=True)
    mdl = Mesh((DIST_WORLD,), ("model",))
    dat = Mesh((DIST_WORLD,), ("data",))
    w = experts(rank * half, (rank + 1) * half)
    res = {"expert_bytes_per_rank": tree_bytes(
        {k: v for k, v in w.items() if k != "router"})}

    def timed(fn):
        coll.reset_traffic()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, {
            k: dict(v) for k, v in coll.traffic.items()}

    timed(lambda: moe_apply(w, x, m, act=cfg.act, mesh=mdl))   # warm-up
    (y_ep, aux_ep), ep_ms, ep_moved = timed(
        lambda: moe_apply(w, x, m, act=cfg.act, mesh=mdl))
    rows = MOE_DECODE_TOKENS // DIST_WORLD
    xd_mine = xd[rank * rows:(rank + 1) * rows]
    timed(lambda: _moe_inference_ep(w, xd_mine, m_inf, mesh=dat,
                                    act=cfg.act))
    (yd_mine, auxd), inf_ms, inf_moved = timed(
        lambda: _moe_inference_ep(w, xd_mine, m_inf, mesh=dat, act=cfg.act))
    yd = torch.cat(coll.all_gather(yd_mine, dat.group("data")))
    peak = torch.cuda.max_memory_allocated()
    del w
    free(torch)
    dist.barrier()                     # rank 1's experts are gone
    if rank == 0:
        full = experts(0, e)
        (y1, aux1), one_ms, _ = timed(lambda: moe_apply(full, x, m,
                                                        act=cfg.act))
        (yd1, auxd1), one_d_ms, _ = timed(lambda: moe_apply(full, xd, m_inf,
                                                            act=cfg.act))

        def ulp_bound(got, ref, what):
            ref32, got32 = ref.float(), got.float()
            rms = ref32.square().mean().sqrt()
            bound = 2 ** -7 * ref32.abs() + 2 ** -8 * rms
            over = float(((got32 - ref32).abs() / bound).max())
            check(over <= 1.0, f"dist: {what} y off the one-device layer "
                  f"by {over:.3f} of the bound")
            return over

        x2, xd2 = x.reshape(-1, d), xd.reshape(-1, d)
        drops = {"ep": count_dropped(x2, full["router"], m,
                                     capacity(x2.shape[0], m)),
                 "inference_ep": count_dropped(
                     xd2, full["router"], m_inf, capacity(xd2.shape[0],
                                                          m_inf))}
        check(float(aux_ep) == float(aux1) and float(auxd) == float(auxd1),
              f"dist: aux {float(aux_ep)}/{float(auxd)} vs one device "
              f"{float(aux1)}/{float(auxd1)}")
        res.update(
            ep={"mesh": "model 2", "tokens": MOE_TRAIN_TOKENS, "ms": ep_ms,
                "one_device_ms": one_ms, "collectives": ep_moved,
                "y_over_ulp_bound": ulp_bound(y_ep, y1, "_moe_apply_ep"),
                "aux": float(aux_ep), "dropped": drops["ep"],
                "capacity": capacity(x2.shape[0], m)},
            inference_ep={"mesh": "data 2", "tokens": MOE_DECODE_TOKENS,
                          "ms": inf_ms, "one_device_ms": one_d_ms,
                          "collectives": inf_moved,
                          "y_over_ulp_bound": ulp_bound(
                              yd.reshape(yd1.shape), yd1,
                              "_moe_inference_ep"),
                          "aux": float(auxd), "dropped": drops[
                              "inference_ep"],
                          "capacity": capacity(xd2.shape[0], m_inf)},
            one_device_peak_bytes=torch.cuda.max_memory_allocated())
        del full
        free(torch)
    res["rank_peak_bytes"] = peak
    dist.barrier()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma list of phases to run after device and "
                         "build (dist, vlm, train, dryrun, b2_wide, "
                         "examples, b1_chunk; b2_narrow, b1_decode and "
                         "b1_long run only so), "
                         "for bring-up; prints no result line")
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank of phase dist
    ap.add_argument("--dist-dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    if args.dist_rank is not None:
        return dist_rank(args)
    card = phase_device(torch)
    phase_build()
    if args.only:
        only = {"dist": lambda torch, np, seed: phase_dist(torch, np, seed,
                                                           card),
                "vlm": phase_vlm, "train": phase_train,
                "dryrun": phase_dryrun, "b2_wide": phase_b2_wide,
                "b2_narrow": phase_b2_narrow, "b1_chunk": phase_b1_chunk,
                "b1_decode": phase_b1_decode, "b1_long": phase_b1_long,
                "examples": lambda torch, np, seed: phase_examples(torch)}
        for name in args.only.split(","):
            only[name](torch, np, args.seed)
        return 0
    # first, while this process holds next to nothing on the card: rank 0
    # of phase (b) holds 26.8 GB of experts
    phase_dist(torch, np, args.seed, card)
    max_err = phase_kernel(torch)
    serve = phase_serve(torch, np, args.seed)
    entry = phase_numbers(torch, serve, max_err)
    max_err_b2 = phase_kernel_b2(torch)
    ring = phase_ring_serve(torch, np, serve, args.seed)
    entry_b2 = phase_numbers_b2(torch, np, ring, max_err_b2)
    phase_abft_linear(torch)
    phase_ff_abft_serve(torch, np, serve)
    entry_b2["regimes"] = phase_encoder(torch, np, args.seed)
    entry_b2["regimes"].update(phase_encdec(torch, np, args.seed))
    entry_b2["regimes"].update(phase_decoupled(torch))
    b1_regimes, b2_regimes = phase_kernel_regimes(torch)
    entry["chunk"] = phase_b1_chunk(torch, np, args.seed)
    entry_b2["regimes"].update(b2_regimes)
    entry_b2["regimes"].update(phase_b2_wide(torch, np, args.seed))
    # the VLM's B2 timings before phase 20's profiled windows: after them
    # its timed windows lost their records (seen on the card)
    entry_b2["regimes"].update(phase_vlm(torch, np, args.seed))
    # the moe family: its ring run's B2 timings first, then its paged runs'
    # profiled windows; every per-kernel timing comes before the whole-run
    # profiles: after one, the profiler drops kernel records from later
    # windows (seen on the card)
    _, b1_runs, b2_ring, b1_long = phase_moe(torch, np, args.seed)
    entry_b2["regimes"].update(b2_ring)
    for name, numbers in b1_regimes.items():
        arch = name.split(" ")[0]
        numbers.update(launches=b1_runs[arch],
                       launches_per=f"bf16 paged run of {arch}, "
                                    f"{MOE_LAYERS} layers")
    entry["regimes"] = b1_regimes
    entry["long"] = b1_long
    phase_train(torch, np, args.seed)
    phase_dryrun(torch, np, args.seed)
    phase_examples(torch)
    phase_profile(torch, np, serve, args.seed)
    phase_ring_profile(torch, np, ring)
    # after the whole-run profiles: its own profiled prefills count ~120k
    # kernels each
    phase_ssm(torch, np, args.seed)
    spec = phase_spec_serve(torch, np, args.seed)
    entry["spec_launches"] = spec["launches"]
    phase_draft_serve(torch, np, args.seed)
    phase_gather_serve(torch, np, serve)
    emit({"kernels": [entry, entry_b2]})   # the line before the last
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
