"""Randomized SEU injection campaigns over EFTA attention (paper §5.3) and
over the paged serve engine's resident KV.

``run_campaign`` injects N random single-bit faults across the paper's
attention sites and classifies every trial against the fault-free oracle as

  * ``harmless``  — output unchanged within tolerance (low bit / masked slot,
                    or the site cancels analytically, e.g. ROWMAX Case 1)
  * ``corrected`` — detected and repaired (output back within tolerance)
  * ``detected``  — detected but visibly corrupted (detect-only modes)
  * ``silent``    — corrupted with no detection (the failure mode EFTA
                    exists to eliminate)

``run_kv_campaign`` flips bits of live paged-KV blocks between engine steps
and checks that the engine detects, repairs and finishes with the clean
run's tokens. Inputs and weights come from numpy and ``torch.Generator``
streams (the JAX package draws from ``jax.random``), so tallies compare
with the reference's by property, not by value. Both run on the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.efta import (EFTAConfig, efta_attention,
                                   reference_attention)
from repro_torch.core.fault import Site, random_fault

DEFAULT_SITES = (Site.GEMM1, Site.EXP, Site.ROWMAX, Site.ROWSUM, Site.GEMM2)


@dataclasses.dataclass
class SiteTally:
    trials: int = 0
    harmless: int = 0
    corrected: int = 0
    detected: int = 0
    silent: int = 0
    worst_residual: float = 0.0


@dataclasses.dataclass
class CampaignResult:
    mode: str
    n_trials: int
    per_site: Dict[Site, SiteTally]
    worst_residual: float = 0.0

    @property
    def totals(self) -> SiteTally:
        t = SiteTally()
        for s in self.per_site.values():
            t.trials += s.trials
            t.harmless += s.harmless
            t.corrected += s.corrected
            t.detected += s.detected
            t.silent += s.silent
            t.worst_residual = max(t.worst_residual, s.worst_residual)
        return t

    def format_table(self) -> str:
        rows = [f"mode={self.mode}  trials={self.n_trials}  "
                f"worst_residual={self.worst_residual:.2e}"]
        rows.append(f"  {'site':8s} {'trials':>6s} {'harmless':>8s} "
                    f"{'corrected':>9s} {'detected':>8s} {'SILENT':>7s}")
        for site, t in sorted(self.per_site.items(), key=lambda kv: kv[0]):
            rows.append(f"  {site.name:8s} {t.trials:6d} {t.harmless:8d} "
                        f"{t.corrected:9d} {t.detected:8d} {t.silent:7d}")
        return "\n".join(rows)


@dataclasses.dataclass
class KVCampaignResult:
    """Outcome of a resident-KV SEU campaign (Site.KV) over the paged serve
    engine: every trial flips one bit of a live KV-cache block *between*
    steps, an upset in stored state that EFTA's in-compute checks cannot
    see."""

    n_trials: int = 0
    detected: int = 0            # caught by block checksums at read time
    repaired_blocks: int = 0     # blocks re-prefilled by the engine
    undetected: int = 0          # below-threshold flips (denormal/low-impact)
    mismatched_requests: int = 0  # final tokens differing from the clean run
    telemetry_kv_detected: int = 0  # per-request site-6 counts

    def format_table(self) -> str:
        return (f"KV campaign: trials={self.n_trials} "
                f"detected={self.detected} repaired={self.repaired_blocks} "
                f"undetected={self.undetected} "
                f"mismatched_requests={self.mismatched_requests}")


def run_kv_campaign(
    *,
    n_trials: int = 12,
    seed: int = 0,
    arch: str = "gpt2-smoke",
    n_slots: int = 2,
    cache_len: int = 64,
    block_size: int = 16,
    n_requests: int = 3,
    max_prompt: int = 24,
    gen: int = 8,
    bit_range: Tuple[int, int] = (24, 30),
    kernel: str = "gather",
    chunk_size: Optional[int] = None,
    chunk_budget: Optional[int] = None,
    device="cuda",
) -> KVCampaignResult:
    """Seeded SEU campaign against *resident* KV state.

    Drives one clean and one faulted :class:`repro_torch.serve.
    PagedServeEngine` over the same request stream; each trial flips a
    random high bit of a random filled row of a random live block. The
    engine must detect the corruption at the next read, re-prefill only the
    poisoned block, retry the step, and finish with tokens identical to the
    clean run. ``kernel`` selects the backend under test: ``"gather"``
    verifies outside attention, ``"fused"`` in the paged kernel's loop (and
    the append-time tail check). ``chunk_size``/``chunk_budget`` configure
    the unified chunked step."""
    # local imports: repro_torch.serve imports repro_torch.core
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.paged import PagedServeEngine

    cfg = get_config(arch)
    model = build_model(cfg, device=device)
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    params = model.init(g)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size,
                            (int(rng.integers(2, max_prompt + 1)),)
                            ).astype(np.int32) for _ in range(n_requests)]

    def fresh():
        eng = PagedServeEngine(model, params, n_slots=n_slots,
                               cache_len=cache_len, block_size=block_size,
                               kernel=kernel, chunk_size=chunk_size,
                               chunk_budget=chunk_budget)
        for p in prompts:
            eng.submit(p, max_new_tokens=gen)
        return eng

    clean = fresh().run()

    eng = fresh()
    res = KVCampaignResult()
    hkv = cfg.attn.num_kv_heads
    while eng.scheduler.has_work:
        active = [r for r in eng.scheduler.active_rows() if not r.is_done()]
        candidates = [r for r in active if eng._pos[r.slot] > 0]
        if candidates and res.n_trials < n_trials:
            req = candidates[int(rng.integers(0, len(candidates)))]
            resident = int(eng._pos[req.slot])
            j = int(rng.integers(0, -(-resident // block_size)))
            filled = min(block_size, resident - j * block_size)
            before = eng.paged_stats.kv_detected_blocks
            eng.inject_kv_fault(
                layer=int(rng.integers(0, cfg.num_layers)),
                block=req.block_ids[j],
                head=int(rng.integers(0, hkv)),
                row=int(rng.integers(0, filled)),
                col=int(rng.integers(0, cfg.attn.head_dim)),
                bit=int(rng.integers(bit_range[0], bit_range[1] + 1)),
                into="k" if rng.integers(0, 2) else "v")
            res.n_trials += 1
            eng.step()
            if eng.paged_stats.kv_detected_blocks > before:
                res.detected += 1
            else:
                res.undetected += 1
        else:
            eng.step()
    faulty = {r.rid: np.asarray(r.generated, np.int32)
              for r in eng.scheduler.finished}
    res.repaired_blocks = eng.paged_stats.kv_repaired_blocks
    res.mismatched_requests = sum(
        0 if np.array_equal(clean[rid], faulty[rid]) else 1 for rid in clean)
    res.telemetry_kv_detected = sum(
        st.detected[5] for st in eng.telemetry.requests.values())
    return res


def run_campaign(
    *,
    mode: str = "correct",
    n_trials: int = 50,
    seed: int = 0,
    shape_bhsd: Tuple[int, int, int, int] = (1, 4, 128, 32),
    block_kv: int = 32,
    stride: int = 8,
    sites: Sequence[Site] = DEFAULT_SITES,
    bit_range: Tuple[int, int] = (16, 30),
    tol: float = 1e-3,
    cfg: Optional[EFTAConfig] = None,
    device="cuda",
    qkv=None,
) -> CampaignResult:
    """Run a seeded SEU campaign against a fixed random attention problem
    (q, k, v standard normal from a ``torch.Generator`` seeded with
    ``seed``, or the (B, H, S, D) arrays ``qkv``, whose shape then takes
    the place of ``shape_bhsd``), through plain-PyTorch EFTA. The faults
    are drawn from numpy's generator seeded with ``seed + 1``, as the JAX
    package draws them."""
    from repro_torch.models.api import resolve_device
    dev = resolve_device(device)
    if qkv is None:
        g = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn(shape_bhsd, generator=g).to(dev)
                   for _ in range(3))
    else:
        q, k, v = (torch.tensor(np.asarray(a)).to(dev) for a in qkv)
    b, h, s, d = q.shape
    ref = reference_attention(q, k, v).float()
    cfg = cfg or EFTAConfig(mode=mode, stride=stride, block_kv=block_kv)
    rng = np.random.default_rng(seed + 1)

    result = CampaignResult(mode=mode, n_trials=n_trials,
                            per_site={site: SiteTally() for site in sites})
    n_blocks = max(s // block_kv, 1)
    for _ in range(n_trials):
        spec = random_fault(rng, sites=sites, shape_bhsc=(b, h, s, s),
                            n_blocks=n_blocks, max_bit=bit_range[1])
        # random_fault samples bits uniformly in [0, max_bit]; re-draw the
        # bit into the campaign's range (high bits = visible corruptions)
        bit = int(rng.integers(bit_range[0], bit_range[1] + 1))
        spec = spec._replace(bit=np.asarray([bit], np.int32))
        site = Site(int(spec.site[0]))
        out, rep = efta_attention(q, k, v, cfg=cfg, fault=spec)
        err = float((out.float() - ref).abs().max())
        det = int(rep.detected.sum()) > 0
        t = result.per_site[site]
        t.trials += 1
        t.worst_residual = max(t.worst_residual, err)
        result.worst_residual = max(result.worst_residual, err)
        if err < tol:
            if det:
                t.corrected += 1
            else:
                t.harmless += 1
        elif det:
            t.detected += 1
        else:
            t.silent += 1
    return result
