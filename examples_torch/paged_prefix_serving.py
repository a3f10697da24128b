"""Paged KV-cache serving on the port: one shared system prompt, prefilled
once, plus a resident-state SEU healed by block re-prefill, on the fused
backend (kernel B1 on the card, its plain version on the CPU).

Four requests share a 32-token system prompt. The first admission
prefills it and registers its blocks in the prefix cache; every later
admission hash-chain-matches those blocks and only computes its own
suffix. Mid-run a bit flip strikes a *shared* KV block — the block
checksums catch it at the next read, the engine re-prefills just that
block (healing every request mapping it), retries the step, and finishes
token-identical to a clean run.

  PYTHONPATH=src python examples_torch/paged_prefix_serving.py \\
      [--arch gpt2-smoke] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.efta_paged import efta_paged_attention
from repro_torch.models import build_model
from repro_torch.serve import PagedServeEngine


def main(argv=None, *, params=None) -> dict:
    """``params``: the model's weights (drawn from seed 0 by default).
    Returns the printed numbers, both runs' tokens and the kernel's
    launches (``efta_paged_attention.launches``, the card's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt2-smoke")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    model = build_model(cfg, device=args.device)
    if params is None:
        params = model.init(torch.Generator(model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
    prompts = [np.concatenate([system_prompt,
                               rng.integers(0, cfg.vocab_size, (n,))
                               .astype(np.int32)]) for n in (4, 6, 5, 7)]
    print(f"serving {cfg.name} from a paged KV pool "
          f"(block_size=16, shared system prompt = 32 tokens)")
    launches0 = efta_paged_attention.launches

    def serve(inject_kv_fault: bool):
        eng = PagedServeEngine(model, params, n_slots=2, cache_len=64,
                               block_size=16, num_blocks=24, kernel="fused")
        rids = []
        # staggered arrival: the first request seeds the prefix cache
        rids.append(eng.submit(prompts[0], max_new_tokens=6))
        eng.step()
        for p in prompts[1:]:
            rids.append(eng.submit(p, max_new_tokens=6))
        eng.step()
        if inject_kv_fault:
            # SEU in memory: flip an exponent bit of a *shared* prefix
            # block
            shared_block = next(r for r in eng.scheduler.active_rows()
                                if not r.is_done()).block_ids[0]
            eng.inject_kv_fault(layer=1, block=shared_block, head=0, row=2,
                                col=3, bit=28, into="k")
        while eng.scheduler.has_work:
            eng.step()
        outs = {r.rid: np.asarray(r.generated)
                for r in eng.scheduler.finished}
        return eng, [outs[r] for r in rids]

    _, clean = serve(inject_kv_fault=False)
    fault_eng, healed = serve(inject_kv_fault=True)

    xs = fault_eng.pool.prefix.stats
    ps = fault_eng.paged_stats
    launches = efta_paged_attention.launches - launches0
    print(f"prefix cache: {xs.hit_tokens}/{xs.lookup_tokens} prompt tokens "
          f"served from resident blocks ({len(prompts) - 1} of "
          f"{len(prompts)} requests skipped the system-prompt prefill)")
    print(f"resident KV SEU: detected={ps.kv_detected_blocks} block(s) at "
          f"read time, repaired={ps.kv_repaired_blocks} by block "
          f"re-prefill")
    print(f"kernel B1 launches: {launches}")
    assert xs.hit_tokens >= 32 * (len(prompts) - 1)
    assert ps.kv_detected_blocks >= 1 and ps.kv_repaired_blocks >= 1
    for a, b in zip(clean, healed):
        assert np.array_equal(a, b)
    print("OK: every request's tokens are identical to the clean run — the "
          "corruption never reached an output.")
    return {"hit_tokens": xs.hit_tokens, "lookup_tokens": xs.lookup_tokens,
            "kv_detected_blocks": ps.kv_detected_blocks,
            "kv_repaired_blocks": ps.kv_repaired_blocks,
            "clean": clean, "healed": healed, "b1_launches": launches}


if __name__ == "__main__":
    main()
