"""Model-level error-injection campaign (paper §5.3 style) on the port:
random SEUs are injected into attention during inference; we measure
silent-corruption rates with EFTA off/detect/correct.

The campaign machinery lives in ``repro_torch.core.campaign``. Its
attention problem is one (B, H, S, D) q/k/v, drawn from the seed, not a
model, so there is no ``--arch``.

  PYTHONPATH=src python examples_torch/fault_injection_campaign.py \\
      [n_trials] [--device cpu]
"""
import argparse

from repro_torch.core import run_campaign
from repro_torch.models import resolve_device


def main(argv=None, *, params=None) -> dict:
    """``params``: the campaign's (q, k, v) arrays (drawn from the seed by
    default). Returns each mode's :class:`~repro_torch.core.
    CampaignResult`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_trials", nargs="?", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for mode in ("off", "detect", "correct"):
        out[mode] = run_campaign(mode=mode, n_trials=args.n_trials, seed=1,
                                 device=dev, qkv=params)
        print(out[mode].format_table())
        print()
    print("EFTA turns silent corruptions into detected (and corrected) "
          "events.")
    return out


if __name__ == "__main__":
    main()
