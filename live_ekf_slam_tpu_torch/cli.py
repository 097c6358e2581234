"""Command line of the port: the ``monte_carlo`` preset.

    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter ukf_slam \\
        --batch 256 --steps 1000 --seed 0

Counterpart of ``live_ekf_slam_tpu/cli.py``'s monte_carlo preset for the
four filters with a fused rollout (ekf_slam, iekf_slam, ukf_slam, ukf_loc):
prints each result's mean and std as that CLI does. It runs on the card;
``--device cpu`` runs the plain version on the CPU instead. The other presets
(viewers, closed loop, bar graphs) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import FILTERS, run_monte_carlo


def run_monte_carlo_cli(cfg, args):
    print(f"device: {args.device}", file=sys.stderr, flush=True)
    res, _, _ = run_monte_carlo(
        cfg, batch=args.batch, seed=args.seed, device=args.device
    )
    out = {k.replace("err_", ""): v for k, v in res.items()}
    for k, v in out.items():
        print(f"{k}: mean {np.mean(v):.4f} std {np.std(v):.4f}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch")
    p.add_argument("preset", choices=["monte_carlo"])
    p.add_argument("--filter", default="ekf_slam", choices=FILTERS)
    p.add_argument("--steps", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    cfg = Config().replace(filter=args.filter)
    if args.steps:
        cfg = cfg.replace(num_iterations=args.steps)
    run_monte_carlo_cli(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
