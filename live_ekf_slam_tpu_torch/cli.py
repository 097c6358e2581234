"""Command line of the port: the ``monte_carlo`` preset.

    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter ukf_slam \\
        --batch 256 --steps 1000 --seed 0
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter naive \\
        --impl per_tick --landmark-map demo
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter pose_graph \\
        --secondary ekf_slam --batch 16 --steps 200

Counterpart of ``live_ekf_slam_tpu/cli.py``'s monte_carlo preset for the five
online filters and the pose graph: prints each result's mean and std as that
CLI does. ``--impl fused`` (the default, but for pose_graph) runs the four filters
with a fused rollout kernel; ``--impl per_tick`` (pose_graph's default)
steps every world once a tick through the simulator and the filter (the JAX
CLI's default path), naive included. ``--filter pose_graph`` collects the
pose streams, as the JAX CLI does, and reports the secondary filter
(``--secondary``, the config's ``pose_graph.filter_to_compare``) and the
bulk solve's result and seeds.
``--landmark-map`` picks a fixed map (demo, grid, igvc1) or random maps. It
runs on the card; ``--device cpu`` runs the plain version on the CPU
instead. The other presets (viewers, closed loop, bar graphs) are not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import IMPLS, ONLINE_FILTERS, run_monte_carlo


def run_monte_carlo_cli(cfg, args):
    print(f"device: {args.device}", file=sys.stderr, flush=True)
    impl = args.impl or ("per_tick" if cfg.filter == "pose_graph" else "fused")
    res, _, _ = run_monte_carlo(
        cfg, batch=args.batch, seed=args.seed, impl=impl, device=args.device,
        collect="poses" if cfg.filter == "pose_graph" else "sums",
    )
    out = {k.replace("err_", ""): v for k, v in res.items()}
    for k, v in out.items():
        print(f"{k}: mean {np.mean(v):.4f} std {np.std(v):.4f}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch")
    p.add_argument("preset", choices=["monte_carlo"])
    p.add_argument("--filter", default="ekf_slam",
                   choices=ONLINE_FILTERS + ("pose_graph",))
    p.add_argument("--secondary", choices=ONLINE_FILTERS,
                   help="pose_graph only: the filter that seeds the graph "
                        "(default: the config's, naive)")
    p.add_argument("--impl", choices=IMPLS,
                   help="fused rollout kernel (default; pose_graph: per_tick) "
                        "or the per-tick path")
    p.add_argument("--landmark-map", dest="landmark_map",
                   choices=["random", "rand", "demo", "grid", "igvc1"])
    p.add_argument("--steps", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    cfg = Config().replace(filter=args.filter)
    if args.steps:
        cfg = cfg.replace(num_iterations=args.steps)
    if args.landmark_map:
        cfg = cfg.replace(landmark_map=args.landmark_map)
    if args.secondary:
        cfg = cfg.replace(pose_graph=dataclasses.replace(
            cfg.pose_graph, filter_to_compare=args.secondary))
    run_monte_carlo_cli(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
