"""Command line of the port: the ``monte_carlo`` and ``igvc1`` presets.

    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter ukf_slam \\
        --batch 256 --steps 1000 --seed 0
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter naive \\
        --impl per_tick --landmark-map demo
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter pose_graph \\
        --secondary ekf_slam --batch 16 --steps 200
    python -m live_ekf_slam_tpu_torch.cli igvc1 [--filter ukf_loc] \\
        [--steps 200] [--params params.yaml] [--device cpu]

Counterpart of ``live_ekf_slam_tpu/cli.py``'s monte_carlo and igvc1 presets.
``igvc1`` is the closed loop (``eval/closed_loop.run_closed_loop``): the igvc
barrel course, simulator and online filter, a local A* replan every 5 ticks
and pure pursuit, in one world, as the JAX CLI runs it; it prints that CLI's
line (average position error, final true pose). ``--params`` reads a
reference-format params.yaml, ``--occ-map-img`` another map image (an 8-bit
RGB or RGBA PNG). The monte_carlo preset runs the five online filters and
the pose graph and prints each result's mean and std as that CLI does.
``--impl fused`` (the default, but for pose_graph) runs the four filters
with a fused rollout kernel; ``--impl per_tick`` (pose_graph's default)
steps every world once a tick through the simulator and the filter (the JAX
CLI's default path), naive included. ``--filter pose_graph`` collects the
pose streams, as the JAX CLI does, and reports the secondary filter
(``--secondary``, the config's ``pose_graph.filter_to_compare``) and the
bulk solve's result and seeds.
``--landmark-map`` picks a fixed map (demo, grid, igvc1) or random maps.
Both presets run on the card; ``--device cpu`` runs the plain version on
the CPU instead. The other presets (``sim_base``, ``filter_demo_live``,
``filter_demo_results_only``, ``bar_graphs``) need the viewers and the
recorder, which are not ported yet (ROADMAP.md, M12).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from live_ekf_slam_tpu_torch.config import Config, load_config, preset
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


def run_igvc(cfg, seed: int = 0, device="cuda", batch: int = 1):
    """igvc1: the closed-loop local-planner run (JAX ``run_igvc``)."""
    from live_ekf_slam_tpu_torch.eval.closed_loop import run_closed_loop

    print(f"device: {device}", file=sys.stderr, flush=True)
    metrics, _, _ = run_closed_loop(cfg, batch, seed, device=device)
    err = metrics["err_" + cfg.filter]
    print(
        f"igvc closed loop: avg position error {np.mean(err):.4f} m, "
        f"final true pose {metrics['final_true_pose'][0]}"
    )
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch")
    p.add_argument("preset", choices=["monte_carlo", "igvc1"])
    p.add_argument("--params", help="igvc1: a reference-format params.yaml")
    p.add_argument("--occ-map-img", dest="occ_map_img",
                   help="igvc1: the map image (default igvc1.png)")
    p.add_argument("--filter", choices=ONLINE_FILTERS + ("pose_graph",),
                   help="default ekf_slam (igvc1: the params' filter)")
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
    if args.preset == "igvc1":
        cfg = preset("igvc1", load_config(args.params) if args.params else Config())
        over = {k: v for k, v in (("filter", args.filter),
                                  ("occ_map_img", args.occ_map_img),
                                  ("num_iterations", args.steps)) if v}
        run_igvc(cfg.replace(**over) if over else cfg, args.seed, args.device)
        return 0
    cfg = Config().replace(filter=args.filter or "ekf_slam")
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
