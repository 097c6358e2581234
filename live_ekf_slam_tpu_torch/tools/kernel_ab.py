"""A/B timing of the rollout kernels against another source tree's, on the card.

    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        [--filters ekf_slam,iekf_slam] [--worlds 4096] [--steps 1000] \\
        [--reps 5] [--clocks]

DIR is another tree's ``csrc`` directory with the same C interface, for a
commit: ``git archive COMMIT live_ekf_slam_tpu_torch/csrc | tar -x -C OUT``
and DIR = OUT/live_ekf_slam_tpu_torch/csrc. Both trees' kernels are built
(one nvcc per source, as ``ops/_build`` builds) and launched through this
tree's wrappers on the bench's inputs (shared protocol, seed 0, N = 20).
For each filter one JSON line: the median CUDA-event milliseconds of
``--reps`` rollouts in four turns, other, this, this, other (two versions
are compared only within one call, on one card), whether the two trees'
results are equal bit for bit, and the card's name and power limit. With
``--clocks`` also each tree's clock64() cycles by phase of the tick, from
its ``-DLES_PHASE_CLOCKS`` build, where its source has the counters.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import card
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import fused_rollout, mc_inputs
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

FILTERS = ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls, after
    one warm-up call."""
    fn()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return float(np.median(ms))


def clocks(cfg, lms, cmds) -> dict | None:
    """Cycles by phase of the tick from the current tree's clocks build, or
    None where its source has no counters."""
    try:
        if cfg.filter in ("ekf_slam", "iekf_slam"):
            kind = "iekf" if cfg.filter == "iekf_slam" else "ekf"
            return fr.phase_clocks(cfg, lms, cmds, 0, filter_kind=kind)[0]
        return fu.phase_clocks(cfg, lms, cmds, 0, slam=cfg.filter == "ukf_slam")[0]
    except AttributeError:  # the library has no such entry point
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_ab", description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--filters", default="ekf_slam,iekf_slam")
    ap.add_argument("--worlds", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    other = args.against.resolve()
    if not (other / "fused_ekf_rollout.cu").is_file():
        raise SystemExit(f"kernel_ab: {other} holds no fused_ekf_rollout.cu")
    filters = args.filters.split(",")
    if not set(filters) <= set(FILTERS):
        raise SystemExit(f"kernel_ab: filters must be among {FILTERS}")
    pin_fp32()
    dev = torch.device("cuda")
    builds = [((), _build.CSRC), ((), other)]
    if args.clocks:
        builds += [(_build.PHASE_CLOCKS, _build.CSRC), (_build.PHASE_CLOCKS, other)]
    with ThreadPoolExecutor(len(builds)) as pool:  # every nvcc at once
        list(pool.map(lambda b: _build.build(*b), builds))
    base = Config(num_iterations=args.steps)
    lms, cmds = mc_inputs(base, args.worlds, 0, dev, shared=True, relabel=True)
    srcs = {"other": other, "this": _build.CSRC}
    for filt in filters:
        cfg = base.replace(filter=filt)
        turns, outs, cyc = [], {}, {}
        for tree in ("other", "this", "this", "other"):
            with _build.sources(srcs[tree]):
                turns.append((tree, median_ms(
                    lambda: fused_rollout(cfg, lms, cmds, 1), args.reps)))
                if tree not in outs:
                    outs[tree] = fused_rollout(cfg, lms, cmds, 0)
                    if args.clocks:
                        cyc[tree] = clocks(cfg, lms, cmds)
        torch.cuda.synchronize()
        line = {
            "filter": filt, "worlds": args.worlds, "steps": args.steps,
            "reps": args.reps, "turns": turns,
            "other_ms": float(np.median([t for k, t in turns if k == "other"])),
            "this_ms": float(np.median([t for k, t in turns if k == "this"])),
            "results_bitwise_equal": {k: bool(torch.equal(outs["other"][k], outs["this"][k]))
                                      for k in outs["this"]},
            "against": str(other), "card": card(),
        }
        if args.clocks:
            line["cycles"] = cyc
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
