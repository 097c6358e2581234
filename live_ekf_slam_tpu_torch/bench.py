"""Benchmark of the port: fused sim + filter steps/s/world on one GPU.

    python -m live_ekf_slam_tpu_torch.bench                # EKF-SLAM kernel
    python -m live_ekf_slam_tpu_torch.bench --filter ukf_slam
    python -m live_ekf_slam_tpu_torch.bench --impl plain --reps 1

The JAX ``bench.py`` path with ``BENCH_IMPL=pallas`` and ``BENCH_FILTER`` one
of ekf_slam, iekf_slam, ukf_slam, ukf_loc (``--filter``), on the card: 4096
worlds, T = 1000, N = 20; by default the shared protocol (16 random maps x
256 noise realisations, ids relabelled by tour, for every filter: the JAX
bench's 128-world UKF block was a TPU memory limit), ``--protocol perworld``
for a map per world. Inputs are
made once; each timed rep is one rollout between two
``torch.cuda.synchronize()`` calls, and the value is the median rep.
``--impl plain`` times the plain torch version on the card instead of the
kernel. It needs a CUDA device and never falls back to the CPU; it writes
nothing to disk. Prints one JSON line: metric, value, unit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import FILTERS, fused_rollout, mc_inputs
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

WARMUP_TICKS = 10


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_rollouts(cfg, lms, cmds, impl: str, reps: int, seed0: int = 1):
    """Time ``reps`` rollouts of ``cfg.filter`` (``impl`` "cuda" for the
    kernel, "plain" for the plain version) with seeds seed0, seed0+1, ...,
    after a short warm-up (CUDA context, kernel build). Each rep runs between
    two synchronizes. Returns (host-clock seconds, CUDA-event milliseconds,
    last result)."""
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    plain = impl == "plain"
    fused_rollout(cfg, lms, cmds[:, :WARMUP_TICKS].contiguous(), 0,
                  plain=plain)
    torch.cuda.synchronize()
    host_s, dev_ms, out = [], [], None
    for rep in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = fused_rollout(cfg, lms, cmds, seed0 + rep, plain=plain)
        e1.record()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        dev_ms.append(e0.elapsed_time(e1))
    return host_s, dev_ms, out


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch.bench")
    p.add_argument("--filter", choices=FILTERS, default="ekf_slam")
    p.add_argument("--impl", choices=["cuda", "plain"], default="cuda")
    p.add_argument("--protocol", choices=["shared", "perworld"],
                   default="shared")
    p.add_argument("--worlds", type=int, default=4096)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device; none is available")
    pin_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f}s")

    cfg = Config(num_iterations=args.steps).replace(filter=args.filter)
    t0 = time.perf_counter()
    lms, cmds = mc_inputs(cfg, args.worlds, 0, dev,
                          shared=args.protocol == "shared", relabel=True)
    torch.cuda.synchronize()
    log(f"worlds+trajectories ready {time.perf_counter() - t0:.2f}s")

    times, _, out = time_rollouts(cfg, lms, cmds, args.impl, args.reps)
    elapsed = float(np.median(times))
    log(f"timed: {elapsed:.6f}s/rep (median of {args.reps}; per-rep "
        f"{' '.join(f'{t:.6f}' for t in times)})")
    steps = args.steps / elapsed
    avg_err = float(np.nanmean(out["err_sum"].cpu().numpy() / args.steps))
    if not np.isfinite(avg_err):
        raise RuntimeError("benchmark rollout produced non-finite errors")
    print(json.dumps({
        "metric": (
            f"fused sim+{args.filter} steps/sec/world at {args.worlds} worlds "
            f"(T={args.steps}, {args.impl} {args.protocol}; mean "
            f"avg-pos-err {avg_err:.4f} m; {card()})"
        ),
        "value": steps,
        "unit": "steps/s/world",
    }))


if __name__ == "__main__":
    main()
