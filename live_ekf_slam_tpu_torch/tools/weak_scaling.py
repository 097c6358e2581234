"""Weak scaling of the per-tick EKF-SLAM Monte-Carlo path over a world mesh.

Counterpart of ``scripts/weak_scaling.py``. Worlds per device stay constant
while the device count grows. Each shard makes its own worlds on its device
(``eval/runner.mc_inputs`` and the Philox stream, both from
``parallel.mesh.shard_seed(seed, d)``), the per-tick step
(``eval/runner.make_step``) runs through ``parallel.mesh.sharded_step`` a
tick at a time, and the mean error over every world is the run's one
reduction across devices (``mean_over_worlds``). Ideal weak scaling is flat
wall time and aggregate ticks/s linear in the device count.

Two modes:

* virtual (default): n shards on one device (``parallel.mesh.virtual_mesh``),
  each on a CUDA stream of its own. The shards share one card and one host
  thread, and the per-tick step is bound by its launches, so wall time grows
  with the total work: the rows show that the sharded path runs and that
  the shards' work is independent, not a scaling curve (the JAX script's
  virtual CPU mesh shares its host's cores the same way).
* ``--real``: the first n of ``torch.cuda.device_count()`` cards, each driven
  by a thread of its own.

    python -m live_ekf_slam_tpu_torch.tools.weak_scaling [--devices 1 2 4 8]
        [--worlds-per-device 64] [--t 100] [--real] [--device cpu] [--out FILE]

Prints one JSON row a device count (devices, worlds, wall seconds,
steps/s/world, aggregate ticks/s, mean error, the mode and the device it ran
on), then a markdown table. ``--device cpu`` runs the plain per-tick path on
a CPU mesh: a check of the path, not a device measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import (
    init_carry,
    make_step,
    mc_inputs,
    resolve_device,
)
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.parallel.mesh import (
    Shards,
    make_mesh,
    map_shards,
    mean_over_worlds,
    shard_seed,
    sharded_step,
    virtual_mesh,
)

WARMUP_TICKS = 2  # ticks run before the timed run, from the same start


def _sync(mesh) -> float:
    for dev in mesh.distinct_devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return time.perf_counter()


def run_row(n: int, worlds_per_device: int, t: int, *, real: bool = False,
            device="cuda", seed: int = 0) -> dict:
    """One row: n shards of ``worlds_per_device`` worlds, T = ``t`` ticks of
    the per-tick EKF-SLAM step, timed after ``WARMUP_TICKS`` ticks of
    warm-up, from the inputs' end to the reduced mean error."""
    pin_fp32()
    device = resolve_device(device)
    if real:
        mesh = make_mesh(n)
    else:
        mesh = virtual_mesh(n, device)
    cfg = Config(num_iterations=t, filter="ekf_slam")
    n_lm = cfg.map.num_landmarks

    def inputs(d):
        s = shard_seed(seed, d)
        lms, cmds = mc_inputs(cfg, worlds_per_device, s, mesh.devices[d])
        noise = philox_noise(s, t, n_lm, worlds_per_device, mesh.devices[d])
        return lms, cmds, noise

    made = map_shards(mesh, inputs)
    step = sharded_step(make_step(cfg, "sums"), mesh)

    def rollout(ticks: int):
        carry = map_shards(mesh, lambda d: init_carry(cfg, made[d][0], n_lm))
        for k in range(ticks):
            cmd = Shards([p[1][:, k] for p in made.parts], made.placement)
            u = Shards([p[2][k].transpose(0, 1) for p in made.parts],
                       made.placement)
            carry, _ = step(carry, cmd, u, k)
        return carry

    rollout(WARMUP_TICKS)
    t0 = _sync(mesh)
    final = rollout(t)
    err = Shards([c.err_sum_primary for c in final.parts], final.placement)
    mean_err = float(mean_over_worlds(err, mesh)) / t
    dt = _sync(mesh) - t0
    b = n * worlds_per_device
    return {
        "devices": n,
        "mode": "real" if real else "virtual",
        "distinct_devices": len(mesh.distinct_devices),
        "device_kind": (torch.cuda.get_device_name(mesh.devices[0])
                        if device.type == "cuda" else "cpu"),
        "worlds_per_device": worlds_per_device,
        "worlds": b,
        "t": t,
        "wall_s": dt,
        "steps_per_s_per_world": t / dt,
        "aggregate_ticks_per_s": t * b / dt,
        "mean_err": mean_err,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m live_ekf_slam_tpu_torch.tools.weak_scaling",
        description="Weak scaling of the per-tick EKF-SLAM path over a "
                    "world mesh.")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--worlds-per-device", type=int, default=64)
    ap.add_argument("--t", type=int, default=100)
    ap.add_argument("--real", action="store_true",
                    help="the cards of this machine (default: a virtual mesh "
                         "of n shards on one device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu (a "
                         "virtual CPU mesh, the plain path)")
    ap.add_argument("--out", default=None, help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if args.real and args.device != "cuda":
        ap.error("--real needs --device cuda")

    rows, failed = [], 0
    for n in args.devices:
        try:
            row = run_row(n, args.worlds_per_device, args.t, real=args.real,
                          device=args.device)
        except ValueError as e:  # make_mesh: fewer cards than asked for
            print(f"devices={n}: FAILED: {e}", file=sys.stderr)
            failed += 1
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("| devices | mode | worlds | wall (s) | steps/s/world | aggregate ticks/s | mean err |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['devices']} | {r['mode']} | {r['worlds']} | {r['wall_s']} | "
              f"{r['steps_per_s_per_world']} | {r['aggregate_ticks_per_s']} | "
              f"{r['mean_err']} |")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mode": "real" if args.real else "virtual",
                       "rows": rows}, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
