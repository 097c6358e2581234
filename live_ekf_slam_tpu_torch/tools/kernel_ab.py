"""A/B timing of the port's kernels against another source tree's, on the card.

    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        [--filters ekf_slam,iekf_slam] [--worlds 4096] [--steps 1000] \\
        [--reps 5] [--clocks]
    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        --target block_thomas [--worlds 1024] [--study] [--clocks]

DIR is another tree's ``csrc`` directory with the same C interface, for a
commit: ``git archive COMMIT live_ekf_slam_tpu_torch/csrc | tar -x -C OUT``
and DIR = OUT/live_ekf_slam_tpu_torch/csrc. Both trees' kernels are built
(one nvcc per source, as ``ops/_build`` builds) and launched through this
tree's wrappers; two versions are compared only within one call, on one
card, in turns: other, this, this, other.

``--target rollouts`` (the default): on the bench's inputs (shared protocol,
seed 0, N = 20), for each filter one JSON line: the median CUDA-event
milliseconds of ``--reps`` rollouts in each turn, whether the two trees'
results are equal bit for bit, and the card's name and power limit. With
``--clocks`` also each tree's clock64() cycles by phase of the tick, from
its ``-DLES_PHASE_CLOCKS`` build, where its source has the counters.

``--target block_thomas``: the block-Thomas solve (P1) on the chain system
that the pose-graph study factors first (``bench.chain_blocks`` on the
graphs of ``--worlds`` worlds x ``--steps`` ticks, one factor of this
tree's), timed in turns (a wrapper call between two events, and the
kernel alone: back-to-back launches, at the whole batch and at one world an
SM); the largest difference of this tree's x from the other tree's
relative to its scale (not bitwise: the trees may sum in other orders) and
from this tree's plain version; this tree's occupancy, and with
``--clocks`` its cycles by phase of the solve (thread 0 of every world).
With ``--study`` also the whole pose-graph study (``ekf_slam`` secondary,
bulk) on each tree in turns: wall and solve seconds, mean errors, diverged
worlds. A variant of this tree's kernel is timed the same way: a copy of
``csrc`` with the change, given as ``--against``.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import card, chain_blocks, pg_config, pg_graphs, pg_summary
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo_pg_streams,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
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


def launch_ms(entry: str, args: tuple, launches: int = 20) -> float:
    """Device milliseconds of one launch of the current library's C entry
    point ``entry`` with ``args``: CUDA events around ``launches`` launches
    back to back, after one warm-up. Without a wrapper's checks between
    them the card does not wait for the host, as it does between two events
    around one wrapper call (``median_ms``)."""
    fn = getattr(_build.load(), entry)
    _build.check(fn(*args), entry)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    rcs = []
    e0.record()
    for _ in range(launches):
        rcs.append(fn(*args))
    e1.record()
    torch.cuda.synchronize()
    for rc in rcs:
        _build.check(rc, entry)
    return e0.elapsed_time(e1) / launches


def solve_kernel_ms(fac: dict, rhs: torch.Tensor) -> float:
    """``launch_ms`` of the block-Thomas solve on a factor and rhs."""
    rhs = rhs.contiguous()
    x = torch.empty_like(rhs)
    return launch_ms("les_block_thomas_solve", (
        fac["sinv"].data_ptr(), fac["l"].data_ptr(), fac["u"].data_ptr(),
        fac["dsc"].data_ptr(), rhs.data_ptr(), rhs.shape[0], rhs.shape[1] - 1,
        x.data_ptr(), torch.cuda.current_stream().cuda_stream))


def factor_kernel_ms(d: torch.Tensor, u: torch.Tensor) -> float:
    """``launch_ms`` of the block-Thomas factor on d, u."""
    d, u = d.contiguous(), u.contiguous()
    out = [torch.empty_like(d), torch.empty_like(u), torch.empty_like(u),
           d.new_empty(d.shape[:3])]
    return launch_ms("les_block_thomas_factor", (
        d.data_ptr(), u.data_ptr(), d.shape[0], d.shape[1] - 1,
        *(o.data_ptr() for o in out), torch.cuda.current_stream().cuda_stream))


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / float(b.abs().max())


def block_thomas_ab(args, other: Path, dev):
    """P1's solve on the pose-graph study's chain system, the other tree's
    kernel against this tree's, in turns; then, with ``--study``, the study
    itself on each tree in turns."""
    trees = {"other": other, "this": _build.CSRC}
    builds = [((), other), ((), _build.CSRC)]
    if args.clocks:
        builds.append((_build.PHASE_CLOCKS, _build.CSRC))
    with ThreadPoolExecutor(len(builds)) as pool:  # every nvcc at once
        list(pool.map(lambda v: _build.build(*v), builds))
    cfg = pg_config(args.steps, "ekf_slam", False)
    d, u, rhs = chain_blocks(cfg, pg_graphs(cfg, args.worlds, dev)[0], 1.0)
    fac = pg._tridiag_factor(d, u)
    pfac = pg._tridiag_factor_reference(d, u)
    # one world an SM: the time is one world's latency
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fac_sm = {k: v[:n_sm].contiguous() for k, v in fac.items()}
    turns, xs, dev_ms, dev_ms_sm = [], {}, {}, {}
    for name in ("other", "this", "this", "other"):
        with _build.sources(trees[name]):
            turns.append((name, median_ms(lambda: pg._tridiag_solve(fac, rhs), args.reps)))
            dev_ms.setdefault(name, []).append(solve_kernel_ms(fac, rhs))
            dev_ms_sm.setdefault(name, []).append(solve_kernel_ms(fac_sm, rhs[:n_sm]))
            xs.setdefault(name, pg._tridiag_solve(fac, rhs))
    torch.cuda.synchronize()
    print(json.dumps({
        "target": "block_thomas", "worlds": args.worlds, "steps": args.steps,
        "reps": args.reps, "turns": turns,
        "median_ms": {n: float(np.median([t for k, t in turns if k == n])) for n in trees},
        "kernel_ms": dev_ms, f"kernel_ms_{n_sm}_worlds": dev_ms_sm,
        "occupancy": pg.solve_occupancy(args.steps),
        "cycles": pg.solve_phase_clocks(fac, rhs)[0] if args.clocks else None,
        "x_rel_diff_to_other": rel_diff(xs["this"], xs["other"]),
        "x_rel_diff_to_plain": rel_diff(xs["this"], pg._tridiag_solve_reference(pfac, rhs)),
        "x_rel_diff_other_to_sequential": rel_diff(
            xs["other"], pg._tridiag_solve_sequential(pfac, rhs)),
        "against": str(other), "card": card(),
    }), flush=True)
    if not args.study:
        return
    turns, res = [], {}
    for tree in ("other", "this", "this", "other"):
        with _build.sources(trees[tree]):
            t0 = time.perf_counter()
            out, info, _ = run_monte_carlo_pg_streams(cfg, args.worlds, seed=0,
                                                      world_chunk=args.worlds, device=dev)
            torch.cuda.synchronize()
            summary = pg_summary(out, info, args.steps, "ekf_slam")
            turns.append({"tree": tree, "wall_s": time.perf_counter() - t0, **summary})
            res.setdefault(tree, out)
    print(json.dumps({
        "target": "pose_graph_study", "secondary": "ekf_slam", "mode": "bulk",
        "worlds": args.worlds, "steps": args.steps, "turns": turns,
        "wall_s": {t: float(np.median([r["wall_s"] for r in turns if r["tree"] == t]))
                   for t in ("other", "this")},
        "solve_s": {t: float(np.median([r["solve_s"] for r in turns if r["tree"] == t]))
                    for t in ("other", "this")},
        "err_pose_graph_result_max_abs_diff": float(np.abs(
            res["this"]["err_pose_graph_result"].astype(np.float64)
            - res["other"]["err_pose_graph_result"]).max()),
        "against": str(other), "card": card(),
    }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_ab", description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--target", choices=("rollouts", "block_thomas"), default="rollouts")
    ap.add_argument("--filters", default="ekf_slam,iekf_slam")
    ap.add_argument("--worlds", type=int, default=None,
                    help="default 4096, block_thomas 1024")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--study", action="store_true",
                    help="block_thomas: also the pose-graph study on each tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    other = args.against.resolve()
    if not (other / "fused_ekf_rollout.cu").is_file():
        raise SystemExit(f"kernel_ab: {other} holds no fused_ekf_rollout.cu")
    pin_fp32()
    dev = torch.device("cuda")
    if args.target == "block_thomas":
        args.worlds = args.worlds or 1024
        block_thomas_ab(args, other, dev)
        return
    args.worlds = args.worlds or 4096
    filters = args.filters.split(",")
    if not set(filters) <= set(FILTERS):
        raise SystemExit(f"kernel_ab: filters must be among {FILTERS}")
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
