"""Benchmark of the port: fused sim + filter steps/s/world on one GPU.

    python -m live_ekf_slam_tpu_torch.bench                # EKF-SLAM kernel
    python -m live_ekf_slam_tpu_torch.bench --filter ukf_slam
    python -m live_ekf_slam_tpu_torch.bench --impl plain --reps 1
    python -m live_ekf_slam_tpu_torch.bench --impl per_tick --filter naive
    python -m live_ekf_slam_tpu_torch.bench --filter pose_graph \
        --secondary ekf_slam [--iterative] [--worlds 1024]
    python -m live_ekf_slam_tpu_torch.bench --impl per_tick --filter pose_graph \
        --secondary naive --iterative [--worlds 1024] [--device cpu]
    python -m live_ekf_slam_tpu_torch.bench --filter closed_loop [--worlds 1024] \
        [--steps 1000] [--reps 1] [--device cpu]

The JAX ``bench.py`` path with ``BENCH_IMPL=pallas`` and ``BENCH_FILTER`` one
of ekf_slam, iekf_slam, ukf_slam, ukf_loc (``--filter``), on the card: 4096
worlds, T = 1000, N = 20; by default the shared protocol (16 random maps x
256 noise realisations, ids relabelled by tour, for every filter: the JAX
bench's 128-world UKF block was a TPU memory limit), ``--protocol perworld``
for a map per world. Inputs are
made once; each timed rep is one rollout between two
``torch.cuda.synchronize()`` calls, and the value is the median rep.
``--impl plain`` times the plain torch version on the card instead of the
kernel. ``--impl per_tick`` (the JAX ``BENCH_IMPL=xla``) times the per-tick
path instead, ``eval.runner.rollout`` over the same inputs and the Philox
noise stream, for any of the five online filters (naive included), one rep
by default. It needs a CUDA device and never falls back to the CPU; only
``--impl per_tick --device cpu`` runs on the CPU, which asks for it. It
writes nothing to disk. Prints one JSON line: metric, value, unit.

``--filter pose_graph`` times the pose-graph streams path instead
(``run_monte_carlo_pg_streams``, the JAX ``scripts/bench_pg_streams.py``): by
default 1024 worlds with a map each, the high-noise profile, bulk solve. Its
value is the accumulation rate in steps/s/world (streams + secondary + graph
assembly); the line also carries the replay and solve wall seconds and the
mean errors of the seeds and of the solution. With ``--impl per_tick`` the
same study runs on the per-tick path instead (``run_monte_carlo(impl=
"per_tick", collect="poses")``, any online filter as the secondary, its
graphs built tick by tick and, with ``--iterative``, re-solved every tick):
the line gives each phase's seconds, the ms a tick of the rollout (the
simulator, the secondary, the graph's update and per-tick solve) and the
mean errors; ``--device cpu`` runs it on the CPU.

``--filter closed_loop`` times the closed loop instead (the JAX
``BENCH_FILTER=closed_loop``, bench.py:126-248): the igvc1 course at the
JAX bench's configuration (``closed_loop_config``: 37 barrels, 16
measurement slots, 128 / 64 relaxation sweeps, a 64-cell window, EKF-SLAM),
1024 worlds x 1000 ticks (200 replan blocks of 5 ticks) by default, one rep.
Each rep is ``run_closed_loop`` on the Philox noise of its seed, with a
device synchronise around every block's replan and ticks; its value is
steps/s/world of the median rep; the line also gives the ms of the replan
alone at the same batch (the JAX bench's ``plan_once``: the local planner
and A* from the course's start pose, median of 5), the median ms per block
of the run's replans and of a control tick, and the mean average position
error. ``--device cpu`` runs it on the CPU, labelled so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.config import Config, preset
from live_ekf_slam_tpu_torch.eval.closed_loop import occupancy, run_closed_loop
from live_ekf_slam_tpu_torch.eval.runner import (
    ONLINE_FILTERS,
    fused_rollout,
    init_carry,
    make_step,
    mc_inputs,
    resolve_device,
    rollout,
    run_monte_carlo,
    run_monte_carlo_pg_streams,
    sync_clock,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.planning import astar as p_astar
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim.streams import sim_streams

WARMUP_TICKS = 10
PG_WORLDS = 1024
CL_WORLDS = 1024
# the high-noise profile of the accuracy studies (scripts/accuracy_matrix.py)
HIGH_NOISE = dict(V_00=0.01, V_11=0.001, W_00=0.01, W_11=0.01)


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


def time_per_tick(cfg, lms, cmds, seed: int, reps: int):
    """Time ``reps`` per-tick rollouts of ``cfg.filter`` over (lms, cmds)
    with the Philox noise of ``seed`` (drawn once, outside the timing),
    after a warm-up of a few ticks (CUDA context, cuBLAS, the Philox build).
    Each rep ends in a device synchronise. Returns (host-clock seconds of
    each rep, the last final carry)."""
    dev = lms.device
    t_total, n_lm = cmds.shape[1], lms.shape[1]
    noise = philox.philox_noise(seed, t_total, n_lm, lms.shape[0], dev)
    step = make_step(cfg)
    rollout(cfg, init_carry(cfg, lms, n_lm), cmds[:, :WARMUP_TICKS],
            noise[:WARMUP_TICKS], step=step)
    host_s, final = [], None
    for _ in range(reps):
        t0 = sync_clock(dev)
        final, _ = rollout(cfg, init_carry(cfg, lms, n_lm), cmds, noise,
                           step=step)
        host_s.append(sync_clock(dev) - t0)
    return host_s, final


def bench_per_tick(args) -> dict:
    dev = resolve_device(args.device)
    cfg = Config(num_iterations=args.steps).replace(filter=args.filter)
    lms, cmds = mc_inputs(cfg, args.worlds, 0, dev,
                          shared=args.protocol == "shared", relabel=True)
    reps = args.reps or 1
    times, final = time_per_tick(cfg, lms, cmds, 0, reps)
    elapsed = float(np.median(times))
    log(f"timed: {elapsed:.6f}s/rep (median of {reps}; per-rep "
        f"{' '.join(f'{t:.6f}' for t in times)})")
    ticks = torch.clamp_min(final.ticks_primary, 1).to(torch.float32)
    err = (final.err_sum_primary / ticks).cpu().numpy()
    if not np.isfinite(err).all():
        raise RuntimeError("the per-tick rollout produced non-finite errors")
    where = card() if dev.type == "cuda" else "the CPU, not a device metric"
    return {
        "metric": (
            f"per-tick sim+{args.filter} steps/sec/world at {args.worlds} "
            f"worlds (T={args.steps}, {args.protocol}; mean avg-pos-err "
            f"{float(err.mean()):.4f} m, "
            f"{int((~final.alive_primary).sum())} diverged; {where})"
        ),
        "value": args.steps / elapsed,
        "unit": "steps/s/world",
        "ms_per_tick": 1e3 * elapsed / args.steps,
    }


def pg_config(steps: int, secondary: str, iterative: bool) -> Config:
    """The pose-graph study's config: high noise, honest sigmas, the given
    secondary filter and solve mode."""
    cfg = Config(num_iterations=steps).replace(filter="pose_graph")
    return cfg.replace(
        process_noise=dataclasses.replace(
            cfg.process_noise, V_00=HIGH_NOISE["V_00"], V_11=HIGH_NOISE["V_11"]),
        sensing_noise=dataclasses.replace(
            cfg.sensing_noise, W_00=HIGH_NOISE["W_00"], W_11=HIGH_NOISE["W_11"]),
        pose_graph=dataclasses.replace(
            cfg.pose_graph, filter_to_compare=secondary,
            solve_graph_every_iteration=iterative),
    )


def pg_summary(res: dict, info: dict, steps: int, secondary: str) -> dict:
    """The numbers of one pose-graph run: accumulation steps/s/world, the
    phases' seconds and the mean errors."""
    sec = info["seconds"]
    accum = sec["streams"] + sec["secondary"] + sec["assemble"]
    return {
        "accum_steps_per_s_per_world": steps / accum,
        "accum_s": accum, "inputs_s": sec["inputs"],
        "replay_s": sec["replay"], "solve_s": sec["solve"],
        "mean_err_" + secondary: float(np.mean(res["err_" + secondary])),
        "mean_err_pose_graph_initial": float(np.mean(res["err_pose_graph_initial"])),
        "mean_err_pose_graph_result": float(np.mean(res["err_pose_graph_result"])),
        "diverged": int(res["diverged_pose_graph"].sum()),
    }


def time_per_tick_pose_graph(cfg, worlds: int, dev, seed: int = 0) -> dict:
    """One pose-graph study on the per-tick path, after a warm-up of a few
    ticks (CUDA context, cuBLAS) and the kernels' build: the numbers of
    ``pg_summary``'s kind (each phase's seconds, ms a tick of the rollout,
    mean errors, diverged worlds)."""
    if dev.type == "cuda":
        _build.load()
    warm = cfg.replace(num_iterations=WARMUP_TICKS)
    lms, cmds = mc_inputs(warm, worlds, seed, dev)
    noise = philox.philox_noise(seed, WARMUP_TICKS, lms.shape[1], worlds, dev)
    rollout(warm, init_carry(warm, lms, lms.shape[1]), cmds, noise, "poses")
    sec = {}
    t0 = sync_clock(dev)
    res, _, _ = run_monte_carlo(cfg, worlds, seed=seed, impl="per_tick",
                                device=dev, collect="poses", seconds=sec)
    wall = sync_clock(dev) - t0
    secondary = cfg.pose_graph.filter_to_compare
    return {
        "ms_per_tick": 1e3 * sec["rollout"] / cfg.num_iterations,
        "inputs_s": sec["inputs"], "rollout_s": sec["rollout"],
        "solve_s": sec["solve"], "wall_s": wall,
        "mean_err_" + secondary: float(np.mean(res["err_" + secondary])),
        "mean_err_pose_graph_initial": float(np.mean(res["err_pose_graph_initial"])),
        "mean_err_pose_graph_result": float(np.mean(res["err_pose_graph_result"])),
        "diverged": int(res["diverged_pose_graph"].sum()),
    }


def bench_per_tick_pose_graph(args) -> dict:
    dev = resolve_device(args.device)
    worlds = args.worlds or PG_WORLDS
    cfg = pg_config(args.steps, args.secondary, args.iterative)
    out = time_per_tick_pose_graph(cfg, worlds, dev)
    if not np.isfinite(out["mean_err_pose_graph_result"]):
        raise RuntimeError("the per-tick pose-graph run produced non-finite errors")
    mode = "iterative" if args.iterative else "bulk"
    where = card() if dev.type == "cuda" else "the CPU, not a device metric"
    return {
        "metric": (
            f"per-tick pose-graph steps/sec/world at {worlds} worlds "
            f"(T={args.steps}, secondary={args.secondary}, {mode}, high "
            f"noise; {where})"
        ),
        "value": 1e3 / out["ms_per_tick"], "unit": "steps/s/world", **out,
    }


def pg_graphs(cfg, batch: int, dev, seed: int = 0):
    """The graphs of the pose-graph path's first world chunk, rebuilt from
    the pieces ``run_monte_carlo_pg_streams`` composes, with the inputs they
    came from: (graphs, lms, cmds, noise, the EKF rollout's result)."""
    lms, cmds = mc_inputs(cfg, batch, seed, dev)
    n_lm = lms.shape[1]
    noise = philox.philox_noise(seed, cfg.num_iterations, n_lm, batch, dev)
    st = sim_streams(cfg, lms, n_lm, cmds, noise)
    out = fr.fused_ekf_rollout(cfg, lms, cmds, seed, noise=noise, emit_traj=True)
    graphs = pg.assemble_streams(cfg, out["est_traj"], st["r"], st["b"],
                                 st["vis"], cmds)
    return graphs, lms, cmds, noise, out


def schur_system(cfg, s, meas_scale: float, slots=None, chordal: bool = False) -> dict:
    """The Schur-reduced system solve_schur_pcg sets up first on the graphs
    ``s`` (at the seeds, damping 1e-4): the chain blocks d, u, the landmark
    inverses hll_inv, the measurement coefficients, the slot map and the
    pose gradient rhs, the arguments of posegraph._schur_mv and of P1.
    ``chordal``: the system of chordal_init's linear solve instead, at
    ``posegraph.chordal_seed`` with the headings fixed (``fix_theta``)."""
    slots = slots or pg.LmSlots(s)
    poses, lms = pg.chordal_seed(cfg, s, slots) if chordal else (s.poses_init, s.lms_init)
    sy = pg._schur_system(cfg, s, poses, lms, meas_scale, 1e-4, slots, fix_theta=chordal)
    return dict(d=sy["d"], u=sy["u"], hll_inv=sy["hll_inv"], coeffs=sy["coeffs"],
                slots=slots, rhs=sy["gp"])


def chain_blocks(cfg, s, meas_scale: float, chordal: bool = False):
    """The block-tridiagonal system solve_schur_pcg factors first on the
    graphs ``s`` and its first right-hand side: (d, u, rhs)."""
    sy = schur_system(cfg, s, meas_scale, chordal=chordal)
    return sy["d"], sy["u"], sy["rhs"]


def bench_pose_graph(args) -> dict:
    worlds = args.worlds or PG_WORLDS
    cfg = pg_config(args.steps, args.secondary, args.iterative)
    res, info, _ = run_monte_carlo_pg_streams(cfg, worlds, seed=0,
                                              world_chunk=worlds)
    out = pg_summary(res, info, args.steps, args.secondary)
    if not np.isfinite(out["mean_err_pose_graph_result"]):
        raise RuntimeError("the pose-graph run produced non-finite errors")
    mode = "iterative" if args.iterative else "bulk"
    return {
        "metric": (
            f"pg-streams accumulation steps/sec/world at {worlds} worlds "
            f"(T={args.steps}, secondary={args.secondary}, {mode}, high "
            f"noise; {card()})"
        ),
        "value": out.pop("accum_steps_per_s_per_world"),
        "unit": "steps/s/world", **out, "device": torch.cuda.get_device_name(0),
    }


def closed_loop_config(steps: int, meas_slots: int = 16, sweeps=(128, 64)) -> Config:
    """The JAX bench's closed-loop configuration (bench.py:141-156,
    docs/BENCHMARKS.md:20): the igvc1 preset (map, 37 barrels, start
    (0, -8.5, 0), tight control), 37 landmark slots, ``meas_slots``
    measurement slots (16 cover the barrels visible at once in the 3 m,
    +/-90 deg cone), A* and local-planner sweeps, path capacity 128 and a
    64-cell A* window; EKF-SLAM."""
    cfg = preset("igvc1", num_iterations=steps)
    return cfg.replace(
        num_landmark_slots=37, num_meas_slots=meas_slots,
        path_planning=dataclasses.replace(
            cfg.path_planning, astar_max_iters=sweeps[0],
            local_astar_max_iters=sweeps[1], path_capacity=128,
            astar_window=64))


def plan_once_ms(cfg, batch: int, dev, reps: int = 5) -> float:
    """Median ms of one batched replan alone (the JAX bench's
    ``plan_once``): the local planner's goal and A* to it for ``batch``
    worlds at the course's start pose, between two synchronises, after one
    untimed call."""
    occ = occupancy(cfg, dev)
    est = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev).expand(batch, 3)

    def plan():
        goal, _ = p_astar.local_planner(cfg, occ, est)
        p_astar.astar(cfg, occ, est[:, :2], goal)

    plan()
    times = []
    for _ in range(reps):
        t0 = sync_clock(dev)
        plan()
        times.append(sync_clock(dev) - t0)
    return 1e3 * float(np.median(times))


def time_closed_loop(cfg, worlds: int, dev, reps: int = 1) -> dict:
    """``reps`` closed-loop runs (seeds 1, 2, ...) after a two-block warm-up
    (CUDA context, cuBLAS, the Philox build): each rep's host-clock seconds,
    the median rep's, the median ms of a block's replan and of a control
    tick over the last rep, its per-world average errors."""
    period = cfg.path_planning.replan_period
    run_closed_loop(cfg.replace(num_iterations=2 * period), worlds, 0, device=dev)
    rep_s, sec, m = [], {}, None
    for rep in range(reps):
        sec = {}
        t0 = sync_clock(dev)
        m, _, _ = run_closed_loop(cfg, worlds, rep + 1, device=dev, seconds=sec)
        rep_s.append(sync_clock(dev) - t0)
    return {"rep_s": rep_s, "wall_s": float(np.median(rep_s)),
            "replan_ms": 1e3 * float(np.median(sec["replan"][1:])),
            "tick_ms": 1e3 * float(np.median(sec["ticks"])) / period,
            "err": m["err_" + cfg.filter]}


def bench_closed_loop(args) -> dict:
    dev = resolve_device(args.device)
    worlds = args.worlds or CL_WORLDS
    cfg = closed_loop_config(args.steps)
    period = cfg.path_planning.replan_period
    t_run = (args.steps // period) * period
    out = time_closed_loop(cfg, worlds, dev, args.reps or 1)
    err = out.pop("err")
    if not np.isfinite(err).all():
        raise RuntimeError("the closed loop produced non-finite errors")
    plan_ms = plan_once_ms(cfg, worlds, dev)
    where = card() if dev.type == "cuda" else "the CPU, not a device metric"
    return {
        "metric": (
            f"closed-loop igvc sim+EKF+A*+pure-pursuit steps/sec/world at "
            f"{worlds} worlds (T={t_run}, replan every {period}; replan alone "
            f"{plan_ms:.2f} ms at batch {worlds}; mean avg-pos-err "
            f"{float(err.mean()):.4f} m; {where})"
        ),
        "value": t_run / out["wall_s"], "unit": "steps/s/world",
        "plan_once_ms": plan_ms, "mean_avg_pos_err_m": float(err.mean()), **out,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch.bench")
    p.add_argument("--filter", choices=ONLINE_FILTERS + ("pose_graph", "closed_loop"),
                   default="ekf_slam",
                   help="naive runs with --impl per_tick only; closed_loop "
                        "times the igvc1 closed loop (EKF-SLAM)")
    p.add_argument("--secondary", choices=ONLINE_FILTERS, default="naive",
                   help="pose_graph only: the filter that seeds the graph "
                        "(the streams path: naive, ekf_slam or iekf_slam)")
    p.add_argument("--iterative", action="store_true",
                   help="pose_graph only: replay the per-tick solves first")
    p.add_argument("--impl", choices=["cuda", "plain", "per_tick"],
                   default="cuda")
    p.add_argument("--device", default="cuda",
                   help="per_tick and closed_loop only: cpu runs it on the CPU")
    p.add_argument("--protocol", choices=["shared", "perworld"],
                   default="shared")
    p.add_argument("--worlds", type=int, default=None,
                   help="default 4096, pose_graph and closed_loop 1024")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--reps", type=int, default=None,
                   help="default 5, per_tick and closed_loop 1")
    args = p.parse_args(argv)
    if args.filter == "closed_loop":
        pin_fp32()
        print(json.dumps(bench_closed_loop(args)))
        return
    if args.filter == "naive" and args.impl != "per_tick":
        raise SystemExit("naive has no fused rollout: use --impl per_tick")
    if args.device != "cuda" and args.impl != "per_tick":
        raise SystemExit("only --impl per_tick runs on another device")
    if args.impl == "per_tick":
        pin_fp32()
        if args.filter == "pose_graph":
            print(json.dumps(bench_per_tick_pose_graph(args)))
            return
        args.worlds = args.worlds or 4096
        print(json.dumps(bench_per_tick(args)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device; none is available")
    pin_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f}s")
    if args.filter == "pose_graph":
        print(json.dumps(bench_pose_graph(args)))
        return
    args.worlds = args.worlds or 4096

    cfg = Config(num_iterations=args.steps).replace(filter=args.filter)
    t0 = time.perf_counter()
    lms, cmds = mc_inputs(cfg, args.worlds, 0, dev,
                          shared=args.protocol == "shared", relabel=True)
    torch.cuda.synchronize()
    log(f"worlds+trajectories ready {time.perf_counter() - t0:.2f}s")

    args.reps = args.reps or 5
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
