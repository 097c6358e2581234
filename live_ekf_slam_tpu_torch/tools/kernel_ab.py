"""A/B timing of the port's kernels against another source tree's, on the card.

    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        [--filters ekf_slam,iekf_slam] [--worlds 4096] [--steps 1000] \\
        [--reps 5] [--clocks]
    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        --target block_thomas | block_thomas_factor | schur_mv \\
        [--worlds 1024] [--study] [--clocks]
    python3 -m live_ekf_slam_tpu_torch.tools.kernel_ab --against DIR \\
        --target micro_rank_update | micro_joseph | micro_chol | micro_matvec \\
        [--worlds 4096] [--reps 5]

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
``--target block_thomas_factor``: P1's factor on that system the same way
(a wrapper call, alone, one world an SM), each output's largest difference
from the other tree's and from this tree's plain version relative to its
scale, whether each tree's -fmad=false build gives the plain version's
bits, and with ``--clocks`` each tree's cycles by phase of the factor
(lane 0 of every world), where its source has the counters.
``--target schur_mv``: the Schur matvec (P2) at that system, applied to
the preconditioned gradient (a CG direction): this tree's kernel (a
wrapper call, alone) in turns with the other tree's matvec, which is its
kernel where its library has one, else the torch spelling the solver ran
before it (``posegraph._schur_mv_torch``); the results' difference
relative to scale, this tree's occupancy and the bytes it must move.
``--study`` (with any of the three): also the whole pose-graph study
(``ekf_slam`` secondary, bulk, ``--worlds`` x ``--steps``) of each tree in
turns, each in a process of its own run from that tree's root, so that
each runs its own Python as well as its own kernels (DIR must be the
``live_ekf_slam_tpu_torch/csrc`` of a whole tree: ``git archive COMMIT |
tar -x -C OUT``): wall and solve seconds, mean errors, diverged worlds.
``--target micro_rank_update`` / ``micro_joseph`` / ``micro_chol`` /
``micro_matvec``: every case of that
family in the three microbenchmark tools (``micro_downdate``, ``micro_ukf``,
``micro_ukf_probe``) at ``--worlds`` worlds, D = 48 and the tools' own pass
counts, the other tree's ``micro_ops.cu`` against this tree's in turns:
one JSON line a case with the median CUDA-event milliseconds of ``--reps``
launches in each turn, microseconds a pass, the largest difference of this
tree's result from the other's relative to its scale (not bitwise: FMA
contraction may round apart), this tree's occupancy, and the card.
A variant of this tree's kernel is timed the same way: a copy of ``csrc``
with the change, given as ``--against``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import (
    card,
    chain_blocks,
    pg_config,
    pg_graphs,
    schur_system,
)
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import micro_ops as mo
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.tools import _common, micro_downdate, micro_ukf, micro_ukf_probe

FILTERS = ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")
PG_TARGETS = ("block_thomas", "block_thomas_factor", "schur_mv")
# the register micro families: target -> the micro_ops function
MICRO_TARGETS = {"micro_rank_update": "rank_update", "micro_joseph": "joseph",
                 "micro_chol": "chol", "micro_matvec": "matvec"}
PEAK_BYTES = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


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
    kernel against this tree's, in turns."""
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


# one study on the tree whose root is the working directory, run by
# ``study_ab`` in a process of its own: a warm-up at a short T (the build,
# the CUDA context), then the timed study; one JSON line
STUDY = """
import json, sys, time
import numpy as np, torch
from live_ekf_slam_tpu_torch.bench import pg_config, pg_summary
from live_ekf_slam_tpu_torch.eval.runner import run_monte_carlo_pg_streams
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
worlds, steps = int(sys.argv[1]), int(sys.argv[2])
pin_fp32()
dev = torch.device("cuda")
run_monte_carlo_pg_streams(pg_config(20, "ekf_slam", False), 2, seed=0, device=dev)
cfg = pg_config(steps, "ekf_slam", False)
torch.cuda.synchronize()
t0 = time.perf_counter()
out, info, _ = run_monte_carlo_pg_streams(cfg, worlds, seed=0, world_chunk=worlds, device=dev)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({"wall_s": wall, **pg_summary(out, info, steps, "ekf_slam"),
                  "err_pose_graph_result": out["err_pose_graph_result"].tolist()}))
"""


def tree_root(csrc: Path) -> Path:
    """The root of the tree whose ``live_ekf_slam_tpu_torch/csrc`` is csrc."""
    root = csrc.resolve().parent.parent
    if not (root / "live_ekf_slam_tpu_torch" / "eval" / "runner.py").is_file():
        raise SystemExit(f"kernel_ab --study: {csrc} is not the csrc of a whole tree")
    return root


def study_ab(args, other: Path):
    """The 1024-world pose-graph study (``ekf_slam``, bulk) of each tree in
    turns, other, this, this, other, each its own Python and kernels."""
    roots = {"other": tree_root(other), "this": tree_root(_build.CSRC)}
    turns, errs = [], {}
    for tree in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", STUDY, str(args.worlds), str(args.steps)],
                              cwd=roots[tree], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the study on {roots[tree]} failed:\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        errs.setdefault(tree, np.asarray(r.pop("err_pose_graph_result")))
        turns.append({"tree": tree, **r})
    print(json.dumps({
        "target": "pose_graph_study", "secondary": "ekf_slam", "mode": "bulk",
        "worlds": args.worlds, "steps": args.steps, "turns": turns,
        **{key: {t: float(np.median([r[key] for r in turns if r["tree"] == t]))
                 for t in ("other", "this")} for key in ("wall_s", "solve_s")},
        "err_pose_graph_result_max_abs_diff": float(np.abs(
            errs["this"].astype(np.float64) - errs["other"]).max()),
        "against": str(other), "card": card(),
    }), flush=True)


def factor_ab(args, other: Path, dev):
    """P1's factor on the study's first chain system, the other tree's
    kernel against this tree's, in turns."""
    trees = {"other": other, "this": _build.CSRC}
    flags = [(), _build.NO_FMA] + ([_build.PHASE_CLOCKS] if args.clocks else [])
    builds = [(f, c) for f in flags for c in (other, _build.CSRC)]
    with ThreadPoolExecutor(len(builds)) as pool:  # every nvcc at once
        list(pool.map(lambda v: _build.build(*v), builds))
    cfg = pg_config(args.steps, "ekf_slam", False)
    d, u, _ = chain_blocks(cfg, pg_graphs(cfg, args.worlds, dev)[0], 1.0)
    pfac = pg._tridiag_factor_reference(d, u)
    no_fma = {}
    for name, tree in trees.items():
        with _build.sources(tree), _build.without_fma():
            nf = pg._tridiag_factor(d, u)
        no_fma[name] = all(torch.equal(nf[k], pfac[k]) for k in pfac)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    d_sm, u_sm = d[:n_sm].contiguous(), u[:n_sm].contiguous()
    turns, facs, dev_ms, dev_ms_sm, cyc = [], {}, {}, {}, {}
    for name in ("other", "this", "this", "other"):
        with _build.sources(trees[name]):
            turns.append((name, median_ms(lambda: pg._tridiag_factor(d, u), args.reps)))
            dev_ms.setdefault(name, []).append(factor_kernel_ms(d, u))
            dev_ms_sm.setdefault(name, []).append(factor_kernel_ms(d_sm, u_sm))
            facs.setdefault(name, pg._tridiag_factor(d, u))
            if args.clocks and name not in cyc:
                try:
                    cyc[name] = pg.factor_phase_clocks(d, u)[0]
                except AttributeError:  # no counters in that tree's source
                    cyc[name] = None
    torch.cuda.synchronize()
    print(json.dumps({
        "target": "block_thomas_factor", "worlds": args.worlds, "steps": args.steps,
        "reps": args.reps, "turns": turns,
        "median_ms": {n: float(np.median([t for k, t in turns if k == n])) for n in trees},
        "kernel_ms": dev_ms, f"kernel_ms_{n_sm}_worlds": dev_ms_sm,
        "cycles": cyc or None,
        "rel_diff_to_other": {k: rel_diff(facs["this"][k], facs["other"][k]) for k in pfac},
        "rel_diff_to_plain": {k: rel_diff(facs["this"][k], pfac[k]) for k in pfac},
        "no_fma_bitwise_equal_to_plain": no_fma,
        "against": str(other), "card": card(),
    }), flush=True)


def schur_mv_kernel_ms(d, u, hll_inv, coeffs, slots, vp) -> float:
    """``launch_ms`` of the Schur matvec on its arguments (contiguous)."""
    sp = torch.empty_like(vp)
    b, t1 = vp.shape[:2]
    return launch_ms("les_schur_mv", (
        d.data_ptr(), u.data_ptr(), *(c.data_ptr() for c in coeffs),
        hll_inv.data_ptr(), slots.index32.data_ptr(), int(slots.by_column),
        vp.data_ptr(), b, t1 - 1, slots.shape[2], slots.n, sp.data_ptr(),
        torch.cuda.current_stream().cuda_stream))


def schur_mv_bytes(d, u, hll_inv, coeffs, slots, vp) -> float:
    """The bytes the matvec must move: every input read once, sp written."""
    return 4.0 * (sum(c.numel() for c in coeffs) + d.numel() + u.numel()
                  + hll_inv.numel() + slots.index32.numel() + 2 * vp.numel())


def schur_mv_ab(args, other: Path, dev):
    """P2 on the study's first system, in turns with the other tree's
    matvec (its kernel, or without one the torch spelling)."""
    with ThreadPoolExecutor(2) as pool:  # every nvcc at once
        list(pool.map(lambda c: _build.build((), c), [other, _build.CSRC]))
    with _build.sources(other):
        other_kernel = hasattr(_build.load(), "les_schur_mv")
    cfg = pg_config(args.steps, "ekf_slam", False)
    sy = schur_system(cfg, pg_graphs(cfg, args.worlds, dev)[0], 1.0)
    vp = pg._tridiag_solve(pg._tridiag_factor(sy["d"], sy["u"]), sy["rhs"])
    mv_args = (sy["d"], sy["u"], sy["hll_inv"], sy["coeffs"], sy["slots"], vp)
    turns, outs, dev_ms = [], {}, {}
    for name in ("other", "this", "this", "other"):
        with _build.sources(other if name == "other" else _build.CSRC):
            fn = (pg._schur_mv if name == "this" or other_kernel
                  else pg._schur_mv_torch)
            turns.append((name, median_ms(lambda: fn(*mv_args), args.reps)))
            if name == "this" or other_kernel:
                dev_ms.setdefault(name, []).append(schur_mv_kernel_ms(*mv_args))
            outs.setdefault(name, fn(*mv_args))
    torch.cuda.synchronize()
    nbytes = schur_mv_bytes(*mv_args)
    this_ms = float(np.median(dev_ms["this"]))
    print(json.dumps({
        "target": "schur_mv", "worlds": args.worlds, "steps": args.steps,
        "reps": args.reps, "other_impl": "kernel" if other_kernel else "torch",
        "turns": turns,
        "median_ms": {n: float(np.median([t for k, t in turns if k == n]))
                      for n in ("other", "this")},
        "kernel_ms": dev_ms, "bytes": nbytes,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES,
        "achieved_bytes_per_s": nbytes / (this_ms * 1e-3),
        "sp_rel_diff_to_other": rel_diff(outs["this"], outs["other"]),
        "occupancy": pg.schur_mv_occupancy(sy["slots"].shape[2], sy["slots"].n),
        "against": str(other), "card": card(),
    }), flush=True)


def micro_ab(args, other: Path, dev):
    """The tools' cases of one micro family, the other tree's kernel against
    this tree's, in turns (other, this, this, other), one line a case."""
    with ThreadPoolExecutor(2) as pool:  # every nvcc at once
        list(pool.map(lambda c: _build.build((), c), [other, _build.CSRC]))
    op = MICRO_TARGETS[args.target]
    for tool in (micro_downdate, micro_ukf, micro_ukf_probe):
        for c in tool.cases(args.worlds, dev):
            if c["op"] != op:
                continue
            fn = getattr(mo, op)
            turns, outs = [], {}
            for tree in ("other", "this", "this", "other"):
                with _build.sources(other if tree == "other" else _build.CSRC):
                    turns.append((tree, 1e3 * _common.time_op(
                        lambda: fn(*c["args"]), dev, args.reps)))
                    outs.setdefault(tree, fn(*c["args"]))
            torch.cuda.synchronize()
            ms = {t: float(np.median([m for k, m in turns if k == t]))
                  for t in ("other", "this")}
            print(json.dumps({
                "target": args.target, "tool": tool.__name__.rsplit(".", 1)[1],
                "case": c["name"], "variant": c["variant"], "worlds": args.worlds,
                "dim": _common.DIM, "passes": c["passes"], "reps": args.reps,
                "turns": turns, "median_ms": ms,
                "us_per_pass": {t: 1e3 * m / c["passes"] for t, m in ms.items()},
                "other_over_this": ms["other"] / ms["this"],
                "rel_diff_to_other": rel_diff(outs["this"], outs["other"]),
                "occupancy": mo.occupancy(op, _common.DIM, **mo.occupancy_kwargs(
                    op, c["variant"], c["args"][1].shape[1] if op == "matvec" else 4)),
                "against": str(other), "card": card(),
            }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_ab", description=__doc__.split("\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--target", choices=("rollouts",) + PG_TARGETS + tuple(MICRO_TARGETS),
                    default="rollouts")
    ap.add_argument("--filters", default="ekf_slam,iekf_slam")
    ap.add_argument("--worlds", type=int, default=None,
                    help="default 4096, the pose-graph targets 1024")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--study", action="store_true",
                    help="the pose-graph targets: also the study of each tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    other = args.against.resolve()
    if not (other / "fused_ekf_rollout.cu").is_file():
        raise SystemExit(f"kernel_ab: {other} holds no fused_ekf_rollout.cu")
    pin_fp32()
    dev = torch.device("cuda")
    if args.target in PG_TARGETS:
        args.worlds = args.worlds or 1024
        {"block_thomas": block_thomas_ab, "block_thomas_factor": factor_ab,
         "schur_mv": schur_mv_ab}[args.target](args, other, dev)
        if args.study:
            study_ab(args, other)
        return
    args.worlds = args.worlds or 4096
    if args.target in MICRO_TARGETS:
        micro_ab(args, other, dev)
        return
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
