"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``live_ekf_slam_tpu_torch/csrc`` with
nvcc and holds each rollout kernel (EKF-SLAM, RI-EKF-SLAM, UKF-SLAM,
UKF-Loc) against its plain torch version: on three configs with injected
noise, predicated against unpredicated, in-kernel Philox against the
replayed stream, and a build with FMA contraction off against the plain
version bit for bit; the same for the EKF kernels' pose stream and for the
block-Thomas factor and solve kernels on the blocks of real graphs. Those
checks feed nothing later and wait mostly for the host, so they run in five
processes side by side (``python3 chip_smoke.py --side-checks NAME ...`` is
one of them). Then it drives the main paths, alone on the card.
``run_monte_carlo`` at 4096 worlds, T = 1000, N = 20
under the bench's shared protocol, once per filter, each through its own
kernel, timed, the kernel compared with the plain version on the first 256
worlds of that run. ``run_monte_carlo_pg_streams``, the pose-graph study, at
1024 worlds with the EKF-SLAM secondary (twice: the results must repeat),
and at 256 worlds with the naive and RI-EKF secondaries and in iterative
mode, with the launch counts each run implies. Last the kernel-attribution
path at the bench's size: the EKF and RI-EKF rollouts in their ``sim``,
``nolm`` and ``full`` profile modes (the split of a rollout into simulator,
predict and landmark loop), the three microbenchmark tools, which time each
primitive of a tick alone (every kernel and variant of ``ops/micro_ops``
held against its plain version), and the sum of the passes a tick executes
against the EKF and UKF-SLAM kernels' measured times. Beside these, right
after the build, every rollout kernel's occupancy (registers, spills,
shared memory, resident worlds an SM; K1, K2 and K4 SLAM must keep 16
without spilling), and after the main paths the UKF, EKF and RI-EKF
kernels' cycles by phase of the tick (``ukf_phase_clocks``,
``ekf_phase_clocks``), from a third build compiled with -DLES_PHASE_CLOCKS. Every phase
prints one JSON line; any failure raises and the exit code is nonzero. The last three
lines are the kernels' record, the card's name and power limit as
nvidia-smi reports them, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repository beside it, it fails
before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import (
    card,
    pg_config,
    pg_summary,
    time_rollouts,
)
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import kernel_params
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo,
    run_monte_carlo_pg_streams,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import micro_ops as mo
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim.streams import sim_streams
from live_ekf_slam_tpu_torch.tools import micro_downdate, micro_ukf, micro_ukf_probe
from live_ekf_slam_tpu_torch.tools._common import DIM as MICRO_DIM

# Kernel vs plain version (injected noise), as |kernel - plain| <= atol +
# rtol * scale, where scale is the plain value for the per-world scalars and,
# for a vector or matrix output, its largest magnitude in that world
# (covariance entries near zero are differences of large terms; their error
# follows the matrix's scale, not their own). The plain versions run the
# kernels' float32 algebra in the kernels' order: a build with nvcc's FMA
# contraction off (-fmad=false) must give their bits exactly, in every world.
# The default build, which the port runs, contracts a*b + c into one FMA (one
# rounding instead of two); ticks of sequential updates carry those last-bit
# differences along, hence these tolerances. `seen` must match exactly, and
# the UKFs' `update_rejects` wherever the world is checked.
TOL = {
    "true_pose": (1e-5, 1e-5),
    "err_sum": (1e-3, 1e-3),
    "err_max": (1e-3, 1e-4),
    "x": (1e-4, 1e-4),
    "P": (1e-3, 1e-6),
}
# The same at the main path's shape, T = 1000: more ticks of feedback carry
# the differences further.
TOL_MAIN = {
    "true_pose": (1e-4, 1e-4),
    "err_sum": (3e-2, 1e-2),
    "err_max": (3e-2, 1e-3),
    "x": (1e-3, 1e-3),
    "P": (1e-2, 1e-5),
}
# Some UKF worlds are chaotic: once their covariance goes indefinite, the
# clamped Cholesky pivots turn on the last bits, and from then on two
# roundings of the same algebra follow different estimates (ROADMAP F6); so
# does a world whose sanity gate refused an update. Which worlds are chaotic
# is read off the plain version alone: it runs again with its injected noise
# scaled by NUDGE, which moves the measurements by ~1e-7 m, the size of a
# float32 rounding of a metre-scale state. A world is chaotic when that nudge
# alone moves the plain version by more than CHAOS_RATIO of the tolerance, or
# when either plain run refused an update or left an eigenvalue of P below
# UKF_INDEFINITE max|P|. Chaotic worlds are counted and left out of the
# per-world check of the default build; their share is reported, not capped:
# the -fmad=false build is held to every world bit for bit, compat branches
# included. The compat config's signed process noise (fused_ukf.py:318-335)
# makes P indefinite in most worlds by design, and calibrated motion's small
# process noise leaves a few worlds chaotic within SHORT ticks; at T = 200
# the mean error sum over all worlds must agree within AGG_RTOL besides.
NUDGE = 1.0 + 2.0 ** -16
CHAOS_RATIO = 0.1
UKF_INDEFINITE = -1e-3
AGG_RTOL = 1e-2
# The block-Thomas kernels against their plain loops, default build: |kernel
# - plain| <= P1_RTOL * max|plain| per output. The Schur blocks of weakly
# observed nodes have condition numbers in the hundreds, which multiply the
# FMA-rounding differences of a 1000-step recursion (measured: 1.6e-4).
P1_RTOL = 2e-3
# Two runs of the pose-graph main path must agree to this (metres): nothing
# on the path adds with atomics, so they are expected to be equal.
PG_REPEAT_ATOL = 1e-4
PG_MAIN = dict(batch=1024, steps=1000)    # the pose-graph study's size
PG_SIDE = 256                             # worlds of its other three runs
P1_WORLDS = 8                             # worlds of the block-Thomas checks
SMALL = dict(batch=250, steps=200)        # 250: not a multiple of 4 worlds
SHORT = 25                                # ticks, before most chaos sets in
MAIN = dict(batch=4096, steps=1000)       # the bench's size
PLAIN_WORLDS = 256                        # the main-shape comparison's worlds
K3_PLAIN_WORLDS = 64                      # the same for the pose stream: with a
                                          # map per world the plain version rarely
                                          # skips a landmark, ~45 ms a tick
# The standalone primitives against their plain versions, default build:
# |kernel - plain| <= MICRO_RTOL * max|plain| over the output, in a launch of
# at most MICRO_CHECK_PASSES passes. A pass differs from the plain version by
# FMA contraction alone: the product is not rounded before its sum. Where
# the rounded product lands the sum on a tie and the exact one beside it, the
# two round apart by one unit in the last place of the accumulated value, and
# since every pass adds the same term they do so in every pass: the
# difference grows by up to one ulp of the output's scale a pass (measured:
# 1.0e-4 of the scale after 2000 one-term Joseph passes, 5.2e-5 after 4096
# rank-2 passes), so a tolerance that held for a tool's thousands of passes
# would be too wide to catch a fault. MICRO_CHECK_PASSES ulps are 3.1e-5 of
# the scale, a third of MICRO_RTOL. The launch of the tool's own count of passes
# is timed, its drift is reported, and its -fmad=false build must equal the
# plain version bit for bit, as the short launch's must.
MICRO_RTOL = 1e-4
MICRO_CHECK_PASSES = 256
# shared memory: 128 bytes a clock on each of the 132 SMs at 1.98 GHz
PEAK_SMEM_BYTES = 128 * 132 * 1.98e9
REPS = 5
# H100 SXM peaks (NVIDIA data sheet, dense): fp32 without tensor cores, HBM
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the least time of a serial chain: dependent float32 operations at 4 cycles
# each on the card's highest SM clock (1.98 GHz)
DEP_OP_S = 4 / 1.98e9

SRC = "live_ekf_slam_tpu_torch/csrc/"
# kernel name -> (filter, launch counter, source, TPU kernel it replaces)
KERNELS = {
    "fused_ekf_rollout": (
        "ekf_slam", (fr.launches, "ekf"), SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:625"),
    "fused_iekf_rollout": (
        "iekf_slam", (fr.launches, "iekf"), SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:788"),
    "fused_ukf_rollout[slam]": (
        "ukf_slam", (fu.launches, "slam"), SRC + "fused_ukf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_ukf.py:619"),
    "fused_ukf_rollout[loc]": (
        "ukf_loc", (fu.launches, "loc"), SRC + "fused_ukf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_ukf.py:619"),
}


LINES = []  # every phase's line of this run, the side processes' included


def emit(phase: str, **kw):
    LINES.append({"phase": phase, **kw})
    print(json.dumps(LINES[-1]), flush=True)


def configs(steps: int):
    base = Config(num_iterations=steps)
    return {
        "default": base,
        "compat": base.replace(compat=CompatConfig.all_on()),
        "calibrated": base.replace(calibrated_motion=True),
    }


# the kernels of the pose-graph path: name -> (launch counter, key, source,
# what it replaces)
PG_KERNELS = {
    "fused_ekf_rollout[emit_traj]": (
        fr.launches, "ekf_traj", SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:604"),
    "fused_iekf_rollout[emit_traj]": (
        fr.launches, "iekf_traj", SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:604"),
    "block_thomas_factor": (
        pg.launches, "factor", SRC + "block_thomas.cu",
        "live_ekf_slam_tpu/models/posegraph.py:1071"),
    "block_thomas_solve": (
        pg.launches, "solve", SRC + "block_thomas.cu",
        "live_ekf_slam_tpu/models/posegraph.py:1092"),
}


# the kernels of the attribution path. K1p: name -> (filter, profile mode,
# key of fr.launches, the branch of the TPU kernel it replaces)
K1P_KERNELS = {
    f"fused_{kind}_rollout[{mode}]": (
        kind + "_slam", mode, f"{kind}_{mode}",
        "live_ekf_slam_tpu/ops/fused_rollout.py:" + line)
    for kind in fr.FILTER_KINDS for mode, line in (("sim", "188"), ("nolm", "268"))
}
# the standalone primitives: name -> (key of mo.launches, the first of the
# TPU kernel factories it replaces, the variant whose time heads the record)
MICRO_KERNELS = {
    "micro_rank_update": ("rank_update", "scripts/micro_downdate.py:40", "R=2"),
    "micro_column_gather": ("column_gather", "scripts/micro_downdate.py:71", "take"),
    "micro_chol": ("chol", "scripts/micro_ukf.py:53", "lower"),
    "micro_matvec": ("matvec", "scripts/micro_ukf.py:104", "row x4"),
    "micro_joseph": ("joseph", "scripts/micro_ukf.py:132", "prod9"),
    "micro_zstats": ("zstats", "scripts/micro_ukf.py:191", "zstats"),
}


def counts() -> dict:
    out = {name: c[key] for name, (_, (c, key), _, _) in KERNELS.items()}
    out.update({name: c[key] for name, (c, key, _, _) in PG_KERNELS.items()})
    out.update({name: fr.launches[key] for name, (_, _, key, _) in K1P_KERNELS.items()})
    out.update({name: mo.launches[key] for name, (key, _, _) in MICRO_KERNELS.items()})
    out["philox_noise"] = philox.launches
    return out


def zero_counts():
    for c in (fr.launches, fu.launches, pg.launches, mo.launches):
        for key in c:
            c[key] = 0
    philox.launches = 0


def scale(ref: torch.Tensor) -> torch.Tensor:
    """Per-world magnitude an output's error is measured against."""
    if ref.dim() == 1:
        return ref.abs()
    return ref.abs().amax(dim=tuple(range(1, ref.dim())), keepdim=True)


def tol_ratio(a: dict, ref: dict, tol: dict) -> dict:
    """Per output, each world's largest |a - ref| / (atol + rtol * scale)."""
    b = ref["seen"].shape[0]
    return {name: ((a[name] - ref[name]).abs()
                   / (atol + rtol * scale(ref[name]))).reshape(b, -1).amax(dim=1)
            for name, (rtol, atol) in tol.items()}


def plain_run(cfg, lms, cmds, noise, tol: dict
              ) -> tuple[dict, torch.Tensor | None]:
    """The plain version's run on these inputs and, for the UKFs, the worlds
    it flags as chaotic (see NUDGE); None for the EKFs, which have none. The
    UKFs' run and the nudged one go in one batch of twice the worlds (the
    plain version's time is launch-bound)."""
    if not cfg.filter.startswith("ukf"):
        return fused_rollout(cfg, lms, cmds, 0, noise=noise, plain=True), None
    nudged = noise * NUDGE
    b = lms.shape[0]
    both = fused_rollout(cfg, torch.cat([lms, lms]), torch.cat([cmds, cmds]),
                         0, noise=torch.cat([noise, nudged], dim=2).contiguous(),
                         plain=True)
    p = {k: v[:b] for k, v in both.items()}
    p_nudged = {k: v[b:] for k, v in both.items()}
    flags = torch.stack(list(tol_ratio(p_nudged, p, tol).values())).amax(
        dim=0) > CHAOS_RATIO
    for r in (p, p_nudged):
        P = r["P"].double()
        min_eig = torch.linalg.eigvalsh(P).min(dim=1).values
        flags |= min_eig < UKF_INDEFINITE * P.abs().amax(dim=(1, 2))
        flags |= r["update_rejects"] > 0
    return p, flags


def compare(k: dict, p: dict, tol: dict, exempt: torch.Tensor | None = None,
            agg_rtol: float | None = None) -> dict:
    """Max abs error and worst tolerance ratio of each output; raises if
    `seen` differs, or in a world not ``exempt`` an output is out of
    tolerance or `update_rejects` differ, or (with ``agg_rtol``) the mean
    error sums differ by more than that."""
    if not torch.equal(k["seen"], p["seen"]):
        raise AssertionError("seen differs between kernel and plain version")
    b = k["seen"].shape[0]
    if exempt is None:
        exempt = torch.zeros(b, dtype=torch.bool, device=k["seen"].device)
    out, bad_world = {}, torch.zeros_like(exempt)
    checked = bool((~exempt).any())
    for name, r_w in tol_ratio(k, p, tol).items():
        bad_world |= ~(r_w <= 1.0)
        d_w = (k[name] - p[name]).abs().reshape(b, -1).amax(dim=1)
        out[name] = {"max_abs_err": float(d_w.max()),
                     "max_abs_err_checked": float(d_w[~exempt].max())
                     if checked else None,
                     "tol_ratio": float(r_w.max()),
                     "tol_ratio_checked": float(r_w[~exempt].max())
                     if checked else None}
    if "update_rejects" in k:
        bad_world |= k["update_rejects"] != p["update_rejects"]
    mean_k = float(k["err_sum"].mean())
    mean_p = float(p["err_sum"].mean())
    out["mean_err_sum_rel_diff"] = abs(mean_k - mean_p) / abs(mean_p)
    out["worlds_exempt"] = int(exempt.sum())
    out["worlds_out_of_tol"] = int(bad_world.sum())
    out["worlds_out_of_tol_exempt"] = int((bad_world & exempt).sum())
    if bool((bad_world & ~exempt).any()):
        raise AssertionError(f"out of tolerance: {out}")
    if agg_rtol is not None and not out["mean_err_sum_rel_diff"] <= agg_rtol:
        raise AssertionError(f"mean error differs: {out}")
    return out


def bitwise(k: dict, p: dict, what: str) -> dict:
    """Which outputs are equal bit for bit; raises unless all are."""
    same = {key: bool(torch.equal(k[key], p[key])) for key in k}
    if not all(same.values()):
        raise AssertionError(f"{what}: not bitwise equal: {same}")
    return same


def gate_counts(cfg, lms, cmds, seed) -> dict:
    """Counts, summed over worlds and ticks, of the filters' work on these
    inputs: the plain versions' gates (vis * seen updates, vis * (1 - seen)
    insertions, the UKF's active dimension n_act = 4 + 2 * seen and its
    powers, the EKF's seen block D_act = 3 + 2 (1 + the highest id seen or
    visible) and its square, a tick and an update), replayed from the
    simulator and the kernels' Philox stream."""
    b, n, _ = lms.shape
    t_total = cmds.shape[1]
    noise = philox.philox_noise_reference(seed, t_total, n, b, lms.device)
    kp = kernel_params(cfg)  # the plain versions' float32 constants
    tx = torch.full((b,), kp.x0, dtype=torch.float32, device=lms.device)
    ty = torch.full_like(tx, kp.y0)
    tth = torch.full_like(tx, kp.yaw0)
    seen = torch.zeros((b, n), dtype=torch.bool, device=lms.device)
    tot = {k: 0.0 for k in ("updates", "insertions", "visible", "act1",
                            "act2", "act3", "act1u", "act2u", "dact1", "dact2",
                            "dact1u", "dact2u")}
    ids = torch.arange(1, n + 1, device=lms.device)
    for t in range(t_total):
        u = noise[t]
        d_n = torch.clamp(cmds[:, t, 0] + kp.v00s * u[0], 0.0, kp.d_max)
        h_n = torch.clamp(cmds[:, t, 1] + kp.v11s * u[1], -kp.th_max, kp.th_max)
        tx = tx + d_n * torch.cos(tth)
        ty = ty + d_n * torch.sin(tth)
        tth = tth + h_n
        dx = lms[:, :, 0] - tx[:, None]
        dy = lms[:, :, 1] - ty[:, None]
        r = torch.sqrt(dx * dx + dy * dy)
        beta = wrap(atan2(dy, dx) - tth[:, None])
        vis = (r <= kp.r_max) & (beta > kp.fov_min) & (beta < kp.fov_max)
        # n_act: the UKF's active dimensions, 4 + 2 per landmark seen
        n_act = (4 + 2 * seen.sum(dim=1)).to(torch.float64)
        n_upd = (vis & seen).sum(dim=1).to(torch.float64)
        # D_act: the EKF kernels' seen block, rows past it hold +0
        dact = (3 + 2 * torch.where(vis | seen, ids, 0).amax(dim=1)).to(torch.float64)
        for key, v in (("updates", n_upd), ("insertions", (vis & ~seen).sum(dim=1)),
                       ("visible", vis.sum(dim=1)), ("act1", n_act),
                       ("act2", n_act ** 2), ("act3", n_act ** 3),
                       ("act1u", n_upd * n_act), ("act2u", n_upd * n_act ** 2),
                       ("dact1", dact), ("dact2", dact ** 2),
                       ("dact1u", n_upd * dact), ("dact2u", n_upd * dact ** 2)):
            tot[key] += float(v.sum())
        seen |= vis
    tot["ticks"] = float(b * t_total)
    return tot


def work(filt: str, g: dict, b: int, t_total: int, n: int,
         mode: str = "full") -> tuple[float, float]:
    """(flops, bytes) the rollout of ``filt`` must do on these inputs: ops
    per event read off the algebra (the kernels' source notes), times the
    events the plain versions' gates count; bytes are each input read once
    and each output written once (noise is drawn in-kernel). ``mode`` "nolm"
    counts no update or insertion, "sim" the simulator alone."""
    d = 3 + 2 * n
    ticks = g["ticks"]
    sense = 40.0 * n * ticks + 20.0 * ticks  # per landmark and tick; truth, error
    if mode != "full":  # and seen stays empty: the vehicle block alone
        g = {**g, "updates": 0.0, "insertions": 0.0, "dact1": 3.0 * ticks,
             "dact2": 9.0 * ticks, "dact1u": 0.0, "dact2u": 0.0}
    if mode == "sim":
        flops = sense
    elif filt == "ekf_slam":
        # over the seen block D_act (the rest of P is +0 and stays so):
        # predict: two rank-1 row and two column passes; update: gain and
        # H P (~34 D) and the rank-2 downdate (4 D^2); insertion: two rows
        flops = sense + 8.0 * g["dact1"] + 4.0 * g["dact2u"] + 34.0 * g["dact1u"] \
            + g["insertions"] * (4.0 * d + 30.0)
    elif filt == "iekf_slam":
        # over the seen block: predict: one rank-1 pass (2 D^2); update:
        # ~19 D of gain, retraction and H P, the rank-2 downdate (4 D^2);
        # insertion: ~30
        flops = sense + 2.0 * g["dact2"] + 3.0 * g["dact1"] + 4.0 * g["dact2u"] \
            + 19.0 * g["dact1u"] + 60.0 * g["updates"] + g["insertions"] * 30.0
    elif filt == "ukf_slam":
        # per tick over the n_act active dimensions: Cholesky n^3/3, four
        # triangular matvecs (4 n^2), sigma rows and sums (~130 n); per
        # update: two triangular matvecs (2 n^2), half a Joseph pass of ~15
        # flops an entry (7.5 n^2), z-stats and sums (~200 n)
        flops = sense + g["act3"] / 3.0 + 4.0 * g["act2"] + 130.0 * g["act1"] \
            + 9.5 * g["act2u"] + 200.0 * g["act1u"] + g["insertions"] * 30.0
    else:  # ukf_loc: n_act = 4 throughout, every visible landmark updates
        flops = sense + ticks * (64 / 3.0 + 4.0 * 16 + 130.0 * 4) \
            + g["visible"] * (9.5 * 16 + 200.0 * 4)
    du = {"ekf_slam": d, "iekf_slam": d, "ukf_slam": 4 + 2 * n, "ukf_loc": 4}[filt]
    nbytes = 4.0 * (b * t_total * 2 + b * n * 2) \
        + 4.0 * b * (du * du + du + 8) + b * n
    return flops, nbytes


def timed_ms(fn, reps: int = REPS) -> float:
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


def stream_of(r: dict) -> dict:
    """A rollout's pose streams under the names whose tolerances they take:
    est_traj is x[0:3] and true_traj the true pose, tick by tick."""
    return {"x": r["est_traj"], "true_pose": r["true_traj"], "seen": r["seen"],
            "err_sum": r["err_sum"]}


def pose_stream_checks(dev, n_lm: int):
    """K3 against the plain version: EKF and RI-EKF on three configs at
    SMALL. The default build's streams within the tolerances of x and
    true_pose; the -fmad=false build bit for bit; everything else of the
    result bit for bit what emit_traj=False gives; sum_t |est - true| equal
    to err_sum."""
    rng = np.random.default_rng(3)
    for kind in fr.FILTER_KINDS:
        for cname, cfg in configs(SMALL["steps"]).items():
            lms, cmds = mc_inputs(cfg, SMALL["batch"], 3, dev)
            noise = torch.as_tensor(
                rng.uniform(-1, 1, (SMALL["steps"], 2 * n_lm + 8,
                                    SMALL["batch"])).astype(np.float32),
                device=dev)
            kw = dict(noise=noise, filter_kind=kind)
            before = fr.launches[kind + "_traj"]
            k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
            torch.cuda.synchronize()
            if fr.launches[kind + "_traj"] != before + 1:
                raise AssertionError(f"{kind}: the pose-stream kernel was not launched")
            k0 = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
            p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, emit_traj=True, **kw)
            with _build.without_fma():
                k_nofma = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
            same = bitwise(k_nofma, p, f"{kind} {cname} pose stream -fmad=false")
            unchanged = bitwise(k0, k, f"{kind} {cname} emit_traj=True against False")
            errs = compare(stream_of(k), stream_of(p),
                           {o: TOL[o] for o in ("x", "true_pose")})
            d = (k["est_traj"][..., :2] - k["true_traj"][..., :2]).norm(dim=-1).sum(dim=1)
            sum_rel = float(((d - k["err_sum"]).abs() / k["err_sum"]).max())
            last = (torch.equal(k["est_traj"][:, -1], k["x"][:, :3])
                    and torch.equal(k["true_traj"][:, -1], k["true_pose"]))
            emit("pose_stream_vs_plain", kernel=f"fused_{kind}_rollout[emit_traj]",
                 config=cname, **SMALL, est_traj=errs["x"], true_traj=errs["true_pose"],
                 no_fma_bitwise_equal=same, rest_bitwise_equal_to_emit_false=unchanged,
                 last_tick_is_final_state=last, err_sum_rel_diff=sum_rel)
            if not last or sum_rel > 1e-5:
                raise AssertionError(f"{kind} {cname}: the pose stream does not "
                                     f"fit the final state or err_sum ({sum_rel})")


# worlds of the pose-graph runs that launch each pose-stream kernel
K3_WORLDS = {"ekf": PG_MAIN["batch"], "iekf": PG_SIDE}


def pose_stream_inputs(kind: str, dev, n_lm: int):
    """What the pose-graph run with this secondary hands its rollout kernel:
    (cfg, lms, cmds, noise)."""
    cfg = pg_config(PG_MAIN["steps"], kind + "_slam", False)
    lms, cmds = mc_inputs(cfg, K3_WORLDS[kind], 0, dev)
    noise = philox.philox_noise(0, PG_MAIN["steps"], n_lm, K3_WORLDS[kind], dev)
    return cfg, lms, cmds, noise


def pose_stream_main_check(kind: str, dev, n_lm: int):
    """K3 at the pose-graph path's shape against the plain version, on the
    first K3_PLAIN_WORLDS worlds over all its ticks: the default build's
    streams within TOL_MAIN, the -fmad=false build bit for bit."""
    name = f"fused_{kind}_rollout[emit_traj]"
    cfg, lms, cmds, noise = pose_stream_inputs(kind, dev, n_lm)
    w = K3_PLAIN_WORLDS
    lw, cw = lms[:w].contiguous(), cmds[:w].contiguous()
    kw_w = dict(emit_traj=True, noise=noise[:, :, :w].contiguous(), filter_kind=kind)
    k = fr.fused_ekf_rollout(cfg, lw, cw, 0, **kw_w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = fr.fused_ekf_rollout_reference(cfg, lw, cw, 0, **kw_w)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    errs = compare(stream_of(k), stream_of(p),
                   {o: TOL_MAIN[o] for o in ("x", "true_pose")})
    with _build.without_fma():
        same = bitwise(fr.fused_ekf_rollout(cfg, lw, cw, 0, **kw_w),
                       p, f"{name} main shape -fmad=false")
    emit("pose_stream_main_vs_plain", kernel=name, steps=PG_MAIN["steps"],
         plain_ms=p_ms, plain_worlds=w, est_traj=errs["x"],
         true_traj=errs["true_pose"], no_fma_bitwise_equal=same)


def pg_graphs(cfg, batch: int, dev, seed: int = 0):
    """The graphs of the pose-graph path's first world chunk, rebuilt from
    the pieces ``run_monte_carlo_pg_streams`` composes, with the inputs they
    came from: (graphs, lms, cmds, noise, kernel result or None)."""
    lms, cmds = mc_inputs(cfg, batch, seed, dev)
    n_lm = lms.shape[1]
    noise = philox.philox_noise(seed, cfg.num_iterations, n_lm, batch, dev)
    st = sim_streams(cfg, lms, n_lm, cmds, noise)
    out = fr.fused_ekf_rollout(cfg, lms, cmds, seed, noise=noise, emit_traj=True)
    graphs = pg.assemble_streams(cfg, out["est_traj"], st["r"], st["b"],
                                 st["vis"], cmds)
    return graphs, lms, cmds, noise, out


def chain_blocks(cfg, s, meas_scale: float):
    """The block-tridiagonal system solve_schur_pcg factors first on these
    graphs (at the seeds, damping 1e-4), and its first right-hand side."""
    slots = pg.LmSlots(s)
    jac = pg._jacobians(cfg, s, s.poses_init, s.lms_init, meas_scale, slots)
    coeffs, r_meas = pg._meas_coeffs(cfg, s, s.poses_init, s.lms_init,
                                     meas_scale, slots)
    d, u, _ = pg._pose_blocks(cfg, s, jac, coeffs, 1e-4)
    rhs, _ = pg._grad(cfg, s, jac, coeffs, r_meas, slots)
    return d, u, rhs


def block_thomas_compare(d, u, rhs, what: str) -> dict:
    """P1 against its plain loops on one system: the default build within
    P1_RTOL of each output's scale, the -fmad=false build bit for bit.
    Returns the errors and the plain loops' milliseconds."""
    before = dict(pg.launches)
    fac = pg._tridiag_factor(d, u)
    x = pg._tridiag_solve(fac, rhs)
    torch.cuda.synchronize()
    if pg.launches != {"factor": before["factor"] + 1, "solve": before["solve"] + 1}:
        raise AssertionError("the block-Thomas wrappers did not launch their kernels")
    t0 = time.perf_counter()
    pfac = pg._tridiag_factor_reference(d, u)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    px = pg._tridiag_solve_reference(pfac, rhs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with _build.without_fma():
        nfac = pg._tridiag_factor(d, u)
        nx = pg._tridiag_solve(nfac, rhs)
    same = bitwise({**nfac, "x": nx}, {**pfac, "x": px}, f"{what} -fmad=false")
    out = {"no_fma_bitwise_equal": same, "factor_plain_ms": 1e3 * (t1 - t0),
           "solve_plain_ms": 1e3 * (t2 - t1)}
    for name, a, b in [(k_, fac[k_], pfac[k_]) for k_ in fac] + [("x", x, px)]:
        err, top = float((a - b).abs().max()), float(b.abs().max())
        out[name] = {"max_abs_err": err, "scale": top, "rel_to_scale": err / top}
        if not err <= P1_RTOL * top:
            raise AssertionError(f"{what}: {name} out of tolerance: {out[name]}")
    return out


def block_thomas_checks(dev):
    """P1 on the blocks of real graphs: a few worlds at T = 200 and
    T = 1000, at the first and the last measurement scale of the schedule."""
    for steps in (SMALL["steps"], PG_MAIN["steps"]):
        cfg = pg_config(steps, "ekf_slam", False)
        graphs = pg_graphs(cfg, P1_WORLDS, dev, seed=1)[0]
        for sc in (16.0, 1.0):
            res = block_thomas_compare(*chain_blocks(cfg, graphs, sc),
                                       f"block-Thomas T={steps} scale={sc}")
            emit("block_thomas_vs_plain", worlds=P1_WORLDS, steps=steps,
                 meas_scale=sc, rtol_of_scale=P1_RTOL, **res)


def pg_run(secondary: str, iterative: bool, batch: int, dev) -> tuple[dict, dict]:
    """One pose-graph study through ``run_monte_carlo_pg_streams``, in one
    world chunk, with the checks on its launch counts and results. Returns
    (results, launch counts)."""
    cfg = pg_config(PG_MAIN["steps"], secondary, iterative)
    zero_counts()
    t0 = time.perf_counter()
    res, info, _ = run_monte_carlo_pg_streams(cfg, batch, seed=0,
                                              world_chunk=batch, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    # the schedule: 16 + 16 + 50 Gauss-Newton iterations from the seeds, in
    # iterative mode 50 more from the replayed solution; each factors once
    # and solves once per CG iteration and once before them
    pgc = cfg.pose_graph
    n_gn = (max(8, pgc.bulk_gn_iters // 3) * 2 + pgc.bulk_gn_iters
            + (pgc.bulk_gn_iters if iterative else 0))
    want = dict.fromkeys(launches, 0)
    want.update(philox_noise=1, block_thomas_factor=n_gn,
                block_thomas_solve=n_gn * (pgc.bulk_cg_iters + 1))
    if secondary != "naive":
        kind = "iekf" if secondary == "iekf_slam" else "ekf"
        want[f"fused_{kind}_rollout[emit_traj]"] = 1
    if launches != want:
        raise AssertionError(f"pose graph, {secondary}: launched {launches}, "
                             f"expected {want}")
    summary = pg_summary(res, info, PG_MAIN["steps"], secondary)
    emit("pose_graph_path", secondary=secondary, iterative=iterative,
         batch=batch, steps=PG_MAIN["steps"], noise="high", wall_s=wall,
         **summary, launches={k_: v for k_, v in launches.items() if v})
    for key, v in res.items():
        if not key.startswith("diverged") and not np.isfinite(v).all():
            raise AssertionError(f"pose graph, {secondary}: non-finite {key}")
    if summary["diverged"]:
        raise AssertionError(f"pose graph, {secondary}: {summary['diverged']} worlds diverged")
    if not (summary["mean_err_pose_graph_result"]
            < summary["mean_err_pose_graph_initial"]):
        raise AssertionError(f"pose graph, {secondary}: the solve did not "
                             f"improve on the seeds: {summary}")
    return res, launches


def pose_graph_paths(dev, n_lm: int) -> tuple[list, int]:
    """The pose-graph main path and its three side runs; returns the records
    of its kernels for the ``kernels`` line and the main run's count of
    philox_noise launches."""
    res, launches = pg_run("ekf_slam", False, PG_MAIN["batch"], dev)
    again, _ = pg_run("ekf_slam", False, PG_MAIN["batch"], dev)
    spread = {k_: float(np.abs(res[k_].astype(np.float64) - again[k_]).max())
              for k_ in res}
    emit("pose_graph_repeat", equal={k_: bool(np.array_equal(res[k_], again[k_]))
                                     for k_ in res}, max_abs_diff=spread)
    if max(spread.values()) > PG_REPEAT_ATOL:
        raise AssertionError(f"the pose-graph path does not repeat: {spread}")
    pg_run("naive", False, PG_SIDE, dev)
    _, launches_iekf = pg_run("iekf_slam", False, PG_SIDE, dev)
    pg_run("naive", True, PG_SIDE, dev)

    record = []
    # ---- K3 at the shapes those runs gave it: its time with and without
    # the pose stream; its streams were held against the plain version's by
    # pose_stream_main_check, among the side checks
    for kind, ls in (("ekf", launches), ("iekf", launches_iekf)):
        name = f"fused_{kind}_rollout[emit_traj]"
        filt, batch = kind + "_slam", K3_WORLDS[kind]
        cfg, lms, cmds, noise = pose_stream_inputs(kind, dev, n_lm)
        kw = dict(noise=noise, filter_kind=kind)
        ms = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw))
        ms_off = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw))
        chk = next(d for d in LINES if d["phase"] == "pose_stream_main_vs_plain"
                   and d["kernel"] == name)
        gates = gate_counts(cfg, lms, cmds, 0)
        flops, nbytes = work(filt, gates, batch, PG_MAIN["steps"], n_lm)
        # beside the rollout's own traffic: the injected noise read once,
        # the two pose streams written once
        nbytes += 4.0 * noise.numel() + 2 * 4.0 * batch * PG_MAIN["steps"] * 3
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        emit("pose_stream_main_shape", kernel=name, batch=batch,
             steps=PG_MAIN["steps"], ms=ms, ms_without_stream=ms_off)
        record.append({
            "name": name, "route": "cuda", "source": PG_KERNELS[name][2],
            "replaces": PG_KERNELS[name][3], "launches": ls[name],
            "max_abs_err": max(chk[o]["max_abs_err"] for o in ("est_traj", "true_traj")),
            "ms": ms, "ms_without_stream": ms_off, "plain_ms": chk["plain_ms"],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "batch": batch, "plain_worlds": chk["plain_worlds"],
            "plain_steps": chk["steps"], "plain_timed": "beside the other side checks",
        })

    # ---- P1 on the main path's own graphs
    cfg = pg_config(PG_MAIN["steps"], "ekf_slam", False)
    d, u, rhs = chain_blocks(cfg, pg_graphs(cfg, PG_MAIN["batch"], dev)[0], 1.0)
    res = block_thomas_compare(d, u, rhs, "block-Thomas main shape")
    fac = pg._tridiag_factor(d, u)
    ms_f = timed_ms(lambda: pg._tridiag_factor(d, u))
    ms_s = timed_ms(lambda: pg._tridiag_solve(fac, rhs))
    emit("block_thomas_main_shape", **PG_MAIN, factor_ms=ms_f, solve_ms=ms_s, **res)
    b, t1 = d.shape[:2]
    steps = t1 - 1
    # factor: an adjugate inverse (~41 flop) and two 3x3 products (45 each)
    # and a subtraction (9) a step, the scaling (36); solve: three 3x3
    # matvecs (15 each) and two subtractions a step, the two scalings. The
    # longest dependent chain of a step: factor ~20 operations (cofactor,
    # determinant, division, the two products' 3-term sums), solve ~11.
    work_p1 = {
        "block_thomas_factor": (
            b * steps * 176.0, 4.0 * (d.numel() * 2 + u.numel() * 3 + b * t1 * 3),
            ms_f, res["factor_plain_ms"], ("sinv", "l", "u", "dsc"), 20),
        "block_thomas_solve": (
            b * t1 * 57.0, 4.0 * (d.numel() + u.numel() * 2 + b * t1 * 9),
            ms_s, res["solve_plain_ms"], ("x",), 11),
    }
    for name, (flops, nbytes, ms, p_ms, outs, dep_ops) in work_p1.items():
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        record.append({
            "name": name, "route": "cuda", "source": PG_KERNELS[name][2],
            "replaces": PG_KERNELS[name][3], "launches": launches[name],
            "max_abs_err": max(res[o]["max_abs_err"] for o in outs),
            "max_rel_to_scale": max(res[o]["rel_to_scale"] for o in outs),
            "ms": ms, "plain_ms": p_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "latency_floor_ms": 1e3 * steps * dep_ops * DEP_OP_S,
            "batch": b, "steps": steps,
        })
    return record, launches["philox_noise"]


def phase_attribution(dev, n_lm: int, base, lms, cmds, gates: dict):
    """K1p: the EKF and RI-EKF rollouts at MAIN in their sim, nolm and full
    modes, each launched once through the runner's routing with the counts
    zeroed before and read after, then timed; each cut mode's kernel against
    its plain version on the first PLAIN_WORLDS worlds (default build within
    TOL_MAIN, -fmad=false bit for bit), nolm predicated against unpredicated
    and against the replayed Philox stream bit for bit, sim with the estimate
    where it started. Returns the kernels' records and each filter's times
    by mode."""
    modes = ("sim", "nolm", "full")
    b, t_total = MAIN["batch"], MAIN["steps"]
    lw, cw = lms[:PLAIN_WORLDS].contiguous(), cmds[:PLAIN_WORLDS].contiguous()
    noise_w = philox.philox_noise_reference(0, t_total, n_lm, PLAIN_WORLDS, dev)
    noise_card = philox.philox_noise(0, t_total, n_lm, PLAIN_WORLDS, dev)
    record, times = [], {}
    for kind in fr.FILTER_KINDS:
        filt = kind + "_slam"
        cfg = base.replace(filter=filt)
        names = {m: f"fused_{kind}_rollout" + ("" if m == "full" else f"[{m}]")
                 for m in modes}
        zero_counts()
        outs = {m: fused_rollout(cfg, lms, cmds, 0, profile_mode=m) for m in modes}
        torch.cuda.synchronize()
        launches = counts()
        want = {k_: int(k_ in names.values()) for k_ in launches}
        if launches != want:
            raise AssertionError(f"{filt}: the attribution path launched "
                                 f"{launches}, not once each of {list(names.values())}")
        ms = {m: timed_ms(lambda m=m: fused_rollout(cfg, lms, cmds, 1, profile_mode=m))
              for m in modes}
        times[filt] = ms
        d = 3 + 2 * n_lm
        x0 = torch.zeros((b, d), device=dev)
        x0[:, :3] = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev)
        p0 = torch.diag_embed(torch.tensor(
            list(fr.P0) + [0.0] * (d - 3), dtype=torch.float32, device=dev)).expand(b, d, d)
        sim = outs["sim"]
        if not (torch.equal(sim["x"], x0) and torch.equal(sim["P"], p0)
                and not bool(sim["seen"].any())):
            raise AssertionError(f"{filt}: sim mode moved the estimate")
        if bool(outs["nolm"]["seen"].any()):
            raise AssertionError(f"{filt}: nolm mode marked a landmark seen")
        for m in ("sim", "nolm"):
            name = names[m]
            k = {k_: v[:PLAIN_WORLDS] for k_, v in outs[m].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = fused_rollout(cfg, lw, cw, 0, noise=noise_w, plain=True, profile_mode=m)
            torch.cuda.synchronize()
            p_ms = 1e3 * (time.perf_counter() - t0)
            errs = compare(k, p, TOL_MAIN)
            with _build.without_fma():
                same = bitwise(fused_rollout(cfg, lw, cw, 0, profile_mode=m), p,
                               f"{name} main shape -fmad=false")
            checks = {"no_fma_bitwise_equal": same}
            if m == "nolm":
                checks["unpredicated_bitwise_equal"] = bitwise(
                    fused_rollout(cfg, lw, cw, 0, profile_mode=m, predicated=False),
                    k, f"{name} predicated against unpredicated")
                checks["philox_replay_bitwise_equal"] = bitwise(
                    fused_rollout(cfg, lw, cw, 5, noise=noise_card, profile_mode=m),
                    k, f"{name} in-kernel Philox against the replay")
            worst = max(TOL_MAIN, key=lambda o: errs[o]["max_abs_err"])
            flops, nbytes = work(filt, gates, b, t_total, n_lm, mode=m)
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            emit("profile_mode_vs_plain", kernel=name, worlds=PLAIN_WORLDS,
                 steps=t_total, plain_ms=p_ms, errors=errs, **checks)
            record.append({
                "name": name, "route": "cuda", "source": SRC + "fused_ekf_rollout.cu",
                "replaces": K1P_KERNELS[name][3], "launches": launches[name],
                "max_abs_err": errs[worst]["max_abs_err"],
                "ms": ms[m], "plain_ms": p_ms,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "flops": flops, "bytes": nbytes,
                "plain_worlds": PLAIN_WORLDS, "plain_steps": t_total,
            })
        split = {"sim": ms["sim"], "predict": ms["nolm"] - ms["sim"],
                 "landmark_loop": ms["full"] - ms["nolm"]}
        emit("phase_attribution", filter=filt, **MAIN, n_lm=n_lm, protocol="shared",
             ms=ms, split_ms=split,
             shares={k_: v / ms["full"] for k_, v in split.items()},
             launches={k_: v for k_, v in launches.items() if v})
    return record, times


# flops an entry of one Joseph pass: the products, sums and the final add
JOSEPH_FLOPS = {"prod9": 20.0, "hoist": 20.0}
JOSEPH_TERM_FLOPS = (2.0, 2.0, 2.0, 2.0, 3.0, 3.0, 5.0)
# flops a sigma column of one z-stats pass: a range-and-bearing evaluation of
# each sigma half (a square root, a division, the atan2 polynomial and a
# wrap: ~40 each), four sines and cosines (~20 each), the deviations and
# sums (~35). The kernel evaluates range and bearing again in its second
# sweep over the columns, which the function does not need.
ZSTATS_FLOPS = 2 * 40.0 + 4 * 20.0 + 35.0
ZSTATS_FLOPS_KERNEL = ZSTATS_FLOPS + 2 * 40.0


def micro_work(c: dict, b: int, d: int) -> tuple[float, float, float, float]:
    """(flops, device-memory bytes, shared-memory bytes, flops executed) of
    one launch of a tool's case on b worlds of a (d, d) matrix. The flops
    are what the function needs, whichever variant computes it: the
    Cholesky's trailing updates over the lower triangle, one add an entry of
    the gathered column. The bound comes from them and from the bytes, each
    input read and each output written once in device memory. Beside the
    bound: every 4-byte access a lane makes to shared memory, and the flops
    this variant's loops execute, read off the kernel (the full-width and
    trailing-column Cholesky subtract zeros left of the pivot, the
    select-and-sum gather multiplies whole rows by a one-hot)."""
    op, n = c["op"], float(c["passes"])
    mat = 4.0 * b * d * d
    if op == "rank_update":
        r = c["rank"]
        flops = n * b * 2.0 * r * d * d
        return flops, 2 * mat + 2 * 4.0 * b * r * d, n * b * d * d * 4.0 * (2 + r), flops
    if op == "column_gather":
        sel = c["spelling"] == "select"
        return (n * b * d, mat + 4.0 * b + 4.0 * b * d,
                n * b * 4.0 * ((d * d if sel else d) + 2 * d),
                n * b * (2.0 * d * d + d if sel else d))
    if op == "chol":
        du = c["du"]
        e = c["per_pass_elems"] / b  # entries this variant's trailing updates walk
        e_low = micro_ukf.chol_elems("lower", d, du)
        scal = sum(d - j - 1 for j in range(du))
        return (n * b * (2.0 * e_low + scal + 2.0 * du), 2 * mat,
                n * b * 4.0 * (2.0 * d * d + 3.0 * e + 2.0 * scal),
                n * b * (2.0 * e + scal + 2.0 * du))
    if op == "matvec":
        flops = n * b * 2.0 * d * d
        return (flops, mat + 4.0 * b * d * (1 + c["args"][1].shape[1]),
                n * b * 4.0 * (2.0 * d * d + 2 * d), flops)
    if op == "joseph":
        if c["spelling"] == "terms":
            per, loads = sum(JOSEPH_TERM_FLOPS[:c["n_terms"]]), 2 + min(c["n_terms"], 4)
        else:
            per, loads = JOSEPH_FLOPS[c["spelling"]], 6
        flops = n * b * per * d * d
        return flops, 2 * mat + 4.0 * b * (4 * d + 3), n * b * d * d * 4.0 * loads, flops
    if op == "zstats":
        return (n * b * ZSTATS_FLOPS * d, 4.0 * b * (7 * d + 3), n * b * 4.0 * 14 * d,
                n * b * ZSTATS_FLOPS_KERNEL * d)
    raise ValueError(op)


def library_ms(c: dict) -> float | None:
    """Milliseconds of the PyTorch calls that compute a case's function on
    its inputs, one call a pass (``baddbmm`` for the rank update and the
    matvec, ``linalg.cholesky`` of the pivoted block, ``gather``), or None
    where no one call does. A yardstick: nothing in the port calls these."""
    op, args = c["op"], c["args"]
    if op == "rank_update":
        p, k, h, n = args
        kt = k.transpose(1, 2).contiguous()
        step, state = (lambda v: torch.baddbmm(v, kt, h, alpha=-1.0)), p
    elif op == "column_gather":
        p, idx, n, _ = args
        index = idx.long()[:, None, None].expand(-1, p.shape[1], 1)
        step, state = (lambda v: v + torch.gather(p, 2, index)[..., 0]), \
            torch.zeros_like(p[:, :, 0])
    elif op == "chol":
        p, n, _, du = args
        block = p[:, :du, :du].contiguous()
        step, state = (lambda v: torch.linalg.cholesky(block)), None
    elif op == "matvec":
        l, g, n, order = args
        m = l.transpose(1, 2).contiguous() if order == "col" else l
        n = n * g.shape[1]
        ga = g[:, 0, :, None].contiguous()
        step, state = (lambda v: torch.baddbmm(v, m, ga)), torch.zeros_like(ga)
    else:
        return None
    state = step(state)  # warm-up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        state = step(state)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def micro_compare(c: dict, worlds: int, short: dict | None = None) -> dict:
    """One case's kernel against its plain version on the first ``worlds``
    worlds. ``short`` is the same case at no more than MICRO_CHECK_PASSES
    passes (default: ``c`` itself): there the default build must lie within
    MICRO_RTOL of the output's scale. At ``c``'s own passes the default
    build's drift is reported. At both, the -fmad=false build must equal the
    plain version bit for bit. Returns the errors and the milliseconds of
    the plain version of ``c``."""
    fn, ref = getattr(mo, c["op"]), getattr(mo, c["op"] + "_reference")

    def run(case):
        args = tuple(a[:worlds].contiguous() if torch.is_tensor(a) else a
                     for a in case["args"])
        before = mo.launches[case["op"]]
        k = fn(*args)
        torch.cuda.synchronize()
        if mo.launches[case["op"]] != before + 1:
            raise AssertionError(f"{case['name']}: the wrapper did not launch the kernel")
        t0 = time.perf_counter()
        p = ref(*args)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        with _build.without_fma():
            k_nofma = fn(*args)
        if not torch.equal(k_nofma, p):
            raise AssertionError(
                f"{case['name']}, {case['passes']} passes: the -fmad=false build differs "
                f"from the plain version by {float((k_nofma - p).abs().max())}")
        return k, k_nofma, p, p_ms

    k, k_nofma, p, p_ms = run(c)
    k_s, _, p_s, _ = (k, k_nofma, p, p_ms) if short is None else run(short)
    err, top = float((k_s - p_s).abs().max()), float(p_s.abs().max())
    out = {"max_abs_err": err, "scale": top, "rel_to_scale": err / top,
           "rtol_of_scale": MICRO_RTOL,
           "checked_passes": (c if short is None else short)["passes"],
           "drift_rel_to_scale": float((k - p).abs().max()) / float(p.abs().max()),
           "plain_ms": p_ms, "plain_worlds": worlds, "no_fma_bitwise_equal": True}
    if not err <= MICRO_RTOL * top:
        raise AssertionError(f"{c['name']}: out of tolerance: {out}")
    if c["op"] == "joseph" and c["spelling"] != "terms":
        # both triangles from their own expressions: what FMA contraction
        # does to the symmetry the plain version keeps exactly
        out["asymmetry"] = float((k - k.transpose(1, 2)).abs().max())
        out["asymmetry_no_fma"] = float((k_nofma - k_nofma.transpose(1, 2)).abs().max())
    return out


def phase_micro_ops(dev) -> list:
    """The three tools at MAIN's batch and D = 48, through their ``run`` (the
    counts zeroed before, read after); then every case of theirs against its
    plain version and beside its bounds and library call. Returns the six
    families' records."""
    b, d = MAIN["batch"], MICRO_DIM
    tools = {"micro_downdate": micro_downdate, "micro_ukf": micro_ukf,
             "micro_ukf_probe": micro_ukf_probe}
    zero_counts()
    rows = {name: tool.run(b, dev, REPS) for name, tool in tools.items()}
    torch.cuda.synchronize()
    launches = counts()
    want = {k_: 0 for k_ in launches}
    n_cases = {}
    for tool in tools.values():
        for c in tool.cases(8, dev, passes=1):
            n_cases[c["op"]] = n_cases.get(c["op"], 0) + 1
    for name, (key, _, _) in MICRO_KERNELS.items():
        want[name] = n_cases[key] * (REPS + 1)  # a warm-up and REPS timed launches
    if launches != want:
        raise AssertionError(f"the tools launched {launches}, expected {want}")
    families = {name: [] for name in MICRO_KERNELS}
    for tname, tool in tools.items():
        for c, c_short, r in zip(tool.cases(b, dev),
                                 tool.cases(b, dev, passes=MICRO_CHECK_PASSES),
                                 rows[tname]):
            if c_short["passes"] >= c["passes"]:
                c_short = None  # the tool's own launch is short enough
            flops, nbytes, smem, executed = micro_work(c, b, d)
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            v = {**r, "tool": tname, **micro_compare(c, PLAIN_WORLDS, c_short),
                 "bound_ms": 1e3 * max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "flops": flops, "bytes": nbytes, "flops_executed": executed,
                 "smem_bytes": smem, "smem_ms": 1e3 * smem / PEAK_SMEM_BYTES,
                 "library_ms": library_ms(c)}
            emit("micro_ops", worlds=b, dim=d, **v)
            families["micro_" + c["op"]].append(v)
    # linearity in the passes: a launch of the tool's passes takes twice the
    # time of one of half as many (within 5%), or the compiler folded passes
    # together
    lin = {}
    for tool, op, variant in ((micro_ukf_probe, "rank_update", "R=2 (probe)"),
                              (micro_downdate, "column_gather", "take"),
                              (micro_ukf, "chol", "lower"),
                              (micro_ukf_probe, "matvec", "row"),
                              (micro_ukf, "joseph", "prod9"),
                              (micro_ukf, "zstats", "zstats")):
        def pick(passes=None):
            return next(c for c in tool.cases(b, dev, passes=passes)
                        if (c["op"], c["variant"]) == (op, variant))
        full = pick()
        t = [timed_ms(lambda: getattr(mo, op)(*c["args"]))
             for c in (pick(full["passes"] // 2), full)]
        lin[f"{op}[{variant}]"] = t[1] / t[0]
    emit("micro_ops_linearity", time_ratio_for_twice_the_passes=lin)
    if not all(1.9 <= r <= 2.1 for r in lin.values()):
        raise AssertionError(f"time is not linear in the passes: {lin}")
    record = []
    for name, (key, replaces, head) in MICRO_KERNELS.items():
        vs = families[name]
        h = next(v for v in vs if v["variant"] == head)
        record.append({
            "name": name, "route": "cuda", "source": SRC + "micro_ops.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in vs),
            "max_rel_to_scale": max(v["rel_to_scale"] for v in vs),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "variant": head, "passes": h["passes"], "us_per_pass": h["us_per_pass"],
            "smem_ms": h["smem_ms"], "batch": b, "dim": d,
            "plain_worlds": PLAIN_WORLDS,
            "variants": [{k_: v[k_] for k_ in (
                "variant", "tool", "passes", "ms", "us_per_pass", "max_abs_err",
                "checked_passes", "drift_rel_to_scale", "plain_ms", "bound_ms",
                "bound_by", "flops", "flops_executed", "smem_ms", "library_ms")}
                for v in vs],
        })
    return record


def phase_op_sum(dev, n_lm: int, gates: dict, times: dict, kernel_ms: dict):
    """The passes a tick executes, from the gates' counts, times each
    primitive's measured time per pass at the kernel's own dimension, against
    the kernel's measured time: for K1 (D = 43) and K4 SLAM (Du = 44). A pass
    is timed over the whole batch, so a count per world-tick times the
    batch's time per pass is the batch's time."""
    b, t_total = MAIN["batch"], MAIN["steps"]
    upd = gates["updates"] / gates["ticks"]  # updates per world and tick

    def us_per_pass(c):
        return 1e3 * timed_ms(lambda: getattr(mo, c["op"])(*c["args"])) / c["passes"]

    d = 3 + 2 * n_lm
    dd = us_per_pass(micro_ukf_probe.cases(b, dev, dim=d)[0])
    parts = {
        "sim_and_predict (the nolm kernel)": times["ekf_slam"]["nolm"],
        "rank2_downdates": upd * t_total * dd / 1e3,
    }
    total = sum(parts.values())
    emit("op_sum", kernel="fused_ekf_rollout", **MAIN, dim=d,
         updates_per_world_tick=upd, rank2_downdate_us_per_pass=dd,
         parts_ms=parts, op_sum_ms=total, kernel_ms=kernel_ms["ekf_slam"],
         explained_share=total / kernel_ms["ekf_slam"],
         not_timed_alone="gain and H P vectors, state update, insertions")

    du = fu.state_dim(n_lm, True)
    per = {c["variant"]: us_per_pass(c)
           for c in micro_ukf.cases(b, dev, dim=du, du=du)}
    # The micro kernels are the TPU scripts' loops at K4's counts, no longer
    # K4's own (which factors four pivots a pass and walks lines of two
    # rows; its split by phase is the ukf_phase_clocks line): the sum says
    # what a tick would cost spelled as those loops. The rollout factors the
    # active dimensions only (pivots past the highest seen slot are
    # skipped): the mean of n_act^3 over Du^3; matvecs over the lower
    # triangle (half of the rows' products); Joseph over one triangle,
    # timed here as the both-triangles spelling; z-stats by rotation algebra
    # in place of this block's atan2, sin and cos
    f_chol = gates["act3"] / gates["ticks"] / du ** 3
    parts = {
        "sim (the EKF kernel in sim mode)": times["ekf_slam"]["sim"],
        "chol_lower": t_total * f_chol * per["lower"] / 1e3,
        "predict_matvecs (4 a tick, triangular)": t_total * 4 * 0.5 * per["row x4"] / 1e3,
        "update_matvecs (2 an update, triangular)": upd * t_total * 2 * 0.5 * per["row x4"] / 1e3,
        "update_joseph": upd * t_total * per["prod9"] / 1e3,
        "update_zstats": upd * t_total * per["zstats"] / 1e3,
    }
    total = sum(parts.values())
    emit("op_sum", kernel="fused_ukf_rollout[slam]", **MAIN, dim=du,
         updates_per_world_tick=upd, chol_active_share=f_chol,
         us_per_pass=per, parts_ms=parts, op_sum_ms=total,
         kernel_ms=kernel_ms["ukf_slam"],
         explained_share=total / kernel_ms["ukf_slam"],
         not_timed_alone="sigma propagation, the 4x4 block, gain and gate, insertions",
         note="the TPU scripts' loops at K4's counts; K4's own split: ukf_phase_clocks")


# the EKF kernels' instantiations: name -> (filter kind, profile mode,
# emit_traj, template arguments <kInvariant, kEmitTraj, kMode>)
EKF_INSTANCES = {
    "fused_ekf_rollout": ("ekf", "full", False, "false, false, 0"),
    "fused_iekf_rollout": ("iekf", "full", False, "true, false, 0"),
    "fused_ekf_rollout[emit_traj]": ("ekf", "full", True, "false, true, 0"),
    "fused_iekf_rollout[emit_traj]": ("iekf", "full", True, "true, true, 0"),
    "fused_ekf_rollout[nolm]": ("ekf", "nolm", False, "false, false, 1"),
    "fused_iekf_rollout[nolm]": ("iekf", "nolm", False, "true, false, 1"),
    "fused_ekf_rollout[sim]": ("ekf", "sim", False, "false, false, 2"),
    "fused_iekf_rollout[sim]": ("iekf", "sim", False, "true, false, 2"),
}
# worlds an SM that K1 and K2 (EKF_INSTANCES' first two) and K4 SLAM must
# keep without spilling at N = 20: the register file's limit at 128 a thread
EKF_RESIDENT, UKF_SLAM_RESIDENT = 16, 16


def ptxas_report(src: str) -> dict:
    """What ptxas reports of every kernel of one source, compiled with the
    default build's flags: mangled name -> registers, stack frame and spill
    store and load bytes a thread."""
    cmd = [_build.find_nvcc(), *(f for f in _build.NVCC_FLAGS if f != "-shared"),
           "-Xptxas", "-v", "-c", "-o", "/dev/null", str(_build.CSRC / src)]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["ptxas_registers"] = int(line.split("Used")[1].split()[0])
    return out


def mangled_args(args: str) -> str:
    """Template arguments as they are mangled: "true, false, 0" -> ILb1ELb0ELi0EE."""
    parts = {"true": "Lb1E", "false": "Lb0E"}
    return "I" + "".join(parts.get(a, f"Li{a}E") for a in args.split(", ")) + "E"


def phase_occupancy(n_lm: int, ptxas: dict) -> list:
    """Every rollout kernel's launch at N = n_lm as the card takes it:
    registers and local bytes a thread, shared bytes a block, worlds a
    block, and resident blocks and worlds an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); beside them the stack
    and spill bytes ptxas reports (``ptxas``: ptxas_report of both rollout
    sources). K1 and K2 must keep EKF_RESIDENT worlds on an SM, K4 SLAM
    UKF_SLAM_RESIDENT, without spilling."""
    rows, args = [], {}
    for name, (kind, mode, traj, targs) in EKF_INSTANCES.items():
        rows.append({"kernel": name, **fr.occupancy(n_lm, kind, mode, traj)})
        args[name] = targs
    for slam in (True, False):
        name = f"fused_ukf_rollout[{'slam' if slam else 'loc'}]"
        rows.append({"kernel": name, **fu.occupancy(n_lm, slam)})
        args[name] = "true" if slam else "false"
    for r in rows:
        kind = "ukf" if r["kernel"].startswith("fused_ukf") else "ekf"
        stem = f"fused_{kind}_rollout_kernel" + mangled_args(args[r["kernel"]])
        r.update(next(v for k_, v in ptxas.items() if stem in k_))
        emit("occupancy", n_lm=n_lm, **r)
    need = {"fused_ekf_rollout": EKF_RESIDENT, "fused_iekf_rollout": EKF_RESIDENT,
            "fused_ukf_rollout[slam]": UKF_SLAM_RESIDENT}
    for r in rows:
        if r["kernel"] in need and (r["worlds_per_sm"] < need[r["kernel"]]
                                    or r["spill_store_bytes"] or r["spill_load_bytes"]):
            raise AssertionError(f"{r['kernel']}: fewer than {need[r['kernel']]} "
                                 f"worlds an SM, or spills: {r}")
    return rows


def phase_tick_clocks(lms, cmds, n_lm: int, kernel_ms: dict) -> dict:
    """K4 SLAM and Loc, K1 and K2 at MAIN once each in the build that counts
    cycles by phase of the tick (the ``ukf_phase_clocks`` and
    ``ekf_phase_clocks`` lines): each phase's share of the cycles and that
    share of the default build's measured time."""
    runs = {
        "ukf_slam": lambda cfg: fu.phase_clocks(cfg, lms, cmds, 0, slam=True),
        "ukf_loc": lambda cfg: fu.phase_clocks(cfg, lms, cmds, 0, slam=False),
        **{kind + "_slam": (lambda cfg, kind=kind: fr.phase_clocks(
            cfg, lms, cmds, 0, filter_kind=kind)) for kind in fr.FILTER_KINDS},
    }
    out = {}
    for filt, run in runs.items():
        cycles, res = run(Config(num_iterations=MAIN["steps"]).replace(filter=filt))
        if not bool(torch.isfinite(res["err_sum"]).all()):
            raise AssertionError(f"{filt}: the phase-clock build's errors are not finite")
        total = sum(cycles.values())
        shares = {k_: v / total for k_, v in cycles.items()}
        out[filt] = shares
        emit(("ukf" if filt.startswith("ukf") else "ekf") + "_phase_clocks",
             filter=filt, **MAIN, n_lm=n_lm, cycles=cycles, shares=shares,
             kernel_ms=kernel_ms[filt],
             ms_by_share={k_: v * kernel_ms[filt] for k_, v in shares.items()})
    return out


def rollout_checks(kname: str, dev, n_lm: int):
    """One rollout kernel against its plain version on three configs at
    SMALL, then predicated against unpredicated and in-kernel Philox against
    the replayed stream."""
    filt, (ctr, key), _, _ = KERNELS[kname]
    # ---- 3. kernel vs plain version, injected noise, three configs:
    # the default build per world within TOL, over SMALL and over its
    # first SHORT ticks, on the worlds the plain version does not flag as
    # chaotic; the -fmad=false build bit for bit
    rng = np.random.default_rng(3)
    for cname, cfg in configs(SMALL["steps"]).items():
        t_phase = time.perf_counter()
        cfg = cfg.replace(filter=filt)
        lms, cmds = mc_inputs(cfg, SMALL["batch"], 3, dev)
        noise = torch.as_tensor(
            rng.uniform(-1, 1, (SMALL["steps"], 2 * n_lm + 8,
                                SMALL["batch"])).astype(np.float32),
            device=dev)
        before = ctr[key]
        k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        torch.cuda.synchronize()
        if ctr[key] != before + 1:
            raise AssertionError(f"{kname}: the wrapper did not launch the kernel")
        p, exempt = plain_run(cfg, lms, cmds, noise, TOL)
        errs = compare(k, p, TOL, exempt, AGG_RTOL)
        with _build.without_fma():
            k_nofma = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        same = bitwise(k_nofma, p, f"{kname} {cname} -fmad=false")
        cs, ns = cmds[:, :SHORT].contiguous(), noise[:SHORT].contiguous()
        p_short, exempt_short = plain_run(cfg, lms, cs, ns, TOL)
        errs_short = compare(fused_rollout(cfg, lms, cs, 0, noise=ns),
                             p_short, TOL, exempt_short)
        emit("kernel_vs_plain", kernel=kname, config=cname, **SMALL,
             seconds=time.perf_counter() - t_phase,
             n_lm=n_lm, worlds_with_2plus_landmarks=int(
                 (k["seen"].sum(1) >= 2).sum()), errors=errs,
             short_steps=SHORT, errors_short=errs_short,
             no_fma_bitwise_equal=same)

    # ---- 4. predicated == unpredicated, bit for bit (in-kernel noise),
    # ---- 5. in-kernel Philox == the replayed philox_noise stream
    cfg = configs(SMALL["steps"])["default"].replace(filter=filt)
    lms, cmds = mc_inputs(cfg, SMALL["batch"], 4, dev)
    a = fused_rollout(cfg, lms, cmds, 11)
    b = fused_rollout(cfg, lms, cmds, 11, predicated=False)
    nz = philox.philox_noise(11, SMALL["steps"], n_lm, SMALL["batch"], dev)
    c = fused_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    same = {k_: bool(torch.equal(a[k_], b[k_])) for k_ in a}
    replay = {k_: bool(torch.equal(a[k_], c[k_])) for k_ in a}
    emit("predicated_vs_unpredicated", kernel=kname, bitwise_equal=same)
    emit("philox_replay", kernel=kname, inkernel_equals_replay=replay)
    if not all(same.values()):
        raise AssertionError(f"{kname}: predication changed the result: {same}")
    if not all(replay.values()):
        raise AssertionError(f"{kname}: in-kernel Philox differs from the replay")


def philox_check(dev, n_lm: int):
    """The standalone Philox kernel against its torch version."""
    nz = philox.philox_noise(11, SMALL["steps"], n_lm, SMALL["batch"], dev)
    nz_ref = philox.philox_noise_reference(11, SMALL["steps"], n_lm,
                                           SMALL["batch"], dev)
    emit("philox", kernel_equals_torch=bool(torch.equal(nz, nz_ref)),
         mean=float(nz.mean()), var=float(nz.var()), min=float(nz.min()),
         max=float(nz.max()))
    if not torch.equal(nz, nz_ref):
        raise AssertionError("Philox stream differs between kernel and torch")
    if abs(float(nz.mean())) > 0.01 or abs(float(nz.var()) - 1 / 3) > 0.01:
        raise AssertionError("Philox noise moments are off")


# The checks whose results nothing later reads, by name, and the processes
# they run in: the plain versions they wait for are bound by the host (one
# Python thread issuing small launches), so processes side by side shorten
# the run to what the longest group takes; the card is shared among them.
# No kernel is timed meanwhile (the plain versions' host times are, and say
# so). The last group runs in the calling process.
SIDE_CHECKS = {
    **{kname: (lambda dev, n_lm, kname=kname: rollout_checks(kname, dev, n_lm))
       for kname in KERNELS},
    "philox": philox_check,
    "pose_stream": pose_stream_checks,
    **{f"pose_stream_main[{kind}]":
       (lambda dev, n_lm, kind=kind: pose_stream_main_check(kind, dev, n_lm))
       for kind in fr.FILTER_KINDS},
    "block_thomas": lambda dev, n_lm: block_thomas_checks(dev),
}
SIDE_GROUPS = (
    ("fused_ukf_rollout[slam]",),
    ("fused_ukf_rollout[loc]",),
    ("fused_ekf_rollout", "pose_stream_main[ekf]"),
    ("fused_iekf_rollout", "pose_stream_main[iekf]"),
    ("philox", "pose_stream", "block_thomas"),
)
SIDE_FLAG = "--side-checks"


def side_checks(dev, n_lm: int):
    """Every group of SIDE_GROUPS at once: all but the last as ``python3
    chip_smoke.py --side-checks NAME ...``, whose lines are printed when it
    has ended and whose failure fails the run; no process is left behind."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               SIDE_FLAG, *group], stdout=subprocess.PIPE, text=True)
             for group in SIDE_GROUPS[:-1]]
    pool = ThreadPoolExecutor(len(procs))
    try:
        outs = [pool.submit(p.communicate) for p in procs]
        for name in SIDE_GROUPS[-1]:
            SIDE_CHECKS[name](dev, n_lm)
        for group, p, out in zip(SIDE_GROUPS, procs, outs):
            text = out.result()[0]
            sys.stdout.write(text)
            sys.stdout.flush()
            LINES.extend(json.loads(line) for line in text.splitlines()
                         if line.startswith("{"))
            if p.returncode != 0:
                raise AssertionError(f"the side checks {group} ended with "
                                     f"code {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.shutdown()  # every communicate() has returned: no process is left
    emit("side_checks", seconds=time.perf_counter() - t0, groups=SIDE_GROUPS)


def side_main(names: list):
    """The process of one group: the named checks on the libraries the
    caller built, their lines on the standard output."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    pin_fp32()
    _build.load()
    n_lm = Config().map.num_landmarks
    for name in names:
        t0 = time.perf_counter()
        SIDE_CHECKS[name](torch.device("cuda"), n_lm)
        emit("side_check", name=name, seconds=time.perf_counter() - t0)


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    pin_fp32()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card()
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    t_start = time.perf_counter()

    # ---- 2. build every kernel from the checkout's sources: the default
    # build the port runs and the -fmad=false build of the bitwise checks,
    # one nvcc each, side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        libs = list(pool.map(_build.build, [(), _build.NO_FMA, _build.PHASE_CLOCKS]))
        ptxas = {}
        for rep in pool.map(ptxas_report, ["fused_ekf_rollout.cu", "fused_ukf_rollout.cu"]):
            ptxas.update(rep)
    _build.load()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(lib.relative_to(_build.CSRC.parent.parent)) for lib in libs])
    n_lm = Config().map.num_landmarks
    phase_occupancy(n_lm, ptxas)

    # ---- 3-5. the checks that feed nothing later, in processes side by side
    side_checks(dev, n_lm)

    # ---- 6. the main path, once per filter, through its kernel; the counts
    # read right after run_monte_carlo are that path's own
    base = Config(num_iterations=MAIN["steps"])
    lms, cmds = mc_inputs(base, MAIN["batch"], 0, dev, shared=True, relabel=True)
    gates = gate_counts(base, lms, cmds, 0)
    record = []
    for kname, (filt, (ctr, key), src, replaces) in KERNELS.items():
        cfg = base.replace(filter=filt)
        zero_counts()
        t0 = time.perf_counter()
        res, out, _ = run_monte_carlo(cfg, MAIN["batch"], seed=0, device=dev,
                                      protocol="shared")
        torch.cuda.synchronize()
        mc_s = time.perf_counter() - t0
        launches = counts()
        want = {k_: int(k_ == kname) for k_ in launches}
        if launches != want:
            raise AssertionError(
                f"{filt}: the main path launched {launches}, not once {kname}")
        err = res["err_" + filt]
        if not np.isfinite(err).all():
            raise AssertionError(f"{filt}: non-finite average errors")
        du = fu.state_dim(n_lm, filt == "ukf_slam") if filt.startswith("ukf") \
            else 3 + 2 * n_lm
        if tuple(out["x"].shape) != (MAIN["batch"], du):
            raise AssertionError(f"{filt}: state shape {tuple(out['x'].shape)}")
        extra = {}
        if filt.startswith("ukf"):
            P = out["P"]
            extra["P_exactly_symmetric"] = bool(torch.equal(P, P.transpose(1, 2)))
            if not extra["P_exactly_symmetric"]:
                raise AssertionError(f"{filt}: P is not exactly symmetric")
            rej = out["update_rejects"]
            extra["worlds_with_rejects_share"] = float((rej > 0).float().mean())
            extra["update_rejects_total"] = float(rej.sum())
            # world -> refusals, for the few worlds that refuse
            extra["rejecting_worlds"] = {
                int(i): float(rej[i]) for i in torch.nonzero(rej > 0).flatten()[:16]}
        host_s, ms, _ = time_rollouts(cfg, lms, cmds, "cuda", REPS)
        emit("main_path", filter=filt, kernel=kname, **MAIN, n_lm=n_lm,
             protocol="shared", run_monte_carlo_s=mc_s,
             steps_per_s_per_world=MAIN["steps"] / float(np.median(host_s)),
             rep_s=host_s, kernel_ms=ms,
             mean_avg_pos_err_m=float(err.mean()),
             std_avg_pos_err_m=float(err.std()),
             diverged=int(res["diverged_" + filt].sum()), launches=launches,
             **extra)

        # kernel vs plain at the main path's shape: the first 256 worlds of
        # that run, the plain version replaying their slice of the kernel's
        # Philox stream (worlds are independent); and the -fmad=false build
        # on those worlds, bit for bit
        lw = lms[:PLAIN_WORLDS].contiguous()
        cw = cmds[:PLAIN_WORLDS].contiguous()
        k = {k_: v[:PLAIN_WORLDS] for k_, v in out.items()}
        noise = philox.philox_noise_reference(0, MAIN["steps"], n_lm,
                                              PLAIN_WORLDS, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, exempt = plain_run(cfg, lw, cw, noise, TOL_MAIN)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        # the UKFs' plain time is that of the run and its nudged twin in one
        # batch, with the chaos flags' eigenvalues
        plain_worlds = PLAIN_WORLDS * (2 if filt.startswith("ukf") else 1)
        errs = compare(k, p, TOL_MAIN, exempt)
        with _build.without_fma():
            same = bitwise(fused_rollout(cfg, lw, cw, 0), p,
                           f"{kname} main shape -fmad=false")
        outputs = [o for o in TOL_MAIN]
        worst = max(outputs, key=lambda o: errs[o]["max_abs_err"])
        d_avg = (k["err_sum"] - p["err_sum"]).abs() / MAIN["steps"]
        emit("kernel_vs_plain_main_shape", kernel=kname, worlds=PLAIN_WORLDS,
             steps=MAIN["steps"], plain_ms=p_ms, plain_worlds=plain_worlds,
             errors=errs,
             exempt_share=errs["worlds_exempt"] / PLAIN_WORLDS,
             max_abs_err_output=worst, no_fma_bitwise_equal=same,
             avg_err_max_abs_diff_m=float(d_avg.max()),
             avg_err_median_abs_diff_m=float(d_avg.median()))

        flops, nbytes = work(filt, gates, MAIN["batch"], MAIN["steps"], n_lm)
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        record.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[worst]["max_abs_err"],
            "max_abs_err_checked": max(errs[o]["max_abs_err_checked"] or 0.0
                                       for o in outputs),
            "worlds_exempt": errs["worlds_exempt"],
            "ms": float(np.median(ms)), "plain_ms": p_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "plain_worlds": plain_worlds, "plain_steps": MAIN["steps"],
        })
    emit("gate_counts", **MAIN, **gates)
    kernel_ms = {KERNELS[r["name"]][0]: r["ms"] for r in record}
    phase_tick_clocks(lms, cmds, n_lm, kernel_ms)

    # ---- 6b. the kernel-attribution path: the profile modes of K1 and K2,
    # the standalone primitives, and the sum of a tick's passes
    k1p_record, times = phase_attribution(dev, n_lm, base, lms, cmds, gates)
    record += k1p_record + phase_micro_ops(dev)
    phase_op_sum(dev, n_lm, gates, times, kernel_ms)

    # ---- 7. the pose-graph main path and its kernels
    pg_record, philox_launches = pose_graph_paths(dev, n_lm)
    record += pg_record

    # the standalone Philox kernel: the rollouts draw in-kernel, the
    # pose-graph path launches it once per world chunk
    args = (0, MAIN["steps"], n_lm, MAIN["batch"], dev)
    philox.philox_noise(*args)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    nz = philox.philox_noise(*args)
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nz_ref = philox.philox_noise_reference(*args)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = 4.0 * nz.numel()
    record.append({
        "name": "philox_noise", "route": "cuda",
        "source": SRC + "philox_noise.cu",
        "replaces": "live_ekf_slam_tpu/ops/fused_rollout.py:160",
        "launches": philox_launches,
        "max_abs_err": float((nz - nz_ref).abs().max()),
        "ms": e0.elapsed_time(e1), "plain_ms": p_ms,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
        "library_ms": None, "bytes": nbytes,
    })
    emit("wall", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == [SIDE_FLAG]:
        side_main(sys.argv[2:])
    else:
        main()
