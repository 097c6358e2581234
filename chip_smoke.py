"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``live_ekf_slam_tpu_torch/csrc`` with
nvcc and holds each rollout kernel (EKF-SLAM, RI-EKF-SLAM, UKF-SLAM,
UKF-Loc) against its plain torch version: on three configs with injected
noise, predicated against unpredicated, in-kernel Philox against the
replayed stream, and a build with FMA contraction off against the plain
version bit for bit; the same for the EKF kernels' pose stream and for the
block-Thomas factor and solve kernels on the blocks of real graphs. Then it
drives the main paths. ``run_monte_carlo`` at 4096 worlds, T = 1000, N = 20
under the bench's shared protocol, once per filter, each through its own
kernel, timed, the kernel compared with the plain version on the first 256
worlds of that run. ``run_monte_carlo_pg_streams``, the pose-graph study, at
1024 worlds with the EKF-SLAM secondary (twice: the results must repeat),
and at 256 worlds with the naive and RI-EKF secondaries and in iterative
mode, with the launch counts each run implies. Every phase prints one JSON
line; any failure raises and the exit code is nonzero. The last three
lines are the kernels' record, the card's name and power limit as
nvidia-smi reports them, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repository beside it, it fails
before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor

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
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim.streams import sim_streams

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


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def counts() -> dict:
    out = {name: c[key] for name, (_, (c, key), _, _) in KERNELS.items()}
    out.update({name: c[key] for name, (c, key, _, _) in PG_KERNELS.items()})
    out["philox_noise"] = philox.launches
    return out


def zero_counts():
    for c in (fr.launches, fu.launches, pg.launches):
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


def plain_run(cfg, lms, cmds, noise, tol: dict, p: dict | None = None
              ) -> tuple[dict, torch.Tensor | None]:
    """The plain version's run on these inputs and, for the UKFs, the worlds
    it flags as chaotic (see NUDGE); None for the EKFs, which have none.
    Unless its run ``p`` is given, the run and the nudged one go in one
    batch of twice the worlds (the plain version's time is launch-bound)."""
    if not cfg.filter.startswith("ukf"):
        return (p if p is not None else
                fused_rollout(cfg, lms, cmds, 0, noise=noise, plain=True)), None
    nudged = noise * NUDGE
    if p is None:
        b = lms.shape[0]
        both = fused_rollout(cfg, torch.cat([lms, lms]), torch.cat([cmds, cmds]),
                             0, noise=torch.cat([noise, nudged], dim=2).contiguous(),
                             plain=True)
        p = {k: v[:b] for k, v in both.items()}
        p_nudged = {k: v[b:] for k, v in both.items()}
    else:
        p_nudged = fused_rollout(cfg, lms, cmds, 0, noise=nudged, plain=True)
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
    powers), replayed from the simulator and the kernels' Philox stream."""
    b, n, _ = lms.shape
    t_total = cmds.shape[1]
    noise = philox.philox_noise_reference(seed, t_total, n, b, lms.device)
    kp = kernel_params(cfg)  # the plain versions' float32 constants
    tx = torch.full((b,), kp.x0, dtype=torch.float32, device=lms.device)
    ty = torch.full_like(tx, kp.y0)
    tth = torch.full_like(tx, kp.yaw0)
    seen = torch.zeros((b, n), dtype=torch.bool, device=lms.device)
    tot = {k: 0.0 for k in ("updates", "insertions", "visible", "act1",
                            "act2", "act3", "act1u", "act2u")}
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
        for key, v in (("updates", n_upd), ("insertions", (vis & ~seen).sum(dim=1)),
                       ("visible", vis.sum(dim=1)), ("act1", n_act),
                       ("act2", n_act ** 2), ("act3", n_act ** 3),
                       ("act1u", n_upd * n_act), ("act2u", n_upd * n_act ** 2)):
            tot[key] += float(v.sum())
        seen |= vis
    tot["ticks"] = float(b * t_total)
    return tot


def work(filt: str, g: dict, b: int, t_total: int, n: int) -> tuple[float, float]:
    """(flops, bytes) the rollout of ``filt`` must do on these inputs: ops
    per event read off the algebra (the kernels' source notes), times the
    events the plain versions' gates count; bytes are each input read once
    and each output written once (noise is drawn in-kernel)."""
    d = 3 + 2 * n
    ticks = g["ticks"]
    sense = 40.0 * n * ticks + 20.0 * ticks  # per landmark and tick; truth, error
    if filt == "ekf_slam":
        # predict: two rank-1 row and two column passes; update: gain and
        # H P (~34 D) and the rank-2 downdate (4 D^2); insertion: two rows
        flops = sense + 8.0 * d * ticks + g["updates"] * (4.0 * d * d + 34.0 * d) \
            + g["insertions"] * (4.0 * d + 30.0)
    elif filt == "iekf_slam":
        # predict: one full rank-1 pass (2 D^2); update: ~19 D of gain,
        # retraction and H P, the rank-2 downdate (4 D^2); insertion: ~30
        flops = sense + (2.0 * d * d + 3.0 * d) * ticks \
            + g["updates"] * (4.0 * d * d + 19.0 * d + 60.0) + g["insertions"] * 30.0
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
    # the pose stream, and the streams against the plain version's
    for kind, batch, ls in (("ekf", PG_MAIN["batch"], launches),
                            ("iekf", PG_SIDE, launches_iekf)):
        name = f"fused_{kind}_rollout[emit_traj]"
        filt = kind + "_slam"
        cfg = pg_config(PG_MAIN["steps"], filt, False)
        lms, cmds = mc_inputs(cfg, batch, 0, dev)
        noise = philox.philox_noise(0, PG_MAIN["steps"], n_lm, batch, dev)
        kw = dict(noise=noise, filter_kind=kind)
        ms = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw))
        ms_off = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw))
        w = min(batch, PLAIN_WORLDS)
        lw, cw = lms[:w].contiguous(), cmds[:w].contiguous()
        nw = noise[:, :, :w].contiguous()
        k = fr.fused_ekf_rollout(cfg, lw, cw, 0, emit_traj=True, noise=nw, filter_kind=kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = fr.fused_ekf_rollout_reference(cfg, lw, cw, 0, emit_traj=True,
                                           noise=nw, filter_kind=kind)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        errs = compare(stream_of(k), stream_of(p),
                       {o: TOL_MAIN[o] for o in ("x", "true_pose")})
        with _build.without_fma():
            same = bitwise(fr.fused_ekf_rollout(cfg, lw, cw, 0, emit_traj=True,
                                                noise=nw, filter_kind=kind),
                           p, f"{name} main shape -fmad=false")
        gates = gate_counts(cfg, lms, cmds, 0)
        flops, nbytes = work(filt, gates, batch, PG_MAIN["steps"], n_lm)
        # beside the rollout's own traffic: the injected noise read once,
        # the two pose streams written once
        nbytes += 4.0 * noise.numel() + 2 * 4.0 * batch * PG_MAIN["steps"] * 3
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        emit("pose_stream_main_shape", kernel=name, batch=batch,
             steps=PG_MAIN["steps"], ms=ms, ms_without_stream=ms_off,
             plain_ms=p_ms, plain_worlds=w, est_traj=errs["x"],
             true_traj=errs["true_pose"], no_fma_bitwise_equal=same)
        record.append({
            "name": name, "route": "cuda", "source": PG_KERNELS[name][2],
            "replaces": PG_KERNELS[name][3], "launches": ls[name],
            "max_abs_err": max(errs[o]["max_abs_err"] for o in ("x", "true_pose")),
            "ms": ms, "ms_without_stream": ms_off, "plain_ms": p_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "batch": batch, "plain_worlds": w, "plain_steps": PG_MAIN["steps"],
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
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.build, [(), _build.NO_FMA]))
    _build.load()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(lib.relative_to(_build.CSRC.parent.parent)) for lib in libs])

    n_lm = Config().map.num_landmarks
    for kname, (filt, (ctr, key), _, _) in KERNELS.items():
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

    # the standalone Philox kernel against its torch version
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

    # the pose stream (K3) and the block-Thomas kernels (P1) against their
    # plain versions
    pose_stream_checks(dev, n_lm)
    block_thomas_checks(dev)

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
        p = fused_rollout(cfg, lw, cw, 0, noise=noise, plain=True)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        _, exempt = plain_run(cfg, lw, cw, noise, TOL_MAIN, p)
        errs = compare(k, p, TOL_MAIN, exempt)
        with _build.without_fma():
            same = bitwise(fused_rollout(cfg, lw, cw, 0), p,
                           f"{kname} main shape -fmad=false")
        outputs = [o for o in TOL_MAIN]
        worst = max(outputs, key=lambda o: errs[o]["max_abs_err"])
        d_avg = (k["err_sum"] - p["err_sum"]).abs() / MAIN["steps"]
        emit("kernel_vs_plain_main_shape", kernel=kname, worlds=PLAIN_WORLDS,
             steps=MAIN["steps"], plain_ms=p_ms, errors=errs,
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
            "plain_worlds": PLAIN_WORLDS, "plain_steps": MAIN["steps"],
        })
    emit("gate_counts", **MAIN, **gates)

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
    main()
