"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``live_ekf_slam_tpu_torch/csrc`` with
nvcc and holds each rollout kernel (EKF-SLAM, RI-EKF-SLAM, UKF-SLAM,
UKF-Loc) against its plain torch version: on three configs with injected
noise, predicated against unpredicated, in-kernel Philox against the
replayed stream, and a build with FMA contraction off against the plain
version bit for bit. Then it drives the main path, ``run_monte_carlo`` at
4096 worlds, T = 1000, N = 20 under the bench's shared protocol, once per
filter, each through its own kernel, times it, and compares the kernel with
the plain version on the first 256 worlds of that run. Every phase prints one
JSON line; any failure raises and the exit code is nonzero. The last three
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

from live_ekf_slam_tpu_torch.bench import card, time_rollouts
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import kernel_params
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo,
)
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

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
SMALL = dict(batch=250, steps=200)        # 250: not a multiple of 4 worlds
SHORT = 25                                # ticks, before most chaos sets in
MAIN = dict(batch=4096, steps=1000)       # the bench's size
PLAIN_WORLDS = 256                        # the main-shape comparison's worlds
REPS = 5
# H100 SXM peaks (NVIDIA data sheet, dense): fp32 without tensor cores, HBM
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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


def counts() -> dict:
    out = {name: c[key] for name, (_, (c, key), _, _) in KERNELS.items()}
    out["philox_noise"] = philox.launches
    return out


def zero_counts():
    for c in (fr.launches, fu.launches):
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

    # the standalone Philox kernel (checks only: the rollouts draw in-kernel)
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
        "launches": 0, "max_abs_err": float((nz - nz_ref).abs().max()),
        "ms": e0.elapsed_time(e1), "plain_ms": p_ms,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
        "library_ms": None, "bytes": nbytes, "on_main_path": False,
    })
    emit("wall", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
