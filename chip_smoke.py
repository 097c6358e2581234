"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``live_ekf_slam_tpu_torch/csrc`` with
nvcc, holds each against its plain torch version, then drives the main path
(``run_monte_carlo`` at 4096 worlds, T = 1000, N = 20, the bench's shared
protocol and seeds) through the kernel. Every phase prints one JSON line;
any failure raises and the exit code is nonzero. The last three lines are the
kernels' record, the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside it, it fails before printing any result.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import card, time_rollouts
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs, run_monte_carlo
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

# Kernel vs plain version (B = 250, T = 200, N = 20, injected noise), as
# |kernel - plain| <= atol + rtol * scale, where scale is the plain value for
# the per-world scalars and, for a vector or matrix output, its largest
# magnitude in that world (covariance entries near zero are differences of
# large terms; their error follows the matrix's scale, not their own). Both
# versions run the same float32 algebra in the same order; they differ
# because nvcc contracts a*b + c into one FMA (one rounding instead of two),
# and 200 ticks of sequential updates carry those last-bit differences
# along. `seen` must match exactly.
TOL = {
    "true_pose": (1e-5, 1e-5),
    "err_sum": (1e-3, 1e-3),
    "err_max": (1e-3, 1e-4),
    "x": (1e-4, 1e-4),
    "P": (1e-3, 1e-6),
}
# The same at the main path's shape (B = 4096, T = 1000, in-kernel Philox
# replayed by the plain version): five times as many ticks of feedback carry
# the FMA differences further. Measured on an H100: per-world average errors
# within 0.9 mm of each other, median 1.2e-5 m.
TOL_MAIN = {
    "true_pose": (1e-4, 1e-4),
    "err_sum": (3e-2, 1e-2),
    "err_max": (3e-2, 1e-3),
    "x": (1e-3, 1e-3),
    "P": (1e-2, 1e-5),
}
SMALL = dict(batch=250, steps=200)        # 250: not a multiple of 4 worlds
MAIN = dict(batch=4096, steps=1000)       # the bench's size
REPS = 5
KERNEL_SRC = "live_ekf_slam_tpu_torch/csrc/fused_ekf_rollout.cu"
REPLACES = "live_ekf_slam_tpu/ops/fused_rollout.py:625"


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def configs():
    base = Config(num_iterations=SMALL["steps"])
    return {
        "default": base,
        "compat": base.replace(compat=CompatConfig.all_on()),
        "calibrated": base.replace(calibrated_motion=True),
    }


def scale(ref: torch.Tensor) -> torch.Tensor:
    """Per-world magnitude an output's error is measured against."""
    if ref.dim() == 1:
        return ref.abs()
    return ref.abs().amax(dim=tuple(range(1, ref.dim())), keepdim=True)


def compare(k: dict, p: dict, tol: dict) -> dict:
    """Max abs error and worst tolerance ratio of each output; raises if any
    output is out of tolerance or `seen` differs."""
    if not torch.equal(k["seen"], p["seen"]):
        raise AssertionError("seen differs between kernel and plain version")
    out, bad = {}, []
    for name, (rtol, atol) in tol.items():
        d = (k[name] - p[name]).abs()
        r = d / (atol + rtol * scale(p[name]))
        i = int(r.argmax())
        out[name] = {"max_abs_err": float(d.max()), "tol_ratio": float(r.max()),
                     "at_scale": float(scale(p[name]).expand_as(d).flatten()[i])}
        if not float(r.max()) <= 1.0:
            bad.append(name)
    if bad:
        raise AssertionError(f"{bad} out of tolerance: {out}")
    return out


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

    # ---- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(lib_path.relative_to(_build.CSRC.parent.parent)))

    # ---- 3. kernel vs plain version, injected noise, three configs
    rng = np.random.default_rng(3)
    n_lm = Config().map.num_landmarks
    for cname, cfg in configs().items():
        lms, cmds = mc_inputs(cfg, SMALL["batch"], 3, dev)
        noise = torch.as_tensor(
            rng.uniform(-1, 1, (SMALL["steps"], 2 * n_lm + 8,
                                SMALL["batch"])).astype(np.float32),
            device=dev)
        before = fr.launches
        k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise)
        torch.cuda.synchronize()
        if fr.launches != before + 1:
            raise AssertionError("the wrapper did not launch the kernel")
        p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, noise=noise)
        torch.cuda.synchronize()
        errs = compare(k, p, TOL)
        emit("kernel_vs_plain", config=cname, **SMALL, n_lm=n_lm,
             worlds_with_2plus_landmarks=int(
                 (k["seen"].sum(1) >= 2).sum()), errors=errs)

    # ---- 4. predicated == unpredicated, bit for bit (in-kernel noise)
    cfg = configs()["default"]
    lms, cmds = mc_inputs(cfg, SMALL["batch"], 4, dev)
    a = fr.fused_ekf_rollout(cfg, lms, cmds, 11)
    b = fr.fused_ekf_rollout(cfg, lms, cmds, 11, predicated=False)
    torch.cuda.synchronize()
    same = {k_: bool(torch.equal(a[k_], b[k_])) for k_ in a}
    emit("predicated_vs_unpredicated", bitwise_equal=same)
    if not all(same.values()):
        raise AssertionError(f"predication changed the result: {same}")

    # ---- 5. in-kernel Philox == replayed philox_noise; kernel == torch
    nz = philox.philox_noise(11, SMALL["steps"], n_lm, SMALL["batch"], dev)
    nz_ref = philox.philox_noise_reference(11, SMALL["steps"], n_lm,
                                           SMALL["batch"], dev)
    c = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    replay = {k_: bool(torch.equal(a[k_], c[k_])) for k_ in a}
    emit("philox", kernel_equals_torch=bool(torch.equal(nz, nz_ref)),
         inkernel_equals_replay=replay, mean=float(nz.mean()),
         var=float(nz.var()), min=float(nz.min()), max=float(nz.max()))
    if not torch.equal(nz, nz_ref) or not all(replay.values()):
        raise AssertionError("Philox stream differs between kernel and torch")
    if abs(float(nz.mean())) > 0.01 or abs(float(nz.var()) - 1 / 3) > 0.01:
        raise AssertionError("Philox noise moments are off")

    # ---- 6. the main path, through the kernel; the counts read here are the
    # main path's own, before any timing or comparison launches
    cfg = Config(num_iterations=MAIN["steps"])
    fr.launches = 0
    philox.launches = 0
    t0 = time.perf_counter()
    res, out, _ = run_monte_carlo(cfg, MAIN["batch"], seed=0, device=dev,
                                  protocol="shared")
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    launches = {"fused_ekf_rollout": fr.launches,
                "philox_noise": philox.launches}
    if launches["fused_ekf_rollout"] != 1:
        raise AssertionError(
            f"the main path launched the kernel {launches} times, not once")
    err = res["err_ekf_slam"]
    if not np.isfinite(err).all():
        raise AssertionError("non-finite average errors on the main path")
    if out["x"].shape != (MAIN["batch"], 3 + 2 * n_lm):
        raise AssertionError(f"unexpected state shape {tuple(out['x'].shape)}")
    lms, cmds = mc_inputs(cfg, MAIN["batch"], 0, dev, shared=True,
                          relabel=True)
    host_s, ms, _ = time_rollouts(cfg, lms, cmds, "cuda", REPS)
    emit("main_path", **MAIN, n_lm=n_lm, protocol="shared",
         run_monte_carlo_s=mc_s,
         steps_per_s_per_world=MAIN["steps"] / float(np.median(host_s)),
         rep_s=host_s, kernel_ms=ms,
         mean_avg_pos_err_m=float(err.mean()),
         std_avg_pos_err_m=float(err.std()),
         diverged=int(res["diverged_ekf_slam"].sum()), launches=launches)

    # kernel vs plain at the main path's shape: same inputs, the plain
    # version replaying the kernel's Philox stream
    _, (k_ms,), k = time_rollouts(cfg, lms, cmds, "cuda", 1)
    _, (p_ms,), p = time_rollouts(cfg, lms, cmds, "plain", 1)
    errs = compare(k, p, TOL_MAIN)
    worst = max(errs, key=lambda o: errs[o]["max_abs_err"])
    d_avg = (k["err_sum"] - p["err_sum"]).abs() / MAIN["steps"]
    emit("kernel_vs_plain_main_shape", kernel_ms=k_ms, plain_ms=p_ms,
         errors=errs, max_abs_err_output=worst,
         avg_err_max_abs_diff_m=float(d_avg.max()),
         avg_err_median_abs_diff_m=float(d_avg.median()))

    # max_abs_err: the largest |kernel - plain| over every output compared
    # at the main path's shape (named in the line above)
    print(json.dumps({"kernels": [{
        "name": "fused_ekf_rollout", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches["fused_ekf_rollout"],
        "max_abs_err": errs[worst]["max_abs_err"],
        "ms": float(np.median(ms)), "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
