"""Parameters and state carried between the JAX layout, numpy and the port.

This system has no learned weights. What the TPU kernels close over
(``live_ekf_slam_tpu/ops/fused_rollout.py:93-113`` and
``live_ekf_slam_tpu/ops/fused_ukf.py:76-99``: filter noise, sim noise
half-widths, command and vision limits, compat flags, initial pose) are the
rollouts' parameters. ``kernel_params`` packs the EKF and RI-EKF kernel's into
the struct that kernel takes, ``ukf_kernel_params`` the UKF kernel's; each
plain version reads the same struct, so both sides see the same float32
constants.

The pose-graph slice adds the state itself: ``posegraph_state_from_numpy``
turns a JAX ``PoseGraphState`` (its fields as numpy arrays, one world or a
``vmap`` batch) into the port's batched one, ``streams_from_numpy`` the JAX
``sim_streams`` dict into the port's tensors.

The kernel-attribution slice adds ``micro_inputs_from_numpy`` and
``micro_output_to_numpy``, which carry the microbenchmark scripts' world-minor
arrays into the port's world-major layout and back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from live_ekf_slam_tpu_torch.core.noise import (
    S3,
    calibrated_meas_vars,
    use_calibrated,
)
from live_ekf_slam_tpu_torch.core.types import PoseGraphState

_FLOAT_FIELDS = (
    # filter noise variances (compat V/W swap and calibrated W applied)
    "v00f", "v11f", "w00f", "w11f",
    # simulator noise half-widths times sim_noise_scale
    "v00s", "v11s", "w00s", "w11s",
    # command / measurement noise means
    "v_d", "v_th", "w_r", "w_b",
    # command and vision limits
    "d_max", "th_max", "r_max", "fov_min", "fov_max",
    # initial pose
    "x0", "y0", "yaw0",
    # calibrated motion (core/noise.motion_moments): the clip half-widths and
    # their products, taken in double and rounded once as the JAX code does
    "cm_v_fwd", "cm_2v_fwd", "cm_4v_fwd", "cm_6v_fwd", "cm_floor_fwd",
    "cm_v_hdg", "cm_2v_hdg", "cm_4v_hdg", "cm_6v_hdg", "cm_floor_hdg",
)
_INT_FIELDS = ("calibrated", "stale", "wrap_innov")


class KernelParams(ctypes.Structure):
    """Mirror of ``struct EkfParams`` in ``csrc/fused_ekf_rollout.cu``."""

    _fields_ = ([(f, ctypes.c_float) for f in _FLOAT_FIELDS]
                + [(f, ctypes.c_int) for f in _INT_FIELDS])


def _check_known_ids(cfg):
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError("fused rollout requires known landmark ids")


def _filter_noise(cfg):
    """((v00f, v11f), (w00f, w11f), calibrated): the filter noise after the
    compat V/W swap, with the true U(-W, W) variances under calibrated
    motion."""
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    calibrated = use_calibrated(cfg)
    if calibrated:
        w00f, w11f = calibrated_meas_vars(cfg)
    return (v00f, v11f), (w00f, w11f), calibrated


def _shared_fields(cfg) -> dict:
    """The fields both kernels take by the same rules: sim noise, means,
    limits, initial pose and the calibrated-motion constants."""
    nz = cfg.sim_noise_scale
    pn, sn = cfg.process_noise, cfg.sensing_noise
    cmd, vis = cfg.constraints.commands, cfg.constraints.vision
    x0, y0, yaw0 = cfg.init_pose
    v_fwd, v_hdg = pn.V_00, pn.V_11
    return dict(
        v00s=pn.V_00 * nz, v11s=pn.V_11 * nz,
        w00s=sn.W_00 * nz, w11s=sn.W_11 * nz,
        v_d=pn.v_d, v_th=pn.v_th, w_r=sn.w_r, w_b=sn.w_b,
        d_max=cmd.d_max, th_max=cmd.th_max,
        r_max=vis.range_max, fov_min=vis.fov_min, fov_max=vis.fov_max,
        x0=x0, y0=y0, yaw0=yaw0,
        cm_v_fwd=v_fwd, cm_2v_fwd=2.0 * v_fwd, cm_4v_fwd=4.0 * v_fwd,
        cm_6v_fwd=6.0 * v_fwd, cm_floor_fwd=0.1 * v_fwd / S3,
        cm_v_hdg=v_hdg, cm_2v_hdg=2.0 * v_hdg, cm_4v_hdg=4.0 * v_hdg,
        cm_6v_hdg=6.0 * v_hdg, cm_floor_hdg=0.1 * v_hdg / S3,
    )


def kernel_params(cfg) -> KernelParams:
    """The EKF / RI-EKF rollout's parameters for ``cfg``, by the rules of the
    TPU kernel (fused_rollout.py:93-113). The RI-EKF reads the same struct
    and ignores ``stale`` and ``wrap_innov`` (fused_rollout.py:91-92)."""
    _check_known_ids(cfg)
    (v00f, v11f), (w00f, w11f), calibrated = _filter_noise(cfg)
    return KernelParams(
        v00f=v00f, v11f=v11f, w00f=w00f, w11f=w11f, **_shared_fields(cfg),
        calibrated=int(calibrated),
        stale=int(cfg.compat.ekf_stale_landmarks),
        wrap_innov=int(not cfg.compat.ekf_unwrapped_innovation),
    )


_UKF_FLOAT_FIELDS = (
    # filter noise variances (compat V/W swap and calibrated W applied), and
    # the update's determinant gate min(1e-12, 1e-6 w00f w11f)
    "v00f", "v11f", "w00f", "w11f", "det_gate",
    "v00s", "v11s", "w00s", "w11s",
    # noise means, and cos / sin of the bearing mean w_b (z_of's rotation)
    "v_d", "v_th", "w_r", "w_b", "wbc", "wbs",
    "d_max", "th_max", "r_max", "fov_min", "fov_max",
    # initial pose, and the initial state's heading direction
    "x0", "y0", "yaw0", "cyaw0", "syaw0",
    # sigma-point weight of the centre, and float32(1 - W_0)
    "w0", "one_m_w0",
    "cm_v_fwd", "cm_2v_fwd", "cm_4v_fwd", "cm_6v_fwd", "cm_floor_fwd",
    "cm_v_hdg", "cm_2v_hdg", "cm_4v_hdg", "cm_6v_hdg", "cm_floor_hdg",
)
_UKF_INT_FIELDS = ("calibrated", "zero_b_mean", "committed_yaw", "signed_q")


class UkfParams(ctypes.Structure):
    """Mirror of ``struct UkfParams`` in ``csrc/fused_ukf_rollout.cu``."""

    _fields_ = ([(f, ctypes.c_float) for f in _UKF_FLOAT_FIELDS]
                + [(f, ctypes.c_int) for f in _UKF_INT_FIELDS])


def ukf_kernel_params(cfg) -> UkfParams:
    """The UKF rollout's parameters for ``cfg``, by the rules of the TPU
    kernel (fused_ukf.py:76-99). Products of Python floats are taken in
    double and rounded once, as the JAX kernel's constants are."""
    _check_known_ids(cfg)
    (v00f, v11f), (w00f, w11f), calibrated = _filter_noise(cfg)
    shared = _shared_fields(cfg)
    w0 = cfg.ukf.W_0
    compat = cfg.compat
    return UkfParams(
        v00f=v00f, v11f=v11f, w00f=w00f, w11f=w11f,
        det_gate=min(1e-12, 1e-6 * w00f * w11f), **shared,
        wbc=math.cos(shared["w_b"]), wbs=math.sin(shared["w_b"]),
        cyaw0=math.cos(shared["yaw0"]), syaw0=math.sin(shared["yaw0"]),
        w0=w0, one_m_w0=float(np.float32(1.0 - w0)),
        calibrated=int(calibrated),
        zero_b_mean=int(compat.ukf_zero_bearing_mean),
        committed_yaw=int(compat.ukf_committed_yaw_in_sensing),
        signed_q=int(compat.ukf_signed_process_noise),
    )


def inputs_from_numpy(landmarks, cmds, noise=None, device="cpu"):
    """(B, N, 2) maps, (B, T, 2) commands and optional (T, 2N+8, B) noise
    -> contiguous float32 tensors on ``device``, in the same layouts."""
    def conv(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, np.float32), device=device
        )

    return conv(landmarks), conv(cmds), (None if noise is None else conv(noise))


def outputs_to_numpy(res: dict) -> dict:
    """Rollout result -> numpy in the JAX public layout and dtypes: float32
    everywhere, ``seen`` bool."""
    out = {}
    for k, v in res.items():
        a = v.detach().cpu().numpy()
        out[k] = a.astype(bool) if k == "seen" else a.astype(np.float32)
    return out


_PG_DTYPES = {
    "odom_valid": torch.bool, "meas_valid": torch.bool, "solved": torch.bool,
    "meas_lm": torch.int32, "ids": torch.int32, "M": torch.int32,
    "timestep": torch.int32,
}


def posegraph_state_from_numpy(state, device="cpu") -> PoseGraphState:
    """A JAX ``PoseGraphState`` (any object with its fields, as arrays) ->
    the port's, on ``device``. A single world (``poses_init`` of rank 2)
    gains the leading world axis."""
    single = np.asarray(state.poses_init).ndim == 2
    fields = {}
    for f in dataclasses.fields(PoseGraphState):
        a = np.asarray(getattr(state, f.name))
        if single:
            a = a[None]
        fields[f.name] = torch.tensor(  # a copy: jax's arrays are read-only
            a, dtype=_PG_DTYPES.get(f.name, torch.float32), device=device)
    return PoseGraphState(**fields)


def streams_from_numpy(streams: dict, device="cpu") -> dict:
    """The JAX ``sim_streams`` dict of a ``vmap`` batch (poses_true (B, T, 3),
    r, b, vis (B, T, N), noise_u (B, T, 2N+8)), or of one world without the
    leading axis, -> the port's tensors: the same keys, and ``noise``
    (T, 2N+8, B), the rollout kernels' injection layout, in place of
    ``noise_u``."""
    out = {}
    for k, v in streams.items():
        a = np.asarray(v)
        if a.ndim == 2:
            a = a[None]
        if k == "noise_u":
            k, a = "noise", a.transpose(1, 2, 0)
        t = torch.tensor(a, device=device)  # a copy: jax's arrays are read-only
        out[k] = t if k == "vis" else t.to(torch.float32)
    return out


def micro_inputs_from_numpy(*arrays, device="cpu") -> tuple:
    """The arrays that ``scripts/micro_*.py`` build, worlds on the last axis
    ((DP, DP, BL) matrices, (R, DP, BL) vector stacks, (DP, BL) vectors,
    (8, BL) scalar rows, (1, BL) int32 indices), -> the port's contiguous
    tensors with worlds on the first axis ((BL, DP, DP), (BL, R, DP),
    (BL, DP), (BL, 8)); an index row becomes (BL,) int32. Floats become
    float32."""
    out = []
    for a in arrays:
        a = np.moveaxis(np.asarray(a), -1, 0)
        if np.issubdtype(a.dtype, np.integer):
            a = a.reshape(a.shape[0]).astype(np.int32)
        else:
            a = a.astype(np.float32)
        out.append(torch.tensor(np.ascontiguousarray(a), device=device))
    return tuple(out)


def micro_output_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A world-major result of ``ops/micro_ops`` -> numpy with worlds on the
    last axis, the layout of the scripts' kernels."""
    return np.moveaxis(t.detach().cpu().numpy(), 0, -1)
