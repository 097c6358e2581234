"""UKF localization and SLAM on a fixed-capacity padded state, batched over
worlds (counterpart of ``live_ekf_slam_tpu/models/ukf.py``).

State (x, y, cos th, sin th, lm_x1, lm_y1, ...) of static dim Du = 4 + 2 N_cap
(UKF-SLAM) or 4 (UKF-Loc, the true map known). Inactive rows and columns of P
are held at zero, the sigma set is allocated at full capacity (2 Du + 1
columns) and the columns of inactive directions weigh zero, so every active
quantity equals the reference's dynamically sized one.

The sigma square root follows ``cfg.ukf.sigma_sqrt``: "eigh" (the default)
clamps the eigenvalues of the scaled symmetric P at 1e-8 and returns the
principal square root V diag(sqrt(lambda)) V^T, a product that is unique
however the eigenvectors of a repeated eigenvalue come out; "chol" is the
fused kernel's pivot-clamped Cholesky, written as the JAX model writes it: a
loop over columns of full-width masked rank-1 updates, with the Joseph-form
update and the sanity gate beside it. A tick runs the predict, every landmark
update (pass 1), then every insertion (pass 2, SLAM only), each pass a
Python loop over the K measurement slots of branch-free masked updates.
Compat quirks: zero bearing mean, committed-state yaw in the sensing model,
signed process noise and the V/W swap.
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.core.noise import _div, motion_moments, use_calibrated
from live_ekf_slam_tpu_torch.core.types import Measurements, UKFState
from live_ekf_slam_tpu_torch.models.ekf import (
    measurement_noise,
    measurement_vars,
    slots_of,
)
from live_ekf_slam_tpu_torch.ops.precision import constant, first_match, sel_cols
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle

# Initial covariance diag (ukf.cpp:9-18).
P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005, 0.005 * 0.005)


def state_dim(cfg, slam: bool) -> int:
    return 4 + 2 * cfg.num_landmark_slots if slam else 4


def init(cfg, batch: int, slam: bool, init_pose=None, device="cpu") -> UKFState:
    du = state_dim(cfg, slam)
    n_cap = cfg.num_landmark_slots if slam else 0
    pose = torch.as_tensor(cfg.init_pose if init_pose is None else init_pose,
                           dtype=torch.float32, device=device)
    pose = pose.expand(batch, 3)
    x = torch.zeros((batch, du), dtype=torch.float32, device=device)
    x[:, 0], x[:, 1] = pose[:, 0], pose[:, 1]
    x[:, 2], x[:, 3] = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
    p = torch.zeros((batch, du, du), dtype=torch.float32, device=device)
    for i, v in enumerate(P0_DIAG):
        p[:, i, i] = v
    return UKFState(
        x=x, P=p,
        ids=torch.full((batch, max(n_cap, 1)), -1, dtype=torch.int32,
                       device=device),
        M=torch.zeros(batch, dtype=torch.int32, device=device),
        timestep=torch.zeros(batch, dtype=torch.int32, device=device),
        X=torch.zeros((batch, du, 2 * du + 1), dtype=torch.float32,
                      device=device),
    )


def _weights(cfg, du: int, n_active: torch.Tensor) -> torch.Tensor:
    """(B, 2 Du + 1) sigma weights: W_0 on the mean, (1 - W_0) / 2n on the 2n
    active columns, exactly 0 on the padded ones (ukf.cpp:173-176)."""
    w0 = cfg.ukf.W_0
    cols = torch.arange(2 * du + 1, device=n_active.device)
    j = (cols - 1) % du  # the sqrt(P) column of each +/- sigma column
    active_col = (cols[None, :] > 0) & (j[None, :] < n_active[:, None])
    # a tensor numerator: a Python number over a tensor is taken as the
    # tensor's reciprocal times the number, which rounds differently
    num = constant(1.0 - w0, torch.float32, n_active.device)
    w_rest = num / (2.0 * n_active.to(torch.float32))
    w = torch.where(active_col, w_rest[:, None], 0.0)
    w[:, 0] = w0
    return w


def sqrt_spd_clamped(p_sym_scaled: torch.Tensor) -> torch.Tensor:
    """nearestSPD + matrix square root (ukf.cpp:106-123, 207-211): the
    eigenvalues of the scaled symmetric matrix clamped at 1e-8, the principal
    square root V diag(sqrt(lambda)) V^T.

    ``torch.linalg.eigh`` raises on a matrix with a NaN or an infinity, where
    the JAX version returns NaN: such a world's matrix is swapped for the
    identity before the decomposition and its root is NaN, so a diverged
    world goes on as NaN, flagged by the runner's guard, as in JAX.
    """
    finite = torch.isfinite(p_sym_scaled).all(dim=2).all(dim=1)[:, None, None]
    eye = torch.eye(p_sym_scaled.shape[1], dtype=p_sym_scaled.dtype,
                    device=p_sym_scaled.device)
    evals, evecs = torch.linalg.eigh(torch.where(finite, p_sym_scaled, eye))
    evals = torch.sqrt(torch.clamp_min(evals, 1e-8))
    root = (evecs * evals[:, None, :]) @ evecs.transpose(1, 2)
    return torch.where(finite, root, float("nan"))


def chol_clamped(p_sym_scaled: torch.Tensor, eps: float = 1e-8,
                 n_active: torch.Tensor | None = None):
    """Pivot-clamped Cholesky, the fused kernel's sigma-point square root
    (``sigma_sqrt="chol"``): a pivot below eps is clamped and its column below
    zeroed. Outer-product form, one full-width masked rank-1 update a column.
    Returns (lower factor, bad (B,)), bad marking worlds that clamped an
    active direction."""
    b, du, _ = p_sym_scaled.shape
    dev = p_sym_scaled.device
    idx = torch.arange(du, device=dev)
    n_act = torch.full((b,), du, device=dev) if n_active is None else n_active
    a = p_sym_scaled
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    for j in range(du):
        pivot = a[:, j, j]
        ok = pivot > eps
        bad = bad | (~ok & (j < n_act))
        d = torch.sqrt(torch.clamp_min(pivot, eps))
        below = (torch.where((idx[None, :] > j) & ok[:, None], a[:, :, j], 0.0)
                 / d[:, None])
        a = a - below[:, :, None] * below[:, None, :]
        a[:, :, j] = below + torch.where(idx[None, :] == j, d[:, None], 0.0)
    lower = idx[:, None] >= idx[None, :]
    return torch.where(lower, a, 0.0), bad


def _yaw_of(x: torch.Tensor) -> torch.Tensor:
    return wrap_angle(torch.atan2(x[:, 3], x[:, 2]))


def _motion_model(x_sig: torch.Tensor, eff_d, eff_th) -> torch.Tensor:
    """ukf.cpp:125-135 applied to every sigma column of (B, Du, S)."""
    yaw = wrap_angle(torch.atan2(x_sig[:, 3], x_sig[:, 2]))
    new_yaw = wrap_angle(yaw + eff_th[:, None])
    out = x_sig.clone()
    out[:, 0] += eff_d[:, None] * torch.cos(yaw)
    out[:, 1] += eff_d[:, None] * torch.sin(yaw)
    out[:, 2] = torch.cos(new_yaw)
    out[:, 3] = torch.sin(new_yaw)
    return out


def predict(cfg, s: UKFState, cmd: torch.Tensor, slam: bool):
    """Prediction stage (ukf.cpp:197-241). Returns (x_pred, P_pred, the
    sigma points, the propagated sigma points, the weights)."""
    (v00, v11), _ = cfg.filter_noise()
    if use_calibrated(cfg):
        eff_d, eff_th, v00, v11 = motion_moments(cfg, cmd[:, 0], cmd[:, 1])
    else:
        eff_d = cmd[:, 0] + cfg.process_noise.v_d
        eff_th = cmd[:, 1] + cfg.process_noise.v_th
    b, du = s.x.shape
    n_active = (4 + 2 * s.M) if slam else torch.full_like(s.M, 4)

    yaw = _yaw_of(s.x)
    c, si = torch.cos(yaw), torch.sin(yaw)
    q = torch.zeros((b, du, du), dtype=torch.float32, device=s.x.device)
    if cfg.compat.ukf_signed_process_noise:
        # reference quirk (ukf.cpp:182-186): a SIGNED diagonal, negative for
        # half of all headings; the next tick's clamp repairs P
        q[:, 0, 0], q[:, 1, 1] = v00 * c, v00 * si
        q[:, 2, 2], q[:, 3, 3] = v11 * c, v11 * si
    else:
        # the PSD projection G V G^T for the (x, y, cos, sin) state
        q[:, 0, 0] = v00 * c * c
        q[:, 0, 1] = v00 * c * si
        q[:, 1, 0] = v00 * c * si
        q[:, 1, 1] = v00 * si * si
        q[:, 2, 2] = v11 * si * si
        q[:, 2, 3] = -v11 * c * si
        q[:, 3, 2] = -v11 * c * si
        q[:, 3, 3] = v11 * c * c

    scale = _div(n_active.to(torch.float32), 1.0 - cfg.ukf.W_0)
    p_sym = 0.5 * (s.P + s.P.transpose(1, 2)) * scale[:, None, None]
    if cfg.ukf.sigma_sqrt == "chol":
        sqt_p, _ = chol_clamped(p_sym, n_active=n_active)
    else:
        sqt_p = sqrt_spd_clamped(p_sym)

    # sigma points [x, x + cols(sqtP), x - cols(sqtP)] (ukf.cpp:213-219)
    xs = s.x[:, :, None]
    x_sig = torch.cat([xs, xs + sqt_p, xs - sqt_p], dim=2)
    x_pred_sig = _motion_model(x_sig, eff_d, eff_th)

    wts = _weights(cfg, du, n_active)
    x_pred = (x_pred_sig @ wts[:, :, None])[:, :, 0]
    dev = x_pred_sig - x_pred[:, :, None]
    p_pred = (dev * wts[:, None, :]) @ dev.transpose(1, 2) + q
    return x_pred, p_pred, x_sig, x_pred_sig, wts


def _sensing(cfg, x_sig, lm_pos, committed_yaw):
    """Expected (r, b) (B, 2, S) of every sigma column (ukf.cpp:137-159)."""
    w_r, w_b = cfg.sensing_noise.w_r, cfg.sensing_noise.w_b
    if cfg.compat.ukf_committed_yaw_in_sensing:
        yaw = committed_yaw[:, None]
    else:
        yaw = wrap_angle(torch.atan2(x_sig[:, 3], x_sig[:, 2]))
    dx = lm_pos[:, 0] - x_sig[:, 0]
    dy = lm_pos[:, 1] - x_sig[:, 1]
    r = torch.sqrt(dx * dx + dy * dy) + w_r
    b = wrap_angle(torch.atan2(dy, dx) - yaw + w_b)
    return torch.stack([r, b], dim=1)


def _det_gate(w_diag_f: tuple[float, float]) -> float:
    """The chol-mode update's determinant floor, min(1e-12, 1e-6 w00 w11),
    in float32 arithmetic as the JAX model takes it."""
    f32 = np.float32
    return float(min(f32(1e-12), f32(1e-6) * f32(w_diag_f[0]) * f32(w_diag_f[1])))


def _landmark_update(cfg, carry, r, b, li, wts, committed_yaw, true_map,
                     w_diag, w_diag_f, gate):
    """UKF landmark update (ukf.cpp:293-349) of one slot of every world.

    li: the state index of the landmark's x coordinate (SLAM), or with
    ``true_map`` (B, N, 2) (localization) the landmark id into the true map.
    """
    x_pred, p_pred, x_pred_sig = carry
    s_cols = x_pred_sig.shape[2]

    if true_map is None:
        # rows (li, li+1) of the sigma matrix, a one-hot read
        e = sel_cols(x_pred_sig.shape[1], li)
        lm_pos_cols = e.transpose(1, 2) @ x_pred_sig  # (B, 2, S)
    else:
        onehot = (torch.arange(true_map.shape[1], device=li.device)[None, :]
                  == li[:, None]).to(torch.float32)
        lm = (onehot[:, None, :] @ true_map)[:, 0]  # (B, 2)
        lm_pos_cols = lm[:, :, None].expand(-1, 2, s_cols)

    z_cols = _sensing(cfg, x_pred_sig, lm_pos_cols, committed_yaw)
    wcol = wts[:, :, None]
    z_r = (z_cols[:, 0:1] @ wcol)[:, 0, 0]
    if cfg.compat.ukf_zero_bearing_mean:
        # only the range mean is accumulated; the bearing mean stays 0
        z_est = torch.stack([z_r, torch.zeros_like(z_r)], dim=1)
    else:
        # circular mean of the bearings
        zs = (torch.sin(z_cols[:, 1:2]) @ wcol)[:, 0, 0]
        zc = (torch.cos(z_cols[:, 1:2]) @ wcol)[:, 0, 0]
        z_est = torch.stack([z_r, torch.atan2(zs, zc)], dim=1)

    diff = z_cols - z_est[:, :, None]
    diff[:, 1] = wrap_angle(diff[:, 1])
    diff_w = diff * wts[:, None, :]
    ss = diff_w @ diff.transpose(1, 2) + torch.diag(w_diag)  # (B, 2, 2)
    dev_x = x_pred_sig - x_pred[:, :, None]
    c = (dev_x * wts[:, None, :]) @ diff.transpose(1, 2)  # (B, Du, 2)

    det_raw = ss[:, 0, 0] * ss[:, 1, 1] - ss[:, 0, 1] * ss[:, 1, 0]
    # the sanity gate below must see the raw determinant
    det = torch.where(det_raw.abs() > 0, det_raw, 1.0)
    adj = torch.stack([torch.stack([ss[:, 1, 1], -ss[:, 0, 1]], -1),
                       torch.stack([-ss[:, 1, 0], ss[:, 0, 0]], -1)], -2)
    k = c @ (adj / det[:, None, None])  # (B, Du, 2)

    innov = torch.stack([r, b], dim=1) - z_est
    innov[:, 1] = wrap_angle(innov[:, 1])
    chol = cfg.ukf.sigma_sqrt == "chol"
    if chol:
        # divergence guard: reject an update whose innovation or innovation
        # covariance is inconsistent; a diverged world then coasts
        r_gate = 2.0 * cfg.constraints.vision.range_max
        sane = ((innov[:, 0].abs() < r_gate) & (det_raw > _det_gate(w_diag_f))
                & (ss[:, 0, 0] > 0.0) & (ss[:, 1, 1] > 0.0)
                & torch.isfinite(innov[:, 0]))
        gate = gate & sane
    x_new = x_pred + (k @ innov[:, :, None])[:, :, 0]
    kss_kt = (k @ ss) @ k.transpose(1, 2)
    if chol:
        # Joseph form P - K C^T - C K^T + K S K^T: PSD for any gain
        p_new = (p_pred - k @ c.transpose(1, 2) - c @ k.transpose(1, 2)
                 + kss_kt)
    else:
        p_new = p_pred - kss_kt
    x_out = torch.where(gate[:, None], x_new, x_pred)
    p_out = torch.where(gate[:, None, None], p_new, p_pred)
    return x_out, p_out, x_pred_sig


def update(cfg, s: UKFState, cmd: torch.Tensor, meas: Measurements,
           slam: bool, true_map: torch.Tensor | None = None) -> UKFState:
    """One full UKF iteration (ukf.cpp:161-195): predict, every landmark
    update first, then every insertion (ukf.cpp:251-287)."""
    w_diag = measurement_noise(cfg, s.x.device)
    w_diag_f = measurement_vars(cfg)
    n_cap = s.ids.shape[1]
    committed_yaw = _yaw_of(s.x)
    slot_idx = torch.arange(n_cap, device=s.x.device)

    x_pred, p_pred, x_sig, x_pred_sig, wts = predict(cfg, s, cmd, slam)
    slots = slots_of(meas)

    # ---- pass 1: updates of known landmarks (or all, in loc mode)
    carry = (x_pred, p_pred, x_pred_sig)
    for mid, r, b, valid in slots:
        if slam:
            found, i = first_match((s.ids == mid[:, None])
                                   & (slot_idx[None, :] < s.M[:, None]))
            carry = _landmark_update(cfg, carry, r, b, 4 + 2 * i, wts,
                                     committed_yaw, None, w_diag, w_diag_f,
                                     valid & found)
        else:
            carry = _landmark_update(cfg, carry, r, b, torch.clamp_min(mid, 0),
                                     wts, committed_yaw, true_map, w_diag,
                                     w_diag_f, valid)
    x_p, p_p, _ = carry

    # ---- pass 2: insertions of new landmarks (SLAM only)
    ids, m = s.ids, s.M
    if slam:
        w_mat = torch.diag(w_diag)
        for mid, r, b, valid in slots:
            match = (ids == mid[:, None]) & (slot_idx[None, :] < m[:, None])
            is_new = valid & ~match.any(dim=1) & (m < n_cap)
            yaw = wrap_angle(torch.atan2(x_p[:, 3], x_p[:, 2]))  # ukf.cpp:356
            seed = torch.stack([x_p[:, 0] + r * torch.cos(yaw + b),
                                x_p[:, 1] + r * torch.sin(yaw + b)], dim=1)
            e = sel_cols(x_p.shape[1], 4 + 2 * m)  # one-hot at the new slot
            nmask = e[:, :, 0] + e[:, :, 1]
            x_ins = x_p * (1.0 - nmask) + (e @ seed[:, :, None])[:, :, 0]
            # a fresh W block, zero cross terms (ukf.cpp:363-368)
            et = e.transpose(1, 2)
            corner = (et @ p_p) @ e
            p_ins = p_p + e @ ((w_mat - corner) @ et)
            x_p = torch.where(is_new[:, None], x_ins, x_p)
            p_p = torch.where(is_new[:, None, None], p_ins, p_p)
            ids = torch.where(is_new[:, None] & (slot_idx[None, :] == m[:, None]),
                              mid[:, None], ids)
            m = torch.where(is_new, m + 1, m)

    return UKFState(x=x_p, P=p_p, ids=ids, M=m, timestep=s.timestep + 1,
                    X=x_sig)


def pose(s: UKFState) -> torch.Tensor:
    return torch.stack([s.x[:, 0], s.x[:, 1], _yaw_of(s.x)], dim=1)


def state_vector(cfg, s: UKFState, slam: bool) -> torch.Tensor:
    """(x, y, yaw, lm...) EKF-format vector (ukf.cpp:47-53)."""
    if not slam:
        return pose(s)
    return torch.cat([pose(s), s.x[:, 4:]], dim=1)
