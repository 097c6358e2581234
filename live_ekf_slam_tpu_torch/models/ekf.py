"""EKF-SLAM on a fixed-capacity padded state, batched over worlds
(counterpart of ``live_ekf_slam_tpu/models/ekf.py``).

State (x, y, theta, lm_x1, lm_y1, ...) with covariance P at a static
D = 3 + 2 N_cap; an insertion is a masked write at slot M whose new rows and
columns fully overwrite whatever the inactive slot held. Every function takes
and returns tensors with the world batch as the leading axis. The sequential
per-measurement updates are a Python loop over the K measurement slots in
ascending-id order, each a branch-free masked update: no value of a tensor is
read on the host inside a tick.

The algebra is the JAX model's, term for term: the predict's two rank-1
updates, H with its five non-zero columns, the downdate K (P H^T)^T on a P
symmetrised once a tick, the insertion as masked row and column deltas, and
the slot reads as one-hot products (``ops/precision.sel_cols``), which carry
a NaN anywhere in the state into the read as the JAX model's do. Compat
quirks (``cfg.compat``: stale landmarks, unwrapped innovation, the V/W swap)
and the calibrated-motion moments (``core/noise``) are honoured. With
``landmark_id_is_known=False`` the detections are associated by position
(ekf.cpp:82-98).
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.core.noise import (
    calibrated_meas_vars,
    motion_moments,
    use_calibrated,
)
from live_ekf_slam_tpu_torch.core.types import GaussianState, Measurements
from live_ekf_slam_tpu_torch.ops.precision import constant, first_match, sel_cols
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle

# Initial pose covariance (ekf.cpp:11-18).
P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005)


def init(cfg, batch: int, init_pose=None, device="cpu") -> GaussianState:
    """The initial (x, y, theta, lm...) state of the EKF and the RI-EKF."""
    n = cfg.num_landmark_slots
    d = 3 + 2 * n
    pose = torch.as_tensor(cfg.init_pose if init_pose is None else init_pose,
                           dtype=torch.float32, device=device)
    x = torch.zeros((batch, d), dtype=torch.float32, device=device)
    x[:, :3] = pose
    p = torch.zeros((batch, d, d), dtype=torch.float32, device=device)
    for i, v in enumerate(P0_DIAG):
        p[:, i, i] = v
    return GaussianState(
        x=x, P=p,
        ids=torch.full((batch, n), -1, dtype=torch.int32, device=device),
        M=torch.zeros(batch, dtype=torch.int32, device=device),
        timestep=torch.zeros(batch, dtype=torch.int32, device=device),
    )



def measurement_vars(cfg) -> tuple[float, float]:
    """The (range, bearing) measurement variances the filters use: the
    compat-aware half-widths, or the true ones under calibrated motion."""
    _, (w00, w11) = cfg.filter_noise()
    if use_calibrated(cfg):
        w00, w11 = calibrated_meas_vars(cfg)
    return w00, w11


def measurement_noise(cfg, device) -> torch.Tensor:
    """``measurement_vars`` as a (2,) float32 tensor on ``device``."""
    return constant(tuple(measurement_vars(cfg)), torch.float32,
                    torch.device(device))


def executed_motion(cfg, cmd: torch.Tensor):
    """(eff_d, eff_th, var_d, var_th, jac_d) of a predict: the executed-motion
    means and variances and the distance the Jacobian is built from."""
    (v00, v11), _ = cfg.filter_noise()
    d_cmd, th_cmd = cmd[:, 0], cmd[:, 1]
    if use_calibrated(cfg):
        # clip-aware expected motion and the true clipped-uniform variance;
        # eff_* already include the v_d / v_th means
        eff_d, eff_th, v00, v11 = motion_moments(cfg, d_cmd, th_cmd)
        return eff_d, eff_th, v00, v11, eff_d
    eff_d = d_cmd + cfg.process_noise.v_d
    eff_th = th_cmd + cfg.process_noise.v_th
    return eff_d, eff_th, v00, v11, d_cmd  # F_x from the raw command


def predict(cfg, s: GaussianState, cmd: torch.Tensor):
    """Prediction stage (ekf.cpp:41-61) by its rank-1 structure: F_x =
    I + u e2^T with u = (-d sin th, d cos th, 0, ...), so F P F^T =
    P + u P[2,:] + (P + u P[2,:])[:,2] u^T."""
    eff_d, eff_th, v00, v11, jac_d = executed_motion(cfg, cmd)
    th = s.x[:, 2]
    c, si = torch.cos(th), torch.sin(th)
    u = torch.zeros_like(s.x)
    u[:, 0] = -jac_d * si
    u[:, 1] = jac_d * c
    fp = s.P + u[:, :, None] * s.P[:, None, 2, :]
    p_pred = fp + fp[:, :, 2:3] * u[:, None, :]
    # F_v V F_v^T touches only the top-left 3x3 (ekf.cpp:51-54)
    p_pred[:, 0, 0] += c * c * v00
    p_pred[:, 0, 1] += si * c * v00
    p_pred[:, 1, 0] += si * c * v00
    p_pred[:, 1, 1] += si * si * v00
    p_pred[:, 2, 2] += v11
    x_pred = s.x.clone()
    x_pred[:, 0] += eff_d * c
    x_pred[:, 1] += eff_d * si
    x_pred[:, 2] = wrap_angle(th + eff_th)
    return x_pred, p_pred


def _inv2(ss: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, 2, 2) innovation covariances, the determinant floored
    at 1e-20 (the fused kernels' and the RI-EKF's floor)."""
    det = ss[:, 0, 0] * ss[:, 1, 1] - ss[:, 0, 1] * ss[:, 1, 0]
    det = torch.where(det.abs() > 1e-20, det, 1.0)
    adj = torch.stack([torch.stack([ss[:, 1, 1], -ss[:, 0, 1]], -1),
                       torch.stack([-ss[:, 1, 0], ss[:, 0, 0]], -1)], -2)
    return adj / det[:, None, None]


def insert_deltas(p, e_new, new_rows, new_block):
    """P after writing the fresh rows / columns ``new_rows`` (B, 2, D) and
    the corner ``new_block`` (B, 2, 2) at the one-hot slot ``e_new`` (B, D, 2),
    as the JAX model's masked deltas: returns (col_term + row_term, the mask
    of the fresh rows and columns)."""
    e0, e1 = e_new[:, :, 0], e_new[:, :, 1]
    nm = e0 + e1
    r_corner = new_rows @ e_new  # (B, 2, 2): new_rows[a] . e_c
    rf0 = (new_rows[:, 0] + e0 * (new_block[:, 0:1, 0] - r_corner[:, 0:1, 0])
           + e1 * (new_block[:, 0:1, 1] - r_corner[:, 0:1, 1]))
    rf1 = (new_rows[:, 1] + e0 * (new_block[:, 1:2, 0] - r_corner[:, 1:2, 0])
           + e1 * (new_block[:, 1:2, 1] - r_corner[:, 1:2, 1]))
    off_rows = 1.0 - nm
    col_term = off_rows[:, :, None] * (new_rows[:, 0, :, None] * e0[:, None, :]
                                       + new_rows[:, 1, :, None] * e1[:, None, :])
    row_term = e0[:, :, None] * rf0[:, None, :] + e1[:, :, None] * rf1[:, None, :]
    ins_mask = 1.0 - off_rows[:, :, None] * off_rows[:, None, :]
    return col_term + row_term, ins_mask


def select_outcome(p, x, ids, m, su_delta, do_update, x_upd, do_insert,
                   ins_delta, ins_mask, x_ins, ids_ins):
    """The two exclusive outcomes of a slot as masked deltas on P (one
    expression, as the JAX model writes it) and selects on x, ids and M."""
    su = do_update.to(torch.float32)[:, None, None]
    si = do_insert.to(torch.float32)[:, None, None]
    p_out = p - su * su_delta + si * (ins_delta - p * ins_mask)
    x_out = torch.where(do_update[:, None], x_upd,
                        torch.where(do_insert[:, None], x_ins, x))
    ids_out = torch.where(do_insert[:, None], ids_ins, ids)
    m_out = torch.where(do_insert, m + 1, m)
    return x_out, p_out, ids_out, m_out


def _meas_slot_update(cfg, carry, slot, x_committed, w_diag):
    """One measurement slot of every world: landmark update (ekf.cpp:110-140)
    or insertion (ekf.cpp:141-173), selected by masks."""
    x, p, ids, m = carry
    mid, r, b, valid = slot
    n_cap = ids.shape[1]
    dvec = x.shape[1]
    w_r, w_b = cfg.sensing_noise.w_r, cfg.sensing_noise.w_b
    slot_idx = torch.arange(n_cap, device=x.device)
    active = slot_idx[None, :] < m[:, None]

    if cfg.constraints.measurements.landmark_id_is_known:
        match = (ids == mid[:, None]) & active
        ins_id = mid
    else:
        # positional data association (ekf.cpp:82-98): project the detection
        # and match the first landmark within min_landmark_separation in
        # both coordinates; a new landmark takes the next id
        sep = cfg.constraints.measurements.min_landmark_separation
        det_x = x[:, 0] + r * torch.cos(x[:, 2] + b)
        det_y = x[:, 1] + r * torch.sin(x[:, 2] + b)
        lm_xs = x[:, 3::2][:, :n_cap]
        lm_ys = x[:, 4::2][:, :n_cap]
        match = (((det_x[:, None] - lm_xs).abs() < sep)
                 & ((det_y[:, None] - lm_ys).abs() < sep) & active)
        ins_id = m
    found, i = first_match(match)

    e_upd = sel_cols(dvec, 3 + 2 * i)  # (B, D, 2) one-hot at the match

    # ---------------- landmark update path ----------------
    lm_src = x_committed if cfg.compat.ekf_stale_landmarks else x
    lmx = (lm_src[:, :, None] * e_upd).sum(1)  # (B, 2), a one-hot read
    ddx = lmx[:, 0] - x[:, 0]
    ddy = lmx[:, 1] - x[:, 1]
    dist_raw = torch.sqrt(ddx * ddx + ddy * ddy)
    safe = valid & found
    dist = torch.where(safe & (dist_raw > 0), dist_raw, 1.0)
    d2 = dist * dist
    zero, one = torch.zeros_like(dist), torch.ones_like(dist)
    h_veh = torch.stack([
        torch.stack([-ddx / dist, -ddy / dist, zero], -1),
        torch.stack([ddy / d2, -ddx / d2, -one], -1),
    ], -2)  # (B, 2, 3)
    h_lm = torch.stack([
        torch.stack([ddx / dist, ddy / dist], -1),
        torch.stack([-ddy / d2, ddx / d2], -1),
    ], -2)  # (B, 2, 2)
    h = torch.zeros((x.shape[0], 2, dvec), dtype=x.dtype, device=x.device)
    h[:, :, :3] = h_veh
    h = h + h_lm @ e_upd.transpose(1, 2)  # h[:, li:li+2] = h_lm (li >= 3)

    ang = wrap_angle(torch.atan2(ddy, ddx) - x[:, 2])
    nu_b = b - ang - w_b
    if not cfg.compat.ekf_unwrapped_innovation:
        nu_b = wrap_angle(nu_b)
    nu_r = r - dist_raw - w_r

    ph_t = p @ h.transpose(1, 2)  # (B, D, 2) == P H^T
    ss = h @ ph_t + torch.diag(w_diag)
    k = ph_t @ _inv2(ss)  # (B, D, 2)
    x_upd = x + k[:, :, 0] * nu_r[:, None] + k[:, :, 1] * nu_b[:, None]
    x_upd[:, 2] = wrap_angle(x_upd[:, 2])
    # K (H P) with (H P) = (P H^T)^T: P is symmetric by construction (see
    # update); the gain itself comes from P's columns
    upd_delta = (k[:, :, 0:1] * ph_t[:, None, :, 0]
                 + k[:, :, 1:2] * ph_t[:, None, :, 1])

    # ---------------- insertion path ----------------
    tb = x[:, 2] + b
    ct, st = torch.cos(tb), torch.sin(tb)
    e_new = sel_cols(dvec, 3 + 2 * m)  # (B, D, 2) one-hot at the fresh slot
    nm = e_new[:, :, 0] + e_new[:, :, 1]
    seed = torch.stack([x[:, 0] + r * ct, x[:, 1] + r * st], dim=1)
    x_ins = x * (1.0 - nm) + (e_new @ seed[:, :, None])[:, :, 0]
    rst, rct = r * st, r * ct
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    g_x = torch.stack([torch.stack([one, zero, -rst], -1),
                       torch.stack([zero, one, rct], -1)], -2)  # (B, 2, 3)
    g_z = torch.stack([torch.stack([ct, -rst], -1),
                       torch.stack([st, rct], -1)], -2)  # (B, 2, 2)
    new_rows = (g_x[:, :, :, None] * p[:, None, :3, :]).sum(2)  # G_x P[:3]
    new_block = (g_x @ p[:, :3, :3] @ g_x.transpose(1, 2)
                 + (g_z * w_diag) @ g_z.transpose(1, 2))
    ins_delta, ins_mask = insert_deltas(p, e_new, new_rows, new_block)
    ids_ins = torch.where(slot_idx[None, :] == m[:, None],
                          ins_id.to(torch.int32)[:, None], ids)

    # ---------------- select ----------------
    do_update = valid & found
    do_insert = valid & ~found & (m < n_cap)
    return select_outcome(p, x, ids, m, upd_delta, do_update, x_upd,
                          do_insert, ins_delta, ins_mask, x_ins, ids_ins)


def slots_of(meas: Measurements):
    """The K measurement slots, each (mid, r, b, valid) of (B,) tensors."""
    return [(meas.ids[:, j], meas.r[:, j], meas.b[:, j], meas.valid[:, j])
            for j in range(meas.ids.shape[1])]


def update(cfg, s: GaussianState, cmd: torch.Tensor,
           meas: Measurements) -> GaussianState:
    """One full EKF iteration (ekf.cpp:37-178): predict, then the sequential
    per-measurement updates in slot order."""
    w_diag = measurement_noise(cfg, s.x.device)
    x_pred, p_pred = predict(cfg, s, cmd)
    carry = (x_pred, p_pred, s.ids, s.M)
    for slot in slots_of(meas):
        carry = _meas_slot_update(cfg, carry, slot, s.x, w_diag)
    x_t, p_t, ids, m = carry
    # one symmetrisation a tick: the downdate reuses (P H^T)^T for H P,
    # exact only for a symmetric P
    p_t = 0.5 * (p_t + p_t.transpose(1, 2))
    return GaussianState(x=x_t, P=p_t, ids=ids, M=m, timestep=s.timestep + 1)


def state_vector(s: GaussianState) -> torch.Tensor:
    """(x, y, yaw, lm...) vector handed to the pose graph (ekf.cpp:182-185)."""
    return s.x


def pose(s: GaussianState) -> torch.Tensor:
    return s.x[:, :3]
