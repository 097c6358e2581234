"""Right-invariant EKF-SLAM (RI-EKF) on the fixed-capacity padded state,
batched over worlds (counterpart of ``live_ekf_slam_tpu/models/iekf.py``).

The estimation error lives in SE_{1+M}(2) as eta = X Xhat^{-1}: the predict
is F = I (P plus two rank-1 noise terms), the Cartesian innovation has the
constant H = [-I | 0 | +I], and an insertion copies the vehicle-position rows
and adds the fresh measurement noise. The state layout, slot bookkeeping and
the per-slot masked update discipline are those of ``models/ekf``. Known
landmark ids only: ``update`` raises otherwise, as the JAX model does.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.core.noise import _div
from live_ekf_slam_tpu_torch.core.types import GaussianState, Measurements
from live_ekf_slam_tpu_torch.models.ekf import (
    _inv2,
    executed_motion,
    init,  # noqa: F401  (the RI-EKF starts from the EKF's state)
    insert_deltas,
    measurement_noise,
    select_outcome,
    slots_of,
)
from live_ekf_slam_tpu_torch.ops.precision import first_match, sel_cols
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle


def _v_so2(dth: torch.Tensor):
    """SE(2) left-Jacobian entries (a, b), V = [[a, -b], [b, a]],
    a = sin/dth, b = (1-cos)/dth; exactly I at dth = 0."""
    small = dth.abs() < 1e-6
    safe = torch.where(small, 1.0, dth)
    a = torch.where(small, 1.0 - _div(dth * dth, 6.0), torch.sin(safe) / safe)
    b = torch.where(small, 0.5 * dth, (1.0 - torch.cos(safe)) / safe)
    return a, b


def _retract(x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """X <- exp(xi) X on the flat (x, y, th, lm...) layout: every translation
    slot (vehicle and landmarks) rotates by R(xi_th) and gains V(xi_th) xi_slot.
    Inactive slots hold 0 in x and xi, a fixed point; xi = 0 retracts to x
    bit for bit."""
    dth = xi[:, 2]
    c, s = torch.cos(dth), torch.sin(dth)
    a, b = _v_so2(dth)
    out = torch.empty_like(x)
    out[:, 0] = a * xi[:, 0] - b * xi[:, 1] + c * x[:, 0] - s * x[:, 1]
    out[:, 1] = b * xi[:, 0] + a * xi[:, 1] + s * x[:, 0] + c * x[:, 1]
    out[:, 2] = wrap_angle(x[:, 2] + dth)
    a, b, c, s = (v[:, None] for v in (a, b, c, s))
    lx, ly = x[:, 3::2], x[:, 4::2]
    kx, ky = xi[:, 3::2], xi[:, 4::2]
    out[:, 3::2] = a * kx - b * ky + c * lx - s * ly
    out[:, 4::2] = b * kx + a * ky + s * lx + c * ly
    return out


def _col(v):
    """A per-world (B,) variance as (B, 1, 1); a Python float as is."""
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


def predict(cfg, s: GaussianState, cmd: torch.Tensor):
    """Exact group motion; P plus the rank-1 noise terms of the
    executed-distance column g_d = (cos th, sin th, 0, ...) and the heading
    column g_a = Ad_Xhat (1, (0, -d)), inactive landmark entries masked."""
    eff_d, eff_th, v00, v11, jac_d = executed_motion(cfg, cmd)
    x = s.x
    th = x[:, 2]
    c, si = torch.cos(th), torch.sin(th)
    n_cap = (x.shape[1] - 3) // 2

    g_d = torch.zeros_like(x)
    g_d[:, 0] = c
    g_d[:, 1] = si
    active = (torch.arange(n_cap, device=x.device)[None, :]
              < s.M[:, None]).to(torch.float32)
    g_a = torch.zeros_like(x)
    g_a[:, 0] = jac_d * si + x[:, 1]
    g_a[:, 1] = -jac_d * c - x[:, 0]
    g_a[:, 2] = 1.0
    g_a[:, 3::2] = active * x[:, 4::2]
    g_a[:, 4::2] = -active * x[:, 3::2]
    p_pred = (s.P + _col(v00) * (g_d[:, :, None] * g_d[:, None, :])
              + _col(v11) * (g_a[:, :, None] * g_a[:, None, :]))

    x_pred = x.clone()
    x_pred[:, 0] += eff_d * c
    x_pred[:, 1] += eff_d * si
    x_pred[:, 2] = wrap_angle(th + eff_th)
    return x_pred, p_pred


def _meas_slot_update(cfg, carry, slot, w_diag):
    """One measurement slot of every world: invariant update or insertion."""
    x, p, ids, m = carry
    mid, r, b, valid = slot
    n_cap = ids.shape[1]
    dvec = x.shape[1]
    slot_idx = torch.arange(n_cap, device=x.device)
    found, i = first_match((ids == mid[:, None])
                           & (slot_idx[None, :] < m[:, None]))

    th = x[:, 2]
    c, si = torch.cos(th), torch.sin(th)
    # body-frame Cartesian measurement and its world-frame noise
    # Rtil = Rhat J_pc W J_pc^T Rhat^T
    cb, sb = torch.cos(b), torch.sin(b)
    y_w = torch.stack([r * (c * cb - si * sb), r * (si * cb + c * sb)], dim=1)
    jr = torch.stack([
        torch.stack([c * cb - si * sb, -r * (c * sb + si * cb)], -1),
        torch.stack([si * cb + c * sb, r * (c * cb - si * sb)], -1),
    ], -2)  # Rhat @ J_pc
    rtil = (jr * w_diag) @ jr.transpose(1, 2)

    e_upd = sel_cols(dvec, 3 + 2 * i)

    # ---------------- landmark update path ----------------
    lmx = (x[:, :, None] * e_upd).sum(1)  # (B, 2), a one-hot read
    nu = y_w - (lmx - x[:, :2])  # Cartesian invariant innovation
    # P H^T with constant H = [-I | 0 | +I]
    ph_t = p @ e_upd - p[:, :, :2]  # (B, D, 2)
    ss = e_upd.transpose(1, 2) @ ph_t - ph_t[:, :2, :] + rtil
    k = ph_t @ _inv2(ss)
    do_update = valid & found
    su = do_update.to(torch.float32)[:, None]
    xi = su * (k[:, :, 0] * nu[:, 0:1] + k[:, :, 1] * nu[:, 1:2])
    x_upd = _retract(x, xi)
    # P - K (H P) with (H P) = (P H^T)^T, P symmetrised once a tick
    upd_delta = (k[:, :, 0:1] * ph_t[:, None, :, 0]
                 + k[:, :, 1:2] * ph_t[:, None, :, 1])

    # ---------------- insertion path ----------------
    e_new = sel_cols(dvec, 3 + 2 * m)
    nm = e_new[:, :, 0] + e_new[:, :, 1]
    seed = x[:, :2] + y_w
    x_ins = x * (1.0 - nm) + (e_new @ seed[:, :, None])[:, :, 0]
    # eta_new = eta_p + Rhat n: the rows copy the vehicle-position rows, the
    # corner adds the fresh noise
    new_rows = p[:, :2, :]
    new_block = p[:, :2, :2] + rtil
    ins_delta, ins_mask = insert_deltas(p, e_new, new_rows, new_block)
    ids_ins = torch.where(slot_idx[None, :] == m[:, None], mid[:, None], ids)

    do_insert = valid & ~found & (m < n_cap)
    return select_outcome(p, x, ids, m, upd_delta, do_update, x_upd,
                          do_insert, ins_delta, ins_mask, x_ins, ids_ins)


def update(cfg, s: GaussianState, cmd: torch.Tensor,
           meas: Measurements) -> GaussianState:
    """One full RI-EKF iteration: predict, then the sequential invariant
    updates in ascending-id slot order."""
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError(
            "iekf_slam requires known landmark ids "
            "(constraints.measurements.landmark_id_is_known)"
        )
    w_diag = measurement_noise(cfg, s.x.device)
    x_pred, p_pred = predict(cfg, s, cmd)
    carry = (x_pred, p_pred, s.ids, s.M)
    for slot in slots_of(meas):
        carry = _meas_slot_update(cfg, carry, slot, w_diag)
    x_t, p_t, ids, m = carry
    p_t = 0.5 * (p_t + p_t.transpose(1, 2))
    return GaussianState(x=x_t, P=p_t, ids=ids, M=m, timestep=s.timestep + 1)


def pose(s: GaussianState) -> torch.Tensor:
    return s.x[:, :3]


def state_vector(s: GaussianState) -> torch.Tensor:
    return s.x
