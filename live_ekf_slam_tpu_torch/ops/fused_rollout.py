"""Fused sim + EKF-SLAM and RI-EKF-SLAM rollouts: the CUDA kernels'
wrapper and their plain version.

Counterpart of ``live_ekf_slam_tpu/ops/fused_rollout.py``
(``fused_ekf_rollout`` with ``filter_kind`` "ekf" or "iekf", and
``fused_iekf_rollout``). ``fused_ekf_rollout`` runs the whole T-tick rollout
of every world: on CUDA tensors in one launch of the hand-written kernel
``csrc/fused_ekf_rollout.cu`` (whose source note gives the design; the
RI-EKF is a second instantiation of the same kernel), on CPU tensors through
``fused_ekf_rollout_reference``, the same algebra as batched torch. There is
no fallback from one to the other.

The algebra keeps the TPU kernel's hard-won choices: landmark slot = id, so
every index is static; the gain from P's columns and H P from P's rows (the
one-sided spellings go to NaN by T = 1000 in fp32); masked worlds get a zero
gain, which makes their update an exact no-op; the predict as rank-1 row and
column updates; insertion from the old P, written rows, then columns, then
the 2x2 block. The RI-EKF (``filter_kind="iekf"``) swaps the three filter
sections for the invariant ones (``_make_kernel``'s notes): a predict with
F = I and one full rank-1 yaw-noise pass, an update with constant
H = [-I | 0 | +I] and the exp retraction, and an insertion that copies the
vehicle rows. It ignores the EKF compat quirks (stale landmarks, unwrapped
innovation), as the JAX kernel does, but honours the noise V/W swap.

``profile_mode`` cuts the tick short, to attribute a rollout's time to its
phases by difference (``_make_kernel``'s ``profile_mode``, fused_rollout.py:
188-194, 265-268): ``"sim"`` runs the noise draw, truth propagation and
sensing, then takes the error against the estimate that never moves (x, P
and seen keep their initial values); ``"nolm"`` adds the predict and skips
the landmark loop, so seen stays empty; ``"full"`` is the rollout.
``"downdate"`` is named in the JAX kernel's comment but no branch of it reads
the name, so there it runs the full kernel, and here too. On the card each
mode is its own instantiation of the kernel, counted under its own key of
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from live_ekf_slam_tpu_torch.convert import kernel_params
from live_ekf_slam_tpu_torch.core.noise import _div, motion_moments
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.philox import MASK32, philox_noise_reference

# Initial pose covariance diag (ekf.cpp:11-18).
P0 = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005)

# launches of each CUDA kernel instantiation (not of the plain version);
# "_traj": the instantiations that also write the pose stream (emit_traj)
launches = {"ekf": 0, "iekf": 0, "ekf_traj": 0, "iekf_traj": 0,
            "ekf_nolm": 0, "iekf_nolm": 0, "ekf_sim": 0, "iekf_sim": 0}
FILTER_KINDS = ("ekf", "iekf")
# profile_mode -> the kernel's kMode ("downdate" has no branch of its own in
# the JAX kernel and runs the full tick)
PROFILE_MODES = {"full": 0, "downdate": 0, "nolm": 1, "sim": 2}
# the phases of a tick, in the order of the kernel's Phase enum
PHASES = ("sim", "predict", "gate_walk", "update_vectors",
          "solve_and_innovation", "downdate", "insertion", "error_and_stream")


def _check_scope(cfg, filter_kind, profile_mode, emit_traj):
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError("fused rollout requires known landmark ids")
    if filter_kind not in FILTER_KINDS:
        raise ValueError(f"unknown filter_kind {filter_kind!r}")
    if profile_mode not in PROFILE_MODES:
        raise ValueError(f"unknown profile_mode {profile_mode!r}")
    if emit_traj and profile_mode != "full":
        raise ValueError("emit_traj requires profile_mode='full'")


def fused_ekf_rollout(
    cfg, landmarks: torch.Tensor, cmds: torch.Tensor, seed: int, *,
    noise: torch.Tensor | None = None, predicated: bool = True,
    filter_kind: str = "ekf", profile_mode: str = "full",
    emit_traj: bool = False,
) -> dict:
    """Run the full T-tick sim + EKF-SLAM (or, with ``filter_kind="iekf"``,
    RI-EKF-SLAM) rollout of a world batch.

    landmarks (B, N, 2) true maps; cmds (B, T, 2) commanded odometry; seed
    keys the Philox noise stream, unless ``noise`` (T, 2N+8, B) in [-1, 1)
    is given, which replaces it. Returns err_sum (B,), err_max (B,),
    true_pose (B, 3), x (B, D), P (B, D, D) and seen (B, N) bool, D = 3+2N;
    with ``emit_traj`` also est_traj and true_traj (B, T, 3), the estimated
    pose x[0:3] and the true pose after every tick (the node seeds of the
    pose-graph streams path). ``profile_mode`` "sim" or "nolm" ends every
    tick after sensing or after the predict (see the module note); the
    result has the same keys.

    ``predicated=False`` runs every landmark's update and insertion for every
    world, with the gain masked to zero; the result is the same, bit for bit.
    The TPU version's ``block_worlds`` and ``t_chunk`` cut its grid and have
    no meaning here: the kernel runs one warp per world and loops over T.
    """
    _check_scope(cfg, filter_kind, profile_mode, emit_traj)
    dev = landmarks.device
    if dev.type == "cpu":
        return fused_ekf_rollout_reference(
            cfg, landmarks, cmds, seed, noise=noise, predicated=predicated,
            filter_kind=filter_kind, profile_mode=profile_mode,
            emit_traj=emit_traj,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_ekf_rollout runs on cpu or cuda, not {dev}")
    return _launch(cfg, landmarks, cmds, seed, noise, predicated, filter_kind,
                   profile_mode, emit_traj)


def fused_iekf_rollout(cfg, landmarks, cmds, seed, **kw) -> dict:
    """Fused sim + right-invariant-EKF-SLAM rollout: ``fused_ekf_rollout``
    with ``filter_kind="iekf"``; same arguments and results."""
    return fused_ekf_rollout(cfg, landmarks, cmds, seed, filter_kind="iekf",
                             **kw)


def _check_input(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, landmarks on {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(landmarks, cmds, noise) -> tuple[int, int, int]:
    """(B, N, T) of a rollout's CUDA inputs, after checking what every
    rollout kernel takes: float32, contiguous, on the landmarks' device,
    landmarks (B, N, 2), cmds (B, T, 2), noise None or (T, 2N+8, B)."""
    if landmarks.dim() != 3 or landmarks.shape[2] != 2:
        raise ValueError(f"landmarks must be (B, N, 2), got {tuple(landmarks.shape)}")
    b, n, _ = landmarks.shape
    if b == 0 or n == 0:
        raise ValueError("empty world batch or landmark map")
    if cmds.dim() != 3:
        raise ValueError(f"cmds must be (B, T, 2), got {tuple(cmds.shape)}")
    t_total = cmds.shape[1]
    dev = landmarks.device
    _check_input("landmarks", landmarks, (b, n, 2), dev)
    _check_input("cmds", cmds, (b, t_total, 2), dev)
    if noise is not None:
        _check_input("noise", noise, (t_total, 2 * n + 8, b), dev)
    return b, n, t_total


def _launch(cfg, landmarks, cmds, seed, noise, predicated, filter_kind,
            profile_mode, emit_traj):
    b, n, t_total = check_inputs(landmarks, cmds, noise)
    dev = landmarks.device
    d = 3 + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    res = {
        "err_sum": torch.empty(b, **f32),
        "err_max": torch.empty(b, **f32),
        "true_pose": torch.empty((b, 3), **f32),
        "x": torch.empty((b, d), **f32),
        "P": torch.empty((b, d, d), **f32),
        "seen": torch.empty((b, n), dtype=torch.bool, device=dev),
    }
    if emit_traj:
        res["est_traj"] = torch.empty((b, t_total, 3), **f32)
        res["true_traj"] = torch.empty((b, t_total, 3), **f32)
    traj = [res[k].data_ptr() if emit_traj else None
            for k in ("est_traj", "true_traj")]
    kp = kernel_params(cfg)
    lib = _build.load()
    entry = (lib.les_fused_iekf_rollout if filter_kind == "iekf"
             else lib.les_fused_ekf_rollout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(
            ctypes.addressof(kp), landmarks.data_ptr(), cmds.data_ptr(),
            None if noise is None else noise.data_ptr(),
            int(seed) & MASK32, b, t_total, n, int(predicated),
            PROFILE_MODES[profile_mode],
            res["err_sum"].data_ptr(), res["err_max"].data_ptr(),
            res["true_pose"].data_ptr(), res["x"].data_ptr(),
            res["P"].data_ptr(), res["seen"].data_ptr(), *traj, stream,
        )
    _build.check(rc, f"fused {filter_kind} rollout kernel")
    launches[launch_key(filter_kind, profile_mode, emit_traj)] += 1
    return res


def phase_clocks(cfg, landmarks, cmds, seed, *, filter_kind="ekf",
                 predicated=True) -> tuple[dict, dict]:
    """One rollout on the card in the build that counts cycles by phase
    (``_build.PHASE_CLOCKS``): returns the clock64() cycles of each phase of
    ``PHASES``, lane 0 of every warp summed over warps and ticks, and the
    rollout's result. A measurement: the clocks slow the kernel a little."""
    _check_scope(cfg, filter_kind, "full", False)

    def launch():
        res = _launch(cfg, landmarks, cmds, seed, None, predicated,
                      filter_kind, "full", False)
        torch.cuda.synchronize(landmarks.device)
        return res
    return _build.phase_cycles("les_ekf_phase_clocks", PHASES, launch)


def occupancy(n_lm: int, filter_kind: str = "ekf", profile_mode: str = "full",
              emit_traj: bool = False) -> dict:
    """That instantiation's launch for ``n_lm`` landmarks as the card takes
    it (``_build.occupancy``)."""
    return _build.occupancy("les_ekf_occupancy", int(filter_kind == "iekf"),
                            int(emit_traj), PROFILE_MODES[profile_mode], n_lm)


def launch_key(filter_kind: str, profile_mode: str = "full",
               emit_traj: bool = False) -> str:
    """The key of ``launches`` that counts this instantiation."""
    if PROFILE_MODES[profile_mode]:
        return f"{filter_kind}_{profile_mode}"
    return filter_kind + ("_traj" if emit_traj else "")


def fused_ekf_rollout_reference(
    cfg, landmarks: torch.Tensor, cmds: torch.Tensor, seed: int, *,
    noise: torch.Tensor | None = None, predicated: bool = True,
    filter_kind: str = "ekf", profile_mode: str = "full",
    emit_traj: bool = False,
) -> dict:
    """The plain version: the kernel's algebra as batched torch, worlds on
    the leading axis, in the JAX kernel's order of operations.

    Without ``noise`` it draws the Philox stream the kernel draws in-kernel.
    ``predicated`` skips a landmark's update or insertion when no world of
    the batch needs it (the TPU kernel's per-block ``pl.when``); skipped or
    not, the result is the same.
    """
    b, n, _ = landmarks.shape
    t_total = cmds.shape[1]
    d = 3 + 2 * n
    dev = landmarks.device
    if noise is None:
        noise = philox_noise_reference(seed, t_total, n, b, device=dev)
    kp = kernel_params(cfg)
    invariant = filter_kind == "iekf"
    mode = PROFILE_MODES[profile_mode]
    calibrated, wrap_innov = kp.calibrated, kp.wrap_innov
    stale = kp.stale and not invariant
    f32 = dict(dtype=torch.float32, device=dev)

    lx, ly = landmarks[:, :, 0], landmarks[:, :, 1]  # (B, N)
    x = torch.zeros((b, d), **f32)
    x[:, 0], x[:, 1], x[:, 2] = kp.x0, kp.y0, kp.yaw0
    P = torch.zeros((b, d, d), **f32)
    for i, v in enumerate(P0):
        P[:, i, i] = v
    seen = torch.zeros((b, n), **f32)
    tx = torch.full((b,), kp.x0, **f32)
    ty = torch.full((b,), kp.y0, **f32)
    tth = torch.full((b,), kp.yaw0, **f32)
    err_sum = torch.zeros(b, **f32)
    err_max = torch.zeros(b, **f32)
    if emit_traj:
        est_traj = torch.empty((b, t_total, 3), **f32)
        true_traj = torch.empty((b, t_total, 3), **f32)

    for t in range(t_total):
        fwd, ang = cmds[:, t, 0], cmds[:, t, 1]
        u = noise[t]  # (2N+8, B)

        # ---- truth propagation (heading deliberately unwrapped)
        d_n = torch.clamp(fwd + kp.v00s * u[0], 0.0, kp.d_max)
        h_n = torch.clamp(ang + kp.v11s * u[1], -kp.th_max, kp.th_max)
        tx = tx + d_n * torch.cos(tth)
        ty = ty + d_n * torch.sin(tth)
        tth = tth + h_n

        # ---- sensing, all landmarks
        dxl = lx - tx[:, None]
        dyl = ly - ty[:, None]
        r_true = torch.sqrt(dxl * dxl + dyl * dyl)
        beta = wrap(atan2(dyl, dxl) - tth[:, None])
        vis = ((r_true <= kp.r_max) & (beta > kp.fov_min)
               & (beta < kp.fov_max)).to(torch.float32)  # (B, N)
        rn_all = r_true + kp.w00s * u[2:2 + n].T
        bn_all = beta + kp.w11s * u[2 + n:2 + 2 * n].T

        if mode == 2:  # "sim": the error against the unmoved estimate
            ex = x[:, 0] - tx
            ey = x[:, 1] - ty
            e = torch.sqrt(ex * ex + ey * ey)
            err_sum = err_sum + e
            err_max = torch.maximum(err_max, e)
            continue

        # ---- EKF predict: rows 0, 1 from row 2, then columns 0, 1 from
        # column 2, which includes the updated rows
        th = x[:, 2]
        c, s = torch.cos(th), torch.sin(th)
        if calibrated:
            eff_d, eff_th, var_d, var_th = motion_moments(cfg, fwd, ang)
            jac_d = eff_d
        else:
            eff_d, eff_th = fwd + kp.v_d, ang + kp.v_th
            var_d, var_th = kp.v00f, kp.v11f
            jac_d = fwd
        if invariant:
            P = _predict_iekf(P, x, seen, jac_d, c, s, var_th)
        else:
            u0 = (-jac_d * s)[:, None]
            u1 = (jac_d * c)[:, None]
            row2 = P[:, 2, :].clone()
            P[:, 0, :] = P[:, 0, :] + u0 * row2
            P[:, 1, :] = P[:, 1, :] + u1 * row2
            col2 = P[:, :, 2].clone()
            P[:, :, 0] = P[:, :, 0] + col2 * u0
            P[:, :, 1] = P[:, :, 1] + col2 * u1
        P[:, 0, 0] = P[:, 0, 0] + c * c * var_d
        P[:, 0, 1] = P[:, 0, 1] + s * c * var_d
        P[:, 1, 0] = P[:, 1, 0] + s * c * var_d
        P[:, 1, 1] = P[:, 1, 1] + s * s * var_d
        if not invariant:  # the invariant pass carries it (g[2] = 1)
            P[:, 2, 2] = P[:, 2, 2] + var_th
        x[:, 0] = x[:, 0] + eff_d * c
        x[:, 1] = x[:, 1] + eff_d * s
        x[:, 2] = wrap(th + eff_th)
        x_committed = x.clone() if stale else None

        # ---- per landmark in id order; gates from the tick-start seen
        # ("nolm" skips the loop, and with it the update of seen)
        m_u_all = vis * seen
        m_i_all = vis * (1.0 - seen)
        for j in range(n if mode == 0 else 0):
            li = 3 + 2 * j
            m_u, m_i = m_u_all[:, j], m_i_all[:, j]
            rn, bn = rn_all[:, j], bn_all[:, j]
            if not predicated or bool(m_u.any()):
                if invariant:
                    x, P = _update_iekf(kp, x, P, li, m_u, rn, bn)
                else:
                    x, P = _update(kp, x, P, x_committed if stale else x, li,
                                   m_u, rn, bn, wrap_innov)
            if not predicated or bool(m_i.any()):
                insert = _insert_iekf if invariant else _insert
                x, P = insert(kp, x, P, li, m_i > 0, rn, bn)
        if mode == 0:
            seen = torch.maximum(seen, vis)

        # ---- error metric
        ex = x[:, 0] - tx
        ey = x[:, 1] - ty
        e = torch.sqrt(ex * ex + ey * ey)
        err_sum = err_sum + e
        err_max = torch.maximum(err_max, e)
        if emit_traj:
            est_traj[:, t] = x[:, :3]
            true_traj[:, t, 0], true_traj[:, t, 1], true_traj[:, t, 2] = tx, ty, tth

    res = {
        "err_sum": err_sum,
        "err_max": err_max,
        "true_pose": torch.stack([tx, ty, tth], dim=1),
        "x": x,
        "P": P,
        "seen": seen > 0.5,
    }
    if emit_traj:
        res["est_traj"], res["true_traj"] = est_traj, true_traj
    return res


def _update(kp, x, P, x_lm, li, m_u, rn, bn, wrap_innov):
    """EKF update with the landmark in slot li; returns new (x, P)."""
    xv, yv, thv = x[:, 0], x[:, 1], x[:, 2]
    ddx = x_lm[:, li] - xv
    ddy = x_lm[:, li + 1] - yv
    d2 = torch.clamp_min(ddx * ddx + ddy * ddy, 1e-12)
    dist = torch.sqrt(d2)
    a_r, b_r = ddx / dist, ddy / dist
    a_b, b_b = ddy / d2, ddx / d2

    # P H^T from P's columns
    c0, c1, c2 = P[:, :, 0], P[:, :, 1], P[:, :, 2]
    cl0, cl1 = P[:, :, li], P[:, :, li + 1]
    pr = (cl0 - c0) * a_r[:, None] + (cl1 - c1) * b_r[:, None]
    pb = (c0 - cl0) * a_b[:, None] + (cl1 - c1) * b_b[:, None] - c2

    s00 = (-a_r * pr[:, 0] - b_r * pr[:, 1] + a_r * pr[:, li]
           + b_r * pr[:, li + 1]) + kp.w00f
    s01 = (-a_r * pb[:, 0] - b_r * pb[:, 1] + a_r * pb[:, li]
           + b_r * pb[:, li + 1])
    s10 = (a_b * pr[:, 0] - b_b * pr[:, 1] - pr[:, 2] - a_b * pr[:, li]
           + b_b * pr[:, li + 1])
    s11 = (a_b * pb[:, 0] - b_b * pb[:, 1] - pb[:, 2] - a_b * pb[:, li]
           + b_b * pb[:, li + 1]) + kp.w11f
    det = s00 * s11 - s01 * s10
    det = torch.where(det.abs() > 1e-20, det, 1.0)
    i00, i01 = s11 / det, -s01 / det
    i10, i11 = -s10 / det, s00 / det

    # K = (P H^T) S^-1, zero for worlds that do not update
    k0 = (pr * i00[:, None] + pb * i10[:, None]) * m_u[:, None]
    k1 = (pr * i01[:, None] + pb * i11[:, None]) * m_u[:, None]

    ang_lm = wrap(atan2(ddy, ddx) - thv)
    nu_r = rn - dist - kp.w_r
    nu_b = bn - ang_lm - kp.w_b
    if wrap_innov:
        nu_b = wrap(nu_b)

    x_new = x + k0 * nu_r[:, None] + k1 * nu_b[:, None]
    x_new[:, 2] = wrap(x_new[:, 2])

    # P -= K (H P), H P from P's rows
    r0, r1, r2 = P[:, 0, :], P[:, 1, :], P[:, 2, :]
    rl0, rl1 = P[:, li, :], P[:, li + 1, :]
    hp0 = (rl0 - r0) * a_r[:, None] + (rl1 - r1) * b_r[:, None]
    hp1 = (r0 - rl0) * a_b[:, None] + (rl1 - r1) * b_b[:, None] - r2
    P_new = P - k0[:, :, None] * hp0[:, None, :] - k1[:, :, None] * hp1[:, None, :]
    return x_new, P_new


def _insert(kp, x, P, li, ins, rn, bn):
    """Masked insertion of the landmark in slot li; returns new (x, P)."""
    xv, yv, thv = x[:, 0], x[:, 1], x[:, 2]
    tb = thv + bn
    ct, st = torch.cos(tb), torch.sin(tb)
    sx = xv + rn * ct
    sy = yv + rn * st
    ga = -rn * st  # G_x(0,2) = G_z(0,1)
    gb = rn * ct   # G_x(1,2) = G_z(1,1)
    # new rows = G_x P[0:3, :], and the new 2x2 block, from the OLD P
    nr0 = P[:, 0, :] + ga[:, None] * P[:, 2, :]
    nr1 = P[:, 1, :] + gb[:, None] * P[:, 2, :]
    p00, p01, p02 = P[:, 0, 0], P[:, 0, 1], P[:, 0, 2]
    p11, p12, p22 = P[:, 1, 1], P[:, 1, 2], P[:, 2, 2]
    blk00 = (p00 + 2.0 * ga * p02 + ga * ga * p22
             + ct * ct * kp.w00f + ga * ga * kp.w11f)
    blk01 = (p01 + gb * p02 + ga * p12 + ga * gb * p22
             + ct * st * kp.w00f + ga * gb * kp.w11f)
    blk11 = (p11 + 2.0 * gb * p12 + gb * gb * p22
             + st * st * kp.w00f + gb * gb * kp.w11f)

    # x and P belong to the rollout loop alone: update them in place
    x[:, li] = torch.where(ins, sx, x[:, li])
    x[:, li + 1] = torch.where(ins, sy, x[:, li + 1])
    insc = ins[:, None]
    # rows, then columns, then the 2x2 block
    P[:, li, :] = torch.where(insc, nr0, P[:, li, :])
    P[:, li + 1, :] = torch.where(insc, nr1, P[:, li + 1, :])
    P[:, :, li] = torch.where(insc, nr0, P[:, :, li])
    P[:, :, li + 1] = torch.where(insc, nr1, P[:, :, li + 1])
    P[:, li, li] = torch.where(ins, blk00, P[:, li, li])
    P[:, li, li + 1] = torch.where(ins, blk01, P[:, li, li + 1])
    P[:, li + 1, li] = torch.where(ins, blk01, P[:, li + 1, li])
    P[:, li + 1, li + 1] = torch.where(ins, blk11, P[:, li + 1, li + 1])
    return x, P


# ---- the right-invariant EKF's filter sections (fused_rollout.py:207-240,
# 292-382, 477-529)

def _predict_iekf(P, x, seen, jac_d, c, s, var_th):
    """Invariant predict: F = I, one full rank-1 pass var_th g g^T with the
    yaw-noise column g = Ad_Xhat (1, (0, -d)) of the tick-start state; the
    caller adds the 2x2 distance-noise block."""
    g = torch.zeros_like(x)
    g[:, 0] = jac_d * s + x[:, 1]
    g[:, 1] = -jac_d * c - x[:, 0]
    g[:, 2] = 1.0
    # landmark jj: (seen x[4+2jj], -seen x[3+2jj]), crosswise with a sign
    g[:, 3::2] = seen * x[:, 4::2]
    g[:, 4::2] = -seen * x[:, 3::2]
    var_g = var_th * g if isinstance(var_th, float) else var_th[:, None] * g
    return P + var_g[:, :, None] * g[:, None, :]


def _rtil(kp, rn, c1, s1):
    """Rtil = Rhat Jpc W Jpc^T Rhat^T through the unit (c1, s1)."""
    rr2 = rn * rn
    rt00 = kp.w00f * c1 * c1 + kp.w11f * rr2 * s1 * s1
    rt01 = (kp.w00f - kp.w11f * rr2) * c1 * s1
    rt11 = kp.w00f * s1 * s1 + kp.w11f * rr2 * c1 * c1
    return rt00, rt01, rt11


def _line_of_sight(x, bn):
    """cos and sin of heading + bearing, from the row-level cos/sin."""
    cth, sth = torch.cos(x[:, 2]), torch.sin(x[:, 2])
    cbn, sbn = torch.cos(bn), torch.sin(bn)
    return cth * cbn - sth * sbn, sth * cbn + cth * sbn


def _update_iekf(kp, x, P, li, m_u, rn, bn):
    """Invariant update with the landmark in slot li: constant
    H = [-I | 0 | +I], Cartesian innovation, exp retraction of every
    translation pair. Returns new (x, P)."""
    xv, yv, thv = x[:, 0], x[:, 1], x[:, 2]
    c1, s1 = _line_of_sight(x, bn)
    yw0, yw1 = rn * c1, rn * s1
    rt00, rt01, rt11 = _rtil(kp, rn, c1, s1)

    # P H^T from P's columns
    pr = P[:, :, li] - P[:, :, 0]
    pb = P[:, :, li + 1] - P[:, :, 1]
    s00 = pr[:, li] - pr[:, 0] + rt00
    s01 = pb[:, li] - pb[:, 0] + rt01
    s10 = pr[:, li + 1] - pr[:, 1] + rt01
    s11 = pb[:, li + 1] - pb[:, 1] + rt11
    det = s00 * s11 - s01 * s10
    det = torch.where(det.abs() > 1e-20, det, 1.0)
    i00, i01 = s11 / det, -s01 / det
    i10, i11 = -s10 / det, s00 / det
    k0 = (pr * i00[:, None] + pb * i10[:, None]) * m_u[:, None]
    k1 = (pr * i01[:, None] + pb * i11[:, None]) * m_u[:, None]

    nu0 = yw0 - (x[:, li] - xv)
    nu1 = yw1 - (x[:, li + 1] - yv)
    xi = k0 * nu0[:, None] + k1 * nu1[:, None]

    # exp retraction: masked worlds have xi = 0, an exact identity
    dth = xi[:, 2]
    cd, sd = torch.cos(dth), torch.sin(dth)
    small = dth.abs() < 1e-6
    dsafe = torch.where(small, 1.0, dth)
    va = torch.where(small, 1.0 - _div(dth * dth, 6.0), sd / dsafe)
    vb = torch.where(small, 0.5 * dth, (1.0 - cd) / dsafe)
    x_new = torch.empty_like(x)
    x_new[:, 0] = va * xi[:, 0] - vb * xi[:, 1] + cd * xv - sd * yv
    x_new[:, 1] = vb * xi[:, 0] + va * xi[:, 1] + sd * xv + cd * yv
    x_new[:, 2] = wrap(thv + dth)
    va, vb, cd, sd = (v[:, None] for v in (va, vb, cd, sd))
    lxj, lyj = x[:, 3::2], x[:, 4::2]
    kxj, kyj = xi[:, 3::2], xi[:, 4::2]
    x_new[:, 3::2] = va * kxj - vb * kyj + cd * lxj - sd * lyj
    x_new[:, 4::2] = vb * kxj + va * kyj + sd * lxj + cd * lyj

    # P -= K (H P), H P from P's rows
    hp0 = P[:, li, :] - P[:, 0, :]
    hp1 = P[:, li + 1, :] - P[:, 1, :]
    P_new = P - k0[:, :, None] * hp0[:, None, :] - k1[:, :, None] * hp1[:, None, :]
    return x_new, P_new


def _insert_iekf(kp, x, P, li, ins, rn, bn):
    """Invariant insertion of the landmark in slot li: the new rows copy the
    vehicle-position rows, the corner adds Rtil; returns new (x, P)."""
    c1, s1 = _line_of_sight(x, bn)
    sx = x[:, 0] + rn * c1
    sy = x[:, 1] + rn * s1
    rt00, rt01, rt11 = _rtil(kp, rn, c1, s1)
    nr0 = P[:, 0, :].clone()
    nr1 = P[:, 1, :].clone()
    blk00 = P[:, 0, 0] + rt00
    blk01 = P[:, 0, 1] + rt01
    blk11 = P[:, 1, 1] + rt11

    # x and P belong to the rollout loop alone: update them in place
    x[:, li] = torch.where(ins, sx, x[:, li])
    x[:, li + 1] = torch.where(ins, sy, x[:, li + 1])
    insc = ins[:, None]
    # rows, then columns, then the 2x2 block
    P[:, li, :] = torch.where(insc, nr0, P[:, li, :])
    P[:, li + 1, :] = torch.where(insc, nr1, P[:, li + 1, :])
    P[:, :, li] = torch.where(insc, nr0, P[:, :, li])
    P[:, :, li + 1] = torch.where(insc, nr1, P[:, :, li + 1])
    P[:, li, li] = torch.where(ins, blk00, P[:, li, li])
    P[:, li, li + 1] = torch.where(ins, blk01, P[:, li, li + 1])
    P[:, li + 1, li] = torch.where(ins, blk01, P[:, li + 1, li])
    P[:, li + 1, li + 1] = torch.where(ins, blk11, P[:, li + 1, li + 1])
    return x, P
