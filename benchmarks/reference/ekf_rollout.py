"""The fused sim + EKF-SLAM rollout as plain batched torch.

A frozen copy of the port's ``ops/fused_rollout.fused_ekf_rollout_reference``
(filter kind "ekf", the full tick), in the kernel's order of operations:
truth propagation and sensing from the injected noise, the predict as
rank-1 row and column updates, then each landmark in id order, its update
(the gain from P's columns, H P from P's rows) and its insertion from the
old P, with gates from the tick-start ``seen``. Masked worlds get a zero
gain, so every landmark is processed for every world (the kernel's
predication skips only work whose result is unchanged). ``dtype`` is the
precision every state tensor is kept in: float32 is the configuration's,
bfloat16 the control's.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmarks.reference.kernel_math import atan2, wrap

# the filters' initial covariance diagonal (filter.h: 0.01 m, 0.005 rad sigmas)
P0 = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005)


def kernel_params(cfg) -> SimpleNamespace:
    """The rollout's constants, rounded to float32 as the kernel's struct
    holds them. Settings the copy does not follow are refused."""
    if cfg.calibrated_motion or cfg.compat.noise_vw_swap or cfg.compat.ekf_stale_landmarks:
        raise ValueError("the reference follows the default noise model and landmark reads only")
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError("the fused rollout needs known landmark ids")
    f = lambda v: float(np.float32(v))  # noqa: E731
    pn, sn, nz = cfg.process_noise, cfg.sensing_noise, cfg.sim_noise_scale
    return SimpleNamespace(
        v00f=f(pn.V_00), v11f=f(pn.V_11), w00f=f(sn.W_00), w11f=f(sn.W_11),
        v00s=f(pn.V_00 * nz), v11s=f(pn.V_11 * nz), w00s=f(sn.W_00 * nz), w11s=f(sn.W_11 * nz),
        v_d=f(pn.v_d), v_th=f(pn.v_th), w_r=f(sn.w_r), w_b=f(sn.w_b),
        d_max=f(cfg.constraints.commands.d_max), th_max=f(cfg.constraints.commands.th_max),
        r_max=f(cfg.constraints.vision.range_max), fov_min=f(cfg.constraints.vision.fov_min),
        fov_max=f(cfg.constraints.vision.fov_max),
        x0=f(cfg.init_pose[0]), y0=f(cfg.init_pose[1]), yaw0=f(cfg.init_pose[2]),
        wrap_innov=not cfg.compat.ekf_unwrapped_innovation,
    )


def rollout(cfg, landmarks, cmds, noise, *, dtype=torch.float32, emit_traj=False) -> dict:
    """err_sum (B,), err_max (B,) and with ``emit_traj`` est_traj and
    true_traj (B, T, 3) of the rollout of every world: landmarks (B, N, 2),
    cmds (B, T, 2), noise (T, 2N+8, B) in [-1, 1). On a CUDA device the
    tick (some 2000 small operations) is captured once as a CUDA graph and
    replayed, which runs the same kernels on the same buffers."""
    b, n, _ = landmarks.shape
    t_total = cmds.shape[1]
    d = 3 + 2 * n
    kp = kernel_params(cfg)
    f = dict(dtype=dtype, device=landmarks.device)
    landmarks, cmds, noise = landmarks.to(dtype), cmds.to(dtype), noise.to(dtype)
    st = {"x": torch.zeros((b, d), **f), "P": torch.zeros((b, d, d), **f),
          "seen": torch.zeros((b, n), **f), "tx": torch.full((b,), kp.x0, **f),
          "ty": torch.full((b,), kp.y0, **f), "tth": torch.full((b,), kp.yaw0, **f),
          "err_sum": torch.zeros(b, **f), "err_max": torch.zeros(b, **f)}
    st["x"][:, 0], st["x"][:, 1], st["x"][:, 2] = kp.x0, kp.y0, kp.yaw0
    for i, v in enumerate(P0):
        st["P"][:, i, i] = v
    cmd_t = torch.empty((b, 2), **f)
    u_t = torch.empty((2 * n + 8, b), **f)
    if emit_traj:
        est_traj = torch.empty((b, t_total, 3), **f)
        true_traj = torch.empty((b, t_total, 3), **f)

    def step():
        for key, val in _tick(kp, landmarks, st, cmd_t, u_t, n).items():
            st[key].copy_(val)

    def run(t):
        cmd_t.copy_(cmds[:, t])
        u_t.copy_(noise[t])
        if graph is None:
            step()
        else:
            graph.replay()
        if emit_traj:
            est_traj[:, t] = st["x"][:, :3]
            true_traj[:, t] = torch.stack([st["tx"], st["ty"], st["tth"]], dim=1)

    graph, warm = None, min(3, t_total)
    cuda = landmarks.is_cuda
    side = torch.cuda.Stream() if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
        for t in range(warm):  # real ticks, eager (the capture's warm-up)
            run(t)
    if cuda:
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    for t in range(warm, t_total):
        run(t)
    res = {"err_sum": st["err_sum"].clone(), "err_max": st["err_max"].clone()}
    if emit_traj:
        res["est_traj"], res["true_traj"] = est_traj, true_traj
    return res


def _tick(kp, landmarks, st, cmd_t, u, n) -> dict:
    """One tick from the state ``st``: the new state's tensors."""
    lx, ly = landmarks[:, :, 0], landmarks[:, :, 1]
    x, P, seen = st["x"].clone(), st["P"].clone(), st["seen"]
    fwd, ang = cmd_t[:, 0], cmd_t[:, 1]
    d_n = torch.clamp(fwd + kp.v00s * u[0], 0.0, kp.d_max)
    h_n = torch.clamp(ang + kp.v11s * u[1], -kp.th_max, kp.th_max)
    tx = st["tx"] + d_n * torch.cos(st["tth"])
    ty = st["ty"] + d_n * torch.sin(st["tth"])
    tth = st["tth"] + h_n
    dxl = lx - tx[:, None]
    dyl = ly - ty[:, None]
    r_true = torch.sqrt(dxl * dxl + dyl * dyl)
    beta = wrap(atan2(dyl, dxl) - tth[:, None])
    vis = ((r_true <= kp.r_max) & (beta > kp.fov_min) & (beta < kp.fov_max)).to(x.dtype)
    rn_all = r_true + kp.w00s * u[2:2 + n].T
    bn_all = beta + kp.w11s * u[2 + n:2 + 2 * n].T

    # predict: rows 0, 1 from row 2, then columns 0, 1 from column 2
    th = x[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    eff_d, eff_th = fwd + kp.v_d, ang + kp.v_th
    u0 = (-fwd * s)[:, None]
    u1 = (fwd * c)[:, None]
    row2 = P[:, 2, :].clone()
    P[:, 0, :] = P[:, 0, :] + u0 * row2
    P[:, 1, :] = P[:, 1, :] + u1 * row2
    col2 = P[:, :, 2].clone()
    P[:, :, 0] = P[:, :, 0] + col2 * u0
    P[:, :, 1] = P[:, :, 1] + col2 * u1
    P[:, 0, 0] = P[:, 0, 0] + c * c * kp.v00f
    P[:, 0, 1] = P[:, 0, 1] + s * c * kp.v00f
    P[:, 1, 0] = P[:, 1, 0] + s * c * kp.v00f
    P[:, 1, 1] = P[:, 1, 1] + s * s * kp.v00f
    P[:, 2, 2] = P[:, 2, 2] + kp.v11f
    x[:, 0] = x[:, 0] + eff_d * c
    x[:, 1] = x[:, 1] + eff_d * s
    x[:, 2] = wrap(th + eff_th)

    m_u_all = vis * seen
    m_i_all = vis * (1.0 - seen)
    for j in range(n):
        li = 3 + 2 * j
        x, P = _update(kp, x, P, li, m_u_all[:, j], rn_all[:, j], bn_all[:, j])
        x, P = _insert(kp, x, P, li, m_i_all[:, j] > 0, rn_all[:, j], bn_all[:, j])

    ex = x[:, 0] - tx
    ey = x[:, 1] - ty
    e = torch.sqrt(ex * ex + ey * ey)
    return {"x": x, "P": P, "seen": torch.maximum(seen, vis), "tx": tx, "ty": ty, "tth": tth,
            "err_sum": st["err_sum"] + e, "err_max": torch.maximum(st["err_max"], e)}


def _update(kp, x, P, li, m_u, rn, bn):
    """EKF update with the landmark in slot li; a zero gain where m_u = 0."""
    xv, yv, thv = x[:, 0], x[:, 1], x[:, 2]
    ddx = x[:, li] - xv
    ddy = x[:, li + 1] - yv
    d2 = torch.clamp_min(ddx * ddx + ddy * ddy, 1e-12)
    dist = torch.sqrt(d2)
    a_r, b_r = ddx / dist, ddy / dist
    a_b, b_b = ddy / d2, ddx / d2
    c0, c1, c2 = P[:, :, 0], P[:, :, 1], P[:, :, 2]
    cl0, cl1 = P[:, :, li], P[:, :, li + 1]
    pr = (cl0 - c0) * a_r[:, None] + (cl1 - c1) * b_r[:, None]
    pb = (c0 - cl0) * a_b[:, None] + (cl1 - c1) * b_b[:, None] - c2
    s00 = (-a_r * pr[:, 0] - b_r * pr[:, 1] + a_r * pr[:, li] + b_r * pr[:, li + 1]) + kp.w00f
    s01 = (-a_r * pb[:, 0] - b_r * pb[:, 1] + a_r * pb[:, li] + b_r * pb[:, li + 1])
    s10 = (a_b * pr[:, 0] - b_b * pr[:, 1] - pr[:, 2] - a_b * pr[:, li] + b_b * pr[:, li + 1])
    s11 = (a_b * pb[:, 0] - b_b * pb[:, 1] - pb[:, 2] - a_b * pb[:, li]
           + b_b * pb[:, li + 1]) + kp.w11f
    det = s00 * s11 - s01 * s10
    det = torch.where(det.abs() > 1e-20, det, 1.0)
    i00, i01 = s11 / det, -s01 / det
    i10, i11 = -s10 / det, s00 / det
    k0 = (pr * i00[:, None] + pb * i10[:, None]) * m_u[:, None]
    k1 = (pr * i01[:, None] + pb * i11[:, None]) * m_u[:, None]
    nu_r = rn - dist - kp.w_r
    nu_b = bn - wrap(atan2(ddy, ddx) - thv) - kp.w_b
    if kp.wrap_innov:
        nu_b = wrap(nu_b)
    x_new = x + k0 * nu_r[:, None] + k1 * nu_b[:, None]
    x_new[:, 2] = wrap(x_new[:, 2])
    r0, r1, r2 = P[:, 0, :], P[:, 1, :], P[:, 2, :]
    rl0, rl1 = P[:, li, :], P[:, li + 1, :]
    hp0 = (rl0 - r0) * a_r[:, None] + (rl1 - r1) * b_r[:, None]
    hp1 = (r0 - rl0) * a_b[:, None] + (rl1 - r1) * b_b[:, None] - r2
    P_new = P - k0[:, :, None] * hp0[:, None, :] - k1[:, :, None] * hp1[:, None, :]
    return x_new, P_new


def _insert(kp, x, P, li, ins, rn, bn):
    """Masked insertion of the landmark in slot li, from the old P."""
    xv, yv, thv = x[:, 0], x[:, 1], x[:, 2]
    tb = thv + bn
    ct, st = torch.cos(tb), torch.sin(tb)
    sx = xv + rn * ct
    sy = yv + rn * st
    ga = -rn * st
    gb = rn * ct
    nr0 = P[:, 0, :] + ga[:, None] * P[:, 2, :]
    nr1 = P[:, 1, :] + gb[:, None] * P[:, 2, :]
    p00, p01, p02 = P[:, 0, 0], P[:, 0, 1], P[:, 0, 2]
    p11, p12, p22 = P[:, 1, 1], P[:, 1, 2], P[:, 2, 2]
    blk00 = p00 + 2.0 * ga * p02 + ga * ga * p22 + ct * ct * kp.w00f + ga * ga * kp.w11f
    blk01 = (p01 + gb * p02 + ga * p12 + ga * gb * p22
             + ct * st * kp.w00f + ga * gb * kp.w11f)
    blk11 = p11 + 2.0 * gb * p12 + gb * gb * p22 + st * st * kp.w00f + gb * gb * kp.w11f
    x[:, li] = torch.where(ins, sx, x[:, li])
    x[:, li + 1] = torch.where(ins, sy, x[:, li + 1])
    insc = ins[:, None]
    P[:, li, :] = torch.where(insc, nr0, P[:, li, :])
    P[:, li + 1, :] = torch.where(insc, nr1, P[:, li + 1, :])
    P[:, :, li] = torch.where(insc, nr0, P[:, :, li])
    P[:, :, li + 1] = torch.where(insc, nr1, P[:, :, li + 1])
    P[:, li, li] = torch.where(ins, blk00, P[:, li, li])
    P[:, li, li + 1] = torch.where(ins, blk01, P[:, li, li + 1])
    P[:, li + 1, li] = torch.where(ins, blk01, P[:, li + 1, li])
    P[:, li + 1, li + 1] = torch.where(ins, blk11, P[:, li + 1, li + 1])
    return x, P
