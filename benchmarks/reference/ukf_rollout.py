"""The fused sim + UKF-SLAM rollout as plain batched torch.

A frozen copy of the port's ``ops/fused_ukf.fused_ukf_rollout_reference``
(``slam=True``, the default noise model) in the kernel's order of
operations: the state (x, y, cos th, sin th, landmarks...), sigma points
from a pivot-clamped Cholesky of P scaled by n_act / (1 - W_0) over the
active dimensions (the vehicle's and the seen landmarks'), sums over sigma
columns in the kernel's lane order (``lane_sum``) and L-matvec rows summed
in turn (``row_dot``), each visible known landmark's sigma-point update in
id order with the innovation sanity gate (a refused update coasts and is
counted in ``update_rejects``) and the one-pass symmetric Joseph form, then
the insertions. Every pivot and every landmark runs for every world, with
the gain masked to zero where a world has nothing to do (the port's
``predicated=False``, which gives its predicated result bit for bit), so
the tick has no data-dependent branch; on a CUDA device it is captured once
as a CUDA graph and replayed.

``dtype`` is the precision every tensor is kept in: float32 is the
configuration's, bfloat16 the control's. The copy has no library call
(its Cholesky is a loop of elementwise operations, its matvecs products and
sums), so every operation runs in ``dtype``; no product can take TF32, and
the TF32 switches are turned off all the same.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmarks.reference.kernel_math import atan2, wrap

# initial covariance diagonal (ukf.cpp:9-18)
P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005, 0.005 * 0.005)
CHOL_EPS = 1e-8
LANES = 32  # the kernel's warp: the lanes that share a world's sums


def kernel_params(cfg) -> SimpleNamespace:
    """The rollout's constants, rounded to float32 as the kernel's struct
    holds them (the port's ``convert.ukf_kernel_params``). Settings the copy
    does not follow are refused."""
    c = cfg.compat
    if cfg.calibrated_motion or c.noise_vw_swap or c.ukf_zero_bearing_mean \
            or c.ukf_committed_yaw_in_sensing or c.ukf_signed_process_noise:
        raise ValueError("the reference follows the default noise model and sensing only")
    if not cfg.constraints.measurements.landmark_id_is_known:
        raise ValueError("the fused rollout needs known landmark ids")
    if cfg.ukf.sigma_sqrt != "chol":
        raise ValueError("the fused rollout's sigma points come from the Cholesky factor")
    f = lambda v: float(np.float32(v))  # noqa: E731
    pn, sn, nz = cfg.process_noise, cfg.sensing_noise, cfg.sim_noise_scale
    x0, y0, yaw0 = cfg.init_pose
    return SimpleNamespace(
        v00f=f(pn.V_00), v11f=f(pn.V_11), w00f=f(sn.W_00), w11f=f(sn.W_11),
        det_gate=f(min(1e-12, 1e-6 * sn.W_00 * sn.W_11)),
        v00s=f(pn.V_00 * nz), v11s=f(pn.V_11 * nz), w00s=f(sn.W_00 * nz), w11s=f(sn.W_11 * nz),
        v_d=f(pn.v_d), v_th=f(pn.v_th), w_r=f(sn.w_r), w_b=f(sn.w_b),
        wbc=f(math.cos(sn.w_b)), wbs=f(math.sin(sn.w_b)),
        d_max=f(cfg.constraints.commands.d_max), th_max=f(cfg.constraints.commands.th_max),
        r_max=f(cfg.constraints.vision.range_max), fov_min=f(cfg.constraints.vision.fov_min),
        fov_max=f(cfg.constraints.vision.fov_max),
        x0=f(x0), y0=f(y0), yaw0=f(yaw0), cyaw0=f(math.cos(yaw0)), syaw0=f(math.sin(yaw0)),
        w0=f(cfg.ukf.W_0), one_m_w0=f(1.0 - cfg.ukf.W_0),
    )


def lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: lane l adds terms l,
    l + 32, ... in turn, then the 32 partial sums meet in a halving tree."""
    t = torch.nn.functional.pad(t, (0, -t.shape[-1] % LANES))
    acc = torch.zeros_like(t[..., :LANES])
    for c in range(0, t.shape[-1], LANES):
        acc = acc + t[..., c:c + LANES]
    half = LANES
    while half > 1:
        half //= 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def row_dot(L: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """L @ g_a per world and a, each row summed over k in turn from 0:
    L (B, Du, Du), g (B, A, Du) -> (B, A, Du)."""
    prod = L[:, None, :, :] * g[:, :, None, :]
    acc = torch.zeros_like(prod[..., 0])
    for k in range(prod.shape[-1]):
        acc = acc + prod[..., k]
    return acc


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s in true IEEE division (a tensor divided by a Python number is a
    product with the reciprocal on a card)."""
    return x / torch.full_like(x, s)


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t in true IEEE division."""
    return torch.full_like(t, a) / t


def _propagate(px, py, pc, ps, mv, ca, sa):
    """Motion of sigma points: (pc, ps) normalised, rotated by (ca, sa)."""
    nrm = pc * pc + ps * ps
    inv = torch.where(nrm > 0.0, torch.rsqrt(nrm), 0.0)
    cy = torch.where(nrm > 0.0, pc * inv, 1.0)
    sy = ps * inv
    return px + mv * cy, py + mv * sy, cy * ca - sy * sa, sy * ca + cy * sa


def _z_of(kp, lmx, lmy, sx, sy, cy, sy2):
    """Range and bearing direction (cos b, sin b) of a landmark seen from a
    sigma point, by rotation algebra."""
    ddx = lmx - sx
    ddy = lmy - sy
    nrm = ddx * ddx + ddy * ddy
    inv = torch.where(nrm > 0.0, torch.rsqrt(nrm), 0.0)
    ux = ddx * inv
    uy = ddy * inv
    cb = ux * cy + uy * sy2
    sb = uy * cy - ux * sy2
    if kp.w_b != 0.0:
        cb, sb = cb * kp.wbc - sb * kp.wbs, sb * kp.wbc + cb * kp.wbs
    return nrm * inv + kp.w_r, cb, sb


def rollout(cfg, landmarks, cmds, noise, *, dtype=torch.float32) -> dict:
    """err_sum, err_max, update_rejects (B,), true_pose (B, 3), x (B, Du),
    P (B, Du, Du) and seen (B, N) bool of the rollout of every world:
    landmarks (B, N, 2), cmds (B, T, 2), noise (T, 2N+8, B) in [-1, 1),
    Du = 4 + 2N."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, n, _ = landmarks.shape
    t_total = cmds.shape[1]
    du = 4 + 2 * n
    kp = kernel_params(cfg)
    f = dict(dtype=dtype, device=landmarks.device)
    landmarks, cmds, noise = landmarks.to(dtype), cmds.to(dtype), noise.to(dtype)
    st = {"x": torch.zeros((b, du), **f), "P": torch.zeros((b, du, du), **f),
          "seen": torch.zeros((b, n), **f), "tx": torch.full((b,), kp.x0, **f),
          "ty": torch.full((b,), kp.y0, **f), "tth": torch.full((b,), kp.yaw0, **f),
          "err_sum": torch.zeros(b, **f), "err_max": torch.zeros(b, **f),
          "rejects": torch.zeros(b, **f)}
    st["x"][:, 0], st["x"][:, 1], st["x"][:, 2], st["x"][:, 3] = kp.x0, kp.y0, kp.cyaw0, kp.syaw0
    for i, v in enumerate(P0_DIAG):
        st["P"][:, i, i] = v
    cmd_t = torch.empty((b, 2), **f)
    u_t = torch.empty((2 * n + 8, b), **f)

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
    return {"err_sum": st["err_sum"].clone(), "err_max": st["err_max"].clone(),
            "update_rejects": st["rejects"].clone(),
            "true_pose": torch.stack([st["tx"], st["ty"], st["tth"]], dim=1),
            "x": st["x"].clone(), "P": st["P"].clone(), "seen": st["seen"] > 0.5}


def _tick(kp, landmarks, st, cmd_t, u, n) -> dict:
    """One tick from the state ``st``: the new state's tensors."""
    x, P, seen = st["x"].clone(), st["P"].clone(), st["seen"]
    b, du = x.shape
    dt = x.dtype
    w0 = kp.w0
    idx = torch.arange(du, device=x.device)
    lx, ly = landmarks[:, :, 0], landmarks[:, :, 1]
    fwd, ang = cmd_t[:, 0], cmd_t[:, 1]

    # ---- truth propagation and sensing
    d_n = torch.clamp(fwd + kp.v00s * u[0], 0.0, kp.d_max)
    h_n = torch.clamp(ang + kp.v11s * u[1], -kp.th_max, kp.th_max)
    tx = st["tx"] + d_n * torch.cos(st["tth"])
    ty = st["ty"] + d_n * torch.sin(st["tth"])
    tth = st["tth"] + h_n
    dxl = lx - tx[:, None]
    dyl = ly - ty[:, None]
    r_true = torch.sqrt(dxl * dxl + dyl * dyl)
    beta = wrap(atan2(dyl, dxl) - tth[:, None])
    vis = ((r_true <= kp.r_max) & (beta > kp.fov_min) & (beta < kp.fov_max)).to(dt)
    rn_all = r_true + kp.w00s * u[2:2 + n].T
    bn_all = beta + kp.w11s * u[2 + n:2 + 2 * n].T

    # ---- predict: the heading direction of the tick-start state
    xc, xs = x[:, 2], x[:, 3]
    nrm_c = xc * xc + xs * xs
    inv_c = torch.where(nrm_c > 0.0, torch.rsqrt(nrm_c), 0.0)
    cyawv = torch.where(nrm_c > 0.0, xc * inv_c, 1.0)
    syawv = xs * inv_c
    # active sigma columns: the vehicle's and the seen landmarks'
    n_act = 4.0 + 2.0 * seen.sum(dim=1)
    colmask = torch.cat([(idx < 4).to(dt).expand(b, du)[:, :4],
                         seen.repeat_interleave(2, dim=1)], dim=1)
    scale = _div(n_act, kp.one_m_w0)
    wbar = _rdiv(kp.one_m_w0, 2.0 * n_act)
    wm = wbar[:, None] * colmask

    # pivot-clamped Cholesky of P * scale, every pivot
    L = P * scale[:, None, None]
    for j in range(du):
        pivot = L[:, j, j]
        ok = (pivot > CHOL_EPS).to(dt)
        dval = torch.sqrt(torch.clamp_min(pivot, CHOL_EPS))
        below = torch.where(idx > j, L[:, :, j], 0.0) * (ok / dval)[:, None]
        if j + 1 < du:
            L[:, j + 1:, :] = L[:, j + 1:, :] - below[:, j + 1:, None] * below[:, None, :]
        L[:, :, j] = below + (idx == j).to(dt) * dval[:, None]

    # sigma vehicle rows: centre and +/- halves, one column per sigma pair
    mv, ath = fwd + kp.v_d, ang + kp.v_th
    var_d, var_th = kp.v00f, kp.v11f
    ca, sa = torch.cos(ath), torch.sin(ath)
    la = [L[:, a, :] for a in range(4)]
    xv0, xv1 = x[:, 0], x[:, 1]
    col = (mv[:, None], ca[:, None], sa[:, None])
    pxn, pyn, pcn, psn = _propagate(xv0[:, None] + la[0], xv1[:, None] + la[1],
                                    xc[:, None] + la[2], xs[:, None] + la[3], *col)
    mxn, myn, mcn, msn = _propagate(xv0[:, None] - la[0], xv1[:, None] - la[1],
                                    xc[:, None] - la[2], xs[:, None] - la[3], *col)
    cxn, cyn, ccn, csn = _propagate(xv0, xv1, xc, xs, mv, ca, sa)
    sig_p = (pxn, pyn, pcn, psn)
    sig_m = (mxn, myn, mcn, msn)
    sig_c = (cxn, cyn, ccn, csn)

    def wsums(terms):
        return lane_sum(wm[:, None, :] * terms)

    # x_pred: vehicle rows only
    sums = wsums(torch.stack([sig_p[a] + sig_m[a] for a in range(4)], 1))
    m = [w0 * sig_c[a] + sums[:, a] for a in range(4)]
    for a in range(4):
        x[:, a] = m[a]
    x_pred0 = x.clone()

    # P_pred: the vehicle 4x4 block (Q = G V G^T) and vehicle-landmark rows
    dps = [sig_p[a] - m[a][:, None] for a in range(4)]
    dms = [sig_m[a] - m[a][:, None] for a in range(4)]
    dcs = [sig_c[a] - m[a] for a in range(4)]
    qd = {(0, 0): var_d * cyawv * cyawv, (0, 1): var_d * cyawv * syawv,
          (1, 1): var_d * syawv * syawv, (2, 2): var_th * syawv * syawv,
          (2, 3): -var_th * cyawv * syawv, (3, 3): var_th * cyawv * cyawv}
    pairs = [(a, c) for a in range(4) for c in range(a, 4)]
    sums = wsums(torch.stack([dps[a] * dps[c] + dms[a] * dms[c] for a, c in pairs], 1))
    p44 = {}
    for i, (a, c) in enumerate(pairs):
        s = w0 * dcs[a] * dcs[c] + sums[:, i]
        if (a, c) in qd:
            s = s + qd[(a, c)]
        p44[(a, c)] = s
    cross = row_dot(L, wm[:, None, :] * torch.stack([dps[a] - dms[a] for a in range(4)], 1))
    rows4 = []
    for a in range(4):
        row = cross[:, a]
        for c in range(4):
            row[:, c] = p44[(min(a, c), max(a, c))]
        rows4.append(row)
    for a in range(4):
        P[:, a, :] = rows4[a]
    for a in range(4):
        P[:, :, a] = rows4[a]

    # ---- pass 1: landmark updates in id order
    m_u_all = vis * seen
    rejects = st["rejects"]
    for j in range(n):
        m_u = m_u_all[:, j]
        rn, bn = rn_all[:, j], bn_all[:, j]
        li = 4 + 2 * j
        lmx_c, lmy_c = x_pred0[:, li], x_pred0[:, li + 1]
        ll0, ll1 = L[:, li, :], L[:, li + 1, :]
        lxp, lxm = lmx_c[:, None] + ll0, lmx_c[:, None] - ll0
        lyp, lym = lmy_c[:, None] + ll1, lmy_c[:, None] - ll1
        r_p, cb_p, sb_p = _z_of(kp, lxp, lyp, pxn, pyn, pcn, psn)
        r_m, cb_m, sb_m = _z_of(kp, lxm, lym, mxn, myn, mcn, msn)
        r_c, cb_c, sb_c = _z_of(kp, lmx_c, lmy_c, cxn, cyn, ccn, csn)

        sums = wsums(torch.stack([r_p + r_m, sb_p + sb_m, cb_p + cb_m], 1))
        z_r = w0 * r_c + sums[:, 0]
        msb = w0 * sb_c + sums[:, 1]
        mcb = w0 * cb_c + sums[:, 2]
        z_b = atan2(msb, mcb)
        dr_p, dr_m, dr_c = r_p - z_r[:, None], r_m - z_r[:, None], r_c - z_r
        mcb_c, msb_c = mcb[:, None], msb[:, None]
        # wrap(b - z_b) as atan2 of the rotated direction
        db_p = atan2(sb_p * mcb_c - cb_p * msb_c, cb_p * mcb_c + sb_p * msb_c)
        db_m = atan2(sb_m * mcb_c - cb_m * msb_c, cb_m * mcb_c + sb_m * msb_c)
        db_c = atan2(sb_c * mcb - cb_c * msb, cb_c * mcb + sb_c * msb)

        # S, the deviation sums and the vehicle rows of the cross-covariance
        dev4 = [sig_p[a] - x[:, a:a + 1] for a in range(4)]
        dev4m = [sig_m[a] - x[:, a:a + 1] for a in range(4)]
        dev4c = [sig_c[a] - x[:, a] for a in range(4)]
        sums = wsums(torch.stack(
            [dr_p * dr_p + dr_m * dr_m, dr_p * db_p + dr_m * db_m,
             db_p * db_p + db_m * db_m, dr_p + dr_m, db_p + db_m]
            + [dev4[a] * dr_p + dev4m[a] * dr_m for a in range(4)]
            + [dev4[a] * db_p + dev4m[a] * db_m for a in range(4)], 1))
        s00 = w0 * (dr_c * dr_c) + sums[:, 0] + kp.w00f
        s01 = w0 * (dr_c * db_c) + sums[:, 1]
        s11 = w0 * (db_c * db_c) + sums[:, 2] + kp.w11f

        # cross-covariance: landmark rows by delta + L-matvec, vehicle rows
        delta = x_pred0 - x
        lrows = row_dot(L, wm[:, None, :] * torch.stack([dr_p - dr_m, db_p - db_m], 1))
        c_r, c_b = (delta * (w0 * d_c + sums[:, 3 + i])[:, None] + lrows[:, i]
                    for i, d_c in enumerate((dr_c, db_c)))
        for a in range(4):
            c_r[:, a] = w0 * dev4c[a] * dr_c + sums[:, 5 + a]
            c_b[:, a] = w0 * dev4c[a] * db_c + sums[:, 9 + a]

        det_raw = s00 * s11 - s01 * s01
        det = torch.where(det_raw.abs() > 0, det_raw, 1.0)
        i00, i01, i11 = s11 / det, -s01 / det, s00 / det
        nu_r = rn - z_r
        nu_b = wrap(bn - z_b)
        # sanity gate: a refused update coasts instead of going NaN
        sane = ((nu_r.abs() < 2.0 * kp.r_max) & (det_raw > kp.det_gate)
                & (s00 > 0.0) & (s11 > 0.0)).to(dt)
        rejects = rejects + m_u * (1.0 - sane)
        m_g = (m_u * sane)[:, None]
        k0 = (c_r * i00[:, None] + c_b * i01[:, None]) * m_g
        k1 = (c_r * i01[:, None] + c_b * i11[:, None]) * m_g
        x = x + k0 * nu_r[:, None] + k1 * nu_b[:, None]

        # one-pass Joseph form: each pair u_i v_j + v_i u_j is symmetric
        ko0, ko1, cro, cbo = (v[:, :, None] for v in (k0, k1, c_r, c_b))
        kT0, kT1, crT, cbT = (v[:, None, :] for v in (k0, k1, c_r, c_b))
        s00, s01, s11 = (v[:, None, None] for v in (s00, s01, s11))
        P = P + (
            -(ko0 * crT + cro * kT0)
            - (ko1 * cbT + cbo * kT1)
            + s00 * (ko0 * kT0)
            + s01 * (ko0 * kT1 + ko1 * kT0)
            + s11 * (ko1 * kT1)
        )

    # ---- pass 2: insertions, a fresh W block with zero cross terms
    m_i_all = vis * (1.0 - seen)
    yaw_now = atan2(x[:, 3], x[:, 2])
    for j in range(n):
        li = 4 + 2 * j
        rn, bn = rn_all[:, j], bn_all[:, j]
        tb = yaw_now + bn
        sx = x[:, 0] + rn * torch.cos(tb)
        sy = x[:, 1] + rn * torch.sin(tb)
        ins = m_i_all[:, j] > 0
        x[:, li] = torch.where(ins, sx, x[:, li])
        x[:, li + 1] = torch.where(ins, sy, x[:, li + 1])
        P[:, li, li] = torch.where(ins, kp.w00f, P[:, li, li])
        P[:, li + 1, li + 1] = torch.where(ins, kp.w11f, P[:, li + 1, li + 1])

    # ---- error metric
    ex = x[:, 0] - tx
    ey = x[:, 1] - ty
    e = torch.sqrt(ex * ex + ey * ey)
    return {"x": x, "P": P, "seen": torch.maximum(seen, vis), "tx": tx, "ty": ty, "tth": tth,
            "err_sum": st["err_sum"] + e, "err_max": torch.maximum(st["err_max"], e),
            "rejects": rejects}
