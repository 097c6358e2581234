"""Fused sim + UKF rollout (SLAM and localization): the CUDA kernel's wrapper
and its plain version.

Counterpart of ``live_ekf_slam_tpu/ops/fused_ukf.py`` (``fused_ukf_rollout``).
``fused_ukf_rollout`` runs the whole T-tick rollout of every world: on CUDA
tensors in one launch of the hand-written kernel ``csrc/fused_ukf_rollout.cu``
(whose source note gives the design), on CPU tensors through
``fused_ukf_rollout_reference``, the same algebra as batched torch. There is
no fallback from one to the other.

The algebra is the TPU kernel's: state (x, y, cos th, sin th, landmarks...),
landmark slot = id; sigma points from a pivot-clamped Cholesky of P scaled by
n_act / (1 - W_0), where the active dimensions are the vehicle's and those of
the landmarks seen so far (not a prefix); only the four vehicle rows
propagate; every weighted sigma sum splits into a centre term and a sum over
the +/- columns; the cross-covariance of the landmark rows comes from an
L-matvec; the update is the one-pass Joseph form, which keeps P exactly
symmetric; an innovation sanity gate counts ``update_rejects`` and zeroes the
gain; insertion (SLAM only) puts a fresh W block with zero cross terms.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from live_ekf_slam_tpu_torch.convert import ukf_kernel_params
from live_ekf_slam_tpu_torch.core.noise import _div, motion_moments
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.fused_rollout import check_inputs
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.philox import MASK32, philox_noise_reference
from live_ekf_slam_tpu_torch.parallel.mesh import sharded_rollout
from live_ekf_slam_tpu_torch.utils.profiling import count, span, tracing

# Initial covariance diag (ukf.cpp:9-18).
P0_DIAG = (0.01 * 0.01, 0.01 * 0.01, 0.005 * 0.005, 0.005 * 0.005)
CHOL_EPS = 1e-8
LANES = 32  # the kernel's warp: the lanes that share a world's sums

# launches of each CUDA kernel instantiation (not of the plain version)
launches = {"slam": 0, "loc": 0}
# the phases of a tick, in the order of the kernel's Phase enum
PHASES = ("sim", "cholesky", "sigma_and_4x4", "cross_rows", "z_sweep",
          "second_sweep_and_S", "gain_and_matvecs", "joseph", "insertions",
          "error")


def state_dim(n_lm: int, slam: bool) -> int:
    """Du: (x, y, cos th, sin th) plus two rows a landmark under SLAM."""
    return 4 + 2 * n_lm if slam else 4


def fused_ukf_rollout(
    cfg, landmarks: torch.Tensor, cmds: torch.Tensor, seed: int, *,
    slam: bool = True, noise: torch.Tensor | None = None,
    predicated: bool = True,
) -> dict:
    """Run the full T-tick sim + UKF rollout of a world batch.

    landmarks (B, N, 2) true maps (also the known map under localization);
    cmds (B, T, 2) commanded odometry; seed keys the Philox noise stream,
    unless ``noise`` (T, 2N+8, B) in [-1, 1) is given, which replaces it.
    Returns err_sum (B,), err_max (B,), update_rejects (B,) (updates the
    sanity gate refused), true_pose (B, 3), x (B, Du) holding (x, y, cos th,
    sin th, landmarks...), P (B, Du, Du) and seen (B, N) bool, with
    Du = 4 + 2N for SLAM and 4 for localization (``slam=False``, whose
    ``seen`` stays all false).

    ``predicated=False`` runs every Cholesky pivot and every landmark's
    update and insertion for every world, with the gain masked to zero; the
    result is the same. The TPU version's ``block_worlds`` and ``t_chunk`` cut
    its grid and have no meaning here: the kernel runs one warp per world and
    loops over T.

    The whole call is the span ``les.fused_ukf_rollout`` while a profiler
    records (``utils/profiling``), which then also counts the rollout
    (``ukf.rollouts``) and the updates the sanity gate refused, summed on the
    device (``ukf.update_rejects``).
    """
    res = _shard(cfg, landmarks, cmds, seed, slam=slam, noise=noise, predicated=predicated)
    count("ukf.rollouts", 1)
    return res


def fused_ukf_rollout_sharded(cfg, landmarks, cmds, seed: int, mesh, *,
                              slam: bool = True,
                              noise: torch.Tensor | None = None) -> dict:
    """The fused UKF rollout with its world batch sharded over a 1-D mesh
    (JAX ``fused_ukf_rollout_sharded``), as
    ``fused_rollout.fused_ekf_rollout_sharded`` shards the EKF: shard d
    runs ``fused_ukf_rollout`` on its slice at ``shard_seed(seed, d)``, the
    outputs, ``update_rejects`` included, concatenated over worlds. Each
    shard is a span ``les.fused_ukf_rollout``; the rollout counts once."""
    res = sharded_rollout(functools.partial(_shard, cfg, slam=slam),
                          mesh, landmarks, cmds, seed, noise)
    count("ukf.rollouts", 1)
    return res


def _shard(cfg, landmarks, cmds, seed, *, slam=True, noise=None, predicated=True) -> dict:
    """``fused_ukf_rollout`` on one device, inside its span, counting the
    refused updates while tracing."""
    with span("les.fused_ukf_rollout"):
        dev = landmarks.device
        if dev.type == "cpu":
            res = fused_ukf_rollout_reference(
                cfg, landmarks, cmds, seed, slam=slam, noise=noise,
                predicated=predicated,
            )
        elif dev.type == "cuda":
            res = _launch(cfg, landmarks, cmds, seed, noise, slam, predicated)
        else:
            raise ValueError(f"fused_ukf_rollout runs on cpu or cuda, not {dev}")
        if tracing():
            count("ukf.update_rejects", res["update_rejects"].sum())
        return res


def _launch(cfg, landmarks, cmds, seed, noise, slam, predicated):
    b, n, t_total = check_inputs(landmarks, cmds, noise)
    dev = landmarks.device
    du = state_dim(n, slam)
    f32 = dict(dtype=torch.float32, device=dev)
    res = {
        "err_sum": torch.empty(b, **f32),
        "err_max": torch.empty(b, **f32),
        "update_rejects": torch.empty(b, **f32),
        "true_pose": torch.empty((b, 3), **f32),
        "x": torch.empty((b, du), **f32),
        "P": torch.empty((b, du, du), **f32),
        "seen": torch.empty((b, n), dtype=torch.bool, device=dev),
    }
    kp = ukf_kernel_params(cfg)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.les_fused_ukf_rollout(
            ctypes.addressof(kp), landmarks.data_ptr(), cmds.data_ptr(),
            None if noise is None else noise.data_ptr(),
            int(seed) & MASK32, b, t_total, n, int(slam), int(predicated),
            res["err_sum"].data_ptr(), res["err_max"].data_ptr(),
            res["update_rejects"].data_ptr(), res["true_pose"].data_ptr(),
            res["x"].data_ptr(), res["P"].data_ptr(), res["seen"].data_ptr(),
            stream,
        )
    _build.check(rc, "fused_ukf_rollout kernel")
    _build.count(launches, "slam" if slam else "loc")
    return res


def phase_clocks(cfg, landmarks, cmds, seed, *, slam=True) -> tuple[dict, dict]:
    """One rollout on the card in the build that counts cycles by phase
    (``_build.PHASE_CLOCKS``): returns the clock64() cycles of each phase of
    ``PHASES``, lane 0 of every warp summed over warps and ticks, and the
    rollout's result. A measurement: the clocks slow the kernel a little."""
    def launch():
        res = _launch(cfg, landmarks, cmds, seed, None, slam, True)
        torch.cuda.synchronize(landmarks.device)
        return res
    return _build.phase_cycles("les_ukf_phase_clocks", PHASES, launch)


def occupancy(n_lm: int, slam: bool = True) -> dict:
    """The kernel's launch for ``n_lm`` landmarks as the card takes it
    (``_build.occupancy``)."""
    return _build.occupancy("les_ukf_occupancy", int(slam), n_lm)


def lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order (``warp_sum`` of the
    ``.cu``): lane l adds terms l, l + 32, ... in turn from 0, then the 32
    partial sums meet in an xor butterfly, whose result is that of the
    halving tree below. Float addition does not associate; summed in this
    order, the plain version rounds as the kernel does."""
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
    """L @ g_a per world and a, each row summed over k in turn from 0, as the
    kernel's lane sums the row of L it owns: L (B, Du, Du), g (B, A, Du) ->
    (B, A, Du). L's upper triangle is zero, so the terms past the diagonal,
    which the kernel leaves out, add nothing."""
    prod = L[:, None, :, :] * g[:, :, None, :]
    acc = torch.zeros_like(prod[..., 0])
    for k in range(prod.shape[-1]):
        acc = acc + prod[..., k]
    return acc


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t in true IEEE division; ``float / tensor`` multiplies by the
    reciprocal instead."""
    return torch.full_like(t, a) / t


def _propagate(px, py, pc, ps, mv, ca, sa):
    """Motion of sigma points without per-element transcendentals:
    cos/sin(atan2(ps, pc)) is (pc, ps) normalised, and the new heading
    direction is that rotated by the heading increment (ca, sa)."""
    nrm = pc * pc + ps * ps
    inv = torch.where(nrm > 0.0, torch.rsqrt(nrm), 0.0)
    cy = torch.where(nrm > 0.0, pc * inv, 1.0)
    sy = ps * inv
    return px + mv * cy, py + mv * sy, cy * ca - sy * sa, sy * ca + cy * sa


def _z_of(kp, lmx, lmy, sx, sy, cy, sy2):
    """Range and bearing direction (cos b, sin b) of a landmark seen from a
    sigma point, b = atan2(ddy, ddx) - yaw + w_b, by rotation algebra."""
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


def fused_ukf_rollout_reference(
    cfg, landmarks: torch.Tensor, cmds: torch.Tensor, seed: int, *,
    slam: bool = True, noise: torch.Tensor | None = None,
    predicated: bool = True,
) -> dict:
    """The plain version: the kernel's algebra as batched torch, worlds on
    the leading axis, in the JAX kernel's order of operations, except that
    sums over sigma columns and matvec rows run in the kernel's order
    (``lane_sum``, ``row_dot``): built without FMA contraction, the kernel
    gives the same bits.

    Without ``noise`` it draws the Philox stream the kernel draws in-kernel.
    ``predicated`` skips Cholesky pivots past the batch's highest seen slot
    and a landmark's update or insertion when no world of the batch needs it
    (the TPU kernel's per-block ``pl.when``); skipped or not, the result is
    the same.
    """
    kp = ukf_kernel_params(cfg)  # raises unless landmark ids are known
    b, n, _ = landmarks.shape
    t_total = cmds.shape[1]
    du = state_dim(n, slam)
    dev = landmarks.device
    if noise is None:
        noise = philox_noise_reference(seed, t_total, n, b, device=dev)
    w0 = kp.w0
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.arange(du, device=dev)

    lx, ly = landmarks[:, :, 0], landmarks[:, :, 1]  # (B, N)
    x = torch.zeros((b, du), **f32)
    x[:, 0], x[:, 1], x[:, 2], x[:, 3] = kp.x0, kp.y0, kp.cyaw0, kp.syaw0
    P = torch.zeros((b, du, du), **f32)
    for i, v in enumerate(P0_DIAG):
        P[:, i, i] = v
    seen = torch.zeros((b, n), **f32)
    tx = torch.full((b,), kp.x0, **f32)
    ty = torch.full((b,), kp.y0, **f32)
    tth = torch.full((b,), kp.yaw0, **f32)
    err_sum = torch.zeros(b, **f32)
    err_max = torch.zeros(b, **f32)
    rejects = torch.zeros(b, **f32)

    def wsums(wm, terms):
        """Weighted sums over the +/- sigma columns, wm * term per column,
        for each term stacked on axis 1: (B, A, Du) -> (B, A)."""
        return lane_sum(wm[:, None, :] * terms)

    for t in range(t_total):
        fwd, ang = cmds[:, t, 0], cmds[:, t, 1]
        u = noise[t]  # (2N+8, B)

        # ---- truth propagation and sensing, as in the EKF rollout
        d_n = torch.clamp(fwd + kp.v00s * u[0], 0.0, kp.d_max)
        h_n = torch.clamp(ang + kp.v11s * u[1], -kp.th_max, kp.th_max)
        tx = tx + d_n * torch.cos(tth)
        ty = ty + d_n * torch.sin(tth)
        tth = tth + h_n
        dxl = lx - tx[:, None]
        dyl = ly - ty[:, None]
        r_true = torch.sqrt(dxl * dxl + dyl * dyl)
        beta = wrap(atan2(dyl, dxl) - tth[:, None])
        vis = ((r_true <= kp.r_max) & (beta > kp.fov_min)
               & (beta < kp.fov_max)).to(torch.float32)  # (B, N)
        rn_all = r_true + kp.w00s * u[2:2 + n].T
        bn_all = beta + kp.w11s * u[2 + n:2 + 2 * n].T

        # ---- UKF predict: committed-yaw direction of the tick-start state
        xc, xs = x[:, 2], x[:, 3]
        nrm_c = xc * xc + xs * xs
        inv_c = torch.where(nrm_c > 0.0, torch.rsqrt(nrm_c), 0.0)
        cyawv = torch.where(nrm_c > 0.0, xc * inv_c, 1.0)
        syawv = xs * inv_c
        # active sigma columns: the vehicle's and the seen landmarks' (the
        # active set is not a prefix)
        colmask = (idx < 4).to(torch.float32).expand(b, du)
        if slam:
            n_act = 4.0 + 2.0 * seen.sum(dim=1)
            colmask = torch.cat([colmask[:, :4],
                                 seen.repeat_interleave(2, dim=1)], dim=1)
        else:
            n_act = torch.full((b,), 4.0, **f32)
        scale = _div(n_act, kp.one_m_w0)
        wbar = _rdiv(kp.one_m_w0, 2.0 * n_act)
        wm = wbar[:, None] * colmask  # (B, Du)

        # pivot-clamped Cholesky of P * scale; pivots past the highest seen
        # slot are exact no-ops (rows and columns of unseen slots are zero)
        L = P * scale[:, None, None]
        dmax = du
        if slam and predicated:
            seen_any = (seen > 0).any(dim=0).nonzero()
            dmax = 4 + 2 * (int(seen_any.max()) + 1 if len(seen_any) else 0)
        for j in range(du):
            if j >= 4 and j >= dmax:
                break
            pivot = L[:, j, j]
            ok = (pivot > CHOL_EPS).to(torch.float32)
            dval = torch.sqrt(torch.clamp_min(pivot, CHOL_EPS))
            below = torch.where(idx > j, L[:, :, j], 0.0) * (ok / dval)[:, None]
            if j + 1 < du:
                L[:, j + 1:, :] = (L[:, j + 1:, :]
                                   - below[:, j + 1:, None] * below[:, None, :])
            L[:, :, j] = below + (idx == j).to(torch.float32) * dval[:, None]

        # sigma vehicle rows: centre and +/- halves, one column per sigma pair
        if kp.calibrated:
            mv, ath, var_d, var_th = motion_moments(cfg, fwd, ang)
        else:
            mv, ath = fwd + kp.v_d, ang + kp.v_th
            var_d, var_th = kp.v00f, kp.v11f
        ca, sa = torch.cos(ath), torch.sin(ath)
        la = [L[:, a, :] for a in range(4)]
        xv0, xv1 = x[:, 0], x[:, 1]
        col = (mv[:, None], ca[:, None], sa[:, None])
        pxn, pyn, pcn, psn = _propagate(
            xv0[:, None] + la[0], xv1[:, None] + la[1],
            xc[:, None] + la[2], xs[:, None] + la[3], *col)
        mxn, myn, mcn, msn = _propagate(
            xv0[:, None] - la[0], xv1[:, None] - la[1],
            xc[:, None] - la[2], xs[:, None] - la[3], *col)
        cxn, cyn, ccn, csn = _propagate(xv0, xv1, xc, xs, mv, ca, sa)
        sig_p = (pxn, pyn, pcn, psn)
        sig_m = (mxn, myn, mcn, msn)
        sig_c = (cxn, cyn, ccn, csn)

        # x_pred: vehicle rows only (the landmark rows' +/- L terms cancel)
        sums = wsums(wm, torch.stack([sig_p[a] + sig_m[a] for a in range(4)], 1))
        m = [w0 * sig_c[a] + sums[:, a] for a in range(4)]
        for a in range(4):
            x[:, a] = m[a]
        x_pred0 = x.clone()

        # P_pred: vehicle 4x4 block and vehicle-landmark cross rows; the
        # landmark-landmark block stays
        dps = [sig_p[a] - m[a][:, None] for a in range(4)]
        dms = [sig_m[a] - m[a][:, None] for a in range(4)]
        dcs = [sig_c[a] - m[a] for a in range(4)]
        if kp.signed_q:  # compat: the reference's signed diagonal
            qd = {(0, 0): var_d * cyawv, (1, 1): var_d * syawv,
                  (2, 2): var_th * cyawv, (3, 3): var_th * syawv}
        else:  # Q = G V G^T for the (x, y, cos, sin) state
            qd = {(0, 0): var_d * cyawv * cyawv,
                  (0, 1): var_d * cyawv * syawv,
                  (1, 1): var_d * syawv * syawv,
                  (2, 2): var_th * syawv * syawv,
                  (2, 3): -var_th * cyawv * syawv,
                  (3, 3): var_th * cyawv * cyawv}
        pairs = [(a, c) for a in range(4) for c in range(a, 4)]
        sums = wsums(wm, torch.stack(
            [dps[a] * dps[c] + dms[a] * dms[c] for a, c in pairs], 1))
        p44 = {}
        for i, (a, c) in enumerate(pairs):
            s = w0 * dcs[a] * dcs[c] + sums[:, i]
            if (a, c) in qd:
                s = s + qd[(a, c)]
            p44[(a, c)] = s
        cross = row_dot(L, wm[:, None, :] * torch.stack(
            [dps[a] - dms[a] for a in range(4)], 1))
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
        m_u_all = vis * seen if slam else vis
        for j in range(n):
            m_u = m_u_all[:, j]
            if predicated and not bool(m_u.any()):
                continue
            rn, bn = rn_all[:, j], bn_all[:, j]
            if slam:
                li = 4 + 2 * j
                lmx_c, lmy_c = x_pred0[:, li], x_pred0[:, li + 1]
                ll0, ll1 = L[:, li, :], L[:, li + 1, :]
                lxp, lxm = lmx_c[:, None] + ll0, lmx_c[:, None] - ll0
                lyp, lym = lmy_c[:, None] + ll1, lmy_c[:, None] - ll1
            else:
                lmx_c, lmy_c = lx[:, j], ly[:, j]
                lxp = lxm = lmx_c[:, None].expand(b, du)
                lyp = lym = lmy_c[:, None].expand(b, du)
            if kp.committed_yaw:
                dir_p = dir_m = (cyawv[:, None], syawv[:, None])
                dir_c = (cyawv, syawv)
            else:
                dir_p, dir_m, dir_c = (pcn, psn), (mcn, msn), (ccn, csn)
            r_p, cb_p, sb_p = _z_of(kp, lxp, lyp, pxn, pyn, *dir_p)
            r_m, cb_m, sb_m = _z_of(kp, lxm, lym, mxn, myn, *dir_m)
            r_c, cb_c, sb_c = _z_of(kp, lmx_c, lmy_c, cxn, cyn, *dir_c)

            sums = wsums(wm, torch.stack([r_p + r_m, sb_p + sb_m, cb_p + cb_m], 1))
            z_r = w0 * r_c + sums[:, 0]
            if kp.zero_b_mean:  # compat: the bearing mean stays 0
                z_b = torch.zeros(b, **f32)
                mcb, msb = torch.ones(b, **f32), torch.zeros(b, **f32)
            else:
                msb = w0 * sb_c + sums[:, 1]
                mcb = w0 * cb_c + sums[:, 2]
                z_b = atan2(msb, mcb)
            dr_p, dr_m, dr_c = r_p - z_r[:, None], r_m - z_r[:, None], r_c - z_r
            mcb_c, msb_c = mcb[:, None], msb[:, None]
            # wrap(b - z_b) as atan2 of the rotated direction (scale-free)
            db_p = atan2(sb_p * mcb_c - cb_p * msb_c, cb_p * mcb_c + sb_p * msb_c)
            db_m = atan2(sb_m * mcb_c - cb_m * msb_c, cb_m * mcb_c + sb_m * msb_c)
            db_c = atan2(sb_c * mcb - cb_c * msb, cb_c * mcb + sb_c * msb)

            # S, the sigma-weighted deviation sums and the vehicle rows of the
            # cross-covariance, in one pass over the columns
            dev4 = [sig_p[a] - x[:, a:a + 1] for a in range(4)]
            dev4m = [sig_m[a] - x[:, a:a + 1] for a in range(4)]
            dev4c = [sig_c[a] - x[:, a] for a in range(4)]
            sums = wsums(wm, torch.stack(
                [dr_p * dr_p + dr_m * dr_m, dr_p * db_p + dr_m * db_m,
                 db_p * db_p + db_m * db_m, dr_p + dr_m, db_p + db_m]
                + [dev4[a] * dr_p + dev4m[a] * dr_m for a in range(4)]
                + [dev4[a] * db_p + dev4m[a] * db_m for a in range(4)], 1))
            s00 = w0 * (dr_c * dr_c) + sums[:, 0] + kp.w00f
            s01 = w0 * (dr_c * db_c) + sums[:, 1]
            s11 = w0 * (db_c * db_c) + sums[:, 2] + kp.w11f

            # cross-covariance: landmark rows by delta + L-matvec, vehicle
            # rows explicit
            delta = x_pred0 - x
            lrows = row_dot(L, wm[:, None, :] * torch.stack(
                [dr_p - dr_m, db_p - db_m], 1))
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
                    & (s00 > 0.0) & (s11 > 0.0)).to(torch.float32)
            rejects = rejects + m_u * (1.0 - sane)
            m_g = (m_u * sane)[:, None]
            k0 = (c_r * i00[:, None] + c_b * i01[:, None]) * m_g
            k1 = (c_r * i01[:, None] + c_b * i11[:, None]) * m_g
            x = x + k0 * nu_r[:, None] + k1 * nu_b[:, None]

            # one-pass Joseph form: each pair u_i v_j + v_i u_j is symmetric
            # in IEEE arithmetic, so P stays exactly symmetric
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

        # ---- pass 2: insertions (SLAM only), fresh W block, zero cross terms
        if slam:
            m_i_all = vis * (1.0 - seen)
            yaw_now = atan2(x[:, 3], x[:, 2])
            for j in range(n):
                m_i = m_i_all[:, j]
                if predicated and not bool(m_i.any()):
                    continue
                li = 4 + 2 * j
                rn, bn = rn_all[:, j], bn_all[:, j]
                tb = yaw_now + bn
                sx = x[:, 0] + rn * torch.cos(tb)
                sy = x[:, 1] + rn * torch.sin(tb)
                ins = m_i > 0
                x[:, li] = torch.where(ins, sx, x[:, li])
                x[:, li + 1] = torch.where(ins, sy, x[:, li + 1])
                P[:, li, li] = torch.where(ins, kp.w00f, P[:, li, li])
                P[:, li + 1, li + 1] = torch.where(ins, kp.w11f,
                                                   P[:, li + 1, li + 1])
            seen = torch.maximum(seen, vis)

        # ---- error metric
        ex = x[:, 0] - tx
        ey = x[:, 1] - ty
        e = torch.sqrt(ex * ex + ey * ey)
        err_sum = err_sum + e
        err_max = torch.maximum(err_max, e)

    return {
        "err_sum": err_sum,
        "err_max": err_max,
        "update_rejects": rejects,
        "true_pose": torch.stack([tx, ty, tth], dim=1),
        "x": x,
        "P": P,
        "seen": seen > 0.5,
    }
