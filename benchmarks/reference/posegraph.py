"""The bulk pose-graph solve as dense Gauss-Newton, in float64.

The same least-squares problem as the port's ``models/posegraph`` (a prior
on node 0, one between-factor a tick with clip-aware odometry moments, one
bearing-range factor a detection, honest sigmas) and the same schedule as
its cold-start bulk solve (``eval/runner._pg_bulk_solve``: a graduated
16x / 4x / 1x measurement-sigma schedule in calls of at most 10 Gauss-Newton
steps, each call's Levenberg damping starting at 1e-4, a rejected step
raising it 8x and an accepted one lowering it 3x, the better of the full
and the half step taken only if it lowers the error). Each step here solves
the whole damped normal equations exactly: the (3 (T+1) + 2 N)^2 matrix of
every world, assembled densely and solved by Cholesky, where the program reduces
to the poses by Schur complement and runs 40 preconditioned CG steps.
``dtype`` is the precision of the algebra; a dtype torch cannot factor in
(bfloat16, the control's) is factored in float32.
"""

from __future__ import annotations

import torch

from benchmarks.scenario import wrap_angle

S3 = 3.0 ** 0.5
SEG_GN = 10        # Gauss-Newton steps a call (runner.BULK_SEG_GN)
DAMPING = 1e-4     # each call's first damping (solve_schur_pcg)


def _div(x, s: float):
    return x / torch.tensor(float(s), dtype=x.dtype, device=x.device)


def clip_uniform_moments(c, v: float, lo: float, hi: float):
    """Mean and std of clip(c + u, lo, hi), u ~ U(-v, v) (core/noise)."""
    l = torch.clamp(lo - c, -v, v)
    h = torch.clamp(hi - c, -v, v)
    p_lo = _div(l + v, 2.0 * v)
    p_hi = _div(v - h, 2.0 * v)
    mean_g = p_lo * l + p_hi * h + _div(h * h - l * l, 4.0 * v)
    m2_g = p_lo * l * l + p_hi * h * h + _div(h * (h * h) - l * (l * l), 6.0 * v)
    return c + mean_g, torch.sqrt(torch.clamp_min(m2_g - mean_g * mean_g, 0.0))


def _check(cfg):
    pg = cfg.pose_graph
    if cfg.compat.pg_variances_as_sigmas or cfg.compat.noise_vw_swap or pg.exact_logmap:
        raise ValueError("the reference solves the honest, local-coordinates graph only")
    if pg.solver != "schur" or pg.init != "secondary" or pg.solve_graph_every_iteration:
        raise ValueError("the reference follows the cold-start bulk solve only")


class Graph:
    """A world batch's graphs in the algebra's dtype, with the parts of the
    residuals that do not depend on the iterate."""

    def __init__(self, cfg, g: dict, dtype):
        _check(cfg)
        self.cfg, self.dtype = cfg, dtype
        self.g = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in g.items()}
        odom = self.g["odom"]
        v_fwd, v_hdg = cfg.process_noise.V_00, cfg.process_noise.V_11
        eff_d, sig_d = clip_uniform_moments(odom[..., 0], v_fwd, 0.0, cfg.constraints.commands.d_max)
        sig_d = torch.clamp_min(sig_d, 0.1 * v_fwd / S3)
        th_max = cfg.constraints.commands.th_max
        eff_th, sig_th = clip_uniform_moments(odom[..., 1], v_hdg, -th_max, th_max)
        sig_th = torch.clamp_min(sig_th, 0.1 * v_hdg / S3)
        self.eff_d, self.eff_th = eff_d, eff_th
        self.sig = torch.stack([sig_d, torch.full_like(sig_d, 1e-3), sig_th], dim=-1)
        self.prior_s = torch.tensor(cfg.pose_graph.prior_sigmas_honest, dtype=dtype,
                                    device=odom.device)
        b, t = odom.shape[:2]
        n = self.g["lms_init"].shape[1]
        self.onehot = torch.nn.functional.one_hot(self.g["col"], n).to(dtype)  # (B, K, N)
        self.p_active = (torch.arange(t + 1, device=odom.device) <= t - 1).to(dtype)
        self.l_active = (torch.arange(n, device=odom.device)[None] < self.g["M"][:, None]).to(dtype)

    def residuals(self, poses, lms, scale: float):
        cfg, g = self.cfg, self.g
        w00, w11 = cfg.sensing_noise.W_00, cfg.sensing_noise.W_11
        meas_s = (w11 / S3 * scale, w00 / S3 * scale)
        p0 = g["poses_init"][:, 0]
        r_prior = torch.cat([poses[:, 0, :2] - p0[:, :2],
                             wrap_angle(poses[:, 0, 2] - p0[:, 2])[:, None]], dim=1) / self.prior_s
        pa, pb = poses[:, :-1], poses[:, 1:]
        ca, sa = torch.cos(pa[..., 2]), torch.sin(pa[..., 2])
        dx, dy = pb[..., 0] - pa[..., 0], pb[..., 1] - pa[..., 1]
        lx, ly = ca * dx + sa * dy, -sa * dx + ca * dy
        lth = wrap_angle(pb[..., 2] - pa[..., 2])
        r_odom = torch.stack([(lx - self.eff_d) / self.sig[..., 0], ly / self.sig[..., 1],
                              wrap_angle(lth - self.eff_th) / self.sig[..., 2]], dim=-1)
        r_odom = torch.where(g["odom_valid"][..., None], r_odom, 0.0)
        pt = poses[:, 1:, None, :]
        valid = g["meas_valid"]
        lm_at = torch.einsum("bkn,bnc->bkc", self.onehot, lms)[:, None]  # (B, 1, K, 2)
        mdx = torch.where(valid, lm_at[..., 0] - pt[..., 0], 1.0)
        mdy = torch.where(valid, lm_at[..., 1] - pt[..., 1], 0.0)
        rng = torch.sqrt(mdx * mdx + mdy * mdy)
        rng_safe = torch.where(rng > 0, rng, 1.0)
        brg = wrap_angle(torch.atan2(mdy, mdx) - pt[..., 2])
        r_meas = torch.stack([_div(wrap_angle(brg - g["meas_rb"][..., 1]), meas_s[0]),
                              _div(rng - g["meas_rb"][..., 0], meas_s[1])], dim=-1)
        r_meas = torch.where(valid[..., None], r_meas, 0.0)
        return r_prior, r_odom, r_meas, rng_safe, mdx, mdy, meas_s

    def error(self, poses, lms, scale):
        r_prior, r_odom, r_meas = self.residuals(poses, lms, scale)[:3]
        sq = lambda a: (a * a).reshape(a.shape[0], -1).sum(dim=1)  # noqa: E731
        return 0.5 * (sq(r_prior) + sq(r_odom) + sq(r_meas))

    def step(self, poses, lms, scale, lam):
        """The damped Gauss-Newton step (xp, xl) at (poses, lms)."""
        r_prior, r_odom, r_meas, rng_safe, mdx, mdy, meas_s = self.residuals(poses, lms, scale)
        g = self.g
        b, t = g["odom"].shape[:2]
        n = lms.shape[1]
        pa = poses[:, :-1]
        ca, sa = torch.cos(pa[..., 2]), torch.sin(pa[..., 2])
        dx, dy = poses[:, 1:, 0] - pa[..., 0], poses[:, 1:, 1] - pa[..., 1]
        z, o = torch.zeros_like(ca), torch.ones_like(ca)
        ja = torch.stack([torch.stack([-ca, -sa, -sa * dx + ca * dy], -1),
                          torch.stack([sa, -ca, -ca * dx - sa * dy], -1),
                          torch.stack([z, z, -o], -1)], -2)
        jb = torch.stack([torch.stack([ca, sa, z], -1), torch.stack([-sa, ca, z], -1),
                          torch.stack([z, z, o], -1)], -2)
        w = (1.0 / self.sig)[..., :, None] * g["odom_valid"][..., None, None].to(self.dtype)
        ja, jb = ja * w, jb * w
        valid = g["meas_valid"].to(self.dtype)
        r2 = rng_safe * rng_safe
        ab = _div(mdy / r2, meas_s[0]) * valid
        bb = _div(-mdx / r2, meas_s[0]) * valid
        cb = _div(-torch.ones_like(valid), meas_s[0]) * valid
        ar = _div(-mdx / rng_safe, meas_s[1]) * valid
        br = _div(-mdy / rng_safe, meas_s[1]) * valid
        inv_pr = 1.0 / self.prior_s

        # gradient -J^T r
        gp = torch.zeros((b, t + 1, 3), dtype=self.dtype, device=poses.device)
        gp[:, 0] -= inv_pr * r_prior
        gp[:, :-1] -= (ja * r_odom[..., :, None]).sum(-2)
        gp[:, 1:] -= (jb * r_odom[..., :, None]).sum(-2)
        u_b, u_r = -r_meas[..., 0], -r_meas[..., 1]
        px, py, pth = ab * u_b + ar * u_r, bb * u_b + br * u_r, cb * u_b
        gp[:, 1:] += torch.stack([px.sum(2), py.sum(2), pth.sum(2)], -1)
        gl = torch.einsum("bk,bkn->bn", (-px).sum(1), self.onehot)
        gl = torch.stack([gl, torch.einsum("bk,bkn->bn", (-py).sum(1), self.onehot)], -1)

        # J^T J: the pose chain, the landmark blocks and their coupling
        mtm = lambda p, q: (p[..., :, :, None] * q[..., :, None, :]).sum(-3)  # noqa: E731
        d = torch.zeros((b, t + 1, 3, 3), dtype=self.dtype, device=poses.device)
        d[:, 0] += torch.diag(inv_pr * inv_pr)
        d[:, :-1] += mtm(ja, ja)
        d[:, 1:] += mtm(jb, jb)
        hxx, hxy, hyy = ab * ab + ar * ar, ab * bb + ar * br, bb * bb + br * br
        hxt, hyt, htt = ab * cb, bb * cb, cb * cb
        d[:, 1:] += torch.stack([torch.stack([hxx.sum(2), hxy.sum(2), hxt.sum(2)], -1),
                                 torch.stack([hxy.sum(2), hyy.sum(2), hyt.sum(2)], -1),
                                 torch.stack([hxt.sum(2), hyt.sum(2), htt.sum(2)], -1)], -2)
        u = mtm(ja, jb)
        i3 = torch.arange(3, device=poses.device)
        d[:, :, i3, i3] += lam[:, None, None] * d[:, :, i3, i3] + (1.0 - self.p_active)[None, :, None]
        lxx = torch.einsum("bk,bkn->bn", hxx.sum(1), self.onehot)
        lxy = torch.einsum("bk,bkn->bn", hxy.sum(1), self.onehot)
        lyy = torch.einsum("bk,bkn->bn", hyy.sum(1), self.onehot)
        pad = (1.0 - self.l_active) + 1e-12
        lxx = lxx * (1.0 + lam)[:, None] + pad
        lyy = lyy * (1.0 + lam)[:, None] + pad
        cpl = -torch.stack([torch.stack([hxx, hxy], -1), torch.stack([hxy, hyy], -1),
                            torch.stack([hxt, hyt], -1)], -2)           # (B, T, K, 3, 2)
        hpl = torch.einsum("btkij,bkn->btinj", cpl, self.onehot)        # (B, T, 3, N, 2)

        npose = 3 * (t + 1)
        dev = poses.device
        h = torch.zeros((b, npose + 2 * n, npose + 2 * n), dtype=self.dtype, device=dev)

        def put(r0, c0, blocks):
            """Write (B, M, k, k') blocks at rows r0[m] + i, columns c0[m] + j."""
            ri = torch.arange(blocks.shape[-2], device=dev)
            ci = torch.arange(blocks.shape[-1], device=dev)
            h[:, r0[:, None, None] + ri[None, :, None], c0[:, None, None] + ci[None, None, :]] = blocks

        nodes = torch.arange(t + 1, device=dev)
        put(3 * nodes, 3 * nodes, d)
        put(3 * nodes[:-1], 3 * nodes[1:], u)
        put(3 * nodes[1:], 3 * nodes[:-1], u.transpose(-1, -2))
        slots_ = torch.arange(n, device=dev)
        put(npose + 2 * slots_, npose + 2 * slots_,
            torch.stack([torch.stack([lxx, lxy], -1), torch.stack([lxy, lyy], -1)], -2))
        h[:, 3:npose, npose:] = hpl.reshape(b, 3 * t, 2 * n)
        h[:, npose:, 3:npose] = hpl.reshape(b, 3 * t, 2 * n).transpose(1, 2)
        rhs = torch.cat([(gp * self.p_active[None, :, None]).reshape(b, -1),
                         (gl * self.l_active[:, :, None]).reshape(b, -1)], 1)
        solve_dtype = self.dtype if self.dtype in (torch.float32, torch.float64) else torch.float32
        h, rhs = h.to(solve_dtype), rhs.to(solve_dtype)[..., None]
        # cuSOLVER's factorisation a matrix, not MAGMA's batched one (slow at this size)
        lib = torch.backends.cuda.preferred_linalg_library()
        if h.is_cuda:
            torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            fac, info = torch.linalg.cholesky_ex(h)
            x = torch.cholesky_solve(rhs, fac)
            # a world whose matrix is not positive definite gets no step: its
            # error is not finite, so the step is rejected and the damping raised
            x = torch.where((info != 0)[:, None, None], float("nan"), x)
        finally:
            if h.is_cuda:
                torch.backends.cuda.preferred_linalg_library(lib)
        x = x[..., 0].to(self.dtype)
        xp = x[:, :npose].reshape(b, t + 1, 3) * self.p_active[None, :, None]
        xl = x[:, npose:].reshape(b, n, 2) * self.l_active[:, :, None]
        return xp, xl

    def solve_call(self, poses, lms, n_gn: int, scale: float):
        err = self.error(poses, lms, scale)
        lam = torch.full_like(err, DAMPING)
        for _ in range(n_gn):
            xp, xl = self.step(poses, lms, scale, lam)
            cand = []
            for alpha in (1.0, 0.5):
                pn = poses + alpha * xp
                pn[..., 2] = wrap_angle(pn[..., 2])
                ln = lms + alpha * xl
                cand.append((pn, ln, self.error(pn, ln, scale)))
            (p1, l1, e1), (p2, l2, e2) = cand
            half = (e2 < e1)[:, None, None]
            e_new = torch.minimum(e1, e2)
            ok = (e_new < err) & torch.isfinite(e_new)
            okb = ok[:, None, None]
            poses = torch.where(okb, torch.where(half, p2, p1), poses)
            lms = torch.where(okb, torch.where(half, l2, l1), lms)
            err = torch.where(ok, e_new, err)
            lam = torch.where(ok, torch.clamp_min(_div(lam, 3.0), 1e-6), torch.clamp_max(lam * 8.0, 1e4))
        return poses, lms

    def solve(self):
        """The cold-start graduated schedule from the seeds; the solved poses."""
        gn = self.cfg.pose_graph.bulk_gn_iters
        segs = lambda total: [SEG_GN] * (total // SEG_GN) + ([total % SEG_GN] if total % SEG_GN else [])  # noqa: E731
        stage = max(8, gn // 3)
        schedule = ([(16.0, k) for k in segs(stage)] + [(4.0, k) for k in segs(stage)]
                    + [(1.0, k) for k in segs(gn)])
        poses, lms = self.g["poses_init"], self.g["lms_init"]
        for scale, k in schedule:
            poses, lms = self.solve_call(poses, lms, k, scale)
        return poses
