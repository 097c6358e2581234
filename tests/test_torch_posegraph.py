"""The port's pose-graph module (``models/posegraph.py``) against the JAX
module, function by function, on the same graphs.

Graphs are made on the JAX side (closed-form streams of seeded worlds, the
naive secondary, ``assemble_streams``) and carried over with
``convert.posegraph_state_from_numpy``; the JAX functions are per world under
``jax.vmap``, the port's take the batch. The block-Thomas recursions run
through their plain versions here (the kernels are held against those on the
card, tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.models import posegraph as jpg
from live_ekf_slam_tpu.sim.streams import naive_deadreckon as j_naive
from live_ekf_slam_tpu.sim.streams import sim_streams as j_streams
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import posegraph_state_from_numpy
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import few_threads, small_cfg  # noqa: F401  (few_threads: a fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, BOUND = 3, 30, 5, 4.0
# (honest or compat sigmas, exact_logmap)
VARIANTS = [("default", False), ("default", True), ("compat", False),
            ("compat", True)]


def _cfgs(kind, exact, t=T, n=N):
    out = []
    for cls, compat in ((Config, CompatConfig), (JConfig, JCompat)):
        cfg = small_cfg(cls, compat, kind, t, n, BOUND).replace(filter="pose_graph")
        out.append(cfg.replace(pose_graph=dataclasses.replace(
            cfg.pose_graph, exact_logmap=exact)))
    return out


def _graph(kind, exact, seed=7):
    """(cfg, jcfg, port state, JAX state, port (poses, lms), JAX (poses,
    lms)): seeded worlds and an iterate a little off the seeds."""
    cfg, jcfg = _cfgs(kind, exact)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, B)
    cmds = np.stack([rng.uniform(0.02, 0.1, (B, T)),
                     rng.uniform(-0.05, 0.05, (B, T))], axis=-1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)

    def one(l, c, k):
        st = j_streams(jcfg, l, N, c, k)
        return jpg.assemble_streams(jcfg, j_naive(jcfg, c), st["r"], st["b"],
                                    st["vis"], c)

    js = jax.vmap(one)(jnp.asarray(lms), jnp.asarray(cmds), keys)
    s = posegraph_state_from_numpy(js)
    assert int(s.meas_valid.sum()) > 10 * B, "the worlds see too little"
    poses = np.asarray(js.poses_init) + rng.normal(0, 0.01, (B, T + 1, 3)).astype(np.float32)
    lm0 = np.asarray(js.lms_init) + rng.normal(0, 0.02, (B, N, 2)).astype(np.float32)
    return (cfg, jcfg, s, js, (torch.from_numpy(poses), torch.from_numpy(lm0)),
            (jnp.asarray(poses), jnp.asarray(lm0)))


def close(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want|: whitened weights reach 1e7, so the
    scale of an array, not of each entry, is what float32 sums resolve."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def test_assemble_streams_matches_jax_field_for_field():
    # the inputs of the JAX test of assemble_streams against the update scan
    # (tests/test_posegraph.py): sparse visibility with a same-tick double
    # first sighting and a never-seen landmark; a second world shifts them
    t, n = 14, 5
    cfg, jcfg = _cfgs("default", False, t, n)
    rng = np.random.default_rng(11)
    worlds = []
    for w in range(2):
        cmds = np.stack([rng.uniform(0, 0.1, t), rng.uniform(-0.05, 0.05, t)], axis=1)
        est = np.cumsum(rng.normal(0, 0.1, (t, 3)), axis=0)
        r = rng.uniform(0.5, 3.0, (t, n))
        b = rng.uniform(-1.5, 1.5, (t, n))
        vis = rng.random((t, n)) < 0.3
        vis[:, 4 - w] = False
        vis[3, 0] = vis[3, 1] = True
        vis[:3, :2] = False
        worlds.append([a.astype(np.float32) for a in (est, r, b)] + [vis, cmds.astype(np.float32)])
    est, r, b, vis, cmds = (np.stack(a) for a in zip(*worlds))
    want = jax.vmap(lambda *a: jpg.assemble_streams(jcfg, *a))(
        *(jnp.asarray(a) for a in (est, r, b, vis, cmds)))
    got = pg.assemble_streams(cfg, *(torch.from_numpy(a) for a in (est, r, b, vis, cmds)))
    ref = posegraph_state_from_numpy(want)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(ref, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if g.dtype == torch.float32:  # seeds go through sin and cos
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f.name)
        else:
            assert torch.equal(g, w), f.name
    # more measurement slots than landmarks: padded with invalid slots
    wide = pg.assemble_streams(cfg.replace(num_meas_slots=n + 2), *(
        torch.from_numpy(a) for a in (est, r, b, vis, cmds)))
    assert wide.meas_valid.shape == (2, t, n + 2)
    assert not wide.meas_valid[:, :, n:].any()
    with pytest.raises(ValueError, match="num_meas_slots"):
        pg.assemble_streams(cfg.replace(num_meas_slots=n - 1), *(
            torch.from_numpy(a) for a in (est, r, b, vis, cmds)))


@pytest.mark.parametrize("kind,exact", VARIANTS)
def test_residuals_gradient_and_blocks_match_jax(kind, exact):
    cfg, jcfg, s, js, (p, l), (jp, jl) = _graph(kind, exact)
    # float32 sums of whitened terms in another order: 1e-5 of the scale
    want = jax.vmap(lambda s_, p_, l_: jpg.graph_error(jcfg, s_, p_, l_, 4.0))(js, jp, jl)
    np.testing.assert_allclose(pg.graph_error(cfg, s, p, l, 4.0).numpy(),
                               np.asarray(want), rtol=1e-5)

    def j_all(s_, p_, l_):
        jac = jpg._jacobians(jcfg, s_, p_, l_)
        coeffs, r_meas = jpg._meas_coeffs(jcfg, s_, p_, l_, 1.0)
        gp, gl = jpg._grad(jcfg, s_, jac, coeffs, r_meas)
        d, u, act = jpg._pose_blocks(jcfg, s_, jac, coeffs, 1e-4)
        inv, lact = jpg._lm_hessian_inv(jcfg, s_, jac, coeffs, 1e-4)
        dp, dl = jpg._h_diag(s_, jac, coeffs)
        hp, hl = jpg._hv(s_, jac, coeffs, gp, gl)
        return dict(ja=jac["ja"], jb=jac["jb"], coeffs=jnp.stack(coeffs), gp=gp,
                    gl=gl, d=d, u=u, act=act, inv=inv, lact=lact,
                    wl=jpg._hpl_t_apply(s_, coeffs, gp),
                    yp=jpg._hpl_apply(s_, coeffs, gl), dp=dp, dl=dl, hp=hp, hl=hl)

    want = jax.vmap(j_all)(js, jp, jl)
    for slots in (pg.LmSlots(s), pg.LmSlots(s, detect=False)):
        jac = pg._jacobians(cfg, s, p, l, slots=slots)
        coeffs, r_meas = pg._meas_coeffs(cfg, s, p, l, 1.0, slots)
        gp, gl = pg._grad(cfg, s, jac, coeffs, r_meas, slots)
        d, u, act = pg._pose_blocks(cfg, s, jac, coeffs, 1e-4)
        inv, lact = pg._lm_hessian_inv(cfg, s, jac, coeffs, 1e-4, slots)
        dp, dl = pg._h_diag(s, jac, coeffs, slots)
        hp, hl = pg._hv(s, jac, coeffs, gp, gl, slots)
        got = dict(ja=jac["ja"], jb=jac["jb"], coeffs=torch.stack(coeffs, dim=1),
                   gp=gp, gl=gl, d=d, u=u, act=act, inv=inv, lact=lact,
                   wl=pg._hpl_t_apply(s, coeffs, gp, slots),
                   yp=pg._hpl_apply(s, coeffs, gl, slots), dp=dp, dl=dl, hp=hp, hl=hl)
        for k in want:
            # entries like -sa dx + ca dy cancel, and XLA's CPU code
            # contracts them into FMAs: 1e-4 of the array's scale
            close(got[k], want[k], 1e-4, k)
    assert pg.LmSlots(s).by_column and not pg.LmSlots(s, detect=False).by_column


@pytest.mark.parametrize("case", ["by_column", "flat", "fix_theta", "exact_logmap"])
def test_schur_system_reference_matches_jax(case):
    # the system kernel's plain version (P3's order of sums) against the
    # quantities JAX's solve_schur_pcg sets up in a Gauss-Newton step: the
    # blocks, the landmark inverses, the masked gradients, the reduced rhs
    # and the coefficients, each world at its own damping
    cfg, jcfg, s, js, (p, l), (jp, jl) = _graph("default", case == "exact_logmap")
    fix = case == "fix_theta"
    lam = np.asarray([1e-4, 1e-2, 3.0], np.float32)

    def j_system(s_, p_, l_, lam_):
        jac = jpg._jacobians(jcfg, s_, p_, l_, 4.0)
        coeffs, r_meas = jpg._meas_coeffs(jcfg, s_, p_, l_, 4.0)
        if fix:  # as solve_schur_pcg(fix_theta=True) freezes the headings
            jac = dict(jac, ja=jac["ja"].at[:, :, 2].set(0.0),
                       jb=jac["jb"].at[:, :, 2].set(0.0))
            coeffs = coeffs[:2] + (jnp.zeros_like(coeffs[2]),) + coeffs[3:]
        gp, gl = jpg._grad(jcfg, s_, jac, coeffs, r_meas)
        if fix:
            gp = gp.at[:, 2].set(0.0)
        d, u, act = jpg._pose_blocks(jcfg, s_, jac, coeffs, lam_)
        if fix:
            d = d.at[:, 2, 2].add(1.0)
        inv, lact = jpg._lm_hessian_inv(jcfg, s_, jac, coeffs, lam_)
        gl = gl * lact[:, None]
        rhs = gp * act[:, None] - jpg._hpl_apply(s_, coeffs,
                                                 jpg._hll_inv_apply(inv, gl))
        return dict(d=d, u=u, hll_inv=inv, gp=gp, gl=gl, rhs=rhs, p_active=act,
                    l_active=lact, coeffs=jnp.stack(coeffs))

    want = jax.vmap(j_system)(js, jp, jl, jnp.asarray(lam))
    slots = pg.LmSlots(s, detect=case != "flat")
    assert slots.by_column == (case != "flat")
    got = pg._schur_system_reference(cfg, s, p, l, 4.0, torch.from_numpy(lam),
                                     slots, fix)
    got = dict(got, coeffs=torch.stack(got["coeffs"], dim=1))
    for k in want:
        # as the pieces above: XLA contracts cancelling products into FMAs
        close(got[k], want[k], 1e-4, k)
    if fix:
        assert not bool(got["gp"][..., 2].any()) and not bool(got["coeffs"][:, 2].any())


def test_lm_slots_fall_back_to_scatter_when_a_column_changes_slot():
    cfg, _, s, _, (p, l), _ = _graph("default", False)
    # swap the slots two landmarks hold, in the second half of the ticks
    # only: column j no longer binds to one slot
    lm = s.meas_lm.clone()
    half = lm[:, T // 2:]
    half[(s.meas_lm[:, T // 2:] == 0) & s.meas_valid[:, T // 2:]] = 1
    half[(s.meas_lm[:, T // 2:] == 1) & s.meas_valid[:, T // 2:]] = 0
    s2 = s.replace(meas_lm=lm)
    slots = pg.LmSlots(s2)
    assert not slots.by_column
    vals = torch.rand(s.meas_valid.shape) * s.meas_valid
    want = torch.zeros(B, N)
    for w in range(B):
        want[w].index_add_(0, lm[w].reshape(-1).long(), vals[w].reshape(-1))
    torch.testing.assert_close(slots.scatter(vals), want)
    v = torch.rand(B, N)
    assert torch.equal(slots.gather(v)[1, 20, 2], v[1, lm[1, 20, 2]])


def _dense(d, u):
    """The block-tridiagonal matrix of one world, float64."""
    t1 = d.shape[0]
    a = np.zeros((3 * t1, 3 * t1))
    for t in range(t1):
        a[3 * t:3 * t + 3, 3 * t:3 * t + 3] = d[t]
        if t + 1 < t1:
            a[3 * t:3 * t + 3, 3 * t + 3:3 * t + 6] = u[t]
            a[3 * t + 3:3 * t + 6, 3 * t:3 * t + 3] = u[t].T
    return a


@pytest.mark.parametrize("kind,exact", [("default", False), ("compat", True)])
def test_block_thomas_matches_jax_and_a_dense_float64_solve(kind, exact):
    cfg, jcfg, s, js, (p, l), (jp, jl) = _graph(kind, exact)
    jac = pg._jacobians(cfg, s, p, l)
    coeffs, r_meas = pg._meas_coeffs(cfg, s, p, l, 1.0)
    d, u, _ = pg._pose_blocks(cfg, s, jac, coeffs, 1e-4)
    rhs, _ = pg._grad(cfg, s, jac, coeffs, r_meas)
    fac = pg._tridiag_factor(d, u)
    x = pg._tridiag_solve(fac, rhs)
    assert pg.launches == {"factor": 0, "solve": 0, "schur_mv": 0, "system": 0}  # the CPU ran the plain loops

    def j_solve(d_, u_, r_):
        f = jpg._tridiag_factor(d_, u_)
        return f, jpg._tridiag_solve(f, r_)

    jfac, jx = jax.vmap(j_solve)(*(jnp.asarray(a.numpy()) for a in (d, u, rhs)))
    assert set(fac) == set(jfac)
    # T = 30 steps of float32 3x3 algebra with products summed in another
    # order; the Schur blocks of weakly observed nodes have condition
    # numbers near 100 (entries of sinv up to ~100), which their inverses
    # multiply the rounding by
    for k in fac:
        close(fac[k], jfac[k], 1e-3, k)
    close(x, jx, 1e-4, "x")
    for w in range(B):
        want = np.linalg.solve(_dense(d[w].double().numpy(), u[w].double().numpy()),
                               rhs[w].double().numpy().reshape(-1))
        # float32 against float64 on a system whose entries span 1e7
        close(x[w].reshape(-1), want, 1e-4, f"world {w}")


def test_inv3_inverts_and_guards_a_singular_block():
    a = torch.tensor(np.random.default_rng(0).normal(size=(5, 3, 3)), dtype=torch.float32)
    a = a @ a.transpose(1, 2) + torch.eye(3)
    torch.testing.assert_close(pg._inv3(a) @ a, torch.eye(3).expand(5, 3, 3),
                               rtol=0, atol=1e-5)
    assert torch.isfinite(pg._inv3(torch.zeros(1, 3, 3))).all()


@pytest.mark.parametrize("kind,exact", VARIANTS)
def test_solve_schur_pcg_matches_jax(kind, exact):
    cfg, jcfg, s, js, (p, l), (jp, jl) = _graph(kind, exact)
    want = jax.vmap(lambda s_, p_, l_: jpg.solve_schur_pcg(
        jcfg, s_, p_, l_, n_gn=8, n_cg=12, meas_scale=4.0))(js, jp, jl)
    got = pg.solve_schur_pcg(cfg, s, p, l, n_gn=8, n_cg=12, meas_scale=4.0)
    e0 = pg.graph_error(cfg, s, p, l, 4.0)
    assert bool((got[2] < 0.5 * e0).all()), "the solver did not descend"
    # eight Gauss-Newton steps of twelve CG iterations each carry the
    # float32 differences of every sum; the iterates stay within a
    # millimetre and the residual within a percent
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    # (a world that sees no landmark fits its odometry exactly: its
    # residual is rounding noise, hence the floor at 1e-6 of the start)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-2,
                               atol=1e-6 * float(e0.max()))
    # with the headings fixed (chordal_init's solve) they stay as they came
    fixed = pg.solve_schur_pcg(cfg, s, p, l, n_gn=2, n_cg=12, fix_theta=True)
    assert torch.equal(fixed[0][..., 2], pg.wrap_angle(p[..., 2]))
    assert bool((fixed[2] < pg.graph_error(cfg, s, p, l)).all())


@pytest.mark.parametrize("kind,exact", [("default", False), ("compat", True)])
def test_solve_pcg_gn_matches_jax(kind, exact):
    cfg, jcfg, s, js, (p, l), (jp, jl) = _graph(kind, exact)
    want = jax.vmap(lambda s_, p_, l_: jpg.solve_pcg_gn(
        jcfg, s_, p_, l_, n_gn=2, n_cg=12))(js, jp, jl)
    got = pg.solve_pcg_gn(cfg, s, p, l, n_gn=2, n_cg=12)
    # two warm-started steps: float32 sum order only
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)


def test_replay_iterative_and_solve_iteration_match_jax():
    cfg, jcfg, s, js, _, _ = _graph("default", False)
    vis_live = np.asarray(js.meas_valid)
    tidx = np.arange(T)
    first_t = np.where(vis_live.any(1), vis_live.argmax(1), T)  # by column = id
    m_at = (first_t[:, None, :] <= tidx[None, :, None]).sum(2).astype(np.int32)
    ticks = np.arange(T - 1)

    def one(s_, m_):
        p_, l_ = jpg.replay_iterative(jcfg, s_, jnp.asarray(ticks), s_.poses_sol,
                                      s_.lms_sol, m_)
        out = jpg.solve_iteration(jcfg, s_.replace(poses_sol=p_, lms_sol=l_),
                                  s_.M, node_t=jnp.int32(T - 1))
        return p_, l_, out.poses_sol, out.lms_sol

    want = jax.vmap(one)(js, jnp.asarray(m_at))
    p_sol, l_sol = pg.replay_iterative(cfg, s, ticks, s.poses_sol, s.lms_sol,
                                       torch.from_numpy(m_at))
    out = pg.solve_iteration(cfg, s.replace(poses_sol=p_sol, lms_sol=l_sol),
                             s.M, node_t=T - 1)
    assert bool(out.solved.all())
    # 29 warm-started solves in a row, each fed by the last
    for g, w in zip((p_sol, l_sol, out.poses_sol, out.lms_sol), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)
