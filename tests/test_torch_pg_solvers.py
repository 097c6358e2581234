"""The port's pose-graph solvers against the JAX package's: chordal_init
(with solve_schur_pcg(fix_theta=True)), the dense Levenberg-Marquardt solve,
solve, finalize, the bulk solve's dense branch and run_iterative_pgs.

The graphs are built by the JAX per-tick path (B = 3 worlds, T = 40 ticks,
N = 6 landmarks, naive secondary) and carried over with
``convert.posegraph_state_from_numpy``; the JAX functions run per world
under ``jax.vmap``. The Schur schedules run 8 + 8 + 12 Gauss-Newton steps of
12 CG steps (both packages, the same config).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import pgs_iterative as jpgs
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.models import posegraph as jpg
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import posegraph_state_from_numpy
from live_ekf_slam_tpu_torch.eval import pgs_iterative, runner
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import few_threads, tick_noise  # noqa: F401  (few_threads: a fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, SEED = 3, 40, 6, 3
SOLVER = dict(bulk_gn_iters=12, bulk_cg_iters=12)
# Tolerances (metres and radians on the iterates; relative on the graph
# error). chordal_init: dead reckoning and two linear steps, float32 sum
# order only (measured 2.8e-7), 1e-5. The dense LM: a Cholesky a step, the
# same decisions (measured 1.4e-5 on the iterates, 3e-6 relative on the
# error), 2e-4 and 1e-5. The graduated Schur schedules: 28 Gauss-Newton
# steps of 12 CG steps (measured 8e-5), 1e-3 and 1e-4, as
# test_torch_posegraph's solve_schur_pcg check. Iterates are compared on
# the active nodes 0..T-1 and landmark slots 0..M-1: no solve moves the
# others, and a warm start and the raw-seed rescue hold different values
# there (the rescue's choice of a world may differ between the packages
# where the two residuals are within their rounding).
CHORDAL_ATOL = 1e-5
DENSE_ATOL, DENSE_RTOL = 2e-4, 1e-5
SCHUR_ATOL, SCHUR_RTOL = 1e-3, 1e-4


def make_cfg(cls, **pg_kw):
    cfg = cls(num_iterations=T).replace(num_landmark_slots=N, num_meas_slots=N,
                                        filter="pose_graph")
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=N, bound=3.0))
    kw = dict(SOLVER, solve_graph_every_iteration=False)
    kw.update(pg_kw)
    return cfg.replace(pose_graph=dataclasses.replace(cfg.pose_graph, **kw))


def cfgs(**pg_kw):
    return make_cfg(JConfig, **pg_kw), make_cfg(Config, **pg_kw)


@pytest.fixture(scope="module")
def graphs():
    """(JAX graphs, the port's, the JAX run's true poses (B, T, 3))."""
    jcfg, _ = cfgs()
    _, fin, outs = jrunner.run_monte_carlo(jcfg, jax.random.PRNGKey(SEED), B,
                                           seed=SEED, jit=False, collect="poses")
    return fin.primary, posegraph_state_from_numpy(fin.primary), np.asarray(outs[0])


def close_iterates(got, want, atol, rtol_err, m=None):
    """(poses, lms, err) of the port against JAX's: the active nodes and the
    landmarks of the first m (B,) slots within atol, the error within
    rtol_err."""
    np.testing.assert_allclose(got[0][:, :T].numpy(), np.asarray(want[0])[:, :T],
                               rtol=0, atol=atol)
    lms, lms_want = got[1].numpy(), np.asarray(want[1])
    if m is not None:
        active = np.arange(N)[None, :] < np.asarray(m)[:, None]
        lms, lms_want = lms[active], lms_want[active]
    np.testing.assert_allclose(lms, lms_want, rtol=0, atol=atol)
    if len(got) > 2:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=rtol_err)


def test_chordal_init_matches_jax(graphs):
    js, s, _ = graphs
    jcfg, cfg = cfgs()
    want = jax.jit(jax.vmap(lambda g: jpg.chordal_init(jcfg, g)))(js)
    got = pg.chordal_init(cfg, s)
    close_iterates(got, want, CHORDAL_ATOL, None)
    # the linear solve moved the positions and kept the integrated headings
    seed_p, seed_l = pg.chordal_seed(cfg, s)
    assert torch.equal(got[0][..., 2], seed_p[..., 2])
    assert float((got[0][..., :2] - seed_p[..., :2]).abs().max()) > 1e-4


def test_fix_theta_step_matches_jax_and_keeps_headings(graphs):
    js, s, _ = graphs
    jcfg, cfg = cfgs()
    p0, l0 = pg.chordal_seed(cfg, s)
    p0[..., 2] += 0.01  # headings off the chain's, which the step must keep
    want = jax.vmap(lambda g, p, l: jpg.solve_schur_pcg(
        jcfg, g, p, l, n_gn=3, n_cg=12, fix_theta=True))(
        js, jnp.asarray(p0.numpy()), jnp.asarray(l0.numpy()))
    got = pg.solve_schur_pcg(cfg, s, p0, l0, n_gn=3, n_cg=12, fix_theta=True)
    close_iterates(got, want, CHORDAL_ATOL, 1e-5)
    torch.testing.assert_close(got[0][..., 2], pg.wrap_angle(p0[..., 2]), rtol=0, atol=0)


def test_solve_dense_matches_jax_and_the_schur_solve(graphs):
    js, s, _ = graphs
    jcfg, cfg = cfgs()
    want = jax.jit(jax.vmap(lambda g: jpg.solve_dense(jcfg, g)))(js)
    got = pg.solve_dense(cfg, s)
    close_iterates(got, want, DENSE_ATOL, DENSE_RTOL)
    # the Schur solve reaches the dense optimum (tests/test_posegraph.py's
    # test_schur_solver_matches_dense: objective within 2%, trajectory 2 cm)
    ps, _, es = pg.solve_schur_pcg(cfg, s, s.poses_init, s.lms_init, n_gn=50, n_cg=40)
    assert bool((es <= got[2] * 1.02 + 1e-3).all()), (es, got[2])
    np.testing.assert_allclose(ps[:, :T, :2].numpy(), got[0][:, :T, :2].numpy(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("start", ["secondary", "chordal", "warm"])
def test_solve_matches_jax(graphs, start):
    js, s, _ = graphs
    jcfg, cfg = cfgs(init="chordal" if start == "chordal" else "secondary")
    if start == "warm":
        rng = np.random.default_rng(1)
        p0 = (np.asarray(js.poses_init) + rng.normal(0, 0.01, (B, T + 1, 3))).astype(np.float32)
        l0 = (np.asarray(js.lms_init) + rng.normal(0, 0.01, (B, N, 2))).astype(np.float32)
        want = jax.jit(jax.vmap(lambda g, p, l: jpg.solve(jcfg, g, p, l)))(
            js, jnp.asarray(p0), jnp.asarray(l0))
        got = pg.solve(cfg, s, torch.from_numpy(p0), torch.from_numpy(l0))
    else:
        want = jax.jit(jax.vmap(lambda g: jpg.solve(jcfg, g)))(js)
        got = pg.solve(cfg, s)
    close_iterates(got, want, SCHUR_ATOL, SCHUR_RTOL, s.M)
    e0 = pg.graph_error(cfg, s, s.poses_init, s.lms_init)
    assert bool((got[2] < e0).all())


@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_finalize_matches_jax(graphs, solver):
    # iterative mode: warm-started from the per-tick history (here the
    # seeds moved a little)
    js, _, _ = graphs
    rng = np.random.default_rng(2)
    js = js.replace(
        poses_sol=jnp.asarray(np.asarray(js.poses_init)
                              + rng.normal(0, 0.01, (B, T + 1, 3)).astype(np.float32)),
        lms_sol=jnp.asarray(np.asarray(js.lms_init)
                            + rng.normal(0, 0.01, (B, N, 2)).astype(np.float32)))
    jcfg, cfg = cfgs(solver=solver, solve_graph_every_iteration=True)
    want = jax.jit(jax.vmap(lambda g: jpg.finalize(jcfg, g)))(js)
    got = pg.finalize(cfg, posegraph_state_from_numpy(js))
    atol = DENSE_ATOL if solver == "dense" else SCHUR_ATOL
    close_iterates((got.poses_sol, got.lms_sol), (want.poses_sol, want.lms_sol), atol,
                   None, js.M)
    assert bool(got.solved.all())


def test_bulk_solve_dense_branch_matches_jax(graphs):
    js, s, true_poses = graphs
    jcfg, cfg = cfgs(solver="dense")
    want = jrunner._pg_bulk_solve(jcfg, js, jnp.asarray(true_poses), B, solve_chunk=2)
    got = runner._pg_bulk_solve(cfg, s, torch.tensor(true_poses), B, solve_chunk=2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DENSE_ATOL)
    np.testing.assert_array_equal(got[1], want[1])


def test_dense_stage_rejects_the_step_of_a_non_pd_system(graphs, monkeypatch):
    # world 0's normal matrix made negative definite (-1e12 I): its damped
    # system stays indefinite up to lambda = 1e10, so every Cholesky fails;
    # JAX's cho_factor gives NaN and the port's cholesky_ex its info, the
    # step is NaN and rejected each time, until lambda passes 1e10. World 0
    # ends where it began, in both packages; the port's other worlds solve
    # as they do unpoisoned.
    js, s, _ = graphs
    jcfg, cfg = cfgs()
    clean = pg._solve_stage(cfg, s, s.poses_init, s.lms_init, 1.0)
    e0 = pg.graph_error(cfg, s, s.poses_init, s.lms_init)

    def poison_j(*a, **kw):
        h, g, active = assemble_j(*a, **kw)
        return -1e12 * jnp.eye(h.shape[0], dtype=h.dtype), g, active

    def poison(*a, **kw):
        h, g, active = assemble(*a, **kw)
        return torch.cat([-1e12 * torch.eye(h.shape[1])[None], h[1:]]), g, active

    assemble_j, assemble = jpg._assemble, pg._assemble
    monkeypatch.setattr(jpg, "_assemble", poison_j)
    monkeypatch.setattr(pg, "_assemble", poison)
    w0 = jax.tree.map(lambda a: a[0], js)
    want = jax.jit(lambda g: jpg._solve_stage(jcfg, g, g.poses_init, g.lms_init, 1.0))(w0)
    got = pg._solve_stage(cfg, s, s.poses_init, s.lms_init, 1.0)
    np.testing.assert_array_equal(np.asarray(want[0]), np.asarray(w0.poses_init))
    np.testing.assert_array_equal(np.asarray(want[1]), np.asarray(w0.lms_init))
    assert torch.equal(got[0][0], s.poses_init[0]) and torch.equal(got[1][0], s.lms_init[0])
    assert float(got[2][0]) == float(e0[0])
    for a, b in zip(got, clean):
        assert torch.equal(a[1:], b[1:])


def test_run_iterative_pgs_matches_jax():
    # one world, re-solved every 10 ticks; the port's draws rebuilt from the
    # key JAX splits
    jcfg, cfg = cfgs(solve_graph_every_iteration=True)
    lms = random_landmarks_batched(cfg, np.random.default_rng(4), 1)[0]
    key = jax.random.PRNGKey(7)
    want = jpgs.run_iterative_pgs(jcfg, jnp.asarray(lms), key, solve_stride=10)
    # run_iterative_pgs splits the key itself, where run_monte_carlo splits
    # a world's key: the chain of world key ``key`` is that of B = 1 runs
    # keyed by any k with split(k, 1)[0] == key, so it is rebuilt directly
    k_traj, k_roll = jax.random.split(key)
    traj_u = torch.from_numpy(np.asarray(jax.random.uniform(
        k_traj, (N, 2), jnp.float32, -1.0, 1.0))[None])
    noise = torch.from_numpy(tick_noise(jax.random.split(k_roll, T), N)[:, :, None])
    got = pgs_iterative.run_iterative_pgs(cfg, lms, solve_stride=10, device="cpu",
                                          noise=noise, traj_u=traj_u)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["true"], want["true"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["secondary"], want["secondary"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["pgs_result"], want["pgs_result"], rtol=0, atol=SCHUR_ATOL)
    np.testing.assert_allclose(got["landmarks_result"], want["landmarks_result"],
                               rtol=0, atol=SCHUR_ATOL)
    assert abs(got["err_secondary"] - want["err_secondary"]) < 1e-5
    assert abs(got["err_pose_graph_result"] - want["err_pose_graph_result"]) < SCHUR_ATOL
