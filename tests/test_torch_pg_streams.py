"""The pose-graph streams slice as a whole: the port's
``run_monte_carlo_pg_streams`` against the JAX entry point of the same name,
on the same maps, command streams and noise.

The JAX function makes its worlds from a ``jax.random`` key. The test makes
them the same way (the key splits of ``runner.py:535-550``), keeps the maps,
commands and ``noise_u`` draws, and injects them into the port; the JAX
kernels run in interpret mode, the port on the CPU through its plain
versions. Both sides run the same cut-down bulk schedule (8 + 8 + 12
Gauss-Newton iterations in calls of at most 10, 10 CG iterations), which
keeps the plain block-Thomas loops affordable here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.sim.streams import sim_streams as j_streams
from live_ekf_slam_tpu.sim.trajectory import generate_trajectory as j_gen
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import streams_from_numpy
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.models import posegraph as pg
from port_harness import few_threads  # noqa: F401  (fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, SEED = 2, 60, 6, 5


def _cfg(cls, secondary, iterative, t=T):
    cfg = cls(num_iterations=t).replace(
        filter="pose_graph", num_landmark_slots=N, num_meas_slots=N)
    return cfg.replace(
        map=cfg.map.__class__(num_landmarks=N),
        pose_graph=dataclasses.replace(
            cfg.pose_graph, filter_to_compare=secondary,
            solve_graph_every_iteration=iterative, bulk_gn_iters=12,
            bulk_cg_iters=10))


def _jax_worlds(jcfg, key, batch, seed):
    """Maps, commands and noise draws as the JAX entry point makes them."""
    jcfg, lms = jrunner._gen_maps(jcfg, np.random.default_rng(seed), batch)

    def one(l, k):
        k_traj, k_roll = jax.random.split(k)
        cmds = j_gen(jcfg, l, N, k_traj)
        return cmds, j_streams(jcfg, l, N, cmds, k_roll)["noise_u"]

    cmds, noise_u = jax.vmap(one)(lms, jax.random.split(key, batch))
    return (torch.tensor(np.asarray(lms)), torch.tensor(np.asarray(cmds)),
            streams_from_numpy({"noise_u": noise_u})["noise"])


def _both(secondary, iterative, t=T):
    key = jax.random.PRNGKey(6)
    jcfg = _cfg(JConfig, secondary, iterative, t)
    want, _, _ = jrunner.run_monte_carlo_pg_streams(
        jcfg, key, batch=B, seed=SEED, block_worlds=B, interpret=True)
    lms, cmds, noise = _jax_worlds(jcfg, key, B, SEED)
    got, info, _ = runner.run_monte_carlo_pg_streams(
        _cfg(Config, secondary, iterative, t), B, seed=SEED, device="cpu",
        lms=lms, cmds=cmds, noise=noise)
    assert set(got) == set(want)
    assert set(info["seconds"]) == {"inputs", "streams", "secondary",
                                    "assemble", "replay", "solve"}
    return got, want


@pytest.mark.parametrize("secondary", ["naive", "ekf_slam", "iekf_slam"])
def test_bulk_mode_matches_jax(secondary):
    got, want = _both(secondary, False)
    # naive: closed-form cumsums on both sides. Kernel secondaries: the
    # rollout's sequential truth and polynomial atan2 against the streams'
    # cumsum and library atan2, the JAX tests' own 5e-3
    tol = 1e-4 if secondary == "naive" else 5e-3
    for k in ("err_" + secondary, "err_pose_graph_initial"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(got["err_pose_graph_result"],
                               want["err_pose_graph_result"], rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got["err_pose_graph"], got["err_pose_graph_result"])
    for k in ("diverged_" + secondary, "diverged_pose_graph"):
        assert not got[k].any() and not want[k].any(), k
    assert (got["err_pose_graph_result"] < got["err_pose_graph_initial"]).all()


def test_iterative_mode_matches_jax():
    got, want = _both("naive", True, t=40)
    for k in ("err_naive", "err_pose_graph_initial"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["err_pose_graph_result"],
                               want["err_pose_graph_result"], rtol=0, atol=5e-3)
    assert not got["diverged_pose_graph"].any()


def test_replay_prefix_windows_change_cost_not_results(monkeypatch):
    # rows >= cap are invalid and nodes > cap inactive at the ticks a window
    # replays, so cutting the tensors only reorders float sums
    cfg = _cfg(Config, "naive", True, t=80)
    lms, cmds = runner.mc_inputs(cfg, B, 3, "cpu")
    calls = []
    real = pg.replay_iterative

    def spy(cfg_, s, ticks, *a):
        calls.append((s.odom.shape[1], len(ticks)))
        return real(cfg_, s, ticks, *a)

    monkeypatch.setattr(pg, "replay_iterative", spy)
    monkeypatch.setattr(runner, "REPLAY_CAP_STEP", 1024)  # a single window
    full, _, _ = runner.run_monte_carlo_pg_streams(cfg, B, seed=3, device="cpu",
                                                   lms=lms, cmds=cmds)
    assert calls == [(80, 79)]
    calls.clear()
    monkeypatch.setattr(runner, "REPLAY_CAP_STEP", 32)  # windows at 32, 64, 80
    win, _, _ = runner.run_monte_carlo_pg_streams(cfg, B, seed=3, device="cpu",
                                                  lms=lms, cmds=cmds)
    assert calls == [(32, 32), (64, 32), (80, 15)]
    for k in ("err_pose_graph_result", "err_pose_graph_initial"):
        np.testing.assert_allclose(win[k], full[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("window", [32, 80])
def test_replay_window_argument_is_the_cap_step(monkeypatch, window):
    # replay_chunk(window=w) replays exactly as REPLAY_CAP_STEP = w does; a
    # window of T is one window
    cfg = _cfg(Config, "naive", True, t=80)
    lms, cmds = runner.mc_inputs(cfg, B, 3, "cpu")
    seen = []
    real = runner.replay_chunk

    def spy(cfg_, graphs, m_at):
        seen.append((cfg_, graphs, m_at))
        return real(cfg_, graphs, m_at)

    monkeypatch.setattr(runner, "replay_chunk", spy)
    runner.run_monte_carlo_pg_streams(cfg, B, seed=3, device="cpu", lms=lms, cmds=cmds)
    (cfg_, graphs, m_at), = seen
    got = real(cfg_, graphs, m_at, window)
    monkeypatch.setattr(runner, "REPLAY_CAP_STEP", window)
    want = real(cfg_, graphs, m_at)
    for f in ("poses_sol", "lms_sol"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("warm", [False, True])
def test_bulk_solve_keeps_the_reference_schedule_of_calls(monkeypatch, warm):
    # every solve_schur_pcg call starts its damping afresh, so the cut of
    # the 16 + 16 + 50 iterations into calls of at most 10 is part of the
    # numerics (runner.py:755-783 of the JAX package)
    cfg = Config(num_iterations=5).replace(filter="pose_graph")
    cfg = cfg.replace(pose_graph=dataclasses.replace(
        cfg.pose_graph, solve_graph_every_iteration=warm))
    calls = []

    def fake(cfg_, s, p, l, n_gn, n_cg, meas_scale):
        calls.append((meas_scale, n_gn, n_cg, p is s.poses_sol, p is s.poses_init))
        return p, l, torch.zeros(p.shape[0])

    monkeypatch.setattr(pg, "solve_schur_pcg", fake)
    s = pg.assemble_streams(
        cfg, torch.zeros(3, 5, 3), torch.ones(3, 5, 20), torch.zeros(3, 5, 20),
        torch.zeros(3, 5, 20, dtype=torch.bool), torch.zeros(3, 5, 2))
    runner._pg_bulk_solve(cfg, s, torch.zeros(3, 5, 3), 3, solve_chunk=2)
    graduated = ([(16.0, 10), (16.0, 6), (4.0, 10), (4.0, 6)] + [(1.0, 10)] * 5)
    per_chunk = ([(1.0, 10)] * 5 + graduated) if warm else graduated
    assert [(sc, n) for sc, n, *_ in calls] == per_chunk * 2  # chunks of 2 and 1
    assert all(c[2] == 40 for c in calls)
    # a warm solve starts from the replayed solution, a cold one (and the
    # warm solve's rescue) from the seeds
    assert calls[0][3:] == ((True, False) if warm else (False, True))
    assert calls[len(per_chunk) - len(graduated)][3:] == (False, True)


def test_scope_and_argument_errors(monkeypatch):
    cfg = _cfg(Config, "naive", False)
    with pytest.raises(ValueError, match="requires filter=pose_graph"):
        runner.run_monte_carlo_pg_streams(cfg.replace(filter="ekf_slam"), 2, device="cpu")
    pgc = cfg.pose_graph
    for kw, match in [({"update_landmarks_after_adding": True}, "update_landmarks"),
                      ({"filter_to_compare": "ukf_slam"}, "got ukf_slam")]:
        with pytest.raises(ValueError, match=match):
            runner.run_monte_carlo_pg_streams(
                cfg.replace(pose_graph=dataclasses.replace(pgc, **kw)), 2, device="cpu")
    # the dense solver runs (tests/test_torch_pg_solvers.py holds it to
    # JAX); an unknown one is refused
    res, _, _ = runner.run_monte_carlo_pg_streams(
        cfg.replace(num_iterations=12, pose_graph=dataclasses.replace(pgc, solver="dense")),
        2, device="cpu")
    assert np.isfinite(res["err_pose_graph_result"]).all()
    with pytest.raises(ValueError, match="unknown pose_graph.solver"):
        runner.run_monte_carlo_pg_streams(
            cfg.replace(pose_graph=dataclasses.replace(pgc, solver="lu")), 2,
            device="cpu")
    with pytest.raises(ValueError, match="both lms and cmds"):
        runner.run_monte_carlo_pg_streams(cfg, 2, device="cpu",
                                          lms=torch.zeros(2, N, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_monte_carlo_pg_streams(cfg, 2)


def test_results_do_not_depend_on_the_world_chunk():
    cfg = _cfg(Config, "ekf_slam", False, t=30)
    a, _, _ = runner.run_monte_carlo_pg_streams(cfg, 3, seed=2, device="cpu",
                                                world_chunk=3)
    b, _, _ = runner.run_monte_carlo_pg_streams(cfg, 3, seed=2, device="cpu",
                                                world_chunk=2, solve_chunk=1)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
