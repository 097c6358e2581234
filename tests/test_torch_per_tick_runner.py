"""The port's per-tick Monte-Carlo path, run_monte_carlo(impl="per_tick"),
against the JAX runner's impl="xla" at B = 4 worlds, T = 40 ticks, N = 6
landmarks, for the five online filters and their modes: both get the same
maps, and the port's trajectory and simulator draws are rebuilt from JAX's
own key chain. Also a fixed map, the divergence guard with a small radius,
and both packages continued from one mid-run state, once as it is and once
with a NaN put into one world's landmark estimate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import (
    filter_state_from_numpy,
    world_state_from_numpy,
)
from live_ekf_slam_tpu_torch.eval import runner
from port_harness import few_threads, key_chain, tick_noise  # noqa: F401  (few_threads: a fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, SEED = 4, 40, 6, 3
# Per-world average error (metres) and the pose streams (metres, radians):
# both packages run the same float32 algebra; the CPU transcendentals of XLA
# and torch differ in the last bit, which 40 ticks of feedback carry to a few
# 1e-6 (measured: 7e-7 on the errors, 3e-6 on the poses).
ERR_ATOL = 1e-5
POSE_ATOL = 1e-4

# name -> (filter, config changes)
MODES = {
    "naive": ("naive", {}),
    "ekf_slam": ("ekf_slam", {}),
    "ekf_slam_unknown_ids": ("ekf_slam", {"unknown_ids": True}),
    "iekf_slam": ("iekf_slam", {}),
    "ukf_slam_eigh": ("ukf_slam", {}),
    "ukf_slam_chol": ("ukf_slam", {"sigma_sqrt": "chol"}),
    "ukf_loc": ("ukf_loc", {}),
}


def make_cfg(cls, filt, t=T, unknown_ids=False, sigma_sqrt=None, **kw):
    cfg = cls(num_iterations=t).replace(num_landmark_slots=N, num_meas_slots=N,
                                        filter=filt, **kw)
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=N, bound=3.0))
    if unknown_ids:
        cons = cfg.constraints
        cfg = cfg.replace(constraints=dataclasses.replace(
            cons, measurements=dataclasses.replace(
                cons.measurements, landmark_id_is_known=False)))
    if sigma_sqrt:
        cfg = cfg.replace(ukf=dataclasses.replace(cfg.ukf, sigma_sqrt=sigma_sqrt))
    return cfg


def run_both(jcfg, cfg, collect="poses", n=N):
    res_j, fin_j, outs_j = jrunner.run_monte_carlo(
        jcfg, jax.random.PRNGKey(SEED), B, seed=SEED, jit=False, collect=collect)
    traj_u, noise = key_chain(jax.random.PRNGKey(SEED), B, cfg.num_iterations, n)
    res, fin, outs = runner.run_monte_carlo(
        cfg, B, seed=SEED, impl="per_tick", device="cpu", collect=collect,
        noise=noise, traj_u=traj_u)
    return (res_j, fin_j, outs_j), (res, fin, outs)


def _check_results(filt, res_j, res):
    assert set(res) == set(res_j) == {"err_" + filt, "diverged_" + filt}
    np.testing.assert_array_equal(res["diverged_" + filt], res_j["diverged_" + filt])
    np.testing.assert_allclose(res["err_" + filt], res_j["err_" + filt],
                               rtol=0, atol=ERR_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_per_tick_matches_jax_xla(mode):
    filt, kw = MODES[mode]
    (res_j, fin_j, outs_j), (res, fin, outs) = run_both(
        make_cfg(JConfig, filt, **kw), make_cfg(Config, filt, **kw))
    _check_results(filt, res_j, res)
    # collect="poses": (true, est) streams, world-major (B, T, 3)
    assert outs[0].shape == outs[1].shape == (B, T, 3)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(outs_j[0]), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(outs_j[1]), rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(fin.ticks_primary.numpy(), np.asarray(fin_j.ticks_primary))
    if filt in ("ekf_slam", "iekf_slam", "ukf_slam"):
        np.testing.assert_array_equal(fin.primary.M.numpy(), np.asarray(fin_j.primary.M))
        assert int(fin.primary.M.min()) >= 2
    # collect="sums" gives the same results without the streams
    traj_u, noise = key_chain(jax.random.PRNGKey(SEED), B, T, N)
    res_s, _, outs_s = runner.run_monte_carlo(
        make_cfg(Config, filt, **kw), B, seed=SEED, impl="per_tick",
        device="cpu", noise=noise, traj_u=traj_u)
    assert outs_s is None
    np.testing.assert_array_equal(res_s["err_" + filt], res["err_" + filt])


@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_loc"])
def test_fixed_map_runs_on_both_paths(filt):
    t = 80  # the demo map's first landmark is behind the start pose
    jcfg = make_cfg(JConfig, filt, t=t, landmark_map="demo")
    cfg = make_cfg(Config, filt, t=t, landmark_map="demo")
    (res_j, fin_j, _), (res, fin, _) = run_both(jcfg, cfg, collect="sums", n=20)
    _check_results(filt, res_j, res)
    # the capacities grew to the map's 20 landmarks
    assert fin.world.landmarks.shape == (B, 20, 2)
    if filt == "ekf_slam":
        assert fin.primary.x.shape == (B, 43) and int(fin.primary.M.min()) >= 1
    # and the fused path takes the same fixed map
    res_f, out_f, _ = runner.run_monte_carlo(cfg, B, seed=SEED, device="cpu")
    assert out_f["seen"].shape == (B, 20) and np.isfinite(res_f["err_" + filt]).all()


@pytest.mark.parametrize("filt, radius", [("ekf_slam", 0.012), ("ukf_slam", 0.02)])
def test_divergence_guard_matches_jax(filt, radius, monkeypatch):
    # a radius some estimates cross mid-run: those worlds drop out on their
    # own tick, the others run to the end
    monkeypatch.setattr(jrunner, "DIVERGENCE_RADIUS", radius)
    monkeypatch.setattr(runner, "DIVERGENCE_RADIUS", radius)
    (res_j, fin_j, _), (res, fin, _) = run_both(
        make_cfg(JConfig, filt), make_cfg(Config, filt), collect="sums")
    div = res["diverged_" + filt]
    assert div.any() and not div.all(), div
    _check_results(filt, res_j, res)
    ticks = fin.ticks_primary.numpy()
    np.testing.assert_array_equal(ticks, np.asarray(fin_j.ticks_primary))
    assert (ticks[div] < T).all() and (ticks[~div] == T).all()


def _port_carry(fin_j, filt):
    """The port's RunCarry from a JAX RunCarry of a vmap batch."""
    primary = filter_state_from_numpy(filt, fin_j.primary)
    as_t = {f: torch.tensor(np.asarray(getattr(fin_j, f)))
            for f in ("err_sum_primary", "err_sum_secondary", "alive_primary",
                      "alive_secondary", "ticks_primary", "ticks_secondary")}
    return runner.RunCarry(world=world_state_from_numpy(fin_j.world),
                           primary=primary, secondary=None, **as_t)


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_slam"])
def test_continues_from_a_shared_mid_run_state(filt, poison):
    t1, t2 = 20, 30
    jcfg = make_cfg(JConfig, filt, t=t1 + t2)
    cfg = make_cfg(Config, filt, t=t1 + t2)
    lms = np.random.default_rng(5).uniform(-3, 3, (B, N, 2)).astype(np.float32)
    traj_u, _ = key_chain(jax.random.PRNGKey(1), B, t1 + t2, N)
    cmds = runner.generate_trajectory(cfg, torch.from_numpy(lms), N, u=traj_u).numpy()
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    k1s, k2s = jax.random.split(k1, B), jax.random.split(k2, B)

    c0 = jax.vmap(lambda l: jrunner.init_carry(jcfg, l, N))(lms)
    roll = jax.vmap(lambda c, cm, k: jrunner.rollout(jcfg, c, cm, k)[0])
    c_mid = roll(c0, cmds[:, :t1], k1s)
    if poison:
        # a NaN in world 0's estimate of landmark slot 1: the JAX model's
        # one-hot slot reads carry it into every read of that world, so its
        # pose goes non-finite on its next update and the guard drops it
        x = np.asarray(c_mid.primary.x).copy()
        x[0, (4 if filt == "ukf_slam" else 3) + 2] = np.nan
        c_mid = c_mid.replace(primary=c_mid.primary.replace(x=jnp.asarray(x)))
    fin_j = roll(c_mid, cmds[:, t1:], k2s)

    noise = np.stack([tick_noise(jax.random.split(k, t2), N) for k in k2s], axis=2)
    fin, _ = runner.rollout(cfg, _port_carry(c_mid, filt),
                            torch.from_numpy(cmds[:, t1:].copy()),
                            torch.from_numpy(noise))
    alive = fin.alive_primary.numpy()
    np.testing.assert_array_equal(alive, np.asarray(fin_j.alive_primary))
    np.testing.assert_array_equal(fin.ticks_primary.numpy(), np.asarray(fin_j.ticks_primary))
    ticks = np.maximum(fin.ticks_primary.numpy(), 1)
    np.testing.assert_allclose(fin.err_sum_primary.numpy() / ticks,
                               np.asarray(fin_j.err_sum_primary) / ticks,
                               rtol=0, atol=ERR_ATOL)
    assert alive[1:].all() and alive[0] == (not poison)
    if poison:
        assert t1 <= int(fin.ticks_primary[0]) < t1 + t2
        assert not torch.isfinite(fin.primary.x[0, :3]).all()


@pytest.mark.parametrize("filt", ["naive", "ekf_slam"])
def test_zero_command_runs_match_jax(filt):
    # precompute_trajectory=False: the sim still ticks, on zero commands
    kw = dict(precompute_trajectory=False)
    (res_j, _, outs_j), (res, _, outs) = run_both(
        make_cfg(JConfig, filt, **kw), make_cfg(Config, filt, **kw))
    _check_results(filt, res_j, res)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(outs_j[0]), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(outs_j[1]), rtol=0, atol=POSE_ATOL)

