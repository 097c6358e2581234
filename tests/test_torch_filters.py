"""The port's per-tick filter models against the JAX models: one tick from a
shared mid-run state and a 50-tick rollout of each, on one measurement
stream made by the JAX simulator, for naive, EKF-SLAM (known ids, unknown
ids, compat quirks, calibrated motion), RI-EKF-SLAM and UKF (SLAM and Loc,
eigh and chol square roots). The tolerances are the JAX tests' own against
their float64 oracle: EKF 5e-5 a step and 2e-3 a trajectory
(test_ekf_parity.py:108, :131), RI-EKF 2e-4 (test_iekf.py:206), UKF 5e-3
(test_ukf_parity.py:59, :125); naive integrates the commands alone, 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.sim import world as jworld
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import filter_state_from_numpy
from live_ekf_slam_tpu_torch.core.types import Measurements
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.models import ekf, iekf, ukf
from port_harness import arc_commands, few_threads  # noqa: F401  (few_threads: a fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, N, T, MID = 4, 6, 50, 25

# name -> (filter, config changes, (one-tick tol, rollout tol))
VARIANTS = {
    "naive": ("naive", {}, (1e-5, 1e-5)),
    "ekf": ("ekf_slam", {}, (5e-5, 2e-3)),
    "ekf_unknown_ids": ("ekf_slam", {"unknown_ids": True}, (5e-5, 2e-3)),
    "ekf_compat": ("ekf_slam", {"compat": True}, (5e-5, 2e-3)),
    "ekf_calibrated": ("ekf_slam", {"calibrated": True}, (5e-5, 2e-3)),
    "iekf": ("iekf_slam", {}, (2e-4, 2e-4)),
    "iekf_calibrated": ("iekf_slam", {"calibrated": True}, (2e-4, 2e-4)),
    "ukf_slam_eigh": ("ukf_slam", {}, (5e-3, 5e-3)),
    "ukf_slam_chol": ("ukf_slam", {"sigma_sqrt": "chol"}, (5e-3, 5e-3)),
    "ukf_slam_compat": ("ukf_slam", {"compat": True}, (5e-3, 5e-3)),
    "ukf_loc_eigh": ("ukf_loc", {}, (5e-3, 5e-3)),
    "ukf_loc_chol": ("ukf_loc", {"sigma_sqrt": "chol"}, (5e-3, 5e-3)),
}


def make_cfg(cls, filt: str, unknown_ids=False, compat=False,
             calibrated=False, sigma_sqrt=None):
    """One of VARIANTS' configs for either package: N landmarks in a 3 m
    box, T ticks."""
    cfg = cls(num_iterations=T).replace(num_landmark_slots=N, num_meas_slots=N,
                                        filter=filt)
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=N, bound=3.0))
    if unknown_ids:
        cons = cfg.constraints
        cfg = cfg.replace(constraints=dataclasses.replace(
            cons, measurements=dataclasses.replace(
                cons.measurements, landmark_id_is_known=False)))
    if compat:
        cfg = cfg.replace(compat=cfg.compat.__class__.all_on())
    if calibrated:
        cfg = cfg.replace(calibrated_motion=True)
    if sigma_sqrt:
        cfg = cfg.replace(ukf=dataclasses.replace(cfg.ukf, sigma_sqrt=sigma_sqrt))
    return cfg


def to_port_meas(m) -> Measurements:
    return Measurements(**{f.name: torch.tensor(np.asarray(getattr(m, f.name)))
                           for f in dataclasses.fields(Measurements)})


@pytest.fixture(scope="module")
def stream():
    """The JAX simulator's T ticks on B random maps: (maps, commands, the
    JAX measurements of each tick)."""
    jcfg = make_cfg(JConfig, "ekf_slam")
    rng = np.random.default_rng(7)
    lms = rng.uniform(-3, 3, (B, N, 2)).astype(np.float32)
    cmds = arc_commands(B, T)
    step = jax.jit(jax.vmap(lambda w, c, k: jworld.sim_step(jcfg, w, c, k)))
    w = jax.vmap(lambda l: jworld.init_world(jcfg, l))(lms)
    meas = []
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(3), T)):
        w, m = step(w, cmds[:, t], jax.random.split(key, B))
        meas.append(m)
    valid = np.stack([np.asarray(m.valid) for m in meas])  # (T, B, N)
    assert valid.sum() > 2 * T and valid.sum(axis=2).max() >= 2
    return lms, cmds, meas


@pytest.fixture(scope="module")
def jax_runs(stream):
    """name -> (the JAX states after every tick), each variant run once."""
    lms, cmds, meas = stream
    cache = {}

    def run(name):
        if name not in cache:
            filt, kw, _ = VARIANTS[name]
            jcfg = make_cfg(JConfig, filt, **kw)
            upd = jax.jit(jax.vmap(lambda s, c, m, tm: jrunner._filter_update(
                jcfg, filt, s, c, m, true_map=tm)))
            s = jax.vmap(lambda _: jrunner._filter_init(jcfg, filt))(jnp.arange(B))
            states = []
            for t in range(T):
                s = upd(s, cmds[:, t], meas[t], lms)
                states.append(s)
            cache[name] = states
        return cache[name]

    return run


def _check(name, s, js, tol):
    filt = VARIANTS[name][0]
    if filt == "naive":
        np.testing.assert_allclose(s.pose.numpy(), np.asarray(js.pose), rtol=0, atol=tol)
        return
    np.testing.assert_array_equal(s.M.numpy(), np.asarray(js.M))
    np.testing.assert_array_equal(s.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=0, atol=tol)
    np.testing.assert_allclose(s.P.numpy(), np.asarray(js.P), rtol=0, atol=tol)
    pose = runner._filter_pose(filt, s).numpy()
    np.testing.assert_allclose(pose, np.asarray(jax.vmap(
        lambda st: jrunner._filter_pose(filt, st))(js)), rtol=0, atol=tol)
    # the routing the pose graph reads: state vector and landmark estimates
    jcfg = JConfig()
    np.testing.assert_allclose(
        runner._filter_state_vector(None, filt, s).numpy(),
        np.asarray(jax.vmap(lambda st: jrunner._filter_state_vector(
            jcfg, filt, st))(js)), rtol=0, atol=tol)
    lm = runner._filter_landmarks(None, filt, s)
    if filt == "ukf_loc":
        assert lm is None
    else:
        jlm = jax.vmap(lambda st: jrunner._filter_landmarks(jcfg, filt, st))(js)
        np.testing.assert_allclose(lm[0].numpy(), np.asarray(jlm[0]), rtol=0, atol=tol)
        np.testing.assert_array_equal(lm[1].numpy(), np.asarray(jlm[1]))


@pytest.mark.parametrize("name", VARIANTS)
def test_one_tick_from_a_shared_state_matches_jax(name, stream, jax_runs):
    lms, cmds, meas = stream
    filt, kw, (tol, _) = VARIANTS[name]
    cfg = make_cfg(Config, filt, **kw)
    states = jax_runs(name)
    s = filter_state_from_numpy(filt, states[MID - 1])
    s = runner._filter_update(cfg, filt, s, torch.from_numpy(cmds[:, MID]),
                              to_port_meas(meas[MID]), torch.from_numpy(lms))
    _check(name, s, states[MID], tol)


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_matches_jax(name, stream, jax_runs):
    lms, cmds, meas = stream
    filt, kw, (_, tol) = VARIANTS[name]
    cfg = make_cfg(Config, filt, **kw)
    s = runner._filter_init(cfg, filt, B, "cpu")
    for t in range(T):
        s = runner._filter_update(cfg, filt, s, torch.from_numpy(cmds[:, t]),
                                  to_port_meas(meas[t]), torch.from_numpy(lms))
    js = jax_runs(name)[-1]
    _check(name, s, js, tol)
    if filt in ("ekf_slam", "iekf_slam", "ukf_slam"):
        assert int(s.M.min()) >= 2, "a world mapped fewer than 2 landmarks"
    assert s.timestep.tolist() == [T] * B


@pytest.mark.parametrize("name", ["ekf", "iekf", "ukf_slam_eigh", "ukf_slam_chol"])
def test_inactive_slots_stay_zero_and_empty_ticks_only_predict(name, stream):
    lms, cmds, meas = stream
    filt, kw, _ = VARIANTS[name]
    cfg = make_cfg(Config, filt, **kw)
    model, off = (ukf, 4) if filt == "ukf_slam" else (iekf if filt == "iekf_slam" else ekf, 3)
    s = runner._filter_init(cfg, filt, B, "cpu")
    for t in range(20):
        s = runner._filter_update(cfg, filt, s, torch.from_numpy(cmds[:, t]),
                                  to_port_meas(meas[t]), torch.from_numpy(lms))
        # rows and columns of slots no world has filled hold exact zeros
        for w in range(B):
            lo = off + 2 * int(s.M[w])
            assert not s.x[w, lo:].any() and not s.P[w, lo:].any()
            assert not s.P[w, :, lo:].any()
    # a tick with every slot masked is the predict alone, bit for bit
    m = to_port_meas(meas[20])
    empty = m.replace(valid=torch.zeros_like(m.valid))
    cmd = torch.from_numpy(cmds[:, 20])
    after = runner._filter_update(cfg, filt, s, cmd, empty, torch.from_numpy(lms))
    if filt == "ukf_slam":
        x_pred, p_pred = model.predict(cfg, s, cmd, True)[:2]
    else:
        x_pred, p_pred = model.predict(cfg, s, cmd)
        p_pred = 0.5 * (p_pred + p_pred.transpose(1, 2))
    assert torch.equal(after.x, x_pred) and torch.equal(after.P, p_pred)
    assert torch.equal(after.M, s.M) and torch.equal(after.ids, s.ids)


def test_iekf_needs_known_ids(stream):
    lms, cmds, meas = stream
    cfg = make_cfg(Config, "iekf_slam", unknown_ids=True)
    s = iekf.init(cfg, B)
    with pytest.raises(ValueError, match="known landmark ids"):
        iekf.update(cfg, s, torch.from_numpy(cmds[:, 0]), to_port_meas(meas[0]))


def test_chol_clamped_matches_jax_and_reconstructs():
    from live_ekf_slam_tpu.models import ukf as jukf

    rng = np.random.default_rng(11)
    a = rng.normal(size=(6, 10, 10)).astype(np.float32)
    p = a @ a.transpose(0, 2, 1)
    p[3, 5:, :] = 0.0  # a semidefinite world: clamped pivots
    p[3, :, 5:] = 0.0
    n_act = np.array([10, 10, 8, 5, 10, 10], np.int32)
    low, bad = ukf.chol_clamped(torch.from_numpy(p), n_active=torch.from_numpy(n_act))
    jlow, jbad = jax.vmap(lambda m, n: jukf.chol_clamped(m, n_active=n))(p, n_act)
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    np.testing.assert_allclose((low @ low.transpose(1, 2))[[0, 1, 2, 4, 5]].numpy(),
                               p[[0, 1, 2, 4, 5]], rtol=0, atol=1e-3)
    # the eigh square root squares back to the clamped matrix
    root = ukf.sqrt_spd_clamped(torch.from_numpy(p))
    np.testing.assert_allclose((root @ root).numpy(), p, rtol=0, atol=2e-3)


def test_metrics_match_jax():
    from live_ekf_slam_tpu.eval import metrics as jmetrics
    from live_ekf_slam_tpu_torch.eval import metrics

    rng = np.random.default_rng(2)
    est, true = (rng.normal(size=(3, 40, 3)).astype(np.float32) for _ in range(2))
    cov = rng.normal(size=(3, 40, 2, 2)).astype(np.float32)
    cov = cov @ cov.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    lms = rng.normal(size=(3, N, 2)).astype(np.float32)
    true_lms = rng.normal(size=(3, N, 2)).astype(np.float32)
    ids = np.stack([rng.permutation(N) for _ in range(3)]).astype(np.int32)
    m = np.array([0, 2, N], np.int32)
    t = torch.from_numpy
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        metrics.avg_position_error(t(est[..., :2]), t(true[..., :2])).numpy(),
        np.asarray(jmetrics.avg_position_error(est[..., :2], true[..., :2])), **close)
    np.testing.assert_allclose(
        metrics.rmse_position(t(est[..., :2]), t(true[..., :2])).numpy(),
        np.asarray(jmetrics.rmse_position(est[..., :2], true[..., :2])), **close)
    np.testing.assert_allclose(
        metrics.nees(t(est), t(true), t(cov)).numpy(),
        np.asarray(jmetrics.nees(est, true, cov)), rtol=1e-4, atol=1e-5)
    j_lm = jax.vmap(jmetrics.landmark_rmse)(lms, ids, m, true_lms)
    np.testing.assert_allclose(
        metrics.landmark_rmse(t(lms), t(ids), t(m), t(true_lms)).numpy(),
        np.asarray(j_lm), **close)
