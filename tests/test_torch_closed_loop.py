"""The port's closed loop, run_closed_loop, against the JAX package's
run_closed_loop(jit=True) at B = 4 worlds, T = 40 ticks on the igvc1 course
(37 barrels, 12 measurement slots): EKF-SLAM with pure pursuit and with
direct navigation, RI-EKF-SLAM, windows 0 and 32, the port's draws rebuilt
from JAX's closed-loop key chain; a JAX run stopped after block 3 and
continued in the port; the EKF tick at K = 16 slots < N = 37 landmarks;
``cli igvc1``; the pose graph refused; and the card required unless the
CPU is asked for.

The worlds start at (0.5, 0, pi/2), among the barrels, so that the filters
update (the course's start sees none in 40 ticks). The tolerances are the
per-tick path's (test_torch_per_tick_runner.py:32-33): both packages run
the same float32 algebra, XLA's and torch's CPU transcendentals differ in
the last bit, and 40 ticks of feedback carry that to a few 1e-7 here. The
plans are integer-valued, so the final pursuit paths must be equal.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import preset as jpreset
from live_ekf_slam_tpu.eval import closed_loop as jcl
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.sim import world as jworld
from live_ekf_slam_tpu_torch.config import preset
from live_ekf_slam_tpu_torch.convert import (
    closed_loop_carry_from_numpy,
    filter_state_from_numpy,
    world_state_from_numpy,
)
from live_ekf_slam_tpu_torch.eval import closed_loop as tcl
from live_ekf_slam_tpu_torch.models import ekf
from live_ekf_slam_tpu_torch.sim.maps import IGVC1_BARRELS
from live_ekf_slam_tpu_torch.sim.world import sim_step
from port_harness import closed_loop_noise, few_threads, tick_noise  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, SEED = 4, 40, 37, 0
ERR_ATOL = 1e-5
POSE_ATOL = 1e-4
START = (0.5, 0.0, 1.57)

# name -> (filter, nav_method, astar_window)
CASES = {
    "ekf_slam-pp-w32": ("ekf_slam", "pp", 32),
    "ekf_slam-direct-w0": ("ekf_slam", "direct", 0),
    "iekf_slam-pp-w32": ("iekf_slam", "pp", 32),
}


def make_cfg(preset_fn, filt="ekf_slam", nav="pp", window=32, t=T, start=START,
             meas_slots=12):
    cfg = preset_fn("igvc1", num_iterations=t)
    cfg = cfg.replace(num_landmark_slots=N, num_meas_slots=meas_slots,
                      filter=filt, init_pose=start)
    return cfg.replace(path_planning=dataclasses.replace(
        cfg.path_planning, astar_max_iters=96, local_astar_max_iters=48,
        path_capacity=128, astar_window=window, nav_method=nav))


def _check_pursuit(got, want):
    for f in ("path", "head", "length"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("integ", "err_prev"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=0, atol=POSE_ATOL, err_msg=f)


@pytest.mark.parametrize("case", CASES)
def test_closed_loop_matches_jax(case):
    filt, nav, window = CASES[case]
    jcfg, cfg = make_cfg(jpreset, filt, nav, window), make_cfg(preset, filt, nav, window)
    m_j, f_j, o_j = jcl.run_closed_loop(jcfg, jax.random.PRNGKey(SEED), batch=B,
                                        collect=True, jit=True)
    noise = closed_loop_noise(jax.random.PRNGKey(SEED), B, T, N)
    m, f, o = tcl.run_closed_loop(cfg, B, device="cpu", noise=noise, collect=True)
    key = "err_" + filt
    assert set(m) == set(m_j) == {key, "final_true_pose"}
    np.testing.assert_allclose(m[key], m_j[key], rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(m["final_true_pose"], m_j["final_true_pose"],
                               rtol=0, atol=POSE_ATOL)
    for got, want in zip(o, o_j):
        assert got.shape == (B, T, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, T, 3),
                                   rtol=0, atol=POSE_ATOL)
    _check_pursuit(f.pursuit, f_j.pursuit)
    np.testing.assert_array_equal(f.timestep.numpy(), np.asarray(f_j.timestep))
    np.testing.assert_array_equal(f.filt.M.numpy(), np.asarray(f_j.filt.M))
    assert (f.filt.M > 0).all()  # the filters mapped barrels
    assert (f.pursuit.length > 0).all() or nav == "direct"
    # the vehicles moved
    assert (np.linalg.norm(m["final_true_pose"][:, :2] - np.array(START[:2]), axis=1)
            > 0.3).all()


def test_closed_loop_continues_a_jax_carry():
    # a JAX run stopped after block 3 (the segmented runner) continues in
    # the port; JAX continues it too
    jcfg, cfg = make_cfg(jpreset), make_cfg(preset)
    period = cfg.path_planning.replan_period
    n_blocks = T // period
    init_fn, seg_fn, nb = jcl.build_closed_loop_segmented(jcfg)
    assert nb == n_blocks
    keys = jax.random.split(jax.random.PRNGKey(SEED), B)
    world_keys = jnp.swapaxes(jax.vmap(lambda k: jax.random.split(
        k, n_blocks * period).reshape(n_blocks, period, 2))(keys), 0, 1)
    mid = seg_fn(init_fn(keys), world_keys[:3])
    want = seg_fn(mid, world_keys[3:])
    carry = closed_loop_carry_from_numpy(mid, "ekf_slam", "cpu")
    assert (carry.timestep == 3 * period).all()
    noise = closed_loop_noise(jax.random.PRNGKey(SEED), B, T, N)[3 * period:]
    m, f, _ = tcl.run_closed_loop(cfg, B, device="cpu", noise=noise, carry=carry)
    np.testing.assert_allclose(f.err_sum.numpy(), np.asarray(want.err_sum),
                               rtol=0, atol=T * ERR_ATOL)
    np.testing.assert_allclose(f.world.pose.numpy(), np.asarray(want.world.pose),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(m["err_ekf_slam"], np.asarray(want.err_sum) / T,
                               rtol=0, atol=ERR_ATOL)
    _check_pursuit(f.pursuit, want.pursuit)


def test_ekf_tick_with_fewer_slots_than_landmarks():
    # K = 16 measurement slots, N = 37 landmarks, 20 of them in view of
    # every world: the simulator compacts the visible ones (overflow set),
    # and the EKF tick from the JAX state matches JAX's, tick by tick
    k_slots, ticks = 16, 6
    jcfg = make_cfg(jpreset, meas_slots=k_slots, start=(0.0, 0.0, 0.0))
    cfg = make_cfg(preset, meas_slots=k_slots, start=(0.0, 0.0, 0.0))
    rng = np.random.default_rng(5)
    lms = np.array(IGVC1_BARRELS)
    lms[:20] = np.stack([rng.uniform(0.5, 2.5, 20), rng.uniform(-1.0, 1.0, 20)], 1)
    lms = np.broadcast_to(lms, (B, N, 2)).astype(np.float32).copy()
    cmds = np.tile(np.array([0.05, 0.01], np.float32), (B, 1))
    jw = jax.vmap(lambda l: jworld.init_world(jcfg, l))(jnp.asarray(lms))
    js = jax.vmap(lambda _: jrunner._filter_init(jcfg, "ekf_slam"))(jnp.arange(B))
    step = jax.jit(jax.vmap(lambda w, c, k: jworld.sim_step(jcfg, w, c, k)))
    upd = jax.jit(jax.vmap(lambda s, c, m: jrunner._filter_update(jcfg, "ekf_slam", s, c, m)))
    keys = [jax.random.split(jax.random.PRNGKey(9 + w), ticks) for w in range(B)]
    u = np.stack([tick_noise(k, N) for k in keys], axis=1)  # (ticks, B, 2N+8)
    for t in range(ticks):
        w_t = world_state_from_numpy(jw)
        s_t = filter_state_from_numpy("ekf_slam", js)
        jw, jm = step(jw, jnp.asarray(cmds), jnp.stack([k[t] for k in keys]))
        js = upd(js, jnp.asarray(cmds), jm)
        w_new, meas = sim_step(cfg, w_t, torch.from_numpy(cmds), torch.from_numpy(u[t]))
        assert meas.valid.shape == (B, k_slots)
        for f in ("ids", "valid", "overflow"):
            np.testing.assert_array_equal(getattr(meas, f).numpy(), np.asarray(getattr(jm, f)))
        assert meas.overflow.all() and meas.valid.all()
        for f in ("r", "b"):
            np.testing.assert_allclose(getattr(meas, f).numpy(), np.asarray(getattr(jm, f)),
                                       rtol=0, atol=1e-6)
        s = ekf.update(cfg, s_t, torch.from_numpy(cmds), meas)
        np.testing.assert_array_equal(s.M.numpy(), np.asarray(js.M))
        np.testing.assert_array_equal(s.ids.numpy(), np.asarray(js.ids))
        np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=0, atol=5e-5)
        np.testing.assert_allclose(s.P.numpy(), np.asarray(js.P), rtol=0, atol=5e-5)
    assert int(s.M.min()) >= k_slots


def test_cli_igvc1_prints_its_line():
    r = subprocess.run(
        [sys.executable, "-m", "live_ekf_slam_tpu_torch.cli", "igvc1", "--device",
         "cpu", "--steps", "10"], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("igvc closed loop: avg position error ")
    assert "final true pose [" in line


def test_pose_graph_is_refused_by_both():
    jcfg = make_cfg(jpreset, "pose_graph", t=10)
    with pytest.raises(ValueError):
        jcl.run_closed_loop(jcfg, jax.random.PRNGKey(0), batch=1)
    with pytest.raises(ValueError, match="pose_graph"):
        tcl.run_closed_loop(make_cfg(preset, "pose_graph", t=10), 1, device="cpu")


def test_closed_loop_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_cfg(preset, t=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.run_closed_loop(cfg, 1)
    m, _, _ = tcl.run_closed_loop(cfg, 1, device="cpu")
    assert np.isfinite(m["err_ekf_slam"]).all()
