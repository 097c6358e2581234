"""The port's clicked-goal pursuit (``eval/interactive.GoalPursuit``, on the
native A* and the native job scheduler) and its RRT against the JAX
package's: JAX's three goal-pursuit cases (``tests/test_interactive.py``)
on the port's per-tick step, the first on JAX's own draws beside JAX's run;
``GoalPursuit``'s commands equal to JAX's tick by tick from the same
estimated poses (JAX's Python A* against the port's native one); and RRT's
path equal to JAX's (``tests/test_planning.py``'s wall-with-gap map)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.eval.interactive import GoalPursuit as JGoalPursuit
from live_ekf_slam_tpu.planning.rrt import RRT as JRRT
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.eval.interactive import GoalPursuit
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.planning.host import tf_ekf_to_map
from live_ekf_slam_tpu_torch.planning.rrt import RRT
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from port_harness import few_threads, tick_noise  # noqa: F401  (few_threads: a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

POSE_ATOL = 1e-4  # tests/test_torch_per_tick_runner.py:36


def small(cls, t, **kw):
    cfg = cls(num_iterations=t).replace(filter="ekf_slam", num_landmark_slots=5,
                                        num_meas_slots=5, **kw)
    return cfg.replace(map=cfg.map.__class__(num_landmarks=5))


def world(cfg):
    occ, _ = sim_maps.load_occ_map(cfg)
    lms, n = sim_maps.make_landmarks(cfg, np.random.default_rng(0), occ)
    return occ, lms, n


def test_clicked_goal_closed_loop_reaches_goal():
    """Host planner + per-tick sim/filter: click a goal, the vehicle gets
    there, tick for tick as JAX's does on the same draws."""
    t_total, goal = 400, (1.5, 1.0)
    jcfg = small(JConfig, t_total, occ_map_img="blank.jpg")
    cfg = small(Config, t_total, occ_map_img="blank.jpg")
    occ, lms, n = world(cfg)
    key = jax.random.PRNGKey(1)
    keys = jax.vmap(lambda t: jax.random.fold_in(key, t))(jnp.arange(t_total))
    noise = torch.from_numpy(np.array(tick_noise(keys, n)))

    def drive(gp, step_fn):
        # off-map goals are rejected; the clicked goal plans from the start
        assert not gp.set_goal((99.0, 99.0))
        gp._cur = [0.0, 0.0, 0.0]
        assert gp.set_goal(goal)
        cmd, ests = (0.0, 0.0), []
        for t in range(t_total):
            est = step_fn(cmd, t)
            ests.append(est)
            cmd = gp.on_state(est)
            if np.hypot(est[0] - goal[0], est[1] - goal[1]) < 0.2:
                break
        return np.array(ests)

    jcarry = [jrunner.init_carry(jcfg, jnp.asarray(lms), n)]
    jstep = jax.jit(jrunner.make_step(jcfg, collect="poses"))

    def jax_tick(cmd, t):
        jcarry[0], (_, ep) = jstep(jcarry[0], (jnp.asarray(cmd, jnp.float32), keys[t]))
        return np.asarray(ep)

    carry = [runner.init_carry(cfg, torch.as_tensor(lms)[None], n)]
    step = runner.make_step(cfg, collect="poses")

    def port_tick(cmd, t):
        carry[0], (_, ep) = step(carry[0], torch.tensor([cmd], dtype=torch.float32),
                                 noise[t][None], t)
        return ep[0].numpy()

    want = drive(JGoalPursuit(jcfg, occ), jax_tick)
    got = drive(GoalPursuit(cfg, occ), port_tick)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_ATOL)
    assert np.hypot(got[-1, 0] - goal[0], got[-1, 1] - goal[1]) < 0.25, got[-1]


def test_async_replan_on_native_scheduler():
    """PathPlanningConfig.async_replan: local replans run on the native
    JobScheduler's worker threads, whenever the config asks, and completed
    segments are swapped in; the vehicle makes progress."""
    cfg = small(Config, 200, occ_map_img="building1.png", use_local_planner=True)
    cfg = cfg.replace(path_planning=dataclasses.replace(cfg.path_planning,
                                                        async_replan=True))
    occ, lms, n = world(cfg)
    gp = GoalPursuit(cfg, occ)
    assert gp._sched is not None, "the scheduler runs whenever the config asks"
    carry = runner.init_carry(cfg, torch.as_tensor(lms)[None], n)
    step = runner.make_step(cfg, collect="poses")
    gp._cur = [0.0, 0.0, 0.0]
    noise = philox_noise(1, cfg.num_iterations, n, 1)
    cmd, est = (0.0, 0.0), np.zeros(3)
    for t in range(cfg.num_iterations):
        carry, (_, ep) = step(carry, torch.tensor([cmd], dtype=torch.float32),
                              noise[t].T, t)
        est = ep[0].numpy()
        cmd = gp.on_state(est)
    assert gp.cmd == cmd
    gp.close()  # wait out any replan in flight, then release the pool
    assert gp._sched is None
    assert gp.async_replans > 0, "no async replan ever landed"
    assert np.hypot(est[0], est[1]) > 0.5, f"vehicle never made progress: {est}"


def test_async_blocked_replan_holds_once_and_keeps_queue():
    """A completed but blocked async replan (seg None) mirrors the sync
    path: ONE (0, 0) hold tick, the queue kept, no landed replan counted."""
    cfg = small(Config, 50, occ_map_img="blank.jpg")
    occ, _, _ = world(cfg)
    gp = GoalPursuit(cfg, occ)
    gp._cur = [0.0, 0.0, 0.0]
    assert gp.set_goal((1.5, 1.0))
    q_before = [list(p) for p in gp.pp.goal_queue]
    assert q_before
    gp._pending = {"done": True, "seg": None}
    assert gp.on_state(np.zeros(3)) == (0.0, 0.0)
    assert [list(p) for p in gp.pp.goal_queue] == q_before
    assert gp.async_replans == 0 and gp.async_replans_blocked == 1
    assert gp._pending is None
    assert gp.on_state(np.zeros(3)) != (0.0, 0.0)


@pytest.mark.parametrize("case", ["building1_local_planner", "blank_clicked",
                                  "building1_clicked_direct"])
def test_goal_pursuit_commands_equal_jax(case):
    # the same estimated poses into both packages' GoalPursuit: the same
    # plans (JAX's Python A*, the port's native one) and the same commands
    t_total = 150
    kw = dict(occ_map_img="building1.png")
    if case == "building1_local_planner":
        kw["use_local_planner"] = True
    elif case == "blank_clicked":
        kw["occ_map_img"] = "blank.jpg"
    jcfg, cfg = small(JConfig, t_total, **kw), small(Config, t_total, **kw)
    if case == "building1_clicked_direct":
        jcfg = jcfg.replace(path_planning=dataclasses.replace(
            jcfg.path_planning, nav_method="direct"))
        cfg = cfg.replace(path_planning=dataclasses.replace(
            cfg.path_planning, nav_method="direct"))
    occ, lms, n = world(cfg)
    gps = [JGoalPursuit(jcfg, occ), GoalPursuit(cfg, occ)]
    for gp in gps:
        gp._cur = [0.0, 0.0, 0.0]
    goals = [(3.0, 2.0), (-2.0, 4.0)] if case != "building1_local_planner" else []
    for g in goals:
        assert gps[0].set_goal(g) == gps[1].set_goal(g)
    assert gps[0].pp.goal_queue == gps[1].pp.goal_queue
    assert bool(goals) == (len(gps[1].pp.goal_queue) > 1)
    # the poses: the port's own run driven by its commands
    carry = runner.init_carry(cfg, torch.as_tensor(lms)[None], n)
    step = runner.make_step(cfg, collect="poses")
    noise = philox_noise(2, t_total, n, 1)
    cmd, moved = (0.0, 0.0), 0
    for t in range(t_total):
        carry, (_, ep) = step(carry, torch.tensor([cmd], dtype=torch.float32),
                              noise[t].T, t)
        est = ep[0].numpy()
        want, cmd = gps[0].on_state(est), gps[1].on_state(est)
        assert cmd == want, (t, cmd, want)
        assert gps[0].pp.goal_queue == gps[1].pp.goal_queue, t
        moved += cmd != (0.0, 0.0)
    assert moved > t_total // 2


def test_rrt_path_equals_jax():
    """planning/rrt on a wall with a gap (tests/test_planning.py:258): the
    seeded tree's path is JAX's, waypoint by waypoint, and collision-free."""
    cfg, jcfg = Config(), JConfig()
    s = cfg.map.occ_map_size
    occ = np.ones((s, s), np.float32)
    wall_j = s // 2
    occ[:, wall_j - 1: wall_j + 2] = 0.0
    occ[60:90, wall_j - 1: wall_j + 2] = 1.0  # the gap
    start, goal = (-4.0, 0.0, 0.0), (4.0, 0.0)
    path = RRT(*start, cfg, occ_map=occ).find_path(*goal, max_iters=20000, goal_tol=0.4)
    want = JRRT(*start, jcfg, occ_map=occ).find_path(*goal, max_iters=20000, goal_tol=0.4)
    assert path is not None and path == want
    assert math.hypot(path[-1][0] - goal[0], path[-1][1] - goal[1]) < 0.4
    for x, y in path:
        i, j = tf_ekf_to_map(cfg, (x, y))
        assert occ[i][j] == 1.0
    # no occupancy map: nothing collides, and the seed fixes the tree
    assert RRT(0.0, 0.0, 0.0, cfg).find_path(2.0, 1.0) == \
        JRRT(0.0, 0.0, 0.0, jcfg).find_path(2.0, 1.0)
