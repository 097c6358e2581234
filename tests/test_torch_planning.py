"""The port's planning layer against the JAX package's: ``distance_field``,
``extract_path``, ``astar`` and ``local_planner`` on the igvc1 and building1
grids (the JAX package's Pillow path) for seeded starts, goals and poses,
with diagonals on and off and with no window, a 16-cell and a 64-cell
window; the ADVICE #4 case (a local goal outside A*'s window); and every
pure-pursuit function.

The JAX functions run jitted, as the closed loop runs them (XLA turns their
divisions by constants into products with the float32 reciprocal, which
the port spells out). Cells, flags and planned points must be equal
exactly: relaxation is integer-valued min-plus. Pure pursuit is held
within PP_ATOL (integer fields exactly): XLA's and torch's CPU atan2,
sqrt and power kernels may differ in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu import native
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.planning import astar as jastar
from live_ekf_slam_tpu.planning import pure_pursuit as jpp
from live_ekf_slam_tpu.sim import maps as jmaps
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval import closed_loop as tcl
from live_ekf_slam_tpu_torch.planning import astar as tastar
from live_ekf_slam_tpu_torch.planning import pure_pursuit as tpp
from port_harness import few_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

B = 12
PP_ATOL = 1e-6
GRIDS = ("igvc1.png", "building1.png")


def cfgs(window=0, diagonals=True, **pp):
    """(JAX config, port config) with the given planning knobs."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls()
        out.append(cfg.replace(path_planning=dataclasses.replace(
            cfg.path_planning, astar_window=window,
            astar_incl_diagonals=diagonals, astar_max_iters=96,
            local_astar_max_iters=48, path_capacity=64, **pp)))
    return out


@pytest.fixture(scope="module")
def grids():
    assert not native.available()  # JAX's Pillow path is the reference
    out = {}
    for name in GRIDS:
        occ, _ = jmaps.load_occ_map(JConfig().replace(occ_map_img=name))
        out[name] = occ
    return out


def _starts(cfg, occ, seed):
    """Seeded start points and goals 0.5-3 m away (world coords), some
    starts inside obstacles (asserted)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-9.5, 9.5, (B, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, B)
    rad = rng.uniform(0.5, 3.0, B)
    goal = (start + np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)).astype(np.float32)
    ij = np.asarray(jastar.tf_ekf_to_map(cfg, jnp.asarray(start)))
    ij = np.clip(ij, 0, occ.shape[0] - 1)
    return start, goal, occ[ij[:, 0], ij[:, 1]] < 0.5


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("diagonals", [True, False])
@pytest.mark.parametrize("max_iters", [12, 200])
def test_distance_field_and_extract_path_match_jax(grids, name, diagonals, max_iters):
    occ = grids[name]
    jcfg, cfg = cfgs()
    start, goal, blocked = _starts(jcfg, occ, 1)
    assert blocked.any()  # the escape rule is exercised
    s_ij = np.clip(np.asarray(jastar.tf_ekf_to_map(jcfg, jnp.asarray(start))), 0, 149)
    g_ij = np.clip(np.asarray(jastar.tf_ekf_to_map(jcfg, jnp.asarray(goal))), 0, 149)
    jd = jax.jit(jax.vmap(lambda s: jastar.distance_field(
        jnp.asarray(occ), s, max_iters, diagonals)))(jnp.asarray(s_ij))
    jd = np.array(jd)
    for every in (0, 1, 8):
        d = tastar.distance_field(torch.from_numpy(occ), torch.from_numpy(s_ij),
                                  max_iters, diagonals, check_every=every)
        np.testing.assert_array_equal(d.numpy(), jd)
    jc, jv, jr = jax.jit(jax.vmap(lambda d, g: jastar.extract_path(
        d, g, 64, diagonals)))(jnp.asarray(jd), jnp.asarray(g_ij))
    c, v, r = tastar.extract_path(torch.from_numpy(jd), torch.from_numpy(g_ij), 64,
                                  diagonals)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    if max_iters == 200:
        assert r.any()


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("window,diagonals", [(0, True), (0, False), (16, True),
                                              (64, True), (64, False)])
def test_astar_matches_jax(grids, name, window, diagonals):
    occ = grids[name]
    jcfg, cfg = cfgs(window, diagonals)
    start, goal, blocked = _starts(jcfg, occ, 2)
    assert blocked.any()
    jp, jv, jr = jax.jit(jax.vmap(lambda s, g: jastar.astar(
        jcfg, jnp.asarray(occ), s, g)))(jnp.asarray(start), jnp.asarray(goal))
    p, v, r = tastar.astar(cfg, torch.from_numpy(occ), torch.from_numpy(start),
                           torch.from_numpy(goal))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert r.any()
    if window == 16:
        assert (~r).any()  # goals outside the small window


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("window", [0, 16, 64])
def test_local_planner_matches_jax(grids, name, window):
    occ = grids[name]
    jcfg, cfg = cfgs(window)
    rng = np.random.default_rng(3)
    poses = np.concatenate([rng.uniform(-9.5, 9.5, (4 * B, 2)),
                            rng.uniform(-np.pi, np.pi, (4 * B, 1))], 1).astype(np.float32)
    jg, jok = jax.jit(jax.vmap(lambda p: jastar.local_planner(
        jcfg, jnp.asarray(occ), p)))(jnp.asarray(poses))
    g, ok = tastar.local_planner(cfg, torch.from_numpy(occ), torch.from_numpy(poses))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    # some ideal cells are blocked: the BFS spill picked another cell
    d = cfg.path_planning.local_planner_dist
    ideal = poses[:, :2] + d * np.stack([np.cos(poses[:, 2]), np.sin(poses[:, 2])], 1)
    moved = np.abs(g.numpy() - ideal).max(axis=1) > cfg.grid_scale
    assert moved.any()


def test_tf_transforms_match_jax():
    jcfg, cfg = cfgs()
    xy = np.random.default_rng(4).uniform(-12, 12, (4096, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jastar.tf_ekf_to_map(jcfg, a))(xy))
    np.testing.assert_array_equal(tastar.tf_ekf_to_map(cfg, torch.from_numpy(xy)).numpy(), want)
    back = np.asarray(jax.jit(lambda a: jastar.tf_map_to_ekf(jcfg, a))(want))
    np.testing.assert_array_equal(tastar.tf_map_to_ekf(cfg, torch.from_numpy(want)).numpy(),
                                  back)


def _advice4_grid():
    """A free 150^2 grid with a block of obstacle from 5 to 18 cells ahead
    of the centre cell (rows +/-10): from a pose there heading east, the
    ideal cell (13.5 cells ahead) is blocked and its nearest free cell is
    19 columns ahead, outside a 32-cell window centred on the start."""
    occ = np.ones((150, 150), np.float32)
    occ[75 - 10:75 + 11, 75 + 5:75 + 19] = 0.0
    return occ


def test_local_goal_outside_the_astar_window_keeps_the_old_path():
    # ADVICE #4 (live_ekf_slam_tpu/planning/astar.py:213): the local
    # planner's crop is centred on the ideal cell, A*'s on the start, so the
    # goal can lie outside A*'s window; both packages then report
    # reached=False and the closed loop keeps the old path
    occ = _advice4_grid()
    jcfg, cfg = cfgs(32)
    pose = np.array([[0.0, 0.0, 0.0]], np.float32)  # the centre cell, east
    jg, jok = jax.jit(jax.vmap(lambda p: jastar.local_planner(
        jcfg, jnp.asarray(occ), p)))(jnp.asarray(pose))
    g, ok = tastar.local_planner(cfg, torch.from_numpy(occ), torch.from_numpy(pose))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert bool(ok[0]) and bool(jok[0])
    goal_ij = tastar.tf_ekf_to_map(cfg, g)[0]
    assert goal_ij[1] - 75 >= 16  # outside A*'s window [-16, 16)
    _, jv, jr = jax.jit(jax.vmap(lambda s, gg: jastar.astar(
        jcfg, jnp.asarray(occ), s, gg)))(jnp.asarray(pose[:, :2]), jg)
    _, v, r = tastar.astar(cfg, torch.from_numpy(occ), torch.from_numpy(pose[:, :2]), g)
    assert not bool(jr[0]) and not bool(r[0])
    assert not np.asarray(jv).any() and not v.any()
    # a block of either package (replan, then 5 ticks of the naive filter
    # from that pose) leaves the old path in place
    from live_ekf_slam_tpu.eval import closed_loop as jcl
    from live_ekf_slam_tpu.eval import runner as jrunner
    from live_ekf_slam_tpu.sim.world import init_world as j_init_world
    jn = jcfg.replace(filter="naive", init_pose=(0.0, 0.0, 0.0))
    lms, n_act = jmaps.make_landmarks(jn)
    jcarry = jcl.ClosedLoopCarry(
        world=j_init_world(jn, jnp.asarray(lms), n_act),
        filt=jrunner._filter_init(jn, "naive"),
        pursuit=jpp.init(jn).replace(path=jnp.full((64, 2), 0.25, jnp.float32),
                                     length=jnp.int32(3)),
        cmd=jnp.zeros(2, jnp.float32), err_sum=jnp.float32(0.0),
        timestep=jnp.int32(5))
    jfin, _ = jax.jit(jcl.make_block_step(jn, jnp.asarray(occ)))(
        jcarry, jax.random.split(jax.random.PRNGKey(0), 5))
    np.testing.assert_array_equal(np.asarray(jfin.pursuit.path), 0.25)
    # the port's replan keeps the whole old pursuit state
    old = tpp.init(cfg, 1)
    old = old.replace(path=torch.full_like(old.path, 0.25),
                      length=torch.tensor([3], dtype=torch.int32))
    block = tcl.BlockStep(cfg.replace(filter="naive"), torch.from_numpy(occ))
    carry = tcl.init_closed_loop(cfg.replace(filter="naive", init_pose=(0.0, 0.0, 0.0)),
                                 1, "cpu")
    carry = carry.replace(pursuit=old, timestep=torch.tensor([5], dtype=torch.int32))
    new = block.replan(carry).pursuit
    for f in dataclasses.fields(new):
        assert torch.equal(getattr(new, f.name), getattr(old, f.name)), f.name


# ---------------------------------------------------------------- pursuit

C = 16


def _pursuit_inputs(seed, b=B):
    """Seeded pursuit states (paths around the vehicle, heads and lengths
    of every kind, a one-point path among them) and current poses."""
    rng = np.random.default_rng(seed)
    cur = np.concatenate([rng.uniform(-1, 1, (b, 2)),
                          rng.uniform(-np.pi, np.pi, (b, 1))], 1).astype(np.float32)
    steps = rng.normal(0, 0.15, (b, C, 2)).astype(np.float32)
    path = (cur[:, None, :2] + np.cumsum(steps, axis=1)).astype(np.float32)
    head = rng.integers(0, 4, b).astype(np.int32)
    length = rng.integers(0, C - 4, b).astype(np.int32)
    length[0], length[1] = 1, 0
    path[2, head[2]] = cur[2, :2] + 0.05  # a waypoint within 0.15 m
    integ = rng.normal(0, 0.5, b).astype(np.float32)
    err_prev = rng.normal(0, 0.5, b).astype(np.float32)
    return cur, (path, head, length, integ, err_prev)


def _states(fields):
    j = jpp.PursuitState(*[jnp.asarray(a) for a in fields])
    t = tpp.PursuitState(*[torch.from_numpy(np.array(a)) for a in fields])
    return j, t


def _assert_state(t, j):
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=PP_ATOL, err_msg=f.name)


def test_pursuit_state_updates_match_jax():
    cur, fields = _pursuit_inputs(5)
    js, ts = _states(fields)
    rng = np.random.default_rng(6)
    # set_path with invalid entries between valid ones, a path longer and
    # one shorter than the capacity
    for ln in (C + 8, C - 6):
        pts = rng.normal(0, 2, (B, ln, 2)).astype(np.float32)
        valid = rng.random((B, ln)) < 0.6
        valid[0] = False
        want = jax.jit(jax.vmap(jpp.set_path))(js, jnp.asarray(pts), jnp.asarray(valid))
        _assert_state(tpp.set_path(ts, torch.from_numpy(pts), torch.from_numpy(valid)), want)
    goal = rng.normal(0, 2, (B, 2)).astype(np.float32)
    want = jax.jit(jax.vmap(jpp.append_goal))(js, jnp.asarray(goal))
    _assert_state(tpp.append_goal(ts, torch.from_numpy(goal)), want)
    want = jax.jit(jax.vmap(jpp.pare_path))(js, jnp.asarray(cur))
    got = tpp.pare_path(ts, torch.from_numpy(cur))
    _assert_state(got, want)
    assert (got.head != ts.head).any()  # something was pared
    _assert_state(tpp.init(Config().replace(path_planning=dataclasses.replace(
        Config().path_planning, path_capacity=C)), B),
        jax.vmap(lambda _: jpp.init(JConfig().replace(path_planning=dataclasses.replace(
            JConfig().path_planning, path_capacity=C))))(jnp.arange(B)))


def test_lookahead_matches_jax():
    jcfg, cfg = cfgs()
    cur, fields = _pursuit_inputs(7)
    js, ts = _states(fields)
    radii = tpp.radii(cfg, "cpu")
    assert radii.shape == (11,)
    pts, found = tpp._lookahead_at_radius(ts, torch.from_numpy(cur), radii)
    for k, r in enumerate(radii.numpy()):
        jp, jf = jax.jit(jax.vmap(lambda s, c: jpp._lookahead_at_radius(s, c, r)))(
            js, jnp.asarray(cur))
        np.testing.assert_array_equal(found[:, k].numpy(), np.asarray(jf))
        np.testing.assert_allclose(pts[:, k].numpy(), np.asarray(jp), rtol=0, atol=PP_ATOL)
    assert found.any() and (~found).any()
    want = jax.jit(jax.vmap(lambda s, c: jpp.choose_lookahead(jcfg, s, c)))(js, jnp.asarray(cur))
    np.testing.assert_allclose(tpp.choose_lookahead(cfg, ts, torch.from_numpy(cur)).numpy(),
                               np.asarray(want), rtol=0, atol=PP_ATOL)


@pytest.mark.parametrize("tight", [True, False])
def test_get_next_cmd_matches_jax(tight):
    jcfg, cfg = cfgs()
    cur, fields = _pursuit_inputs(8)
    js, ts = _states(fields)
    jc, jst = jax.jit(jax.vmap(lambda s, c: jpp.get_next_cmd(jcfg, s, c, tight)))(
        js, jnp.asarray(cur))
    c, st = tpp.get_next_cmd(cfg, ts, torch.from_numpy(cur), tight)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=PP_ATOL)
    _assert_state(st, jst)
    assert (c.numpy()[1] == 0).all()  # no path, no command


def test_direct_nav_matches_jax():
    jcfg, cfg = cfgs()
    cur, fields = _pursuit_inputs(9)
    js, ts = _states(fields)
    jc, jst = jax.jit(jax.vmap(lambda s, c: jpp.direct_nav(jcfg, s, c)))(js, jnp.asarray(cur))
    c, st = tpp.direct_nav(cfg, ts, torch.from_numpy(cur))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=PP_ATOL)
    _assert_state(st, jst)
    assert (st.head != ts.head).any()  # a waypoint was reached
