"""The port's per-tick simulator, geometry helpers and fixed landmark maps
against the JAX package: ``sim_step`` fed the uniforms JAX draws from its
keys, in both branches of ``sense`` (a slot per landmark, and the stable
compaction with ``overflow``), and the maps bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.sim import maps as jmaps
from live_ekf_slam_tpu.sim import world as jworld
from live_ekf_slam_tpu.utils import geometry as jgeo
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import world_state_from_numpy
from live_ekf_slam_tpu_torch.sim import maps, world
from live_ekf_slam_tpu_torch.utils import geometry as geo

B, N = 16, 12


def _cfgs(k: int):
    """Both packages' configs with N landmarks and K measurement slots."""
    out = []
    for cls in (JConfig, Config):
        cfg = cls().replace(num_landmark_slots=N, num_meas_slots=k)
        out.append(cfg.replace(map=cfg.map.__class__(num_landmarks=N, bound=4.0)))
    return out


def tick_uniforms(key, n: int) -> np.ndarray:
    """The (2N+8,) uniforms JAX's ``sim_step`` draws from ``key``, in the
    injection layout: motion, ranges, bearings, 8 pad rows."""
    k_move, k_sense = jax.random.split(key)
    u_move = jax.random.uniform(k_move, (2,), jnp.float32, -1.0, 1.0)
    u_sense = jax.random.uniform(k_sense, (2, n), jnp.float32, -1.0, 1.0)
    return np.concatenate([np.asarray(u_move), np.asarray(u_sense).reshape(-1),
                           np.zeros(8, np.float32)])


def _worlds(seed: int):
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-4, 4, (B, N, 2)).astype(np.float32)
    pose = np.concatenate([rng.uniform(-2, 2, (B, 2)),
                           rng.uniform(-4, 4, (B, 1))], axis=1).astype(np.float32)
    n_active = rng.integers(N - 3, N + 1, B).astype(np.int32)
    cmd = np.stack([rng.uniform(0, 0.12, B), rng.uniform(-0.1, 0.1, B)],
                   axis=1).astype(np.float32)
    return lms, pose, n_active, cmd


@pytest.mark.parametrize("k", [N, 4])
def test_sim_step_matches_jax(k):
    jcfg, cfg = _cfgs(k)
    lms, pose, n_active, cmd = _worlds(k)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    def one(l, p, n, c, key):
        w = jworld.init_world(jcfg, l, n, p)
        return jworld.sim_step(jcfg, w, c, key)

    jw, jm = jax.vmap(one)(lms, pose, n_active, cmd, keys)
    u = np.stack([tick_uniforms(kk, N) for kk in keys])
    w = world.init_world(cfg, torch.from_numpy(lms), torch.from_numpy(n_active),
                         torch.from_numpy(pose))
    w2, m = world.sim_step(cfg, w, torch.from_numpy(cmd), torch.from_numpy(u))

    # the truth: one multiply-add and a cos / sin, within a few ulp
    np.testing.assert_allclose(w2.pose.numpy(), np.asarray(jw.pose), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(m.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_array_equal(m.overflow.numpy(), np.asarray(jm.overflow))
    np.testing.assert_allclose(m.r.numpy(), np.asarray(jm.r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.b.numpy(), np.asarray(jm.b), rtol=0, atol=1e-5)
    assert int(m.valid.any(dim=1).sum()) >= B // 2, "most worlds saw nothing"
    if k < N:
        # the compaction ran, and some world saw more than its K slots
        assert m.ids.shape == (B, k) and bool(m.overflow.any())
        # visible slots first, in ascending id order
        ids = m.ids.numpy()
        for w_ids, valid in zip(ids, m.valid.numpy()):
            seen = w_ids[valid]
            assert (np.diff(seen) > 0).all() and valid[:len(seen)].all()


def test_world_state_converts_from_jax():
    jcfg, cfg = _cfgs(N)
    lms, pose, n_active, _ = _worlds(1)
    jw = jax.vmap(lambda l, p, n: jworld.init_world(jcfg, l, n, p))(
        lms, pose, n_active)
    w = world_state_from_numpy(jw)
    assert w.num_landmarks.dtype == torch.int32
    np.testing.assert_array_equal(w.pose.numpy(), pose)
    np.testing.assert_array_equal(w.num_landmarks.numpy(), n_active)
    one = world_state_from_numpy(jworld.init_world(jcfg, lms[0]))
    assert one.pose.shape == (1, 3) and int(one.num_landmarks[0]) == N


def test_init_world_defaults():
    _, cfg = _cfgs(N)
    lms, _, _, _ = _worlds(2)
    w = world.init_world(cfg, torch.from_numpy(lms))
    assert w.pose.shape == (B, 3) and w.num_landmarks.tolist() == [N] * B
    np.testing.assert_array_equal(w.pose[0].numpy(), np.float32(cfg.init_pose))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    b = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    pt = rng.uniform(-5, 5, (64, 2)).astype(np.float32)
    r = rng.uniform(0.1, 4, 64).astype(np.float32)
    be = rng.uniform(-3, 3, 64).astype(np.float32)
    ta, tb, tpt = (torch.from_numpy(v) for v in (a, b, pt))
    close = dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(geo.se2_compose(ta, tb).numpy(),
                               np.asarray(jgeo.se2_compose(a, b)), **close)
    np.testing.assert_allclose(geo.se2_between(ta, tb).numpy(),
                               np.asarray(jgeo.se2_between(a, b)), **close)
    rr, bb = geo.range_bearing(ta, tpt)
    jr, jb = jgeo.range_bearing(a, pt)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), **close)
    np.testing.assert_allclose(bb.numpy(), np.asarray(jb), **close)
    np.testing.assert_allclose(
        geo.project_measurement(ta, torch.from_numpy(r), torch.from_numpy(be)).numpy(),
        np.asarray(jgeo.project_measurement(a, r, be)), **close)
    mats = geo.yaw_to_mat(ta[:, 2])
    for i in (0, 17, 63):
        np.testing.assert_allclose(mats[i].numpy(),
                                   np.asarray(jgeo.yaw_to_mat(a[i, 2])), **close)
        assert abs(float(geo.mat_to_yaw(mats[i]))
                   - float(jgeo.mat_to_yaw(jgeo.yaw_to_mat(a[i, 2])))) < 1e-6
    # wrap_angle keeps the true division: equal bit for bit on the CPU
    th = rng.uniform(-40, 40, 1000).astype(np.float32)
    np.testing.assert_array_equal(geo.wrap_angle(torch.from_numpy(th)).numpy(),
                                  np.asarray(jgeo.wrap_angle(th)))


@pytest.mark.parametrize("kind", ["demo", "grid", "igvc1", "random"])
def test_fixed_maps_are_bit_identical(kind):
    jcfg = JConfig().replace(landmark_map=kind)
    cfg = Config().replace(landmark_map=kind)
    j_lms, j_n = jmaps.make_landmarks(jcfg, np.random.default_rng(4))
    lms, n = maps.make_landmarks(cfg, np.random.default_rng(4))
    assert n == j_n and lms.dtype == np.float32
    np.testing.assert_array_equal(lms, j_lms)


def test_map_constants_are_bit_identical():
    np.testing.assert_array_equal(maps.DEMO_MAP, jmaps.DEMO_MAP)
    np.testing.assert_array_equal(maps.IGVC1_BARRELS, jmaps.IGVC1_BARRELS)
    assert maps.DEMO_MAP.shape == (20, 2) and maps.IGVC1_BARRELS.shape == (37, 2)
    np.testing.assert_array_equal(maps.grid_landmarks(Config()),
                                  jmaps.grid_landmarks(JConfig()))
    with pytest.raises(ValueError, match="landmark_map"):
        maps.make_landmarks(Config().replace(landmark_map="moon"))
