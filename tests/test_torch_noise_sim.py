"""The port's noise moments, maps, trajectories and config, against JAX.

Every input is made with numpy from a seed and handed to both packages.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu import config as jconfig
from live_ekf_slam_tpu.core import noise as jnoise
from live_ekf_slam_tpu.sim import maps as jmaps
from live_ekf_slam_tpu.sim.trajectory import generate_trajectory as j_gen
from live_ekf_slam_tpu.utils.geometry import wrap_angle as j_wrap_angle
from live_ekf_slam_tpu_torch import config as tconfig
from live_ekf_slam_tpu_torch.core import noise as tnoise
from live_ekf_slam_tpu_torch.sim import maps as tmaps
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory as t_gen
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle as t_wrap_angle

# The same float32 formulas on both sides; XLA's CPU code may fuse a
# multiply-add or reassociate a constant product, so allow a few ulps.
MOMENT_TOL = dict(rtol=2e-6, atol=1e-9)


def _cfg_pair(**kw):
    return jconfig.Config(**kw), tconfig.Config(**kw)


def test_config_is_the_jax_schema():
    # the port keeps its own copy of the schema (it imports nothing of the
    # JAX package); the copy equals the original (test_torch_config.py)
    assert tconfig.Config is not jconfig.Config
    assert tconfig.Config.__module__ == "live_ekf_slam_tpu_torch.config"
    jc, tc = _cfg_pair()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert ([f.name for f in dataclasses.fields(jc)]
            == [f.name for f in dataclasses.fields(tc)])
    assert tc.filter_noise() == jc.filter_noise()
    compat = tconfig.CompatConfig.all_on()
    assert dataclasses.asdict(compat) == dataclasses.asdict(
        jconfig.CompatConfig.all_on())
    for name in ("filter_demo_live", "igvc1"):
        assert (dataclasses.asdict(tconfig.preset(name))
                == dataclasses.asdict(jconfig.preset(name)))


def test_load_config_reads_params_yaml(tmp_path):
    p = tmp_path / "params.yaml"
    p.write_text("filter: ekf_slam\nnum_iterations: 77\n"
                 "map:\n  num_landmarks: 12\n")
    tc, jc = tconfig.load_config(str(p)), jconfig.load_config(str(p))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.num_iterations == 77 and tc.num_landmark_slots == 12


@pytest.mark.parametrize("v,lo,hi", [(0.01, 0.0, 0.1), (0.001, -0.0546, 0.0546)])
def test_clip_uniform_moments_match_jax(v, lo, hi):
    # commands across the clip: interior, near each edge, saturated
    c = np.float32(np.concatenate([
        np.linspace(lo - 2 * v, hi + 2 * v, 401),
        [lo, hi, lo + v, hi - v, 0.0],
    ]))
    jm, js = jnoise.clip_uniform_moments(jnp.asarray(c), v, lo, hi)
    tm, ts = tnoise.clip_uniform_moments(torch.from_numpy(c), v, lo, hi)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MOMENT_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MOMENT_TOL)


@pytest.mark.parametrize("zero_v", [False, True])
def test_motion_moments_match_jax(zero_v):
    jc, tc = _cfg_pair(calibrated_motion=True)
    if zero_v:
        pn = dataclasses.replace(jc.process_noise, V_00=0.0, V_11=0.0)
        jc, tc = jc.replace(process_noise=pn), tc.replace(process_noise=pn)
    rng = np.random.default_rng(0)
    d = np.float32(rng.uniform(-0.02, 0.12, 512))
    th = np.float32(rng.uniform(-0.07, 0.07, 512))
    jres = jnoise.motion_moments(jc, jnp.asarray(d), jnp.asarray(th))
    tres = tnoise.motion_moments(tc, torch.from_numpy(d), torch.from_numpy(th))
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MOMENT_TOL)
    assert tnoise.calibrated_meas_vars(tc) == jnoise.calibrated_meas_vars(jc)
    assert tnoise.use_calibrated(tc) == jnoise.use_calibrated(jc)
    swap = tconfig.CompatConfig(noise_vw_swap=True)
    assert not tnoise.use_calibrated(tc.replace(compat=swap))


def test_wrap_angle_matches_jax():
    x = np.float32(np.concatenate([
        np.linspace(-20, 20, 2001), [math.pi, -math.pi, 3 * math.pi, 0.0]]))
    np.testing.assert_array_equal(t_wrap_angle(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_wrap_angle(jnp.asarray(x))))


@pytest.mark.parametrize("sep,occ", [(0.05, False), (0.05, True), (1.5, True),
                                     (3.0, False)])
def test_random_landmarks_batched_bit_identical(sep, occ):
    # sep 1.5 forces redraw rounds; sep 3.0 leaves stragglers for the exact
    # sampler
    cfg = tconfig.Config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                              min_landmark_separation=sep))
    grid = tmaps.load_occ_map(cfg)[0] if occ else None
    a = tmaps.random_landmarks_batched(cfg, np.random.default_rng(42), 64, grid)
    b = jmaps.random_landmarks_batched(cfg, np.random.default_rng(42), 64, grid)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_blank_occ_map_matches_and_image_maps_raise():
    cfg = tconfig.Config()
    for x, y in zip(tmaps.load_occ_map(cfg), jmaps.load_occ_map(cfg)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(NotImplementedError, match="M11"):
        tmaps.load_occ_map(cfg.replace(occ_map_img="igvc1.png"))


def test_generate_trajectory_matches_jax():
    b, t_total = 16, 100
    cfg = tconfig.Config(num_iterations=t_total)
    lms = tmaps.random_landmarks_batched(cfg, np.random.default_rng(7), b)
    n = lms.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    jcfg = jconfig.Config(num_iterations=t_total)
    j_cmds, j_tour = jax.vmap(
        lambda l, k: j_gen(jcfg, l, n, k, return_tour=True)
    )(jnp.asarray(lms), keys)
    # the same draw generate_trajectory makes from each key
    u = jax.vmap(lambda k: jax.random.uniform(k, (n, 2), jnp.float32, -1.0, 1.0))(keys)
    t_cmds, t_tour = t_gen(cfg, torch.from_numpy(lms), n,
                           u=torch.tensor(np.asarray(u)), return_tour=True)
    assert t_cmds.shape == (b, t_total, 2) and t_tour.shape == (b, n)
    np.testing.assert_array_equal(t_tour.numpy(), np.asarray(j_tour))
    for w in range(b):  # every tour is a permutation of the slots
        assert sorted(t_tour[w].tolist()) == list(range(n))
    # XLA's and torch's CPU atan2/sin/cos differ in the last bit; the
    # pursuit loop is stable, so the streams stay within a few ulps of the
    # command scale (0.1 m, 0.0546 rad)
    np.testing.assert_allclose(t_cmds.numpy(), np.asarray(j_cmds),
                               rtol=0, atol=1e-5)


def test_tours_match_jax_at_large_batch():
    # ROADMAP F5: tours stay permutations, equal to JAX's, at B = 1024
    # (the tour does not depend on T, so one tick suffices)
    b = 1024
    cfg = tconfig.Config(num_iterations=1)
    lms = tmaps.random_landmarks_batched(cfg, np.random.default_rng(8), b)
    n = lms.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    jcfg = jconfig.Config(num_iterations=1)
    _, j_tour = jax.jit(jax.vmap(
        lambda l, k: j_gen(jcfg, l, n, k, return_tour=True)
    ))(jnp.asarray(lms), keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (n, 2), jnp.float32, -1.0, 1.0))(keys)
    _, t_tour = t_gen(cfg, torch.from_numpy(lms), n,
                      u=torch.tensor(np.asarray(u)), return_tour=True)
    np.testing.assert_array_equal(t_tour.numpy(), np.asarray(j_tour))
    assert (np.sort(t_tour.numpy(), axis=1) == np.arange(n)).all()
