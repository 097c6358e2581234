"""The port's sharded fused rollouts (``fused_ekf_rollout_sharded``,
``fused_ukf_rollout_sharded``; their plain versions on an 8-shard CPU mesh)
against the JAX package's sharded wrappers in interpret mode on the
conftest's 8 virtual devices, with injected noise: EKF-SLAM, UKF-SLAM and
UKF-Loc at 16 worlds (two a device), T = 20, N = 4 in a +/-3 m box,
where every world sees a landmark and some see several at once
(UKF-SLAM's comparison with JAX runs from ``test_torch_sharded_ukf_slam.py``,
on a pytest-xdist worker of its own).
Within the port, sharded equals unsharded bit for bit with injected noise
(every world's arithmetic is its own; the plain rollouts draw nothing from
the batch), and, without noise, shard d equals a single rollout of its
slice at ``shard_seed(seed, d)``, with a seed whose per-shard seeds wrap
past 2^32 as JAX's int32 seed arithmetic does.

Tolerances: ``test_torch_fused_rollout.py``'s and ``test_torch_fused_ukf.py``'s
``JAX_TOL`` (the same float32 algebra; XLA's and torch's CPU sin, cos and
sqrt differ in the last bit); ``seen`` and ``update_rejects`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout_sharded as j_ekf
from live_ekf_slam_tpu.ops.fused_ukf import fused_ukf_rollout_sharded as j_ukf
from live_ekf_slam_tpu.parallel import mesh as jmesh
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import inputs_from_numpy, outputs_to_numpy
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.parallel import mesh as pmesh
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import arc_commands, few_threads, max_co_observed, small_cfg  # noqa: F401  (few_threads: a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

B, N, T, BOUND, SHARDS = 16, 4, 20, 3.0, 8
JAX_TOL = {
    "true_pose": dict(rtol=0, atol=1e-5),
    "err_sum": dict(rtol=1e-4, atol=1e-6),
    "err_max": dict(rtol=1e-4, atol=1e-6),
    "x": dict(rtol=0, atol=1e-5),
    "P": dict(rtol=1e-4, atol=1e-6),
}
# filter -> (port's sharded wrapper, its single rollout, JAX's, keywords)
FILTERS = {
    "ekf_slam": (fr.fused_ekf_rollout_sharded, fr.fused_ekf_rollout, j_ekf, {}),
    "ukf_slam": (fu.fused_ukf_rollout_sharded, fu.fused_ukf_rollout, j_ukf,
                 {"slam": True}),
    "ukf_loc": (fu.fused_ukf_rollout_sharded, fu.fused_ukf_rollout, j_ukf,
                {"slam": False}),
}
# per-shard seeds (seed + d * 1000003) that cross 2^32 between shards 0 and 7
WRAP_SEED = 2 ** 32 - 3 * 1000003


def make_inputs():
    cfg = small_cfg(Config, CompatConfig, "default", T, N, BOUND)
    rng = np.random.default_rng(1)
    lms = random_landmarks_batched(cfg, rng, B)
    noise = rng.uniform(-1, 1, size=(T, 2 * N + 8, B)).astype(np.float32)
    cmds = arc_commands(B, T)
    assert max_co_observed(cfg, lms, cmds, noise) >= 2, "no co-observation"
    return cfg, lms, cmds, noise


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def check_sharded_matches_jax(filt):
    cfg, lms, cmds, noise = make_inputs()
    sharded, _, j_sharded, kw = FILTERS[filt]
    jcfg = small_cfg(JConfig, JCompat, "default", T, N, BOUND)
    want = {k: np.asarray(v) for k, v in j_sharded(
        jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0, jmesh.make_mesh(SHARDS),
        block_worlds=B // SHARDS, interpret=True, noise=jnp.asarray(noise),
        **kw).items()}
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    got = outputs_to_numpy(sharded(cfg, lt, ct, 0, pmesh.make_mesh(SHARDS, "cpu"),
                                   noise=nt, **kw))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got["seen"], want["seen"])
    if filt != "ukf_loc":
        assert want["seen"].sum(axis=1).min() >= 1, "a world saw no landmark"
    if "update_rejects" in want:
        np.testing.assert_array_equal(got["update_rejects"], want["update_rejects"])
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_loc"])
def test_sharded_rollout_matches_jax_sharded_wrapper(filt):
    check_sharded_matches_jax(filt)


@pytest.mark.parametrize("filt", FILTERS)
def test_sharded_rollout_is_the_unsharded_one(filt, inputs):
    cfg, lms, cmds, noise = inputs
    sharded, single, _, kw = FILTERS[filt]
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    mesh = pmesh.make_mesh(SHARDS, "cpu")
    # injected noise: every world's rollout is its own, wherever it lies
    got = sharded(cfg, lt, ct, 0, mesh, noise=nt, **kw)
    want = single(cfg, lt, ct, 0, noise=nt, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # in-kernel draws: shard d is its slice's rollout at shard_seed(seed, d)
    got = sharded(cfg, lt, ct, WRAP_SEED, mesh, **kw)
    k = B // SHARDS
    for d in range(SHARDS):
        one = single(cfg, lt[d * k:(d + 1) * k].contiguous(),
                     ct[d * k:(d + 1) * k].contiguous(),
                     pmesh.shard_seed(WRAP_SEED, d), **kw)
        for name in one:
            assert torch.equal(got[name][d * k:(d + 1) * k], one[name]), (d, name)
    assert pmesh.shard_seed(WRAP_SEED, SHARDS - 1) < pmesh.shard_seed(WRAP_SEED, 0)
    with pytest.raises(ValueError, match="batch 16 not divisible by mesh size 3"):
        sharded(cfg, lt, ct, 0, pmesh.make_mesh(3, "cpu"), **kw)


def test_shard_seeds_are_jax_int32_seed_bits():
    # JAX's shard seed is seed + axis_index * int32(1000003) in int32,
    # which wraps; read as uint32 it is the port's seed, mod 2^32
    for seed in (0, 5, 2 ** 31 - 2, WRAP_SEED - 2 ** 32):
        for d in range(SHARDS):
            j = jnp.int32(seed) + jnp.int32(d) * jnp.int32(1000003)
            assert int(np.asarray(j).view(np.uint32)) == pmesh.shard_seed(seed, d)
    assert jax.device_count() == SHARDS
