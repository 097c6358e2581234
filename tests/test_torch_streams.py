"""The port's closed-form simulator streams (``sim/streams.py``) against the
JAX functions, world for world, on JAX's own noise draws.

The JAX ``sim_streams`` draws from a ``jax.random`` key and returns the draws
as ``noise_u``; the port takes the noise as its input. So the JAX run comes
first and its ``noise_u`` is injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.sim.streams import naive_deadreckon as j_naive
from live_ekf_slam_tpu.sim.streams import sim_streams as j_streams
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import streams_from_numpy
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from live_ekf_slam_tpu_torch.sim.streams import naive_deadreckon, sim_streams
from port_harness import small_cfg

B, T, N, BOUND = 4, 60, 6, 4.0


def _inputs(seed=2):
    cfg = small_cfg(Config, CompatConfig, "default", T, N, BOUND)
    jcfg = small_cfg(JConfig, JCompat, "default", T, N, BOUND)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, B)
    cmds = np.stack([rng.uniform(0.0, 0.1, (B, T)),
                     rng.uniform(-0.05, 0.05, (B, T))], axis=-1).astype(np.float32)
    return cfg, jcfg, lms, cmds


@pytest.mark.parametrize("n_active", [N, N - 2])
def test_sim_streams_match_jax_on_its_noise(n_active):
    cfg, jcfg, lms, cmds = _inputs()
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = jax.vmap(lambda l, c, k: j_streams(jcfg, l, n_active, c, k))(
        jnp.asarray(lms), jnp.asarray(cmds), keys)
    st = streams_from_numpy(want)
    assert st["noise"].shape == (T, 2 * N + 8, B)
    got = sim_streams(cfg, torch.from_numpy(lms), n_active,
                      torch.from_numpy(cmds), st["noise"])
    assert set(got) == {"poses_true", "r", "b", "vis"}
    # cumsums of float32 terms in another order, and XLA's against torch's
    # CPU sin, cos and atan2: a few ulps of metre-scale values over 60 ticks
    for k in ("poses_true", "r", "b"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    # no landmark sits within 1e-5 of the edge of the field of view here
    np.testing.assert_array_equal(got["vis"].numpy(), np.asarray(want["vis"]))
    assert got["vis"].any() and not got["vis"][:, :, n_active:].any()


def test_naive_deadreckon_matches_jax():
    cfg, jcfg, _, cmds = _inputs()
    want = jax.vmap(lambda c: j_naive(jcfg, c))(jnp.asarray(cmds))
    got = naive_deadreckon(cfg, torch.from_numpy(cmds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_streams_truth_agrees_with_the_rollouts_truth():
    # the same noise tensor drives the closed-form truth and the rollout's
    # sequential one: they agree to float tolerance (cumsum against a
    # running sum, library against polynomial atan2), not bit for bit
    from live_ekf_slam_tpu_torch.ops.fused_rollout import fused_ekf_rollout

    cfg, _, lms, cmds = _inputs()
    noise = philox_noise(3, T, N, B)
    lt, ct = torch.from_numpy(lms), torch.from_numpy(cmds)
    st = sim_streams(cfg, lt, N, ct, noise)
    out = fused_ekf_rollout(cfg, lt, ct, 0, noise=noise, emit_traj=True)
    np.testing.assert_allclose(out["true_traj"].numpy(),
                               st["poses_true"].numpy(), rtol=0, atol=1e-5)


def test_philox_world_offset_continues_the_batch():
    whole = philox_noise(7, 5, N, 6)
    tail = philox_noise(7, 5, N, 4, world0=2)
    assert torch.equal(whole[:, :, 2:], tail)
