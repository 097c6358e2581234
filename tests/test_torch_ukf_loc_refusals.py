"""UKF-Loc's one world that refuses updates at the bench's shape, held against
the JAX kernel.

At 4096 worlds x 1000 ticks, N = 20, shared protocol, seed 0 (the bench's
and ``chip_smoke.py``'s main path), one UKF-Loc world refuses updates on the
card: world 3904, map 15 (737 refusals in the default build, 750 in the
plain version and the -fmad=false build). Here that world runs on the CPU
through the port's plain version and the JAX Pallas kernel in interpret mode,
on its map and commands from ``mc_inputs`` and its slice of the kernel's
Philox stream replayed as injected noise. Both follow the same estimate
within the JAX tolerances through tick 200; then the world grows sensitive
(by tick 241 the two estimates differ by 1e-4 m), at tick 242 both take an
update that throws the estimate metres off (a one-ulp nudge of the noise
moves its result by decimetres), and from tick 243 both refuse updates: the
refusals are the JAX kernel's behaviour too, not a fault of the port. Past
that jump the two are chaotic (ROADMAP F6): their refusal counts differ (JAX
2, the port 1 on the CPU by T = 1000; 750 on the card), and only their onset
is compared.

The JAX interpret-mode runs take minutes, hence ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_ukf import fused_ukf_rollout as j_rollout
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import philox
from test_torch_fused_ukf import JAX_TOL

WORLD, BATCH, STEPS = 3904, 4096, 1000
CALM, JUMP = 200, 243  # ticks held to JAX_TOL; the first refusal


def _run_both(world_inputs, t):
    """(port's plain version, JAX kernel in interpret mode) on the world's
    first t ticks, as numpy."""
    lms, cmds, noise = world_inputs
    cmds, noise = cmds[:, :t].contiguous(), noise[:t].contiguous()
    got = fu.fused_ukf_rollout(Config(num_iterations=t).replace(filter="ukf_loc"),
                               lms, cmds, 0, slam=False, noise=noise)
    want = j_rollout(JConfig(num_iterations=t).replace(filter="ukf_loc"),
                     jnp.asarray(lms.numpy()), jnp.asarray(cmds.numpy()), 0,
                     slam=False, block_worlds=1, noise=jnp.asarray(noise.numpy()),
                     interpret=True)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.fixture(scope="module")
def world_inputs():
    cfg = Config(num_iterations=STEPS).replace(filter="ukf_loc")
    lms, cmds = mc_inputs(cfg, BATCH, 0, "cpu", shared=True, relabel=True)
    noise = philox.philox_noise_reference(0, STEPS, lms.shape[1], 1, world0=WORLD)
    return (lms[WORLD:WORLD + 1].contiguous(), cmds[WORLD:WORLD + 1].contiguous(),
            noise)


@pytest.mark.slow
def test_refusing_world_follows_jax_until_the_jump(world_inputs):
    got, want = _run_both(world_inputs, CALM)
    assert got["update_rejects"][0] == want["update_rejects"][0] == 0
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert got["err_max"][0] < 0.2  # still on track


@pytest.mark.slow
def test_refusing_world_refuses_in_jax_too(world_inputs):
    got, want = _run_both(world_inputs, JUMP)
    np.testing.assert_allclose(got["true_pose"], want["true_pose"],
                               **JAX_TOL["true_pose"])
    for res in (got, want):  # both jump metres off at tick 242, then refuse
        assert res["err_max"][0] > 5.0
        assert res["update_rejects"][0] >= 1
