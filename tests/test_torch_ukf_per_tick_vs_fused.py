"""UKF-SLAM's per-tick path against its fused kernel's plain version (F6).

Both ports follow their JAX counterparts: the per-tick path the JAX model
(tests/test_torch_per_tick_runner.py), the fused plain version the Pallas
kernel (tests/test_torch_fused_ukf.py). The JAX package's model and kernel
part where a landmark lies a few centimetres from the vehicle: the sigma
points straddle it, the bearing Jacobian is ~1/r, and the two spellings of
the update part by centimetres in one tick, in a world the NUDGE chaos test
calls calm (world 8 of the 64-world, 200-tick study of seed 0, tick 103):
the JAX model against the JAX Pallas kernel, run in interpret mode on that
world, each with its port beside it. So the per-tick path is held to the
kernel by its mean error over all worlds, to F6's 3%.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.core.types import Measurements as JM
from live_ekf_slam_tpu.core.types import UKFState as JU
from live_ekf_slam_tpu.models import ukf as jukf
from live_ekf_slam_tpu.ops.fused_ukf import fused_ukf_rollout as j_fused_ukf
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.ops.fused_ukf import fused_ukf_rollout_reference
from live_ekf_slam_tpu_torch.ops.philox import philox_noise_reference
from live_ekf_slam_tpu_torch.sim.world import sim_step
from port_harness import few_threads  # noqa: F401  (fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

UKF_MEAN_RTOL = 0.03
UKF_WORLD, UKF_TICK = 8, 103


def _ukf_chol_worlds(b, t):
    cfg = Config(num_iterations=t).replace(filter="ukf_slam")
    cfg = cfg.replace(ukf=dataclasses.replace(cfg.ukf, sigma_sqrt="chol"))
    lms, cmds = runner.mc_inputs(cfg, b, 0, "cpu")
    return cfg, lms, cmds, philox_noise_reference(0, t, 20, b, "cpu")


@functools.cache
def _world_near_a_landmark():
    """UKF_WORLD's inputs and its per-tick carries before and after
    UKF_TICK."""
    cfg, lms, cmds, noise = _ukf_chol_worlds(64, 200)
    w, k = UKF_WORLD, UKF_TICK
    lw, cw, nw = lms[w:w + 1], cmds[w:w + 1], noise[:, :, w:w + 1].contiguous()
    step = runner.make_step(cfg)
    c = runner.init_carry(cfg, lw, 20)
    for t in range(k):
        c, _ = step(c, cw[:, t], nw[t].T, t)
    after, _ = step(c, cw[:, k], nw[k].T, k)
    return cfg, lw, cw, nw, c, after


def test_ukf_slam_update_near_a_landmark_is_jax_models():
    cfg, lw, cw, nw, c, after = _world_near_a_landmark()
    k = UKF_TICK
    _, meas = sim_step(cfg, c.world, cw[:, k], nw[k].T)
    # the vehicle is ~9 cm from the one landmark it sees
    seen = int(meas.ids[0][meas.valid[0]][0])
    assert float(meas.r[0, meas.valid[0]][0]) < 0.15
    jcfg = JConfig(num_iterations=200).replace(filter="ukf_slam")
    jcfg = jcfg.replace(ukf=dataclasses.replace(jcfg.ukf, sigma_sqrt="chol"))
    p = c.primary
    js = JU(**{f: jnp.asarray(getattr(p, f)[0].numpy())
               for f in ("x", "P", "ids", "M", "timestep", "X")})
    jm = JM(ids=jnp.asarray(meas.ids[0].numpy()), r=jnp.asarray(meas.r[0].numpy()),
            b=jnp.asarray(meas.b[0].numpy()), valid=jnp.asarray(meas.valid[0].numpy()),
            overflow=jnp.asarray(False))
    want = jukf.update(jcfg, js, jnp.asarray(cw[0, k].numpy()), jm, slam=True)
    np.testing.assert_allclose(after.primary.x[0].numpy(), np.asarray(want.x),
                               rtol=0, atol=1e-5)
    # the kernel's algebra lands centimetres away on the same tick
    fused = fused_ukf_rollout_reference(cfg.replace(num_iterations=k + 1), lw,
                                        cw[:, :k + 1].contiguous(), 0, slam=True,
                                        noise=nw[:k + 1].contiguous())
    assert seen in torch.nonzero(fused["seen"][0]).flatten().tolist()
    part = float((fused["x"][0, :2] - after.primary.x[0, :2]).abs().max())
    assert part > 5e-3, part


def test_ukf_slam_per_tick_holds_the_fused_mean_within_f6s_bound():
    b, t = 32, 200
    cfg, lms, cmds, noise = _ukf_chol_worlds(b, t)
    fin, _ = runner.rollout(cfg, runner.init_carry(cfg, lms, 20), cmds, noise)
    assert bool(fin.alive_primary.all())
    e = (fin.err_sum_primary / fin.ticks_primary.float()).numpy()
    e_f = (fused_ukf_rollout_reference(cfg, lms, cmds, 0, slam=True,
                                       noise=noise)["err_sum"] / t).numpy()
    assert abs(e.mean() - e_f.mean()) <= UKF_MEAN_RTOL * e_f.mean()


def test_jax_kernel_parts_from_jax_model_near_a_landmark():
    # the second witness: the JAX Pallas kernel itself (interpret mode) on
    # UKF_WORLD lands where the port's fused plain version does (measured
    # 1.9e-6; JAX_TOL of tests/test_torch_fused_ukf.py), and 1 cm from the
    # JAX model's estimate (the per-tick path's, held to it above) on
    # UKF_TICK, one tick after the two agreed to 8.6e-5 (held to 1e-3)
    cfg, lw, cw, nw, before, after = _world_near_a_landmark()
    k = UKF_TICK
    jcfg = JConfig(num_iterations=k + 1).replace(filter="ukf_slam")
    jcfg = jcfg.replace(ukf=dataclasses.replace(jcfg.ukf, sigma_sqrt="chol"))
    cw, nw = cw[:, :k + 1].contiguous(), nw[:k + 1].contiguous()
    jx = np.asarray(j_fused_ukf(jcfg, jnp.asarray(lw.numpy()), jnp.asarray(cw.numpy()), 0,
                                slam=True, block_worlds=1, noise=jnp.asarray(nw.numpy()),
                                interpret=True)["x"])
    plain = fused_ukf_rollout_reference(cfg.replace(num_iterations=k + 1), lw, cw, 0,
                                        slam=True, noise=nw)
    np.testing.assert_allclose(plain["x"].numpy(), jx, rtol=0, atol=1e-5)
    assert float(np.abs(jx[0, :2] - after.primary.x[0, :2].numpy()).max()) > 5e-3
    plain_before = fused_ukf_rollout_reference(cfg.replace(num_iterations=k), lw,
                                               cw[:, :k].contiguous(), 0, slam=True,
                                               noise=nw[:k].contiguous())
    np.testing.assert_allclose(plain_before["x"][0, :2].numpy(),
                               before.primary.x[0, :2].numpy(), rtol=0, atol=1e-3)


CHAOTIC_WORLD = 17  # of the same study: 0.74 m apart on the card (PT_CHAOS)


@pytest.mark.slow
def test_jax_model_and_kernel_part_on_the_chaotic_world():
    # The card test of the per-tick path against the fused kernel
    # (tests/test_torch_cuda.py) leaves CHAOTIC_WORLD out of UKF-SLAM's mean
    # as chaotic. The JAX package's own per-tick model (its UKF update a
    # tick, on the port's measurements) and its Pallas kernel (interpret
    # mode) part on that world too, by centimetres of average error
    # (measured: 0.151 against 0.091 m), where the port's fused plain
    # version stays with the JAX kernel; the port's per-tick path follows
    # the JAX model for some 50 ticks, then the chaos parts them as well.
    b, t = 64, 200
    cfg, lms, cmds, noise = _ukf_chol_worlds(b, t)
    w = CHAOTIC_WORLD
    jcfg = JConfig(num_iterations=t).replace(filter="ukf_slam")
    jcfg = jcfg.replace(ukf=dataclasses.replace(jcfg.ukf, sigma_sqrt="chol"))
    update = jax.jit(lambda s, u, m: jukf.update(jcfg, s, u, m, slam=True))
    step = runner.make_step(cfg)
    c = runner.init_carry(cfg, lms, 20)
    js = JU(**{f: jnp.asarray(getattr(c.primary, f)[w].numpy())
               for f in ("x", "P", "ids", "M", "timestep", "X")})
    err_model, part = 0.0, []
    for k in range(t):
        _, meas = sim_step(cfg, c.world, cmds[:, k], noise[k].T)
        c, _ = step(c, cmds[:, k], noise[k].T, k)
        jm = JM(ids=jnp.asarray(meas.ids[w].numpy()), r=jnp.asarray(meas.r[w].numpy()),
                b=jnp.asarray(meas.b[w].numpy()), valid=jnp.asarray(meas.valid[w].numpy()),
                overflow=jnp.asarray(False))
        js = update(js, jnp.asarray(cmds[w, k].numpy()), jm)
        truth = c.world.pose[w, :2].numpy()
        err_model += float(np.linalg.norm(np.asarray(js.x[:2]) - truth)) / t
        part.append(float(np.abs(np.asarray(js.x[:2]) - c.primary.x[w, :2].numpy()).max()))
    lw, cw, nw = lms[w:w + 1], cmds[w:w + 1], noise[:, :, w:w + 1].contiguous()
    jk = j_fused_ukf(jcfg, jnp.asarray(lw.numpy()), jnp.asarray(cw.numpy()), 0, slam=True,
                     block_worlds=1, noise=jnp.asarray(nw.numpy()), interpret=True)
    err_kernel = float(np.asarray(jk["err_sum"])[0]) / t
    plain = fused_ukf_rollout_reference(cfg, lw, cw, 0, slam=True, noise=nw)
    assert abs(float(plain["err_sum"][0]) / t - err_kernel) < 1e-3
    assert abs(err_model - err_kernel) > 0.03, (err_model, err_kernel)
    assert max(part[:40]) < 1e-3 and max(part) > 0.05, part
