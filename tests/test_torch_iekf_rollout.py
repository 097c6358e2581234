"""The port's fused RI-EKF-SLAM rollout (``fused_iekf_rollout``): the plain
version against the JAX Pallas kernel in interpret mode. The CUDA kernel is
held against the plain version on the card in test_torch_cuda.py.

Every input is made with numpy from a seed, noise included, and injected
into both sides (the kernels' ``noise=`` argument).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_rollout import fused_iekf_rollout as j_rollout
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import inputs_from_numpy, outputs_to_numpy
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import philox
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import arc_commands, max_co_observed, small_cfg

KINDS = ["default", "compat", "calibrated"]
# B = 4 worlds, N = 4 landmarks in a +/-3 m box, T = 20 ticks: worlds see
# several landmarks in one tick (asserted), so the sequential updates, the
# retraction of every landmark pair and the insertions all run.
B, N, T, BOUND = 4, 4, 20, 3.0

# Plain version vs the Pallas kernel (interpret mode, CPU): the same float32
# algebra in the same order; XLA's and torch's CPU sin/cos differ in the last
# bit, and 20 ticks of updates carry that along. `seen` is compared exactly.
JAX_TOL = {
    "true_pose": dict(rtol=0, atol=1e-5),
    "err_sum": dict(rtol=1e-4, atol=1e-6),
    "err_max": dict(rtol=1e-4, atol=1e-6),
    "x": dict(rtol=0, atol=1e-5),
    "P": dict(rtol=1e-4, atol=1e-6),
}


def _inputs(kind, seed=5):
    cfg = small_cfg(Config, CompatConfig, kind, T, N, BOUND)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, B)
    noise = rng.uniform(-1, 1, size=(T, 2 * N + 8, B)).astype(np.float32)
    return cfg, lms, arc_commands(B, T), noise


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_kernel(kind):
    cfg, lms, cmds, noise = _inputs(kind)
    assert max_co_observed(cfg, lms, cmds, noise) >= 2, "no co-observation"
    jcfg = small_cfg(JConfig, JCompat, kind, T, N, BOUND)
    want = {k: np.asarray(v) for k, v in j_rollout(
        jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0, block_worlds=B,
        noise=jnp.asarray(noise), interpret=True).items()}
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    got = outputs_to_numpy(fr.fused_iekf_rollout(cfg, lt, ct, 0, noise=nt))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got["seen"], want["seen"])
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_pose_stream_matches_pallas_kernel(kind):
    # emit_traj=True of the invariant filter, at the tolerances of x and
    # true_pose above
    cfg, lms, cmds, noise = _inputs(kind)
    jcfg = small_cfg(JConfig, JCompat, kind, T, N, BOUND)
    want = j_rollout(jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0,
                     block_worlds=B, noise=jnp.asarray(noise), interpret=True,
                     emit_traj=True)
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    res = fr.fused_iekf_rollout(cfg, lt, ct, 0, noise=nt, emit_traj=True)
    np.testing.assert_allclose(res["est_traj"].numpy(),
                               np.asarray(want["est_traj"]), **JAX_TOL["x"])
    np.testing.assert_allclose(res["true_traj"].numpy(),
                               np.asarray(want["true_traj"]),
                               **JAX_TOL["true_pose"])
    assert torch.equal(res["est_traj"][:, -1], res["x"][:, :3])
    assert torch.equal(res["true_traj"][:, -1], res["true_pose"])
    plain = fr.fused_iekf_rollout(cfg, lt, ct, 0, noise=nt)
    for k in plain:
        assert torch.equal(plain[k], res[k]), k


def test_predicated_equals_unpredicated_and_seed_replays():
    cfg, lms, cmds, _ = _inputs("default")
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    a = fr.fused_iekf_rollout(cfg, lt, ct, 9)
    b = fr.fused_iekf_rollout(cfg, lt, ct, 9, predicated=False)
    c = fr.fused_iekf_rollout(cfg, lt, ct, 0,
                              noise=philox.philox_noise(9, T, N, B))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k


def test_iekf_differs_from_ekf_and_ignores_ekf_compat_quirks():
    cfg, lms, cmds, noise = _inputs("default")
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    iekf = fr.fused_iekf_rollout(cfg, lt, ct, 0, noise=nt)
    ekf = fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt)
    assert not torch.equal(iekf["P"], ekf["P"])
    # stale landmarks and the unwrapped innovation are EKF quirks: the
    # invariant filter reads neither (fused_rollout.py:91-92)
    quirks = cfg.replace(compat=CompatConfig(ekf_stale_landmarks=True,
                                             ekf_unwrapped_innovation=True))
    same = fr.fused_iekf_rollout(quirks, lt, ct, 0, noise=nt)
    for k in iekf:
        assert torch.equal(iekf[k], same[k]), k


def test_out_of_scope_requests_raise():
    cfg, lms, cmds, _ = _inputs("default")
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    # the phase-attribution modes run (test_torch_profile_modes.py holds
    # them against the JAX kernel); a name that is none of them raises
    sim = fr.fused_iekf_rollout(cfg, lt, ct, 0, profile_mode="sim")
    assert not sim["seen"].any() and float(sim["P"][:, 3:, 3:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown profile_mode"):
        fr.fused_iekf_rollout(cfg, lt, ct, 0, profile_mode="landmarks")
    with pytest.raises(ValueError, match="emit_traj requires profile_mode"):
        fr.fused_iekf_rollout(cfg, lt, ct, 0, profile_mode="sim", emit_traj=True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fr.fused_iekf_rollout(cfg, lt.to("meta"), ct.to("meta"), 0)


@pytest.mark.slow
def test_plain_rollout_long_horizon_stays_finite():
    # ROADMAP hazard F1 for the invariant filter: T = 1000 at full width
    cfg = Config(num_iterations=1000)
    lms, cmds = mc_inputs(cfg, 16, 0, "cpu")
    out = fr.fused_iekf_rollout(cfg, lms, cmds, 0)
    for k in ("err_sum", "err_max", "x", "P", "true_pose"):
        assert torch.isfinite(out[k]).all(), k
    assert float((out["err_sum"] / 1000).mean()) < 1.0
