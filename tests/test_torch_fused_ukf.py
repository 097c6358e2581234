"""The port's fused UKF rollout (SLAM and localization): the plain version
against the JAX Pallas kernel in interpret mode, and its parameters. The CUDA
kernel is held against the plain version on the card in test_torch_cuda.py.

Every input is made with numpy from a seed, noise included, and injected
into both sides (the kernels' ``noise=`` argument).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_ukf import fused_ukf_rollout as j_rollout
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import (
    inputs_from_numpy,
    outputs_to_numpy,
    ukf_kernel_params,
)
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import philox
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import arc_commands, max_co_observed, small_cfg

KINDS = ["default", "compat", "calibrated"]
# B = 4 worlds, N = 4 landmarks in a +/-3 m box, T = 20 ticks: worlds see
# several landmarks in one tick (asserted), so the per-landmark updates of a
# tick share one set of sigma points, and insertions grow the active set.
B, N, T, BOUND = 4, 4, 20, 3.0

# Plain version vs the Pallas kernel (interpret mode, CPU): the same float32
# algebra; XLA's and torch's CPU sin/cos/rsqrt and their sums over sigma
# columns differ in the last bits. Measured: x 8e-7, P 1.2e-7 (of 1.0 in
# compat), err_sum 7e-6 (of 0.17), err_max 7e-7, true_pose 1.2e-7. `seen`
# and `update_rejects` are compared exactly.
JAX_TOL = {
    "true_pose": dict(rtol=0, atol=1e-5),
    "err_sum": dict(rtol=1e-4, atol=1e-6),
    "err_max": dict(rtol=1e-4, atol=1e-6),
    "x": dict(rtol=0, atol=1e-5),
    "P": dict(rtol=1e-4, atol=1e-6),
}


def _inputs(kind, seed=5, **replace):
    cfg = small_cfg(Config, CompatConfig, kind, T, N, BOUND).replace(**replace)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, B)
    noise = rng.uniform(-1, 1, size=(T, 2 * N + 8, B)).astype(np.float32)
    return cfg, lms, arc_commands(B, T), noise


def _run_both(kind, slam, **replace):
    """(port's plain version, JAX kernel in interpret mode) on the same
    seeded inputs, as numpy in the JAX layout."""
    cfg, lms, cmds, noise = _inputs(kind, **replace)
    assert max_co_observed(cfg, lms, cmds, noise) >= 2, "no co-observation"
    jcfg = small_cfg(JConfig, JCompat, kind, T, N, BOUND).replace(**replace)
    want = {k: np.asarray(v) for k, v in j_rollout(
        jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0, slam=slam,
        block_worlds=B, noise=jnp.asarray(noise), interpret=True).items()}
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    got = outputs_to_numpy(fu.fused_ukf_rollout(cfg, lt, ct, 0, slam=slam,
                                                noise=nt))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got["seen"], want["seen"])
    np.testing.assert_array_equal(got["update_rejects"], want["update_rejects"])
    # the one-pass Joseph form keeps P exactly symmetric
    np.testing.assert_array_equal(got["P"], got["P"].transpose(0, 2, 1))
    return got, want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("slam", [True, False], ids=["slam", "loc"])
def test_plain_matches_pallas_kernel(kind, slam):
    got, want = _run_both(kind, slam)
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    if slam:
        assert got["seen"].sum(axis=1).max() >= 2
    else:
        assert not got["seen"].any()


def test_sanity_gate_rejects_match_pallas_kernel():
    # simulator noise 800 times the filter's: ranges off by up to 8 m, so
    # the innovation gate |nu_r| < 2 r_max refuses some updates. The gate's
    # decisions (update_rejects) must be the JAX kernel's exactly. The
    # estimates of such worlds are chaotic (a one-ulp change of the inputs
    # moves them beyond JAX_TOL), so beyond the truth they are held to
    # finiteness only.
    got, want = _run_both("default", True, sim_noise_scale=800.0)
    assert got["update_rejects"].sum() > 0
    np.testing.assert_allclose(got["true_pose"], want["true_pose"],
                               **JAX_TOL["true_pose"])
    for k in ("err_sum", "err_max", "x", "P"):
        assert np.isfinite(got[k]).all(), k


def test_predicated_equals_unpredicated_and_seed_replays():
    cfg, lms, cmds, _ = _inputs("default")
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    for slam in (True, False):
        a = fu.fused_ukf_rollout(cfg, lt, ct, 9, slam=slam)
        b = fu.fused_ukf_rollout(cfg, lt, ct, 9, slam=slam, predicated=False)
        c = fu.fused_ukf_rollout(cfg, lt, ct, 0, slam=slam,
                                 noise=philox.philox_noise(9, T, N, B))
        for k in a:
            assert torch.equal(a[k], b[k]), (slam, k)
            assert torch.equal(a[k], c[k]), (slam, k)


def _terms(rng, shape):
    """float32 terms over eight decades of magnitude and both signs, where
    the order of a sum shows in its last bits."""
    mag = 10.0 ** rng.integers(-4, 4, size=shape)
    return (rng.standard_normal(shape) * mag).astype(np.float32)


@pytest.mark.parametrize("du", [4, 12, 44, 70])
def test_lane_sum_follows_the_kernels_warp_order(du):
    # a lane-by-lane model of the kernel's warp_sum: lane l adds terms l,
    # l + 32, ... from 0, then v += shfl_xor(v, m) for m = 16, 8, 4, 2, 1
    t = _terms(np.random.default_rng(du), (6, du))
    got = fu.lane_sum(torch.from_numpy(t)).numpy()
    for w in range(t.shape[0]):
        acc = [np.float32(0.0)] * fu.LANES
        for k in range(du):
            acc[k % fu.LANES] = np.float32(acc[k % fu.LANES] + t[w, k])
        for m in (16, 8, 4, 2, 1):
            acc = [np.float32(acc[ln] + acc[ln ^ m]) for ln in range(fu.LANES)]
        assert len({float(a) for a in acc}) == 1  # every lane the same bits
        assert got[w] == acc[0], (w, got[w], acc[0])


@pytest.mark.parametrize("du", [4, 44])
def test_row_dot_sums_each_row_in_order(du):
    # the kernel's lane i: c = 0; for k <= i: c += L[i, k] * g[k]
    rng = np.random.default_rng(du)
    L = np.tril(_terms(rng, (2, du, du)))
    g = _terms(rng, (2, 3, du))
    got = fu.row_dot(torch.from_numpy(L), torch.from_numpy(g)).numpy()
    for w in range(2):
        for a in range(3):
            for i in range(du):
                c = np.float32(0.0)
                for k in range(i + 1):
                    c = np.float32(c + np.float32(L[w, i, k] * g[w, a, k]))
                assert got[w, a, i] == c, (w, a, i)


@pytest.mark.parametrize("kind", ["default", "compat", "calibrated",
                                  "calibrated+swap", "w_b"])
def test_ukf_kernel_params_follow_cfg_rules(kind):
    cfg = Config().replace(init_pose=(1.0, -2.0, 0.3))
    if kind == "compat":
        cfg = cfg.replace(compat=CompatConfig.all_on())
    elif kind == "calibrated":
        cfg = cfg.replace(calibrated_motion=True)
    elif kind == "calibrated+swap":  # the swap wins over calibration
        cfg = cfg.replace(calibrated_motion=True,
                          compat=CompatConfig(noise_vw_swap=True))
    elif kind == "w_b":
        cfg = cfg.replace(sensing_noise=dataclasses.replace(
            cfg.sensing_noise, w_r=0.01, w_b=0.02), ukf=dataclasses.replace(
            cfg.ukf, W_0=0.3))
    kp = ukf_kernel_params(cfg)
    f32 = np.float32
    pn, sn = cfg.process_noise, cfg.sensing_noise
    # fused_ukf.py:76-99
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    calibrated = cfg.calibrated_motion and not cfg.compat.noise_vw_swap
    if calibrated:
        w00f, w11f = sn.W_00 ** 2 / 3.0, sn.W_11 ** 2 / 3.0
    want = {
        "v00f": v00f, "v11f": v11f, "w00f": w00f, "w11f": w11f,
        "det_gate": min(1e-12, 1e-6 * w00f * w11f),
        "v00s": pn.V_00, "v11s": pn.V_11, "w00s": sn.W_00, "w11s": sn.W_11,
        "v_d": pn.v_d, "v_th": pn.v_th, "w_r": sn.w_r, "w_b": sn.w_b,
        "wbc": math.cos(sn.w_b), "wbs": math.sin(sn.w_b),
        "d_max": cfg.constraints.commands.d_max,
        "th_max": cfg.constraints.commands.th_max,
        "r_max": cfg.constraints.vision.range_max,
        "fov_min": cfg.constraints.vision.fov_min,
        "fov_max": cfg.constraints.vision.fov_max,
        "x0": 1.0, "y0": -2.0, "yaw0": 0.3,
        "cyaw0": math.cos(0.3), "syaw0": math.sin(0.3),
        "w0": cfg.ukf.W_0, "one_m_w0": 1.0 - cfg.ukf.W_0,
        "cm_v_fwd": pn.V_00, "cm_floor_hdg": 0.1 * pn.V_11 / 3 ** 0.5,
    }
    for name, v in want.items():
        assert getattr(kp, name) == f32(v), name
    assert kp.calibrated == int(calibrated)
    assert kp.zero_b_mean == int(cfg.compat.ukf_zero_bearing_mean)
    assert kp.committed_yaw == int(cfg.compat.ukf_committed_yaw_in_sensing)
    assert kp.signed_q == int(cfg.compat.ukf_signed_process_noise)


def test_out_of_scope_requests_raise():
    cfg, lms, cmds, _ = _inputs("default")
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    unknown = cfg.replace(constraints=dataclasses.replace(
        cfg.constraints, measurements=dataclasses.replace(
            cfg.constraints.measurements, landmark_id_is_known=False)))
    with pytest.raises(ValueError, match="known landmark ids"):
        fu.fused_ukf_rollout(unknown, lt, ct, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fu.fused_ukf_rollout(cfg, lt.to("meta"), ct.to("meta"), 0)


@pytest.mark.slow
@pytest.mark.parametrize("slam", [True, False], ids=["slam", "loc"])
def test_plain_rollout_long_horizon_stays_finite(slam):
    # T = 1000 at full width; ROADMAP hazard F3: P must stay exactly
    # symmetric, or the Cholesky breaks down over long runs
    cfg = Config(num_iterations=1000)
    lms, cmds = mc_inputs(cfg, 8, 0, "cpu")
    out = fu.fused_ukf_rollout(cfg, lms, cmds, 0, slam=slam)
    for k in ("err_sum", "err_max", "x", "P", "true_pose"):
        assert torch.isfinite(out[k]).all(), k
    assert torch.equal(out["P"], out["P"].transpose(1, 2))
    assert float((out["err_sum"] / 1000).mean()) < 1.0
