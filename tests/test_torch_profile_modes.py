"""The fused EKF and RI-EKF rollouts' ``profile_mode`` variants ("sim",
"nolm", "downdate"): the port's plain version against the JAX Pallas kernel
in interpret mode, for both filter kinds. The CUDA instantiations are held
against the plain version on the card in test_torch_cuda.py.

Every input is made with numpy from a seed, noise included, and injected
into both sides (the kernels' ``noise=`` argument), at the small sizes and
the tolerances of test_torch_fused_rollout.py (EKF) and
test_torch_iekf_rollout.py (RI-EKF).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout as j_rollout
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import inputs_from_numpy, outputs_to_numpy
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import philox
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import arc_commands, small_cfg

# (B worlds, N landmarks, T ticks, half-width of the map's box in m) of each
# filter kind's rollout tests
SIZES = {"ekf": (8, 6, 40, 2.5), "iekf": (4, 4, 20, 3.0)}
KINDS = list(SIZES)

# Plain version vs the Pallas kernel (interpret mode, CPU): the same float32
# algebra in the same order; XLA's and torch's CPU sin/cos/sqrt differ in the
# last bit. `seen` is compared exactly.
JAX_TOL = {
    "true_pose": dict(rtol=0, atol=1e-5),
    "err_sum": dict(rtol=1e-4, atol=1e-6),
    "err_max": dict(rtol=1e-4, atol=1e-6),
    "x": dict(rtol=0, atol=1e-5),
    "P": dict(rtol=1e-4, atol=1e-6),
}


def _inputs(kind, cfg_kind="default", seed=5):
    b, n, t, bound = SIZES[kind]
    cfg = small_cfg(Config, CompatConfig, cfg_kind, t, n, bound)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, b)
    noise = rng.uniform(-1, 1, size=(t, 2 * n + 8, b)).astype(np.float32)
    return cfg, lms, arc_commands(b, t), noise


def _jax(cfg_kind, lms, cmds, noise, kind, mode):
    b, n, t, bound = SIZES[kind]
    jcfg = small_cfg(JConfig, JCompat, cfg_kind, t, n, bound)
    out = j_rollout(jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0,
                    block_worlds=b, noise=jnp.asarray(noise), interpret=True,
                    filter_kind=kind, profile_mode=mode)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(cfg, lms, cmds, noise, kind, mode):
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    return fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt, filter_kind=kind,
                                profile_mode=mode)


def _hold(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got["seen"], want["seen"])
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode,cfg_kind", [("sim", "default"),
                                           ("nolm", "default"),
                                           ("nolm", "calibrated"),
                                           ("nolm", "compat")])
def test_mode_matches_pallas_kernel(mode, cfg_kind, kind):
    cfg, lms, cmds, noise = _inputs(kind, cfg_kind)
    want = _jax(cfg_kind, lms, cmds, noise, kind, mode)
    res = _port(cfg, lms, cmds, noise, kind, mode)
    _hold(outputs_to_numpy(res), want)
    # neither mode runs the landmark loop, so no landmark is ever marked seen
    assert not res["seen"].any()
    assert float(res["err_sum"].min()) > 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_downdate_names_the_full_kernel_on_both_sides(kind):
    # the JAX kernel's comment lists "downdate", but no branch reads it
    cfg, lms, cmds, noise = _inputs(kind)
    want = _jax("default", lms, cmds, noise, kind, "downdate")
    full_j = _jax("default", lms, cmds, noise, kind, "full")
    for k in want:
        np.testing.assert_array_equal(want[k], full_j[k], err_msg=k)
    got = _port(cfg, lms, cmds, noise, kind, "downdate")
    full = _port(cfg, lms, cmds, noise, kind, "full")
    for k in got:
        assert torch.equal(got[k], full[k]), k
    _hold(outputs_to_numpy(got), want)
    assert got["seen"].sum(dim=1).max() >= 2, "no world saw 2 landmarks"


@pytest.mark.parametrize("kind", KINDS)
def test_sim_leaves_the_estimate_where_it_started(kind):
    cfg, lms, cmds, noise = _inputs(kind)
    res = _port(cfg, lms, cmds, noise, kind, "sim")
    b, n = lms.shape[:2]
    d = 3 + 2 * n
    x0 = torch.zeros(b, d)
    x0[:, :3] = torch.tensor(cfg.init_pose, dtype=torch.float32)
    p0 = torch.zeros(b, d, d)
    for i, v in enumerate(fr.P0):
        p0[:, i, i] = v
    assert torch.equal(res["x"], x0)
    assert torch.equal(res["P"], p0)
    assert not res["seen"].any()
    # the truth moves as in the full rollout; the error is its distance from
    # the start
    full = _port(cfg, lms, cmds, noise, kind, "full")
    assert torch.equal(res["true_pose"], full["true_pose"])
    assert float(res["err_max"].min()) > 0.5


@pytest.mark.parametrize("kind", KINDS)
def test_nolm_is_the_predict_alone(kind):
    # x dead-reckons the commands: the same for both filters; P grows by the
    # predict only, which differs between them
    cfg, lms, cmds, noise = _inputs("ekf")
    B, N = lms.shape[:2]
    res = _port(cfg, lms, cmds, noise, kind, "nolm")
    other = _port(cfg, lms, cmds, noise, "iekf" if kind == "ekf" else "ekf", "nolm")
    assert torch.equal(res["x"], other["x"])
    assert torch.equal(res["x"][:, 3:], torch.zeros(B, 2 * N))
    assert not torch.equal(res["P"], other["P"])
    assert torch.equal(res["P"][:, 3:, 3:], torch.zeros(B, 2 * N, 2 * N))
    full = _port(cfg, lms, cmds, noise, kind, "full")
    assert torch.equal(res["true_pose"], full["true_pose"])


@pytest.mark.parametrize("mode", ["sim", "nolm"])
def test_modes_replay_the_seeded_noise_and_ignore_predication(mode):
    cfg, lms, cmds, _ = _inputs("ekf")
    B, N, T, _ = SIZES["ekf"]
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    a = fr.fused_ekf_rollout(cfg, lt, ct, 9, profile_mode=mode)
    b = fr.fused_ekf_rollout(cfg, lt, ct, 9, profile_mode=mode, predicated=False)
    c = fr.fused_ekf_rollout(cfg, lt, ct, 0, profile_mode=mode,
                             noise=philox.philox_noise(9, T, N, B))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k


def test_modes_route_through_the_runner_and_count_their_own_launches():
    cfg, lms, cmds, noise = _inputs("ekf")
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    for filt, kind in (("ekf_slam", "ekf"), ("iekf_slam", "iekf")):
        via = runner.fused_rollout(cfg.replace(filter=filt), lt, ct, 0,
                                   noise=nt, profile_mode="nolm")
        direct = fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt,
                                      filter_kind=kind, profile_mode="nolm")
        for k in via:
            assert torch.equal(via[k], direct[k]), k
    with pytest.raises(ValueError, match="has no profile_mode"):
        runner.fused_rollout(cfg.replace(filter="ukf_slam"), lt, ct, 0,
                             profile_mode="sim")
    with pytest.raises(ValueError, match="unknown profile_mode"):
        fr.fused_ekf_rollout(cfg, lt, ct, 0, profile_mode="update")
    # every instantiation has its own counter; "downdate" is the full kernel
    assert fr.launch_key("ekf") == "ekf"
    assert fr.launch_key("ekf", "downdate") == "ekf"
    assert fr.launch_key("iekf", "nolm") == "iekf_nolm"
    assert fr.launch_key("ekf", "sim") == "ekf_sim"
    assert fr.launch_key("iekf", "full", emit_traj=True) == "iekf_traj"
    assert {fr.launch_key(k, m) for k in KINDS for m in fr.PROFILE_MODES} \
        <= set(fr.launches)
    assert not any(fr.launches.values())  # the plain version counts nothing
