"""The port's fused EKF rollout: plain version against the JAX Pallas kernel
(interpret mode) and the float64 oracle. The CUDA kernel is held against the
plain version on the card in test_torch_cuda.py.

Every input is made with numpy from a seed, noise included, and injected
into both sides (the kernels' ``noise=`` argument).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import CompatConfig as JCompat
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout as j_rollout
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.convert import (
    inputs_from_numpy,
    kernel_params,
    outputs_to_numpy,
)
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.sim.maps import random_landmarks_batched
from port_harness import arc_commands, oracle_replay, small_cfg

KINDS = ["default", "compat", "calibrated"]
# B = 8 worlds, N = 6 landmarks in a +/-2.5 m box, T = 40 ticks: every world
# sees and re-observes at least two landmarks (asserted below).
B, N, T, BOUND = 8, 6, 40, 2.5

# Plain version vs the Pallas kernel (interpret mode, CPU): the same float32
# algebra in the same order, but XLA's and torch's CPU sin/cos/sqrt differ
# in the last bit. Measured: x 7e-7, P 1.5e-7, err_sum 1.3e-5 (of ~0.5),
# true_pose 5e-7. `seen` is compared exactly.
JAX_TOL = {
    "true_pose": dict(rtol=0, atol=1e-5),
    "err_sum": dict(rtol=1e-4, atol=1e-6),
    "err_max": dict(rtol=1e-4, atol=1e-6),
    "x": dict(rtol=0, atol=1e-5),
    "P": dict(rtol=1e-4, atol=1e-6),
}


def _inputs(kind, seed=5, b=B, n=N, t=T, bound=BOUND):
    cfg = small_cfg(Config, CompatConfig, kind, t, n, bound)
    rng = np.random.default_rng(seed)
    lms = random_landmarks_batched(cfg, rng, b)
    noise = rng.uniform(-1, 1, size=(t, 2 * n + 8, b)).astype(np.float32)
    return cfg, lms, arc_commands(b, t), noise


def _jax_rollout(kind, lms, cmds, noise, t=T, n=N, bound=BOUND, **kw):
    jcfg = small_cfg(JConfig, JCompat, kind, t, n, bound)
    out = j_rollout(jcfg, jnp.asarray(lms), jnp.asarray(cmds), 0,
                    block_worlds=lms.shape[0], noise=jnp.asarray(noise),
                    interpret=True, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_kernel(kind):
    cfg, lms, cmds, noise = _inputs(kind)
    want = _jax_rollout(kind, lms, cmds, noise)
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    got = outputs_to_numpy(fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt))
    assert want["seen"].sum(axis=1).min() >= 2, "a world saw <2 landmarks"
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got["seen"], want["seen"])
    for k, tol in JAX_TOL.items():
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("kind", KINDS)
def test_pose_stream_matches_pallas_kernel(kind):
    # emit_traj=True: the estimated and the true pose after every tick, at
    # the tolerances of x and true_pose above
    cfg, lms, cmds, noise = _inputs(kind)
    want = _jax_rollout(kind, lms, cmds, noise, emit_traj=True)
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    res = fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt, emit_traj=True)
    got = outputs_to_numpy(res)
    assert set(got) == set(want) and got["est_traj"].shape == (B, T, 3)
    np.testing.assert_allclose(got["est_traj"], want["est_traj"], **JAX_TOL["x"])
    np.testing.assert_allclose(got["true_traj"], want["true_traj"],
                               **JAX_TOL["true_pose"])
    # the last tick is the final state, exactly; the rest of the result is
    # what emit_traj=False gives, exactly
    assert torch.equal(res["est_traj"][:, -1], res["x"][:, :3])
    assert torch.equal(res["true_traj"][:, -1], res["true_pose"])
    plain = fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt)
    for k in plain:
        assert torch.equal(plain[k], res[k]), k
    d = (res["est_traj"][..., :2] - res["true_traj"][..., :2]).norm(dim=-1)
    torch.testing.assert_close(d.sum(dim=1), res["err_sum"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compat", [False, True])
def test_plain_matches_float64_oracle(compat):
    # the JAX kernel test's setup and tolerances (test_fused_rollout.py)
    cfg, lms, cmds, noise = _inputs("compat" if compat else "default",
                                    b=8, n=5, t=25, bound=10.0)
    lt, ct, nt = inputs_from_numpy(lms, cmds, noise)
    out = outputs_to_numpy(fr.fused_ekf_rollout(cfg, lt, ct, 0, noise=nt))
    for w in range(lms.shape[0]):
        o, pose, err_sum = oracle_replay(cfg, lms[w], cmds[w], noise[:, :, w])
        np.testing.assert_allclose(out["true_pose"][w], pose, atol=1e-4)
        assert abs(out["err_sum"][w] - err_sum) < 1e-3 * max(err_sum, 1.0)
        assert set(o.lm_ids) == set(np.where(out["seen"][w])[0])
        perm = [0, 1, 2]
        for sl in range(o.M):
            perm += [3 + 2 * o.lm_ids[sl], 4 + 2 * o.lm_ids[sl]]
        np.testing.assert_allclose(out["x"][w][np.array(perm)], o.x_t,
                                   atol=2e-4)


def test_predicated_equals_unpredicated_and_seed_replays():
    cfg, lms, cmds, _ = _inputs("default")
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    a = fr.fused_ekf_rollout(cfg, lt, ct, 9)
    b = fr.fused_ekf_rollout(cfg, lt, ct, 9, predicated=False)
    c = fr.fused_ekf_rollout(cfg, lt, ct, 0,
                             noise=philox.philox_noise(9, T, N, B))
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k


@pytest.mark.parametrize("kind", ["default", "compat", "calibrated",
                                  "calibrated+swap", "scaled"])
def test_kernel_params_follow_cfg_rules(kind):
    cfg = Config().replace(init_pose=(1.0, -2.0, 0.3))
    if kind == "compat":
        cfg = cfg.replace(compat=CompatConfig.all_on())
    elif kind == "calibrated":
        cfg = cfg.replace(calibrated_motion=True)
    elif kind == "calibrated+swap":  # the swap wins over calibration
        cfg = cfg.replace(calibrated_motion=True,
                          compat=CompatConfig(noise_vw_swap=True))
    elif kind == "scaled":
        cfg = cfg.replace(sim_noise_scale=0.5)
    kp = kernel_params(cfg)
    f32 = np.float32
    pn, sn = cfg.process_noise, cfg.sensing_noise
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    calibrated = cfg.calibrated_motion and not cfg.compat.noise_vw_swap
    if calibrated:
        w00f, w11f = sn.W_00 ** 2 / 3.0, sn.W_11 ** 2 / 3.0
    nz = cfg.sim_noise_scale
    want = {
        "v00f": v00f, "v11f": v11f, "w00f": w00f, "w11f": w11f,
        "v00s": pn.V_00 * nz, "v11s": pn.V_11 * nz,
        "w00s": sn.W_00 * nz, "w11s": sn.W_11 * nz,
        "v_d": pn.v_d, "v_th": pn.v_th, "w_r": sn.w_r, "w_b": sn.w_b,
        "d_max": cfg.constraints.commands.d_max,
        "th_max": cfg.constraints.commands.th_max,
        "r_max": cfg.constraints.vision.range_max,
        "fov_min": cfg.constraints.vision.fov_min,
        "fov_max": cfg.constraints.vision.fov_max,
        "x0": 1.0, "y0": -2.0, "yaw0": 0.3,
        "cm_v_fwd": pn.V_00, "cm_6v_fwd": 6 * pn.V_00,
        "cm_floor_hdg": 0.1 * pn.V_11 / 3 ** 0.5,
    }
    for name, v in want.items():
        assert getattr(kp, name) == f32(v), name
    assert kp.calibrated == int(calibrated)
    assert kp.stale == int(cfg.compat.ekf_stale_landmarks)
    assert kp.wrap_innov == int(not cfg.compat.ekf_unwrapped_innovation)


def test_out_of_scope_requests_raise():
    cfg, lms, cmds, _ = _inputs("default", t=2)
    lt, ct, _ = inputs_from_numpy(lms, cmds)
    unknown = cfg.replace(constraints=dataclasses.replace(
        cfg.constraints, measurements=dataclasses.replace(
            cfg.constraints.measurements, landmark_id_is_known=False)))
    with pytest.raises(ValueError, match="known landmark ids"):
        fr.fused_ekf_rollout(unknown, lt, ct, 0)
    # the phase-attribution modes run (test_torch_profile_modes.py holds
    # them against the JAX kernel); a name that is none of them raises
    nolm = fr.fused_ekf_rollout(cfg, lt, ct, 0, profile_mode="nolm")
    assert not nolm["seen"].any() and torch.isfinite(nolm["P"]).all()
    with pytest.raises(ValueError, match="unknown profile_mode"):
        fr.fused_ekf_rollout(cfg, lt, ct, 0, profile_mode="landmarks")
    with pytest.raises(ValueError, match="emit_traj requires profile_mode"):
        fr.fused_ekf_rollout(cfg, lt, ct, 0, profile_mode="nolm", emit_traj=True)
    with pytest.raises(ValueError, match="unknown filter_kind"):
        fr.fused_ekf_rollout(cfg, lt, ct, 0, filter_kind="ukf")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fr.fused_ekf_rollout(cfg, lt.to("meta"), ct.to("meta"), 0)


def test_build_finds_no_nvcc_without_a_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # sources are hashed into the library name
    assert _build.library_path().name.startswith("libles_kernels_")


def test_every_kernel_entry_point_has_its_signature():
    # each extern "C" function of csrc/ is bound with explicit argument
    # types (ctypes would cut an untyped pointer to 32 bits), and the
    # sources ship as package data
    import re

    entries = set()
    for src in _build.CSRC.glob("*.cu"):
        entries |= set(re.findall(r'extern "C" [\w* ]+?(les_\w+)\(', src.read_text()))
    assert entries == set(_build.SIGNATURES)
    assert {"les_block_thomas_factor", "les_block_thomas_solve"} <= entries
    toml = (Path(_build.CSRC).parent.parent / "pyproject.toml").read_text()
    assert '"csrc/*.cu", "csrc/*.cuh"' in toml
    assert '"live_ekf_slam_tpu_torch.models"' in toml


@pytest.mark.slow
def test_plain_rollout_long_horizon_stays_finite():
    # ROADMAP hazard F1: the one-sided gain / H P spellings go NaN by T=1000
    cfg = Config(num_iterations=1000)
    lms, cmds = mc_inputs(cfg, 16, 0, "cpu")
    out = fr.fused_ekf_rollout(cfg, lms, cmds, 0)
    for k in ("err_sum", "err_max", "x", "P", "true_pose"):
        assert torch.isfinite(out[k]).all(), k
    P = out["P"]
    assert float((P - P.transpose(1, 2)).abs().max()) < 1e-3 * float(P.abs().max())
    assert float((out["err_sum"] / 1000).mean()) < 1.0
