"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; each takes the ``cuda_device``
fixture, which skips it where ``torch.cuda.is_available()`` is false. This
file imports only torch, numpy and the port (no jax, no flax), so it also
runs on a GPU machine without the JAX package's dependencies:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from port_harness import cuda_device, small_cfg  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

KINDS = ["default", "compat", "calibrated"]
B, T, N = 250, 200, 20  # 250 worlds: a ragged edge for 4-world blocks

# nvcc contracts a*b + c into FMA, the plain version does not; over 200
# ticks the last-bit differences stay within these, as |kernel - plain| <=
# atol + rtol * scale with the scale of chip_smoke.py (per-world scalars by
# their value, vectors and matrices by their largest magnitude in the world).
CARD_TOL = {"true_pose": (1e-5, 1e-5), "err_sum": (1e-3, 1e-3),
            "err_max": (1e-3, 1e-4), "x": (1e-4, 1e-4), "P": (1e-3, 1e-6)}


def _inputs(kind, dev, seed=3):
    cfg = small_cfg(Config, CompatConfig, kind, T, N)
    lms, cmds = mc_inputs(cfg, B, seed, dev)
    noise = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, (T, 2 * N + 8, B)).astype(np.float32), device=dev)
    return cfg, lms, cmds, noise


def test_philox_kernel_matches_torch(cuda_device):
    before = philox.launches
    nz = philox.philox_noise(11, T, N, B, device=cuda_device)
    ref = philox.philox_noise_reference(11, T, N, B, device=cuda_device)
    assert philox.launches == before + 1
    assert torch.equal(nz, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(kind, cuda_device):
    cfg, lms, cmds, noise = _inputs(kind, cuda_device)
    before = fr.launches
    k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, noise=noise)
    assert torch.equal(k["seen"], p["seen"])
    for name, (rtol, atol) in CARD_TOL.items():
        ref = p[name]
        scale = ref.abs() if ref.dim() == 1 else ref.abs().amax(
            dim=tuple(range(1, ref.dim())), keepdim=True)
        assert bool(((k[name] - ref).abs() <= atol + rtol * scale).all()), name


def test_predicated_and_philox_replay_are_bitwise(cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device)
    a = fr.fused_ekf_rollout(cfg, lms, cmds, 11)
    b = fr.fused_ekf_rollout(cfg, lms, cmds, 11, predicated=False)
    nz = philox.philox_noise(11, T, N, B, device=cuda_device)
    c = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert torch.equal(a[key], c[key]), key


def test_kernel_without_fma_equals_plain_bitwise(cuda_device, monkeypatch):
    # with contraction off the kernel rounds exactly like the plain version:
    # the two are then the same algorithm to the last bit
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-fmad=false",))
    monkeypatch.setattr(_build, "_lib", None)
    for kind in KINDS:
        cfg, lms, cmds, noise = _inputs(kind, cuda_device)
        k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise)
        p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, noise=noise)
        for key in k:
            assert torch.equal(k[key], p[key]), (kind, key)


def test_wrapper_rejects_bad_inputs(cuda_device):
    cfg, lms, cmds, noise = _inputs("default", cuda_device)
    with pytest.raises(TypeError, match="float32"):
        fr.fused_ekf_rollout(cfg, lms.double(), cmds, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_ekf_rollout(cfg, lms, cmds.transpose(0, 1).contiguous()
                             .transpose(0, 1), 0)
    with pytest.raises(ValueError, match="shape"):
        fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise[:, :, :10])
    with pytest.raises(ValueError, match="is on"):
        fr.fused_ekf_rollout(cfg, lms, cmds.cpu(), 0)
