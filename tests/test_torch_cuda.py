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

import chip_smoke
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.eval.runner import fused_rollout, mc_inputs
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
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


# kernel of each filter: (launch counter, key)
LAUNCHES = {"ekf_slam": (fr.launches, "ekf"), "iekf_slam": (fr.launches, "iekf"),
            "ukf_slam": (fu.launches, "slam"), "ukf_loc": (fu.launches, "loc")}


def _inputs(kind, dev, seed=3, filt="ekf_slam"):
    cfg = small_cfg(Config, CompatConfig, kind, T, N).replace(filter=filt)
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
    before = fr.launches["ekf"]
    k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise)
    torch.cuda.synchronize()
    assert fr.launches["ekf"] == before + 1
    p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, noise=noise)
    assert torch.equal(k["seen"], p["seen"])
    for name, (rtol, atol) in CARD_TOL.items():
        ref = p[name]
        scale = ref.abs() if ref.dim() == 1 else ref.abs().amax(
            dim=tuple(range(1, ref.dim())), keepdim=True)
        assert bool(((k[name] - ref).abs() <= atol + rtol * scale).all()), name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filt", ["iekf_slam", "ukf_slam", "ukf_loc"])
def test_new_kernels_match_plain(filt, kind, cuda_device):
    # chip_smoke.compare's rule: TOL per world; for the UKFs, the worlds the
    # plain version itself flags as chaotic are reported but exempt
    cfg, lms, cmds, noise = _inputs(kind, cuda_device, filt=filt)
    ctr, key = LAUNCHES[filt]
    before = ctr[key]
    k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
    torch.cuda.synchronize()
    assert ctr[key] == before + 1
    p, exempt = chip_smoke.plain_run(cfg, lms, cmds, noise, chip_smoke.TOL)
    chip_smoke.compare(k, p, chip_smoke.TOL, exempt, chip_smoke.AGG_RTOL)
    if filt.startswith("ukf"):
        assert torch.equal(k["P"], k["P"].transpose(1, 2))


@pytest.mark.parametrize("filt", ["ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"])
def test_predicated_and_philox_replay_are_bitwise(filt, cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device, filt=filt)
    a = fused_rollout(cfg, lms, cmds, 11)
    b = fused_rollout(cfg, lms, cmds, 11, predicated=False)
    nz = philox.philox_noise(11, T, N, B, device=cuda_device)
    c = fused_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert torch.equal(a[key], c[key]), key


def test_ukf_covariance_stays_exactly_symmetric_at_t1000(cuda_device):
    # ROADMAP hazard F3: nvcc's FMA contraction must not skew the Joseph
    # update; the kernel computes each entry once and mirrors it
    cfg = Config(num_iterations=1000).replace(filter="ukf_slam")
    lms, cmds = mc_inputs(cfg, 256, 0, cuda_device, shared=True, relabel=True)
    out = fu.fused_ukf_rollout(cfg, lms, cmds, 0)
    torch.cuda.synchronize()
    assert torch.equal(out["P"], out["P"].transpose(1, 2))
    assert bool(torch.isfinite(out["err_sum"]).all())


@pytest.mark.parametrize("filt", ["ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"])
def test_kernel_without_fma_equals_plain_bitwise(filt, cuda_device):
    # with contraction off the kernel rounds exactly like the plain version:
    # the two are then the same algorithm to the last bit, in every world
    for kind in KINDS:
        cfg, lms, cmds, noise = _inputs(kind, cuda_device, filt=filt)
        with _build.without_fma():
            k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        p = fused_rollout(cfg, lms, cmds, 0, noise=noise, plain=True)
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
