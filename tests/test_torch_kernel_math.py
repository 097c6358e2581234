"""The port's scalar kernel math and Philox generator.

``live_ekf_slam_tpu_torch/ops/kernel_math.py`` against the JAX package's
``ops/kernel_math.py`` on the same float32 inputs, and the hand-written
Philox-4x32-10 against the Random123 known-answer vectors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.ops import kernel_math as jkm
from live_ekf_slam_tpu_torch.ops import kernel_math as tkm
from live_ekf_slam_tpu_torch.ops import philox
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32


def _angles():
    pi = np.float32(math.pi)
    special = [0.0, -0.0, pi, -pi, 2 * pi, -2 * pi, 3 * pi, -3 * pi,
               pi / 2, -pi / 2, 1e-30, -1e-30, 100.0, -100.0, 12345.678]
    rng = np.random.default_rng(0)
    return np.concatenate([np.float32(special),
                           rng.uniform(-50, 50, 4096).astype(np.float32)])


def test_rint_is_half_to_even_like_jax():
    x = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, 3.0,
                    -7.5, 8388607.5, 1e9])
    np.testing.assert_array_equal(tkm.rint(torch.from_numpy(x)).numpy(),
                                  np.asarray(jkm.rint(jnp.asarray(x))))
    np.testing.assert_array_equal(tkm.rint(torch.from_numpy(x)).numpy(),
                                  np.rint(x))


def test_wrap_matches_jax():
    # the same three float32 operations on both sides: equal to the last bit
    x = _angles()
    got = tkm.wrap(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jkm.wrap(jnp.asarray(x))))
    # and C remainder semantics: |wrap| <= pi (+1 ulp of fp32 at pi)
    assert np.abs(got).max() <= np.float32(math.pi) * (1 + 2e-7)


def test_atan2_matches_jax():
    rng = np.random.default_rng(1)
    vals = np.float32([0.0, -0.0, 1.0, -1.0, 1e-30, 3.5, -3.5])
    yy, xx = np.meshgrid(vals, vals)  # zeros, axes, diagonals, both signs
    y = np.concatenate([yy.ravel(), rng.normal(size=4096).astype(np.float32)])
    x = np.concatenate([xx.ravel(), rng.normal(size=4096).astype(np.float32)])
    got = tkm.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jkm.atan2(jnp.asarray(y), jnp.asarray(x)))
    # the same polynomial in float32; XLA may fuse its mul-adds, so allow
    # a couple of ulps at the polynomial's scale
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    # and within the polynomial's error of the true atan2, up to the sign
    # of zero (-0.0 is not < 0: +pi, not -pi). That error measures 1.8e-6
    # on a dense grid of [0, 1], not the ~1e-7 the JAX docstring states.
    finite = np.hypot(x, y) > 1e-20
    diff = got.astype(np.float64) - np.arctan2(y.astype(np.float64),
                                              x.astype(np.float64))
    diff = np.remainder(diff + math.pi, 2 * math.pi) - math.pi
    assert np.abs(diff[finite]).max() < 2.5e-6


def test_uniform_pm1_matches_jax():
    rng = np.random.default_rng(2)
    bits = np.concatenate([
        np.int32([0, 1, -1, 255, 256, -256, 2 ** 31 - 1, -2 ** 31]),
        rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32),
    ])
    got = tkm.uniform_pm1(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jkm.uniform_pm1(jnp.asarray(bits))))
    assert got.min() >= -1.0 and got.max() < 1.0


def test_round_up():
    for x, m in [(43, 8), (48, 8), (0, 8), (1, 4), (4, 4)]:
        assert tkm.round_up(x, m) == jkm.round_up(x, m)


# Random123's kat_vectors for philox4x32_10: (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox.philox4x32(*ctr, *key)
    assert tuple(int(v) for v in got) == want


def test_philox_noise_layout_and_moments():
    seed, t, n, b = 123, 16, 5, 33
    nz = philox.philox_noise(seed, t, n, b)  # CPU: the plain version
    assert nz.shape == (t, 2 * n + 8, b) and nz.dtype == torch.float32
    for (tt, row, w) in [(0, 0, 0), (3, 5, 7), (15, 17, 32), (9, 12, 1)]:
        words = philox.philox4x32(tt, row // 4, 0, 0, seed, w)
        bits = philox.to_int32(words[row % 4])
        assert nz[tt, row, w] == tkm.uniform_pm1(bits)
    big = philox.philox_noise_reference(7, 64, 20, 256)
    assert abs(float(big.mean())) < 0.01
    assert abs(float(big.var()) - 1 / 3) < 0.01
    assert float(big.min()) >= -1.0 and float(big.max()) < 1.0
    # distinct worlds and ticks draw distinct streams
    assert not torch.equal(big[:, :, 0], big[:, :, 1])
    assert not torch.equal(big[0], big[1])


def test_philox_noise_refuses_other_devices():
    with pytest.raises(ValueError):
        philox.philox_noise(0, 2, 2, 2, device="meta")


def test_pin_fp32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    pin_fp32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
