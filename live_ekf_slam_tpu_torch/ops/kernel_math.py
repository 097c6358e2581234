"""Scalar math of the rollout kernel, as torch functions.

The same formulas are the device functions of ``csrc/kernel_math.cuh``; this
module is their plain version. Both follow ``live_ekf_slam_tpu/ops/
kernel_math.py`` operation for operation: C ``remainder(., 2*pi)`` from a
round-half-to-even, a minimax-polynomial ``atan2`` in place of the library's
(so the port and the JAX package agree to fp32 rounding), and the 24-bit
mapping of signed random words to [-1, 1).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586
PI = 3.141592653589793
HALF_PI = 1.5707963267948966
INV_TWO_PI = float(np.float32(1.0 / TWO_PI))

# odd minimax polynomial of arctan on [0, 1] in z^2, highest power first
_ATAN_COEFFS = tuple(float(np.float32(c)) for c in (
    -0.0117212, 0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726,
))


def rint(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``, like ``rintf``)."""
    return torch.round(x)


def wrap(t: torch.Tensor) -> torch.Tensor:
    """C remainder(t, 2*pi): t - 2*pi*rint(t / (2*pi))."""
    return t - TWO_PI * rint(t * INV_TWO_PI)


def atan_01(z: torch.Tensor) -> torch.Tensor:
    """arctan on [0, 1], about 1e-7 maximum error."""
    w = z * z
    p = torch.full_like(z, _ATAN_COEFFS[0])
    for c in _ATAN_COEFFS[1:]:
        p = p * w + c
    return z * p


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-quadrant atan2 built from the [0, 1] arctan core."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / hi.clamp_min(1e-30)
    a = atan_01(z)
    a = torch.where(ay > ax, HALF_PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


def uniform_pm1(bits: torch.Tensor) -> torch.Tensor:
    """Signed 32-bit random words -> float32 uniform in [-1, 1).

    The arithmetic shift keeps the sign, giving a symmetric 24-bit integer in
    [-2^23, 2^23), which float32 holds exactly.
    """
    return (bits >> 8).to(torch.float32) * (1.0 / 8388608.0)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
