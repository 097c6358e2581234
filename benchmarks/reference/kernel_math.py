"""The rollout kernels' scalar math (frozen copy of the port's
``ops/kernel_math.py``): C remainder by 2 pi from a round-half-to-even, the
minimax-polynomial atan2, the 24-bit mapping of random words to [-1, 1)."""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586
PI = 3.141592653589793
HALF_PI = 1.5707963267948966
INV_TWO_PI = float(np.float32(1.0 / TWO_PI))
_ATAN_COEFFS = tuple(float(np.float32(c)) for c in (
    -0.0117212, 0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726,
))


def wrap(t: torch.Tensor) -> torch.Tensor:
    return t - TWO_PI * torch.round(t * INV_TWO_PI)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ax, ay = x.abs(), y.abs()
    z = torch.minimum(ax, ay) / torch.maximum(ax, ay).clamp_min(1e-30)
    w = z * z
    p = torch.full_like(z, _ATAN_COEFFS[0])
    for c in _ATAN_COEFFS[1:]:
        p = p * w + c
    a = z * p
    a = torch.where(ay > ax, HALF_PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


def uniform_pm1(bits: torch.Tensor) -> torch.Tensor:
    """Signed 32-bit words -> float32 in [-1, 1) (a 24-bit integer)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 8388608.0)
