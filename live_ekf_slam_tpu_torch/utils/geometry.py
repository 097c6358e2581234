"""Angle utilities (the part of ``live_ekf_slam_tpu/utils/geometry.py`` that
the trajectory generator needs)."""

from __future__ import annotations

import torch

_TWO_PI = 6.283185307179586


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi] as C remainder(theta, 2pi) does.

    Divides by a tensor: dividing a CUDA tensor by a Python number would
    multiply by the reciprocal, which rounds differently from the JAX
    version's true division.
    """
    two_pi = torch.tensor(_TWO_PI, dtype=theta.dtype, device=theta.device)
    return theta - _TWO_PI * torch.round(theta / two_pi)
