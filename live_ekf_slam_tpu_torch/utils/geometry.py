"""SE(2) and angle utilities shared by the simulator, the filters and the
trajectory generator (counterpart of ``live_ekf_slam_tpu/utils/geometry.py``).

Every function works elementwise over leading axes; poses are (..., 3) as
(x, y, theta).
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.ops.precision import constant

_TWO_PI = 6.283185307179586


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi] as C remainder(theta, 2pi) does.

    Divides by a tensor: dividing a CUDA tensor by a Python number would
    multiply by the reciprocal, which rounds differently from the JAX
    version's true division.
    """
    two_pi = constant(_TWO_PI, theta.dtype, theta.device)
    return theta - _TWO_PI * torch.round(theta / two_pi)


def yaw_to_mat(theta: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) rotation matrices from yaws (filter.h:122-130)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def mat_to_yaw(r: torch.Tensor) -> torch.Tensor:
    """Yaw of (..., 2, 2) rotation matrices (filter.h:131-133)."""
    return torch.atan2(r[..., 1, 0], r[..., 0, 0])


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a o b for poses (..., 3)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = a[..., 2] + b[..., 2]
    return torch.stack([x, y, th], dim=-1)


def se2_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose a^-1 o b with wrapped heading."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    x = ca * dx + sa * dy
    y = -sa * dx + ca * dy
    th = wrap_angle(b[..., 2] - a[..., 2])
    return torch.stack([x, y, th], dim=-1)


def range_bearing(pose: torch.Tensor, point: torch.Tensor):
    """(range, bearing relative to the heading) from pose to point:
    r = ||p - x||, beta = wrap(atan2(dy, dx) - theta) (sim_node.py:233-237)."""
    dx = point[..., 0] - pose[..., 0]
    dy = point[..., 1] - pose[..., 1]
    r = torch.sqrt(dx * dx + dy * dy)
    beta = wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
    return r, beta


def project_measurement(pose: torch.Tensor, r: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Global landmark position (..., 2) implied by a (range, bearing)
    detection (ekf.cpp:147-148)."""
    th = pose[..., 2] + b
    return torch.stack(
        [pose[..., 0] + r * torch.cos(th), pose[..., 1] + r * torch.sin(th)],
        dim=-1,
    )
