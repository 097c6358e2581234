"""Naive command-propagation filter (filter.h:325-370), batched over worlds
(counterpart of ``live_ekf_slam_tpu/models/naive.py``).

Ignores all measurements and integrates the commanded odometry: the baseline
and the pose graph's default secondary filter.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.core.types import Measurements, NaiveState
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle


def init(cfg, batch: int, init_pose=None, device="cpu") -> NaiveState:
    pose = torch.as_tensor(cfg.init_pose if init_pose is None else init_pose,
                           dtype=torch.float32, device=device)
    return NaiveState(
        pose=pose.expand(batch, 3).clone(),
        timestep=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def update(cfg, s: NaiveState, cmd: torch.Tensor,
           meas: Measurements | None = None) -> NaiveState:
    """x += d cos(th); y += d sin(th); th = wrap(th + ang) (filter.h:345-347)."""
    th = s.pose[:, 2]
    pose = torch.stack([
        s.pose[:, 0] + cmd[:, 0] * torch.cos(th),
        s.pose[:, 1] + cmd[:, 0] * torch.sin(th),
        wrap_angle(th + cmd[:, 1]),
    ], dim=1)
    return NaiveState(pose=pose, timestep=s.timestep + 1)


def state_vector(s: NaiveState) -> torch.Tensor:
    return s.pose
