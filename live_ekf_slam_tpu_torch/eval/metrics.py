"""Accuracy metrics (counterpart of ``live_ekf_slam_tpu/eval/metrics.py``).

The reference's benchmark metric is the average Euclidean position error of
the estimated trajectory against the truth (plotting_node.py:195-218); the
runner accumulates it online. These are the offline forms and the standard
extras, elementwise over leading axes.
"""

from __future__ import annotations

import torch


def avg_position_error(est_xy: torch.Tensor, true_xy: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean position error over (..., T, 2) trajectories."""
    return torch.linalg.vector_norm(est_xy - true_xy, dim=-1).mean(dim=-1)


def rmse_position(est_xy: torch.Tensor, true_xy: torch.Tensor) -> torch.Tensor:
    err2 = ((est_xy - true_xy) ** 2).sum(dim=-1)
    return torch.sqrt(err2.mean(dim=-1))


def landmark_rmse(est_lms, est_ids, est_m, true_lms) -> torch.Tensor:
    """RMSE of the active landmark estimates against their true positions.

    est_lms (..., N, 2) slot estimates; est_ids (..., N) slot ids; est_m (...)
    counts; true_lms (..., N_world, 2) indexed by id.
    """
    n = est_lms.shape[-2]
    active = torch.arange(n, device=est_lms.device) < est_m[..., None]
    ids = torch.clamp(est_ids, 0, true_lms.shape[-2] - 1).to(torch.int64)
    truth = torch.gather(true_lms, -2, ids[..., None].expand(*ids.shape, 2))
    err2 = ((est_lms - truth) ** 2).sum(dim=-1)
    err2 = torch.where(active, err2, 0.0)
    denom = torch.clamp_min(est_m, 1).to(err2.dtype)
    return torch.sqrt(err2.sum(dim=-1) / denom)


def nees(est_pose, true_pose, pose_cov) -> torch.Tensor:
    """Normalised estimation error squared of the vehicle position: e^T P^-1 e
    over the (x, y) block, ~2 on average for a consistent filter."""
    e = est_pose[..., :2] - true_pose[..., :2]
    a = pose_cov[..., 0, 0]
    b = pose_cov[..., 0, 1]
    c = pose_cov[..., 1, 0]
    d = pose_cov[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() > 1e-18, det, 1e-18)
    return (d * e[..., 0] ** 2 - (b + c) * e[..., 0] * e[..., 1]
            + a * e[..., 1] ** 2) / det
