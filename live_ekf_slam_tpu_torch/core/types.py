"""State containers of the port (counterpart of
``live_ekf_slam_tpu/core/types.py``).

The JAX package keeps per-world PyTrees and batches them with ``jax.vmap``;
the port's containers hold tensors with the world batch as an explicit leading
axis ``B``. The field names are the JAX package's. Every container is
allocated at fixed capacity with an active extent (``M``, ``num_landmarks``)
and per-slot masks, so a masked no-op update is an exact identity.
"""

from __future__ import annotations

import dataclasses

import torch


class StateFields:
    """``replace`` and ``map`` for the frozen dataclasses below."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn):
        """``fn`` applied to every field (a world slice, a device move)."""
        return type(self)(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class WorldState(StateFields):
    """Ground-truth worlds (the reference's sim_node globals).

    pose (B, 3) true vehicle (x, y, theta), theta deliberately unwrapped;
    landmarks (B, N, 2) true landmark positions, slot index == landmark id;
    num_landmarks (B,) int32, the number of active landmark slots.
    """

    pose: torch.Tensor
    landmarks: torch.Tensor
    num_landmarks: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Measurements(StateFields):
    """One tick's landmark detections in fixed slots, ordered by ascending
    landmark id (the sequential-update order of the reference filters)."""

    ids: torch.Tensor       # (B, K) int32, -1 for empty slots
    r: torch.Tensor         # (B, K) float32 noisy range
    b: torch.Tensor         # (B, K) float32 noisy bearing
    valid: torch.Tensor     # (B, K) bool
    overflow: torch.Tensor  # (B,) bool: more than K landmarks were visible


@dataclasses.dataclass(frozen=True)
class NaiveState(StateFields):
    """Naive command-propagation filter state (filter.h:325-370)."""

    pose: torch.Tensor      # (B, 3)
    timestep: torch.Tensor  # (B,) int32


@dataclasses.dataclass(frozen=True)
class GaussianState(StateFields):
    """EKF-SLAM / RI-EKF-SLAM padded state over (x, y, theta, lm...) of dim
    D = 3 + 2N: mean x (B, D), covariance P (B, D, D), landmark id per slot in
    discovery order ids (B, N) int32 (-1 when empty), active count M (B,)
    int32 and timestep (B,) int32."""

    x: torch.Tensor
    P: torch.Tensor
    ids: torch.Tensor
    M: torch.Tensor
    timestep: torch.Tensor


@dataclasses.dataclass(frozen=True)
class UKFState(StateFields):
    """UKF padded state over (x, y, cos t, sin t, lm...) of dim Du = 4 + 2N
    (UKF-SLAM) or 4 (UKF-Loc), the same fields as ``GaussianState`` and X
    (B, Du, 2 Du + 1), the last tick's sigma points."""

    x: torch.Tensor
    P: torch.Tensor
    ids: torch.Tensor
    M: torch.Tensor
    timestep: torch.Tensor
    X: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PoseGraphState(StateFields):
    """A batch of factor graphs (pose_graph.cpp) as fixed tensors.

    Poses are keyed by timestep (0..T); landmarks by slot in discovery order.
    One between-factor per tick and up to K bearing-range factors per tick,
    all masked. float32 unless noted.
    """

    # initial values, seeded from the secondary filter
    poses_init: torch.Tensor   # (B, T+1, 3)
    lms_init: torch.Tensor     # (B, N, 2)
    # odometry factors: tick t connects pose t -> t+1 with (fwd, ang)
    odom: torch.Tensor         # (B, T, 2)
    odom_valid: torch.Tensor   # (B, T) bool
    # measurement factors per tick and slot
    meas_rb: torch.Tensor      # (B, T, K, 2) (range, bearing)
    meas_lm: torch.Tensor      # (B, T, K) int32 landmark slot index
    meas_valid: torch.Tensor   # (B, T, K) bool
    # landmark bookkeeping
    ids: torch.Tensor          # (B, N) int32
    M: torch.Tensor            # (B,) int32
    timestep: torch.Tensor     # (B,) int32
    # the secondary filter's current pose estimate
    cur_pose: torch.Tensor     # (B, 3)
    # last solution, if solved
    poses_sol: torch.Tensor    # (B, T+1, 3)
    lms_sol: torch.Tensor      # (B, N, 2)
    solved: torch.Tensor       # (B,) bool
