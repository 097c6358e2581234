"""State containers of the port (counterpart of
``live_ekf_slam_tpu/core/types.py``).

The JAX package keeps per-world PyTrees and batches them with ``jax.vmap``;
the port's containers hold tensors with the world batch as an explicit leading
axis. Only ``PoseGraphState`` is here so far: the other states belong to the
per-tick path (ROADMAP.md, M9).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PoseGraphState:
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

    def replace(self, **kw) -> "PoseGraphState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "PoseGraphState":
        """``fn`` applied to every field (a world slice, a device move)."""
        return PoseGraphState(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
        })
