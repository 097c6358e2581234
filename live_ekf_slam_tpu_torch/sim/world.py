"""Ground-truth world dynamics and the sensor model as one batched step
(counterpart of ``live_ekf_slam_tpu/sim/world.py``).

Noisy-command truth propagation, the visibility cull over all landmarks and
the noisy range-bearing measurements, as masked tensor ops over a world batch
(leading axis B). The JAX step draws its noise from ``jax.random`` keys; here
the draws are an input: one tick's uniforms in [-1, 1) in the fused rollout
kernels' injection layout, rows 0-1 the motion, rows 2..2+N the ranges and
rows 2+N..2+2N the bearings. ``eval/runner`` hands it a tick of the Philox
stream, so the per-tick path sees the worlds the fused kernels see.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.core.types import Measurements, WorldState
from live_ekf_slam_tpu_torch.utils.geometry import range_bearing


def _pose_tensor(cfg, init_pose, batch: int, device) -> torch.Tensor:
    pose = torch.as_tensor(cfg.init_pose if init_pose is None else init_pose,
                           dtype=torch.float32, device=device)
    return pose.expand(batch, 3).clone()


def init_world(cfg, landmarks: torch.Tensor, num_landmarks=None,
               init_pose=None) -> WorldState:
    """A WorldState from (B, N, 2) landmark maps (N = capacity);
    ``num_landmarks`` an int or (B,) tensor, by default N."""
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32)
    b, n = landmarks.shape[:2]
    dev = landmarks.device
    count = n if num_landmarks is None else num_landmarks
    return WorldState(
        pose=_pose_tensor(cfg, init_pose, b, dev),
        landmarks=landmarks,
        num_landmarks=torch.as_tensor(count, dtype=torch.int32,
                                      device=dev).expand(b).clone(),
    )


def propagate_truth(cfg, pose: torch.Tensor, cmd: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Noisy truth propagation (sim_node.py:216-222): uniform U(-V, V) command
    noise from the draws u (B, 2), commands clamped to the constraints, the
    true heading left unwrapped."""
    u = cfg.sim_noise_scale * u
    lim = cfg.constraints.commands
    d = torch.clamp(cmd[:, 0] + cfg.process_noise.V_00 * u[:, 0], 0.0, lim.d_max)
    hdg = torch.clamp(cmd[:, 1] + cfg.process_noise.V_11 * u[:, 1],
                      -lim.th_max, lim.th_max)
    th = pose[:, 2]
    return torch.stack([pose[:, 0] + d * torch.cos(th),
                        pose[:, 1] + d * torch.sin(th), th + hdg], dim=1)


def sense(cfg, world: WorldState, pose: torch.Tensor,
          u: torch.Tensor) -> Measurements:
    """FOV / range visibility cull and noisy (r, b) (sim_node.py:228-250),
    with the draws u (B, 2, N): ranges, then bearings.

    Visible iff r <= range_max and fov_min < beta < fov_max. Slots are in
    ascending landmark id; with fewer slots K than landmarks N the visible
    ones are compacted to the front, stably, and ``overflow`` marks worlds
    that saw more than K.
    """
    lms = world.landmarks
    b, n_cap = lms.shape[:2]
    k = cfg.num_meas_slots
    vision = cfg.constraints.vision
    r, beta = range_bearing(pose[:, None, :], lms)  # (B, N) each
    ids = torch.arange(n_cap, dtype=torch.int32, device=lms.device)
    vis = ((r <= vision.range_max) & (beta > vision.fov_min)
           & (beta < vision.fov_max) & (ids < world.num_landmarks[:, None]))
    u = cfg.sim_noise_scale * u
    r_noisy = r + cfg.sensing_noise.W_00 * u[:, 0]
    b_noisy = beta + cfg.sensing_noise.W_11 * u[:, 1]
    if k >= n_cap:
        return Measurements(
            ids=torch.where(vis, ids, -1), r=r_noisy, b=b_noisy, valid=vis,
            overflow=torch.zeros(b, dtype=torch.bool, device=lms.device),
        )
    # stable compaction: visible slots first, in ascending id order (the
    # sort keys are distinct, so any sort is stable here)
    order = torch.argsort(torch.where(vis, ids, ids + n_cap), dim=1)
    take = order[:, :k]
    keep = torch.gather(vis, 1, take)
    return Measurements(
        ids=torch.where(keep, take.to(torch.int32), -1),
        r=torch.gather(r_noisy, 1, take),
        b=torch.gather(b_noisy, 1, take),
        valid=keep,
        overflow=vis.sum(dim=1) > k,
    )


def sim_step(cfg, world: WorldState, cmd: torch.Tensor, u: torch.Tensor):
    """One sim tick: the truth moves under the noisy command, then senses.

    cmd (B, 2); u (B, 2N+8), one tick of the injected-noise layout. The
    measurement a filter receives alongside command t was taken after the
    truth moved by the noisy command t (sim_node.py:209-250).
    """
    n_cap = world.landmarks.shape[1]
    new_pose = propagate_truth(cfg, world.pose, cmd, u[:, 0:2])
    new_world = world.replace(pose=new_pose)
    u_sense = u[:, 2:2 + 2 * n_cap].reshape(-1, 2, n_cap)
    return new_world, sense(cfg, new_world, new_pose, u_sense)
