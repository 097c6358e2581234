"""Full-rollout sim streams in closed form (counterpart of
``live_ekf_slam_tpu/sim/streams.py``).

Given the per-tick uniform noise draws, the simulator is not sequential: the
executed motions are elementwise in (command, draw), the true heading is their
cumulative sum, the position a cumsum of d (cos, sin) of the heading, and the
visibility cull and the noisy (range, bearing) are elementwise over (tick,
landmark). So the whole ground truth of a rollout is O(T N) vector ops, which
``models/posegraph.assemble_streams`` turns into graphs.

The JAX function draws its noise from a ``jax.random`` key and returns it as
``noise_u``. Here the noise is the input, in the rollout kernels' injection
layout (T, 2N+8, B) with rows d, hdg, r x N, b x N, pad: the same tensor goes
to ``fused_ekf_rollout(noise=...)``, so the kernel's world is this one. Worlds
are the leading axis of everything else.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle


def _before(th0: float, th_after: torch.Tensor) -> torch.Tensor:
    """Heading before each tick: th0, then the heading after the last."""
    first = torch.full_like(th_after[:, :1], th0)
    return torch.cat([first, th_after[:, :-1]], dim=1)


def sim_streams(cfg, landmarks: torch.Tensor, n_active: int,
                cmds: torch.Tensor, noise: torch.Tensor) -> dict:
    """Ground truth and measurement streams of a world batch.

    landmarks (B, N, 2); cmds (B, T, 2); noise (T, 2N+8, B) in [-1, 1).
    Returns poses_true (B, T, 3) (the true pose after tick t), r and b
    (B, T, N) noisy ranges and bearings to every landmark slot, and vis
    (B, T, N) bool (range and field-of-view cull, active slots only).
    """
    n_cap = landmarks.shape[1]
    u = noise.permute(2, 0, 1)  # (B, T, 2N+8)
    scale = cfg.sim_noise_scale
    cmd_lim, vision = cfg.constraints.commands, cfg.constraints.vision

    # executed motion per tick: uniform noise, then the clamps
    d = torch.clamp(
        cmds[:, :, 0] + cfg.process_noise.V_00 * scale * u[:, :, 0],
        0.0, cmd_lim.d_max,
    )
    hdg = torch.clamp(
        cmds[:, :, 1] + cfg.process_noise.V_11 * scale * u[:, :, 1],
        -cmd_lim.th_max, cmd_lim.th_max,
    )

    # move, then turn: the move uses the heading before this tick's turn;
    # the true heading is deliberately left unwrapped
    x0, y0, th0 = cfg.init_pose
    th_after = th0 + torch.cumsum(hdg, dim=1)
    th_before = _before(th0, th_after)
    x = x0 + torch.cumsum(d * torch.cos(th_before), dim=1)
    y = y0 + torch.cumsum(d * torch.sin(th_before), dim=1)
    poses_true = torch.stack([x, y, th_after], dim=2)

    # sensing, elementwise over (tick, landmark)
    dx = landmarks[:, None, :, 0] - x[:, :, None]
    dy = landmarks[:, None, :, 1] - y[:, :, None]
    r_true = torch.sqrt(dx * dx + dy * dy)
    beta = wrap_angle(torch.atan2(dy, dx) - th_after[:, :, None])
    slot = torch.arange(n_cap, device=landmarks.device)
    vis = (
        (r_true <= vision.range_max)
        & (beta > vision.fov_min)
        & (beta < vision.fov_max)
        & (slot < n_active)
    )
    r_noisy = r_true + cfg.sensing_noise.W_00 * scale * u[:, :, 2:2 + n_cap]
    b_noisy = beta + cfg.sensing_noise.W_11 * scale * u[:, :, 2 + n_cap:2 + 2 * n_cap]
    return {"poses_true": poses_true, "r": r_noisy, "b": b_noisy, "vis": vis}


def naive_deadreckon(cfg, cmds: torch.Tensor) -> torch.Tensor:
    """The naive filter's whole pose history in closed form (x += d cos th,
    y += d sin th, th = rem(th + ang)): it integrates the commanded motion,
    so its trajectory is a cumsum; wrapping every tick and once at the end
    agree. cmds (B, T, 2) -> (B, T, 3), the naive pose after tick t.
    """
    x0, y0, th0 = cfg.init_pose
    th_after = th0 + torch.cumsum(cmds[:, :, 1], dim=1)
    th_before = _before(th0, th_after)
    x = x0 + torch.cumsum(cmds[:, :, 0] * torch.cos(th_before), dim=1)
    y = y0 + torch.cumsum(cmds[:, :, 0] * torch.sin(th_before), dim=1)
    return torch.stack([x, y, wrap_angle(th_after)], dim=2)
