"""TSP-nearest-neighbour command streams, batched over worlds, in torch.

Counterpart of ``live_ekf_slam_tpu/sim/trajectory.py`` (itself replacing
sim_node.generate_full_trajectory, sim_node.py:63-152): perturb each world's
landmark map, order it by a nearest-neighbour tour from the start pose, then
roll the unicycle toward the tour goals for T ticks, cycling through the
tour. The JAX version is ``vmap`` over worlds of two ``lax.scan``s; here the
batch dimension is written out and the scans are Python loops of batched
tensor ops, as XLA was left to run them there.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 2."""
    return torch.sqrt((v * v).sum(-1))


def _select(one_hot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, N) one-hot rows picking (B, N, 2) points -> (B, 2)."""
    return torch.where(one_hot[:, :, None], pts, 0.0).sum(1)


def _nn_tour(noisy_lm: torch.Tensor, start_xy: torch.Tensor,
             n_active: int) -> torch.Tensor:
    """(B, N) nearest-neighbour tours over landmark slots (sim_node.py:89-112).

    Ties resolve to the lowest index, as the reference's strict-< scan and
    ``argmin`` both do. Inactive slots are excluded with +inf; the visited set
    is a one-hot OR and the current point a one-hot reduction, as in the JAX
    version.
    """
    b, n_cap = noisy_lm.shape[:2]
    idx = torch.arange(n_cap, device=noisy_lm.device)
    active = (idx < n_active)[None]
    inf = torch.tensor(float("inf"), device=noisy_lm.device)

    d0 = _norm2(noisy_lm - start_xy)
    cur = torch.argmin(torch.where(active, d0, inf), dim=1)
    visited = idx[None] == cur[:, None]
    tour = [cur]
    for _ in range(n_cap - 1):
        cur_pt = _select(idx[None] == cur[:, None], noisy_lm)
        d = _norm2(noisy_lm - cur_pt[:, None])
        d = torch.where(active & ~visited, d, inf)
        cur = torch.argmin(d, dim=1)
        visited = visited | (idx[None] == cur[:, None])
        tour.append(cur)
    tour = torch.stack(tour, dim=1)
    # pad slots beyond n_active cycle back onto the active prefix
    return torch.where(idx[None] < n_active, tour, tour[:, :1])


def generate_trajectory(
    cfg, landmarks: torch.Tensor, n_active: int, *,
    generator: torch.Generator | None = None, u: torch.Tensor | None = None,
    return_tour: bool = False,
):
    """(B, T, 2) commanded (fwd, ang) per tick for (B, N, 2) true maps.

    The planning map is each true map plus U(-landmark_noise, landmark_noise)
    noise, clamped 1 m inside the display region (sim_node.py:82-87). ``u``
    is that (B, N, 2) draw in [-1, 1); when it is None it is drawn from
    ``generator`` (on the generator's device, then moved). Tests pass the
    JAX version's own draw. ``return_tour`` also returns the (B, N) visit
    order.
    """
    b, n_cap = landmarks.shape[:2]
    dev = landmarks.device
    t_total = cfg.num_iterations
    pose0 = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev)
    if u is None:
        gen_dev = generator.device if generator is not None else "cpu"
        u = torch.rand((b, n_cap, 2), generator=generator, device=gen_dev)
        u = u * 2.0 - 1.0
    u = u.to(device=dev, dtype=torch.float32)

    nz = cfg.trajectory_gen.landmark_noise
    lo = -cfg.map.bound * cfg.plotter.display_region_mult + 1.0
    hi = cfg.map.bound * cfg.plotter.display_region_mult - 1.0
    noisy_lm = torch.clamp(landmarks + nz * u, lo, hi)

    tour = _nn_tour(noisy_lm, pose0[:2], n_active)
    tour_pts = torch.gather(noisy_lm, 1, tour[:, :, None].expand(-1, -1, 2))

    d_max = cfg.constraints.commands.d_max
    th_max = cfg.constraints.commands.th_max
    thresh = cfg.trajectory_gen.visitation_threshold
    slot_idx = torch.arange(n_cap, device=dev)[None]

    def goal_at(ptr):
        k = ptr % max(n_active, 1)
        return _select(slot_idx == k[:, None], tour_pts)

    x = pose0.expand(b, 3)
    ptr = torch.zeros(b, dtype=torch.int64, device=dev)
    cmds = []
    for _ in range(t_total):
        arrived = _norm2(x[:, :2] - goal_at(ptr)) < thresh
        ptr = ptr + arrived.to(torch.int64)
        diff = goal_at(ptr) - x[:, :2]
        d = torch.clamp_max(_norm2(diff), d_max)
        gb = torch.atan2(diff[:, 1], diff[:, 0])
        hdg = wrap_angle(gb - x[:, 2])
        hdg = torch.where(hdg.abs() > th_max, th_max * torch.sign(hdg), hdg)
        x = torch.stack([
            x[:, 0] + d * torch.cos(x[:, 2]),
            x[:, 1] + d * torch.sin(x[:, 2]),
            x[:, 2] + hdg,
        ], dim=1)
        cmds.append(torch.stack([d, hdg], dim=1))
    cmds = torch.stack(cmds, dim=1)
    if return_tour:
        return cmds, tour
    return cmds
