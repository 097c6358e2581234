"""The traffic generator: random maps and TSP command streams.

A frozen copy of the port's scenario code as it stood when the benchmark
was written (``live_ekf_slam_tpu_torch/sim/maps.random_landmarks_batched``,
``sim/trajectory.generate_trajectory`` and ``eval/runner.mc_inputs``' shared
and relabel logic), so that the yardstick's scenarios do not move when the
port's trajectory code is rewritten. Given the same seed it gives the port's
maps and commands bit for bit (``tests/test_frozen.py`` holds it to that on
the CPU). Only the blank occupancy map (every cell free) is supported.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """C remainder(theta, 2 pi), dividing by a tensor (the port's
    ``utils/geometry.wrap_angle``: a Python divisor would be a product with
    the reciprocal on the card)."""
    two_pi = torch.tensor(TWO_PI, dtype=theta.dtype, device=theta.device)
    return theta - TWO_PI * torch.round(theta / two_pi)


def occ_map(cfg) -> np.ndarray:
    """The blank occupancy grid (every cell free)."""
    if cfg.occ_map_img not in ("blank.jpg", "blank"):
        raise ValueError(f"the generator supports the blank map only, not {cfg.occ_map_img!r}")
    s = cfg.map.occ_map_size
    return np.ones((s, s), dtype=np.float32)


def _random_landmarks(cfg, rng: np.random.Generator, occ) -> np.ndarray:
    n = cfg.map.num_landmarks
    out = np.zeros((n, 2), np.float32)
    count = 0
    while count < n:
        pos = rng.uniform(-cfg.map.bound, cfg.map.bound, size=2)
        i = int(cfg.grid_shift - pos[1] / cfg.grid_scale)
        j = int(cfg.grid_shift + pos[0] / cfg.grid_scale)
        if not (0 <= i < occ.shape[0] and 0 <= j < occ.shape[1]) or occ[i, j] < 0.5:
            continue
        if count and np.any(np.linalg.norm(out[:count] - pos[None], axis=1)
                            < cfg.map.min_landmark_separation):
            continue
        out[count] = pos
        count += 1
    return out


def random_maps(cfg, rng: np.random.Generator, batch: int, occ) -> np.ndarray:
    """(B, N, 2) maps: uniform over the +/-bound box, min separation apart,
    redrawn until clean (8 rounds, then the exact sampler)."""
    n = cfg.map.num_landmarks
    pts = rng.uniform(-cfg.map.bound, cfg.map.bound, size=(batch, n, 2)).astype(np.float32)

    def bad_mask(p):
        d = np.linalg.norm(p[:, :, None, :] - p[:, None, :, :], axis=-1)
        iu = np.triu_indices(n, 1)
        bad = np.zeros((batch, n), bool)
        close = d < cfg.map.min_landmark_separation
        bad[:, iu[1]] |= close[:, iu[0], iu[1]]
        i = np.clip((cfg.grid_shift - p[:, :, 1] / cfg.grid_scale).astype(int), 0, occ.shape[0] - 1)
        j = np.clip((cfg.grid_shift + p[:, :, 0] / cfg.grid_scale).astype(int), 0, occ.shape[1] - 1)
        return bad | (occ[i, j] < 0.5)

    for _ in range(8):
        bad = bad_mask(pts)
        if not bad.any():
            break
        redraw = rng.uniform(-cfg.map.bound, cfg.map.bound, size=(batch, n, 2))
        pts = np.where(bad[:, :, None], redraw, pts).astype(np.float32)
    else:
        for wi in np.argwhere(bad_mask(pts).any(axis=1)).ravel():
            pts[wi] = _random_landmarks(cfg, rng, occ)
    return pts


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _select(one_hot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return torch.where(one_hot[:, :, None], pts, 0.0).sum(1)


def _nn_tour(noisy_lm: torch.Tensor, start_xy: torch.Tensor, n_active: int) -> torch.Tensor:
    """(B, N) nearest-neighbour tours, ties to the lowest index."""
    n_cap = noisy_lm.shape[1]
    idx = torch.arange(n_cap, device=noisy_lm.device)
    active = (idx < n_active)[None]
    inf = torch.tensor(float("inf"), device=noisy_lm.device)
    cur = torch.argmin(torch.where(active, _norm2(noisy_lm - start_xy), inf), dim=1)
    visited = idx[None] == cur[:, None]
    tour = [cur]
    for _ in range(n_cap - 1):
        cur_pt = _select(idx[None] == cur[:, None], noisy_lm)
        d = torch.where(active & ~visited, _norm2(noisy_lm - cur_pt[:, None]), inf)
        cur = torch.argmin(d, dim=1)
        visited = visited | (idx[None] == cur[:, None])
        tour.append(cur)
    tour = torch.stack(tour, dim=1)
    return torch.where(idx[None] < n_active, tour, tour[:, :1])


def trajectory(cfg, landmarks: torch.Tensor, generator: torch.Generator):
    """((B, T, 2) commands, (B, N) tour) for (B, N, 2) maps: the planning
    map is each map plus U(-landmark_noise, landmark_noise), clamped 1 m
    inside the display region; the unicycle steers toward the tour's goals
    for T ticks, cycling through the tour."""
    b, n_cap = landmarks.shape[:2]
    dev = landmarks.device
    pose0 = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev)
    u = torch.rand((b, n_cap, 2), generator=generator, device=generator.device)
    u = (u * 2.0 - 1.0).to(device=dev, dtype=torch.float32)
    nz = cfg.trajectory_gen.landmark_noise
    lo = -cfg.map.bound * cfg.plotter.display_region_mult + 1.0
    hi = cfg.map.bound * cfg.plotter.display_region_mult - 1.0
    noisy_lm = torch.clamp(landmarks + nz * u, lo, hi)
    tour = _nn_tour(noisy_lm, pose0[:2], n_cap)
    tour_pts = torch.gather(noisy_lm, 1, tour[:, :, None].expand(-1, -1, 2))
    d_max = cfg.constraints.commands.d_max
    th_max = cfg.constraints.commands.th_max
    thresh = cfg.trajectory_gen.visitation_threshold
    slot_idx = torch.arange(n_cap, device=dev)[None]

    def goal_at(ptr):
        return _select(slot_idx == (ptr % n_cap)[:, None], tour_pts)

    x = pose0.expand(b, 3)
    ptr = torch.zeros(b, dtype=torch.int64, device=dev)
    cmds = []
    for _ in range(cfg.num_iterations):
        ptr = ptr + (_norm2(x[:, :2] - goal_at(ptr)) < thresh).to(torch.int64)
        diff = goal_at(ptr) - x[:, :2]
        d = torch.clamp_max(_norm2(diff), d_max)
        hdg = wrap_angle(torch.atan2(diff[:, 1], diff[:, 0]) - x[:, 2])
        hdg = torch.where(hdg.abs() > th_max, th_max * torch.sign(hdg), hdg)
        x = torch.stack([x[:, 0] + d * torch.cos(x[:, 2]),
                         x[:, 1] + d * torch.sin(x[:, 2]), x[:, 2] + hdg], dim=1)
        cmds.append(torch.stack([d, hdg], dim=1))
    return torch.stack(cmds, dim=1), tour


def inputs(cfg, worlds: int, maps: int, relabel: bool, seed: int, device):
    """(landmarks (B, N, 2), cmds (B, T, 2)) float32 on ``device``: ``maps``
    maps from ``np.random.default_rng(seed)``, their trajectories' map
    perturbation from a CPU ``torch.Generator`` seeded with seed + 1, each
    map and its commands repeated over worlds // maps worlds that differ
    only in their noise; ``relabel`` renumbers landmark ids by tour visit
    order. maps = worlds is a map per world (the runner's ``perworld``),
    maps = worlds // 256 the shared protocol of the port's bench."""
    if maps < 1 or worlds % maps:
        raise ValueError(f"{worlds} worlds do not split into {maps} maps")
    rng = np.random.default_rng(seed)
    lms = torch.as_tensor(random_maps(cfg, rng, maps, occ_map(cfg)), device=device)
    cmds, tour = trajectory(cfg, lms, torch.Generator().manual_seed(seed + 1))
    if relabel:
        lms = torch.gather(lms, 1, tour[:, :, None].expand(-1, -1, 2))
    rep = worlds // maps
    if rep > 1:
        lms = lms.repeat_interleave(rep, dim=0)
        cmds = cmds.repeat_interleave(rep, dim=0)
    return lms.contiguous(), cmds.contiguous()
