"""The simulator's streams of a whole rollout in closed form, and the pose
graph built from them.

Frozen copies of the port's ``sim/streams.sim_streams`` (the truth as
cumulative sums of the executed motion, the noisy range and bearing to
every landmark slot, the range and field-of-view cull) and
``models/posegraph.assemble_streams`` (the graph that T per-tick updates
would build: landmark slots in first-sighting order, first sightings seeded
from the secondary's pose at the sighting tick, the last tick adding no
factor), returned as a dict of tensors.
"""

from __future__ import annotations

import torch

from benchmarks.scenario import wrap_angle


def _before(th0: float, th_after: torch.Tensor) -> torch.Tensor:
    first = torch.full_like(th_after[:, :1], th0)
    return torch.cat([first, th_after[:, :-1]], dim=1)


def sim_streams(cfg, landmarks, cmds, noise) -> dict:
    """landmarks (B, N, 2), cmds (B, T, 2), noise (T, 2N+8, B) -> poses_true
    (B, T, 3), r, b (B, T, N), vis (B, T, N) bool."""
    n_cap = landmarks.shape[1]
    u = noise.permute(2, 0, 1)
    scale = cfg.sim_noise_scale
    cmd_lim, vision = cfg.constraints.commands, cfg.constraints.vision
    d = torch.clamp(cmds[:, :, 0] + cfg.process_noise.V_00 * scale * u[:, :, 0], 0.0, cmd_lim.d_max)
    hdg = torch.clamp(cmds[:, :, 1] + cfg.process_noise.V_11 * scale * u[:, :, 1],
                      -cmd_lim.th_max, cmd_lim.th_max)
    x0, y0, th0 = cfg.init_pose
    th_after = th0 + torch.cumsum(hdg, dim=1)
    th_before = _before(th0, th_after)
    x = x0 + torch.cumsum(d * torch.cos(th_before), dim=1)
    y = y0 + torch.cumsum(d * torch.sin(th_before), dim=1)
    poses_true = torch.stack([x, y, th_after], dim=2)
    dx = landmarks[:, None, :, 0] - x[:, :, None]
    dy = landmarks[:, None, :, 1] - y[:, :, None]
    r_true = torch.sqrt(dx * dx + dy * dy)
    beta = wrap_angle(torch.atan2(dy, dx) - th_after[:, :, None])
    vis = (r_true <= vision.range_max) & (beta > vision.fov_min) & (beta < vision.fov_max)
    r_noisy = r_true + cfg.sensing_noise.W_00 * scale * u[:, :, 2:2 + n_cap]
    b_noisy = beta + cfg.sensing_noise.W_11 * scale * u[:, :, 2 + n_cap:2 + 2 * n_cap]
    return {"poses_true": poses_true, "r": r_noisy, "b": b_noisy, "vis": vis}


def assemble(cfg, est_poses, r, b, vis, cmds) -> dict:
    """The graphs of a world batch: node seeds poses_init (B, T+1, 3) and
    lms_init (B, N, 2), odometry (B, T, 2) with its mask, measurements
    meas_rb (B, T, N, 2) with their mask (column j = landmark id j), each
    column's landmark slot ``col`` (B, N) and the slots in use M (B,)."""
    t_cap = cfg.num_iterations
    bsz, _, n_cap = vis.shape
    dev = vis.device
    tidx = torch.arange(t_cap, device=dev)
    live = tidx < t_cap - 1
    vis_live = vis & live[None, :, None]
    first_t = torch.where(vis_live, tidx[None, :, None], t_cap).amin(dim=1)
    order = torch.argsort(first_t, dim=1, stable=True)
    slot_of_id = torch.argsort(order, dim=1, stable=True)
    m = (first_t < t_cap).sum(dim=1)
    has_slot = torch.arange(n_cap, device=dev)[None, :] < m[:, None]
    tf = first_t.clamp(0, t_cap - 1)
    p_at = torch.gather(est_poses, 1, tf[:, :, None].expand(-1, -1, 3))
    r_at = torch.gather(r, 1, tf[:, None, :])[:, 0]
    b_at = torch.gather(b, 1, tf[:, None, :])[:, 0]
    seed_x = p_at[:, :, 0] + r_at * torch.cos(p_at[:, :, 2] + b_at)
    seed_y = p_at[:, :, 1] + r_at * torch.sin(p_at[:, :, 2] + b_at)
    seeds_by_id = torch.stack([seed_x, seed_y], dim=2)
    lms_init = torch.where(has_slot[:, :, None],
                           torch.gather(seeds_by_id, 1, order[:, :, None].expand(-1, -1, 2)), 0.0)
    pose0 = torch.tensor(cfg.init_pose, dtype=est_poses.dtype, device=dev)
    poses_init = torch.cat([pose0.expand(bsz, 1, 3),
                            torch.where(live[None, :, None], est_poses, 0.0)], dim=1)
    return {
        "poses_init": poses_init, "lms_init": lms_init,
        "odom": torch.where(live[None, :, None], cmds, 0.0),
        "odom_valid": live.expand(bsz, t_cap),
        "meas_rb": torch.where(vis_live[..., None], torch.stack([r, b], dim=-1), 0.0),
        "meas_valid": vis_live, "col": slot_of_id, "M": m,
    }
