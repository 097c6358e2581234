"""Host-loop iterative pose-graph mode, one world (the validation path).

Counterpart of ``live_ekf_slam_tpu/eval/pgs_iterative.py``. The reference
re-optimises the whole graph after every tick and feeds the result back as
the next initial estimate (pose_graph.cpp:262-267). The Monte-Carlo path
does that with the per-tick PCG step inside ``eval.runner.make_step``; this
loop also runs the full ``posegraph.solve`` every ``solve_stride`` ticks,
warm-started from the last solution, with the nodes added since taken from
the secondary filter's seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.eval import runner as R
from live_ekf_slam_tpu_torch.models import posegraph
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory


def run_iterative_pgs(cfg, landmarks, seed: int = 0, solve_stride: int = 1,
                      n_active=None, device=None, *, noise=None, traj_u=None):
    """One world, the pose-graph filter, re-solved every ``solve_stride``
    ticks and on the last.

    landmarks (N, 2); the command stream comes from the TSP trajectory (its
    map perturbation drawn from a CPU generator seeded with seed + 1, as
    ``eval.runner.mc_inputs`` draws it), the simulator's draws from the
    Philox stream of ``seed``. ``noise`` (T, 2N+8, 1) and ``traj_u`` (1, N,
    2) are test hooks that replace them. ``device`` defaults to the card.

    Returns a dict of numpy arrays: the per-tick true and secondary poses
    (T, 3), the final solution's nodes 1..T ("pgs_result", (T, 3)) and
    landmarks, and the average errors of the secondary and of the solution.
    """
    if cfg.filter != "pose_graph":
        raise ValueError("run_iterative_pgs requires filter=pose_graph")
    pin_fp32()
    dev = R.resolve_device(device)
    lms = torch.as_tensor(np.asarray(landmarks, np.float32), device=dev)[None]
    n_act = lms.shape[1] if n_active is None else n_active
    t_total = cfg.num_iterations
    gen = torch.Generator().manual_seed(seed + 1)
    cmds = generate_trajectory(cfg, lms, n_act, generator=gen, u=traj_u)
    if noise is None:
        noise = philox_noise(seed, t_total, lms.shape[1], 1, dev)
    noise = noise.to(dev)
    carry = R.init_carry(cfg, lms, n_act)
    step = R.make_step(cfg, collect="poses")

    true_hist, sec_hist = [], []
    poses_ws, lms_ws = carry.primary.poses_init, carry.primary.lms_init
    warm = False
    for t in range(t_total):
        carry, (tp, ep) = step(carry, cmds[:, t], noise[t].transpose(0, 1), t)
        true_hist.append(tp[0])
        sec_hist.append(ep[0])
        if (t + 1) % solve_stride == 0 or t + 1 == t_total:
            s = carry.primary
            if warm:
                # feedback: the last solution seeds the solve, the nodes
                # added since from the secondary's estimates
                ts = int(s.timestep[0])
                lo = max(ts - solve_stride + 1, 0)
                poses0 = poses_ws.clone()
                poses0[:, lo:ts + 1] = s.poses_init[:, lo:ts + 1]
                lms0 = lms_ws
            else:
                poses0, lms0 = s.poses_init, s.lms_init
            poses_ws, lms_ws, _ = posegraph.solve(cfg, s, poses0, lms0)
            warm = True

    true_arr = torch.stack(true_hist).cpu().numpy()
    sec_arr = torch.stack(sec_hist).cpu().numpy()
    sol = poses_ws[0, 1:t_total + 1].cpu().numpy()
    return {
        "true": true_arr,
        "secondary": sec_arr,
        "pgs_result": sol,
        "landmarks_result": lms_ws[0].cpu().numpy(),
        "err_secondary": float(
            np.linalg.norm(sec_arr[:, :2] - true_arr[:, :2], axis=1).mean()),
        "err_pose_graph_result": float(
            np.linalg.norm(sol[:, :2] - true_arr[:, :2], axis=1).mean()),
    }
