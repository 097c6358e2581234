"""Monte-Carlo evaluation of the fused EKF-SLAM rollout, in torch.

Counterpart of ``run_monte_carlo(impl="fused")`` in
``live_ekf_slam_tpu/eval/runner.py`` for ``filter="ekf_slam"`` and
``collect="sums"``: random maps, TSP command streams, one fused rollout of
every world, and per-world average position error with a divergence latch.
The per-tick path (``impl="xla"``), the other filters and pose-graph runs are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.ops.fused_rollout import fused_ekf_rollout
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory

# a pose estimate farther than this from truth marks the world diverged
# (the map spans ~2*bound = 20 m; 50 m means the filter is unrecoverable)
DIVERGENCE_RADIUS = 50.0

# worlds that share one map and command stream under the shared protocol
SHARED_BLOCK = 256


def default_device() -> torch.device:
    """The card when there is one, otherwise the CPU (the plain version)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _gen_maps(cfg, rng: np.random.Generator, batch: int):
    """(cfg, (B, N, 2) float32 maps) for a Monte-Carlo run: random maps,
    rejection-sampled off the occupancy map's obstacles."""
    if cfg.landmark_map not in ("random", "rand"):
        raise NotImplementedError(
            f"landmark_map={cfg.landmark_map!r}: fixed maps are not ported "
            "yet (ROADMAP.md, M9)"
        )
    occ, _ = sim_maps.load_occ_map(cfg)
    return cfg, sim_maps.random_landmarks_batched(cfg, rng, batch, occ=occ)


def mc_inputs(cfg, batch: int, seed: int, device, *, shared: bool = False,
              relabel: bool = False, traj_u: torch.Tensor | None = None):
    """(landmarks (B, N, 2), cmds (B, T, 2)) on ``device``.

    Maps come from ``np.random.default_rng(seed)``, the trajectory's map
    perturbation from a CPU ``torch.Generator`` seeded with seed + 1 (or from
    ``traj_u``, a test hook). ``shared``: B // 256 maps, each with its command
    stream repeated over 256 worlds that differ only in their noise (the
    bench's protocol). ``relabel``: landmark ids renumbered by tour visit
    order, a pure relabelling (bench.py:300-308).
    """
    n_maps = max(batch // SHARED_BLOCK, 1) if shared else batch
    if shared and batch % n_maps:
        raise ValueError(f"shared protocol needs batch % {n_maps} == 0")
    cfg, lms = _gen_maps(cfg, np.random.default_rng(seed), n_maps)
    lms = torch.as_tensor(lms, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    cmds, tour = generate_trajectory(
        cfg, lms, lms.shape[1], generator=gen, u=traj_u, return_tour=True
    )
    if relabel:
        lms = torch.gather(lms, 1, tour[:, :, None].expand(-1, -1, 2))
    if shared:
        rep = batch // n_maps
        lms = lms.repeat_interleave(rep, dim=0)
        cmds = cmds.repeat_interleave(rep, dim=0)
    return lms.contiguous(), cmds.contiguous()


def run_monte_carlo(cfg, batch: int, seed: int = 0, impl: str = "fused",
                    device=None, protocol: str = "perworld",
                    collect: str = "sums", *, noise=None, traj_u=None):
    """Full Monte-Carlo evaluation: B worlds, random maps, TSP trajectories.

    Returns (results, out, None) like the JAX version: ``results`` holds the
    (B,) per-world average position errors ``err_ekf_slam`` and the
    divergence mask ``diverged_ekf_slam``; ``out`` is the rollout's result.
    ``protocol="perworld"`` gives every world its own map (the JAX runner's
    protocol); ``"shared"`` is the bench's (see ``mc_inputs``). ``noise``
    and ``traj_u`` are test hooks that replace the rollout's and the
    trajectory's random draws. ``device`` defaults to ``default_device()``.
    """
    if impl != "fused":
        raise NotImplementedError(
            f"impl={impl!r}: the per-tick path is not ported yet "
            "(ROADMAP.md, M9)"
        )
    if cfg.filter != "ekf_slam":
        raise NotImplementedError(
            f"filter={cfg.filter!r}: only ekf_slam is ported "
            "(ROADMAP.md, M6 iekf_slam, M8 ukf_*, M9 naive, M10 pose_graph)"
        )
    if collect != "sums":
        raise NotImplementedError(
            f"collect={collect!r}: per-tick collection is not ported yet "
            "(ROADMAP.md, M9)"
        )
    if protocol not in ("perworld", "shared"):
        raise ValueError(f"unknown protocol {protocol!r}")
    pin_fp32()
    device = default_device() if device is None else device
    shared = protocol == "shared"
    lms, cmds = mc_inputs(cfg, batch, seed, device, shared=shared,
                          relabel=shared, traj_u=traj_u)
    out = fused_ekf_rollout(cfg, lms, cmds, seed, noise=noise)
    # latched on the running max of the instantaneous error, as the JAX
    # kernels and the per-tick path do, not on the run mean
    err_max = out["err_max"].cpu().numpy()
    diverged = ~np.isfinite(err_max) | (err_max > DIVERGENCE_RADIUS)
    err = out["err_sum"].cpu().numpy() / cfg.num_iterations
    results = {
        "err_" + cfg.filter: err,
        "diverged_" + cfg.filter: diverged | ~np.isfinite(err),
    }
    return results, out, None
