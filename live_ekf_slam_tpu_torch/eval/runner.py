"""Monte-Carlo evaluation of the fused filter rollouts, in torch.

Counterpart of ``run_monte_carlo(impl="fused")`` in
``live_ekf_slam_tpu/eval/runner.py`` for the four filters it serves
(``ekf_slam``, ``iekf_slam``, ``ukf_slam``, ``ukf_loc``) and
``collect="sums"``: random maps, TSP command streams, one fused rollout of
every world, and per-world average position error with a divergence latch.
The per-tick path (``impl="xla"``), the naive filter and pose-graph runs are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.ops.fused_rollout import (
    fused_ekf_rollout,
    fused_ekf_rollout_reference,
)
from live_ekf_slam_tpu_torch.ops.fused_ukf import (
    fused_ukf_rollout,
    fused_ukf_rollout_reference,
)
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory

# a pose estimate farther than this from truth marks the world diverged
# (the map spans ~2*bound = 20 m; 50 m means the filter is unrecoverable)
DIVERGENCE_RADIUS = 50.0

# worlds that share one map and command stream under the shared protocol,
# for every filter, so that the four filters see the same maps
SHARED_BLOCK = 256

# the filters with a fused rollout (runner.py:393-394 of the JAX package)
FILTERS = ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")


def resolve_device(device=None) -> torch.device:
    """``device``, by default the card. The CPU runs only when the caller
    asks for it; without a card a CUDA device is an error, not a fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "false); pass device='cpu' (--device cpu) to run the plain "
            "version on the CPU"
        )
    return device


def fused_rollout(cfg, lms, cmds, seed, *, noise=None, plain=False,
                  predicated=True) -> dict:
    """The fused rollout of ``cfg.filter`` (the routing of runner.py:402-415
    of the JAX package). ``plain=True`` calls the plain torch version
    directly, on whatever device the tensors are."""
    kw = dict(noise=noise, predicated=predicated)
    if cfg.filter in ("ekf_slam", "iekf_slam"):
        fn = fused_ekf_rollout_reference if plain else fused_ekf_rollout
        kind = "iekf" if cfg.filter == "iekf_slam" else "ekf"
        return fn(cfg, lms, cmds, seed, filter_kind=kind, **kw)
    if cfg.filter in ("ukf_slam", "ukf_loc"):
        fn = fused_ukf_rollout_reference if plain else fused_ukf_rollout
        return fn(cfg, lms, cmds, seed, slam=cfg.filter == "ukf_slam", **kw)
    raise NotImplementedError(
        f"filter={cfg.filter!r}: not ported yet (ROADMAP.md, M9 naive, "
        "M10 pose_graph)"
    )


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
    (B,) per-world average position errors ``err_<filter>`` and the
    divergence mask ``diverged_<filter>``; ``out`` is the rollout's result
    (the UKFs' ``update_rejects`` stays there and marks no divergence by
    itself). ``protocol="perworld"`` gives every world its own map (the JAX
    runner's protocol); ``"shared"`` is the bench's (see ``mc_inputs``).
    ``noise`` and ``traj_u`` are test hooks that replace the rollout's and
    the trajectory's random draws. ``device`` defaults to the card and
    raises when there is none (see ``resolve_device``).
    """
    if impl != "fused":
        raise NotImplementedError(
            f"impl={impl!r}: the per-tick path is not ported yet "
            "(ROADMAP.md, M9)"
        )
    if cfg.filter not in FILTERS:
        raise NotImplementedError(
            f"filter={cfg.filter!r}: not ported yet (ROADMAP.md, M9 naive, "
            "M10 pose_graph)"
        )
    if collect != "sums":
        raise NotImplementedError(
            f"collect={collect!r}: per-tick collection is not ported yet "
            "(ROADMAP.md, M9)"
        )
    if protocol not in ("perworld", "shared"):
        raise ValueError(f"unknown protocol {protocol!r}")
    pin_fp32()
    device = resolve_device(device)
    shared = protocol == "shared"
    lms, cmds = mc_inputs(cfg, batch, seed, device, shared=shared,
                          relabel=shared, traj_u=traj_u)
    out = fused_rollout(cfg, lms, cmds, seed, noise=noise)
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
