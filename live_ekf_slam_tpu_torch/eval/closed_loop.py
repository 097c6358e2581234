"""The closed-loop (igvc) runner: simulator, online filter, replanning and
pure pursuit, batched over worlds (counterpart of
``live_ekf_slam_tpu/eval/closed_loop.py``).

It replaces the goal_pursuit_node feedback loop (goal_pursuit_node.py:23-56):
every filter state drives pure pursuit, and in local-planner mode the path is
replanned every ``replan_period`` ticks (goal_pursuit_node.py:30). As in the
JAX package the run is a sequence of blocks: one batched replan (the local
planner's goal, then A* in every world), then ``replan_period`` control ticks
of simulator, filter and pursuit. The JAX scan over blocks is a host loop
here; its ``build_closed_loop_segmented`` (a cut of that scan into device
calls short enough for a TPU watchdog) has no counterpart, since the host
loop gives the same results.

``run_closed_loop_sharded`` runs the blocks on a world mesh
(``parallel/mesh``): ``BlockStep`` through ``sharded_step``, the occupancy
grid replicated, the carry and the noise split over worlds. No step
decides for the batch: the A* relaxation stops once every world of its
batch has converged, a fixed point that more sweeps do not move. So a
world's result does not depend on its shard, but for how a device rounds
a value by its place in a tensor (on the CPU torch.atan2 does:
``tests/test_torch_closed_loop_sharded.py``).

The simulator's draws are the per-tick path's injected layout, (T, 2N+8, B)
for the map's N landmarks, by default the Philox stream of ``seed``
(``ops/philox.philox_noise``: the CUDA kernel on the card, its plain version
on the CPU), so the card and the CPU run the same worlds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from live_ekf_slam_tpu_torch.core.types import StateFields, WorldState
from live_ekf_slam_tpu_torch.eval.runner import (
    ONLINE_FILTERS,
    _filter_init,
    _filter_pose,
    _filter_update,
    resolve_device,
    sync_clock,
)
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.parallel import mesh as pmesh
from live_ekf_slam_tpu_torch.planning import astar as p_astar
from live_ekf_slam_tpu_torch.planning import pure_pursuit as pp
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from live_ekf_slam_tpu_torch.sim.world import init_world, sim_step


@dataclasses.dataclass(frozen=True)
class ClosedLoopCarry(StateFields):
    """What a world batch carries from tick to tick: the worlds, the filter
    state, the pursuit state, the command to apply next tick cmd (B, 2),
    the error sum err_sum (B,) and the tick count timestep (B,) int32."""

    world: WorldState
    filt: object
    pursuit: pp.PursuitState
    cmd: torch.Tensor
    err_sum: torch.Tensor
    timestep: torch.Tensor


class BlockStep:
    """One block of the closed loop (the counterpart of the JAX package's
    ``make_block_step``): ``block(carry, noise)`` replans, then runs one
    control tick for each of the ``period`` ticks of noise (period, 2N+8,
    B). ``replan`` and ``ticks`` are its two parts, for timing."""

    def __init__(self, cfg, occ: torch.Tensor):
        if cfg.filter not in ONLINE_FILTERS:
            # the JAX package's _filter_update raises for the pose graph too
            raise ValueError(f"the closed loop runs an online filter "
                             f"{ONLINE_FILTERS}, not {cfg.filter!r}")
        self.cfg, self.occ = cfg, occ
        self.use_pp = cfg.path_planning.nav_method == "pp"

    def replan(self, carry: ClosedLoopCarry) -> ClosedLoopCarry:
        """The local planner's goal and A* to it from every world's estimate
        (goal_pursuit_node.py:30-40); a world whose plan fails, or whose tick
        count is still 0, keeps its whole pursuit state."""
        cfg, occ = self.cfg, self.occ
        est = _filter_pose(cfg.filter, carry.filt)
        goal, ok = p_astar.local_planner(cfg, occ, est)
        path, valid, reached = p_astar.astar(cfg, occ, est[:, :2], goal)
        pursuit = pp.set_path(carry.pursuit, path, valid & reached[:, None])
        keep = ok & reached & (carry.timestep > 0)
        return carry.replace(pursuit=pp.select(keep, pursuit, carry.pursuit))

    def tick(self, carry: ClosedLoopCarry, u: torch.Tensor):
        """One control tick with the draws u (B, 2N+8): the truth moves under
        the previous command and senses, the filter updates with that
        command, pursuit computes the next one; the error sum adds the
        plain distance of the estimate from the truth (no divergence
        guard). Returns (carry, (true pose, estimate))."""
        cfg = self.cfg
        world, meas = sim_step(cfg, carry.world, carry.cmd, u)
        filt = _filter_update(cfg, cfg.filter, carry.filt, carry.cmd, meas,
                              true_map=world.landmarks)
        est = _filter_pose(cfg.filter, filt)
        nav = pp.get_next_cmd if self.use_pp else pp.direct_nav
        cmd, pursuit = nav(cfg, carry.pursuit, est)
        d = est[:, :2] - world.pose[:, :2]
        err = carry.err_sum + torch.sqrt((d * d).sum(dim=1))
        return (ClosedLoopCarry(world=world, filt=filt, pursuit=pursuit, cmd=cmd,
                                err_sum=err, timestep=carry.timestep + 1),
                (world.pose, est))

    def ticks(self, carry: ClosedLoopCarry, noise: torch.Tensor,
              collect: bool = False):
        """One tick for each of the ticks of noise (period, 2N+8, B).
        Returns (carry, [(true, est) per tick], empty unless ``collect``)."""
        outs = []
        for k in range(noise.shape[0]):
            carry, out = self.tick(carry, noise[k].transpose(0, 1))
            if collect:
                outs.append(out)
        return carry, outs

    def __call__(self, carry: ClosedLoopCarry, noise: torch.Tensor,
                 collect: bool = False):
        """A block: the replan, then the ticks."""
        return self.ticks(self.replan(carry), noise, collect)


def landmarks(cfg, seed: int = 0):
    """(landmarks (N, 2) float32, n_active) of the closed loop: the fixed
    map of ``cfg.landmark_map``, a random one drawn from ``seed``."""
    return sim_maps.make_landmarks(cfg, np.random.default_rng(seed))


def init_closed_loop(cfg, batch: int, device, seed: int = 0) -> ClosedLoopCarry:
    """The carry of ``batch`` worlds before their first tick."""
    lms, n_active = landmarks(cfg, seed)
    lms = torch.as_tensor(lms, device=device)
    world = init_world(cfg, lms.expand(batch, -1, -1).contiguous(), n_active)
    return ClosedLoopCarry(
        world=world,
        filt=_filter_init(cfg, cfg.filter, batch, device),
        pursuit=pp.init(cfg, batch, device),
        cmd=torch.zeros((batch, 2), dtype=torch.float32, device=device),
        err_sum=torch.zeros(batch, dtype=torch.float32, device=device),
        timestep=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def occupancy(cfg, device) -> torch.Tensor:
    """The occupancy grid (S, S) float32 on ``device`` (``sim/maps``)."""
    occ, _ = sim_maps.load_occ_map(cfg)
    return torch.as_tensor(occ, device=device)


def build_closed_loop(cfg, device=None):
    """A reusable closed-loop runner ``run(carry, noise, collect=False,
    seconds=None) -> (final carry, outs)`` that steps a carry through the
    ``T // period`` blocks of noise (T, 2N+8, B). The first block replans
    unless every tick count is 0 (read once); outs with ``collect`` is
    (true (B, T, 3), est (B, T, 3)). ``seconds``, a dict, gets each block's
    host-clock seconds of the replan ("replan") and of its ticks
    ("ticks"), each ended by a device synchronise."""
    pin_fp32()
    device = resolve_device(device)
    block = BlockStep(cfg, occupancy(cfg, device))
    period = cfg.path_planning.replan_period

    def run(carry: ClosedLoopCarry, noise: torch.Tensor, collect: bool = False,
            seconds: dict | None = None):
        clock = (lambda: 0.0) if seconds is None else (lambda: sync_clock(device))
        seconds = {} if seconds is None else seconds
        started = bool((carry.timestep > 0).any())
        outs = []
        for i in range(noise.shape[0] // period):
            t0 = clock()
            if started or i > 0:
                carry = block.replan(carry)
            t1 = clock()
            carry, o = block.ticks(carry, noise[i * period:(i + 1) * period],
                                   collect)
            t2 = clock()
            seconds.setdefault("replan", []).append(t1 - t0)
            seconds.setdefault("ticks", []).append(t2 - t1)
            outs += o
        if not collect:
            return carry, None
        return carry, (torch.stack([o[0] for o in outs], dim=1),
                       torch.stack([o[1] for o in outs], dim=1))

    return run


def run_closed_loop(cfg, batch: int = 1, seed: int = 0, *, device=None,
                    noise: torch.Tensor | None = None, collect: bool = False,
                    carry: ClosedLoopCarry | None = None,
                    seconds: dict | None = None):
    """Run the igvc preset end to end on ``batch`` worlds. Returns (metrics,
    final carry, outs): ``metrics`` holds ``err_<filter>``, each world's
    error sum over the run's ticks, and ``final_true_pose`` (B, 3), as
    numpy; ``outs`` with ``collect`` the per-tick (true pose, estimate),
    each (B, T, 3). ``noise`` (T, 2N+8, B) replaces the Philox draws of
    ``seed``; ``carry`` continues a run from that state (a JAX carry through
    ``convert.closed_loop_carry_from_numpy``) for the blocks the noise
    holds, which by default are all ``cfg.num_iterations // period`` of
    them. ``device`` defaults to the card and raises without one.
    ``seconds``: a dict that gets each block's replan and tick seconds
    (``build_closed_loop``)."""
    device = resolve_device(device)
    run = build_closed_loop(cfg, device)
    period = cfg.path_planning.replan_period
    t_total = (cfg.num_iterations // period) * period
    if carry is None:
        carry = init_closed_loop(cfg, batch, device, seed)
    b = carry.cmd.shape[0]
    if noise is None:
        n_lm = carry.world.landmarks.shape[1]
        noise = philox_noise(seed, t_total, n_lm, b, device)
    final, outs = run(carry, noise.to(device), collect, seconds)
    metrics = {
        "err_" + cfg.filter: final.err_sum.cpu().numpy() / t_total,
        "final_true_pose": final.world.pose.cpu().numpy(),
    }
    return metrics, final, outs


def run_closed_loop_sharded(cfg, mesh, batch: int = 1, seed: int = 0):
    """``run_closed_loop`` with its worlds sharded over ``mesh``
    (``parallel.mesh.Mesh``): the same worlds (the carry and the Philox
    draws of ``seed`` made on the mesh's first device, then split), each
    shard's blocks on its own device and stream. Returns (metrics, final
    carry gathered on the mesh's first device)."""
    pin_fp32()
    device = mesh.devices[0]
    period = cfg.path_planning.replan_period
    t_total = (cfg.num_iterations // period) * period
    carry = init_closed_loop(cfg, batch, device, seed)
    noise = philox_noise(seed, t_total, carry.world.landmarks.shape[1], batch,
                         device)
    occ = pmesh.shard_batch(occupancy(cfg, device), pmesh.replicated(mesh))
    noise = pmesh.shard_batch(noise, pmesh.world_sharding(mesh, 2))

    def block(c, nz, grid, replan):
        step = BlockStep(cfg, grid)
        return step.ticks(step.replan(c) if replan else c, nz)[0]

    run = pmesh.sharded_step(block, mesh)
    state = pmesh.shard_batch(carry, mesh)
    for i in range(t_total // period):
        part = noise.map(lambda x, i=i: x[i * period:(i + 1) * period])
        # every tick count is 0 before the first block: its replan would
        # keep every pursuit state (BlockStep.replan), so it is skipped
        state = run(state, part, occ, i > 0)
    final = pmesh.gather(state)
    metrics = {
        "err_" + cfg.filter: final.err_sum.cpu().numpy() / t_total,
        "final_true_pose": final.world.pose.cpu().numpy(),
    }
    return metrics, final
