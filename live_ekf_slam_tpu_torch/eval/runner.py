"""Monte-Carlo evaluation: the per-tick path, the fused filter rollouts and
pose-graph SLAM on streams, in torch.

Counterpart of ``live_ekf_slam_tpu/eval/runner.py`` for three of its paths.
``run_monte_carlo(impl="per_tick")``, the counterpart of the JAX default
``impl="xla"``, steps every world through ``make_step`` once a tick: the
simulator (``sim/world``), one of the five online filters (naive, EKF-SLAM
with known or unknown ids, RI-EKF-SLAM, UKF-SLAM, UKF-Loc) and the per-world
error with its divergence guard, as batched tensor ops over a leading world
axis, a Python loop over T. With ``filter="pose_graph"`` the tick runs the
secondary filter, then adds the tick's factors to each world's graph
(``models/posegraph.update``) and, in iterative mode, re-solves it; the
bulk solve (``_pg_bulk_solve``) runs on the finished graphs. The noise is
the Philox stream the fused kernels draw (``ops/philox``), so for one seed
both paths see the same worlds.
``run_monte_carlo(impl="fused")`` serves the four filters with a fused
rollout (``ekf_slam``, ``iekf_slam``, ``ukf_slam``, ``ukf_loc``) and
``collect="sums"``: random maps, TSP command streams, one fused rollout of
every world, and per-world average position error with a divergence latch.
``run_monte_carlo_pg_streams`` is the fast pose-graph Monte-Carlo: closed-form
simulator streams, the secondary filter (naive in closed form, EKF or RI-EKF
through the fused kernel's pose stream on the same noise), vectorised graph
assembly, the iterative replay and the bulk Schur / block-Thomas solve
(or, with ``pose_graph.solver="dense"``, the dense Levenberg-Marquardt
solve).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.core.types import StateFields, WorldState
from live_ekf_slam_tpu_torch.models import ekf, iekf, naive, posegraph, ukf
from live_ekf_slam_tpu_torch.ops.fused_rollout import (
    fused_ekf_rollout,
    fused_ekf_rollout_reference,
)
from live_ekf_slam_tpu_torch.ops.fused_ukf import (
    fused_ukf_rollout,
    fused_ukf_rollout_reference,
)
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from live_ekf_slam_tpu_torch.sim.streams import naive_deadreckon, sim_streams
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory
from live_ekf_slam_tpu_torch.sim.world import init_world, sim_step
from live_ekf_slam_tpu_torch.utils.profiling import span

# a pose estimate farther than this from truth marks the world diverged
# (the map spans ~2*bound = 20 m; 50 m means the filter is unrecoverable)
DIVERGENCE_RADIUS = 50.0

# worlds that share one map and command stream under the shared protocol,
# for every filter, so that the four filters see the same maps
SHARED_BLOCK = 256

# the filters with a fused rollout (runner.py:393-394 of the JAX package)
FILTERS = ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")

# the filters of the per-tick path (runner.py:33 of the JAX package)
ONLINE_FILTERS = ("ekf_slam", "iekf_slam", "ukf_loc", "ukf_slam", "naive")

# the Monte-Carlo paths of run_monte_carlo
IMPLS = ("fused", "per_tick")

# secondary filters of the pose-graph streams path (runner.py:527)
PG_SECONDARIES = ("naive", "ekf_slam", "iekf_slam")

# Graph-prefix window quantum of the iterative replay (see ``replay_chunk``);
# module-level so that tests can shrink it to replay several windows at
# small T.
REPLAY_CAP_STEP = 256

# Gauss-Newton iterations per ``solve_schur_pcg`` call of the bulk solve.
# Every call starts its damping afresh, so the cut is part of the numerics
# and stays the JAX runner's (which made it for its device calls' length).
BULK_SEG_GN = 10

_NOT_FUSED = (
    "filter={!r}: no fused rollout; run_monte_carlo(impl='per_tick') runs "
    "it (and run_monte_carlo_pg_streams the pose-graph study)"
)

# worlds a chunk of the dense pose-graph solve (a world's (3(T+1)+2N)^2
# float32 normal matrix is 37 MB at T = 1000, N = 20)
DENSE_CHUNK = 8


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
                  predicated=True, profile_mode="full") -> dict:
    """The fused rollout of ``cfg.filter`` (the routing of runner.py:402-415
    of the JAX package). ``plain=True`` calls the plain torch version
    directly, on whatever device the tensors are. ``profile_mode`` other
    than "full" cuts the EKF and RI-EKF ticks short (``ops/fused_rollout``);
    the UKF rollout has no such modes."""
    kw = dict(noise=noise, predicated=predicated)
    if cfg.filter in ("ekf_slam", "iekf_slam"):
        fn = fused_ekf_rollout_reference if plain else fused_ekf_rollout
        kind = "iekf" if cfg.filter == "iekf_slam" else "ekf"
        return fn(cfg, lms, cmds, seed, filter_kind=kind,
                  profile_mode=profile_mode, **kw)
    if profile_mode != "full":
        raise ValueError(f"filter={cfg.filter!r} has no profile_mode "
                         f"{profile_mode!r}: only the EKF and RI-EKF rollouts do")
    if cfg.filter in ("ukf_slam", "ukf_loc"):
        fn = fused_ukf_rollout_reference if plain else fused_ukf_rollout
        return fn(cfg, lms, cmds, seed, slam=cfg.filter == "ukf_slam", **kw)
    raise NotImplementedError(_NOT_FUSED.format(cfg.filter))


def map_config(cfg):
    """``cfg`` with its slot capacities grown to a fixed map's landmark count
    (demo, grid and igvc1 set their own, sim_node.py:165,176,192), as the
    JAX runner's ``_gen_maps`` does; a random map leaves it as it is."""
    if cfg.landmark_map in ("random", "rand"):
        return cfg
    _, n_active = sim_maps.make_landmarks(cfg)
    if n_active != cfg.num_landmark_slots:
        cfg = cfg.replace(num_landmark_slots=n_active, num_meas_slots=n_active)
    return cfg


def _gen_maps(cfg, rng: np.random.Generator, batch: int):
    """(cfg, (B, N, 2) float32 maps) for a Monte-Carlo run: random maps,
    rejection-sampled off the occupancy map's obstacles, or a fixed map in
    every world, the capacities grown to its landmark count."""
    if cfg.landmark_map in ("random", "rand"):
        occ, _ = sim_maps.load_occ_map(cfg)
        return cfg, sim_maps.random_landmarks_batched(cfg, rng, batch, occ=occ)
    single, _ = sim_maps.make_landmarks(cfg, rng)
    lms = np.broadcast_to(single[None], (batch,) + single.shape).copy()
    return map_config(cfg), lms


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
    with span("les.inputs.maps"):
        cfg, lms = _gen_maps(cfg, np.random.default_rng(seed), n_maps)
        lms = torch.as_tensor(lms, device=device)
    with span("les.inputs.trajectory"):
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


@dataclasses.dataclass(frozen=True)
class RunCarry(StateFields):
    """What the per-tick step carries from tick to tick, for a world batch.

    The alive masks, tick counts and error sums are (B,) tensors. A world
    whose estimate goes non-finite or farther than DIVERGENCE_RADIUS from the
    truth is flagged once and for all, and its error stops accumulating.
    ``secondary`` and the ``*_secondary`` fields belong to the pose graph's
    secondary filter: with ``filter="pose_graph"`` the primary is the
    ``PoseGraphState`` and the published pose, whose error both sums
    accumulate, the secondary's; otherwise they stay as ``init_carry`` made
    them.
    """

    world: WorldState
    primary: object
    secondary: object
    err_sum_primary: torch.Tensor
    err_sum_secondary: torch.Tensor
    alive_primary: torch.Tensor
    alive_secondary: torch.Tensor
    ticks_primary: torch.Tensor
    ticks_secondary: torch.Tensor


def _filter_init(cfg, name: str, batch: int, device, init_pose=None):
    if name == "ekf_slam":
        return ekf.init(cfg, batch, init_pose, device)
    if name == "iekf_slam":
        return iekf.init(cfg, batch, init_pose, device)
    if name == "ukf_slam":
        return ukf.init(cfg, batch, True, init_pose, device)
    if name == "ukf_loc":
        return ukf.init(cfg, batch, False, init_pose, device)
    if name == "naive":
        return naive.init(cfg, batch, init_pose, device)
    if name == "pose_graph":
        return posegraph.init(cfg, batch, init_pose, device)
    raise ValueError(f"Invalid filter choice {name!r} (params.yaml:11)")


def _filter_update(cfg, name: str, state, cmd, meas, true_map=None):
    if name == "ekf_slam":
        return ekf.update(cfg, state, cmd, meas)
    if name == "iekf_slam":
        return iekf.update(cfg, state, cmd, meas)
    if name == "ukf_slam":
        return ukf.update(cfg, state, cmd, meas, slam=True)
    if name == "ukf_loc":
        return ukf.update(cfg, state, cmd, meas, slam=False, true_map=true_map)
    if name == "naive":
        return naive.update(cfg, state, cmd, meas)
    raise ValueError(name)


def _filter_pose(name: str, state) -> torch.Tensor:
    if name in ("ekf_slam", "iekf_slam"):
        return ekf.pose(state)
    if name in ("ukf_slam", "ukf_loc"):
        return ukf.pose(state)
    if name == "naive":
        return state.pose
    raise ValueError(name)


def _filter_state_vector(cfg, name: str, state) -> torch.Tensor:
    if name in ("ekf_slam", "iekf_slam"):
        return ekf.state_vector(state)
    if name == "ukf_slam":
        return ukf.state_vector(cfg, state, slam=True)
    if name == "ukf_loc":
        return ukf.state_vector(cfg, state, slam=False)
    if name == "naive":
        return naive.state_vector(state)
    raise ValueError(name)


def _filter_landmarks(cfg, name: str, state):
    """(lm_xy (B, N, 2), ids, M) of a SLAM filter, for the pose graph's
    update_landmarks_after_adding coupling; None for the others."""
    if name in ("ekf_slam", "iekf_slam"):
        return state.x[:, 3:].reshape(state.x.shape[0], -1, 2), state.ids, state.M
    if name == "ukf_slam":
        return state.x[:, 4:].reshape(state.x.shape[0], -1, 2), state.ids, state.M
    return None


def make_step(cfg, collect: str = "sums"):
    """The per-tick step of ``cfg.filter``: ``step(carry, cmd, u, t=None)``
    with the tick's commands cmd (B, 2), uniforms u (B, 2N+8) and index t
    returns (carry, out).

    The simulator moves and senses, the filter updates, and the divergence
    guard adds the instantaneous error to the world's sum while the world is
    alive. With ``filter="pose_graph"`` (localization_node.cpp:123-131) the
    secondary filter updates first, the graph takes its pose (and, with
    update_landmarks_after_adding, its landmarks), then adds tick t's
    factors and, with solve_graph_every_iteration, re-solves; the published
    pose is the secondary's, and the secondary's divergence mask mirrors the
    primary's. t, the same in every world, places the graph's rows (default:
    world 0's graph timestep); the other filters ignore it. ``collect``
    "sums" returns out = None; "poses" returns (the true pose, the estimated
    pose), each (B, 3).
    """
    if collect not in ("sums", "poses"):
        raise ValueError(f"unknown collect {collect!r}")
    primary = cfg.filter
    if primary not in ONLINE_FILTERS + ("pose_graph",):
        raise ValueError(f"Invalid filter choice {primary!r} (params.yaml:11)")
    pgc = cfg.pose_graph
    secondary = pgc.filter_to_compare if primary == "pose_graph" else None
    if secondary == "pose_graph":
        raise ValueError("Cannot instantiate two instances of the same filter.")
    if secondary is not None and secondary not in ONLINE_FILTERS:
        raise ValueError(f"Invalid filter choice {secondary!r} (params.yaml:11)")
    t_last = cfg.num_iterations - 1

    def graph_tick(carry, world, cmd, meas, t):
        sec = _filter_update(cfg, secondary, carry.secondary, cmd, meas,
                             true_map=world.landmarks)
        sec_lms = _filter_landmarks(cfg, secondary, sec)
        g = posegraph.update_naive_estimate(
            carry.primary, _filter_state_vector(cfg, secondary, sec),
            *(sec_lms or (None, None, None)),
            update_landmarks=pgc.update_landmarks_after_adding and sec_lms is not None,
        )
        m_prev = g.M
        g = posegraph.update(cfg, g, cmd, meas, tick=t)
        if pgc.solve_graph_every_iteration:
            # the reference's default mode (pose_graph.cpp:262-267): re-solve
            # every tick, the result the next initial estimate
            t_now = int(g.timestep[0]) if t is None else min(t + 1, t_last)
            g = posegraph.solve_iteration(cfg, g, m_prev, node_t=t_now)
        return g, sec, _filter_pose(secondary, sec)

    def step(carry: RunCarry, cmd: torch.Tensor, u: torch.Tensor, t=None):
        world, meas = sim_step(cfg, carry.world, cmd, u)
        if secondary is None:
            prim = _filter_update(cfg, primary, carry.primary, cmd, meas,
                                  true_map=world.landmarks)
            sec, est_pose = carry.secondary, _filter_pose(primary, prim)
        else:
            prim, sec, est_pose = graph_tick(carry, world, cmd, meas, t)
        d = est_pose[:, :2] - world.pose[:, :2]
        e = torch.sqrt((d * d).sum(dim=1))
        ok = carry.alive_primary & torch.isfinite(e) & (e < DIVERGENCE_RADIUS)
        err_sum = torch.where(ok, carry.err_sum_primary + e, carry.err_sum_primary)
        ticks = torch.where(ok, carry.ticks_primary + 1, carry.ticks_primary)
        new = carry.replace(world=world, primary=prim, secondary=sec,
                            err_sum_primary=err_sum, alive_primary=ok,
                            ticks_primary=ticks)
        if secondary is not None:
            new = new.replace(err_sum_secondary=err_sum, alive_secondary=ok,
                              ticks_secondary=ticks)
        return new, ((world.pose, est_pose) if collect == "poses" else None)

    return step


def init_carry(cfg, landmarks: torch.Tensor, n_active=None,
               init_pose=None) -> RunCarry:
    """The carry of a world batch with (B, N, 2) maps before its first tick."""
    world = init_world(cfg, landmarks, n_active, init_pose)
    b, dev = landmarks.shape[0], landmarks.device
    zeros = torch.zeros(b, dtype=torch.float32, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    ticks = torch.zeros(b, dtype=torch.int32, device=dev)
    secondary = None
    if cfg.filter == "pose_graph":
        secondary = _filter_init(cfg, cfg.pose_graph.filter_to_compare, b, dev,
                                 init_pose)
    return RunCarry(
        world=world,
        primary=_filter_init(cfg, cfg.filter, b, dev, init_pose),
        secondary=secondary,
        err_sum_primary=zeros, err_sum_secondary=zeros.clone(),
        alive_primary=alive, alive_secondary=alive.clone(),
        ticks_primary=ticks, ticks_secondary=ticks.clone(),
    )


def rollout(cfg, carry: RunCarry, cmds: torch.Tensor, noise: torch.Tensor,
            collect: str = "sums", step=None, t0: int = 0):
    """Step a world batch through T ticks: cmds (B, T, 2), noise (T, 2N+8, B)
    in the fused kernels' injection layout; the ticks are numbered from
    ``t0`` (a pose graph places its rows by them, see ``make_step``: a
    rollout continued from a mid-run state starts at that state's tick).
    Returns (final carry, outs): outs is None for "sums" and (true (B, T,
    3), est (B, T, 3)) for "poses", world-major as the JAX runner returns
    them. ``step`` is a step that ``make_step(cfg, collect)`` already
    made."""
    step = step or make_step(cfg, collect)
    trues, ests = [], []
    for t in range(cmds.shape[1]):
        carry, out = step(carry, cmds[:, t], noise[t].transpose(0, 1), t0 + t)
        if out is not None:
            trues.append(out[0])
            ests.append(out[1])
    if collect != "poses":
        return carry, None
    return carry, (torch.stack(trues, dim=1), torch.stack(ests, dim=1))


def run_monte_carlo(cfg, batch: int, seed: int = 0, impl: str = "fused",
                    device=None, protocol: str = "perworld",
                    collect: str = "sums", *, noise=None, traj_u=None,
                    seconds: dict | None = None):
    """Full Monte-Carlo evaluation: B worlds, maps, TSP trajectories.

    Returns (results, out, outs) like the JAX version: ``results`` holds the
    (B,) per-world average position errors ``err_<filter>`` and the
    divergence mask ``diverged_<filter>``.

    ``impl="per_tick"`` (the JAX package's ``impl="xla"``) steps the worlds
    through ``make_step`` for the five online filters and the pose graph;
    the error is averaged over the ticks a world was alive, ``out`` is the
    final ``RunCarry`` and ``outs`` with ``collect="poses"`` the (true, est)
    pose streams (B, T, 3). ``filter="pose_graph"`` needs
    ``collect="poses"``: its results add the secondary's ``err_<secondary>``
    and ``diverged_<secondary>`` and the bulk solve's per-world
    ``err_pose_graph_result`` and ``err_pose_graph_initial`` (the solved
    and the seeded nodes against the truth, ``_pg_bulk_solve``).
    ``impl="fused"`` runs the four filters with a fused rollout kernel and
    ``collect="sums"``: ``out`` is the rollout's result (the UKFs'
    ``update_rejects`` stays there and marks no divergence by itself), outs
    is None, and the divergence latch reads the running maximum of the
    instantaneous error.

    ``protocol="perworld"`` gives every world its own map (the JAX runner's
    protocol); ``"shared"`` is the bench's (see ``mc_inputs``). A fixed
    ``cfg.landmark_map`` puts that map in every world. ``noise``
    (T, 2N+8, B) and ``traj_u`` (B, N, 2) are test hooks that replace the
    simulator's and the trajectory's random draws. ``device`` defaults to
    the card and raises when there is none (see ``resolve_device``).
    ``seconds``: a dict that the per-tick path fills with the host-clock
    seconds of its phases ("inputs", "rollout" and, for the pose graph,
    "solve"), each ended by a device synchronise.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}: use 'fused' or 'per_tick'")
    if impl == "fused" and (cfg.filter not in FILTERS or collect != "sums"):
        raise ValueError(
            "impl='fused' supports filter in (ekf_slam, iekf_slam, ukf_slam, "
            f"ukf_loc), collect='sums'; got filter={cfg.filter!r}, "
            f"collect={collect!r} (impl='per_tick' runs every online filter "
            "and pose_graph)"
        )
    if impl == "per_tick" and cfg.filter not in ONLINE_FILTERS + ("pose_graph",):
        raise ValueError(f"Invalid filter choice {cfg.filter!r} (params.yaml:11)")
    if cfg.filter == "pose_graph" and collect != "poses":
        raise ValueError("pose_graph runs need collect='poses' for metrics")
    if collect not in ("sums", "poses"):
        raise ValueError(f"unknown collect {collect!r}")
    if protocol not in ("perworld", "shared"):
        raise ValueError(f"unknown protocol {protocol!r}")
    pin_fp32()
    device = resolve_device(device)
    cfg = map_config(cfg)
    shared = protocol == "shared"
    clock = _Clock(device, seconds)
    lms, cmds = mc_inputs(cfg, batch, seed, device, shared=shared,
                          relabel=shared, traj_u=traj_u)
    if impl == "per_tick":
        return _run_per_tick(cfg, lms, cmds, seed, collect, noise, clock)
    out = fused_rollout(cfg, lms, cmds, seed, noise=noise)
    # latched on the running max of the instantaneous error, as the JAX
    # kernels do, not on the run mean
    err_max = out["err_max"].cpu().numpy()
    diverged = ~np.isfinite(err_max) | (err_max > DIVERGENCE_RADIUS)
    err = out["err_sum"].cpu().numpy() / cfg.num_iterations
    results = {
        "err_" + cfg.filter: err,
        "diverged_" + cfg.filter: diverged | ~np.isfinite(err),
    }
    return results, out, None


class _Clock:
    """Adds the seconds since its last mark to ``seconds[name]`` at each
    ``mark(name)``, after a device synchronise; without a dict, nothing.
    ``with clock.phase(name):`` is the span ``les.pg.<name>``
    (``utils/profiling.span``); its seconds run from the host clock at the
    span's start, the device idle after the previous phase's synchronise, to
    ``mark(name)`` inside the span, so the host's moments between phases
    count in no phase. ``sync()`` waits for the device and marks nothing."""

    def __init__(self, device, seconds: dict | None):
        self.device, self.seconds = device, seconds
        self.t = sync_clock(device) if seconds is not None else None

    def mark(self, name: str):
        if self.seconds is not None:
            t, self.t = self.t, sync_clock(self.device)
            self.seconds[name] = self.seconds.get(name, 0.0) + self.t - t

    def sync(self):
        if self.seconds is not None:
            sync_clock(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(f"les.pg.{name}"):
            self.t = time.perf_counter()
            yield
            self.mark(name)


def _run_per_tick(cfg, lms, cmds, seed, collect, noise, clock=None):
    """The per-tick branch of run_monte_carlo on made inputs."""
    clock = clock or _Clock(lms.device, None)
    b, n_lm = lms.shape[:2]
    t_total = cfg.num_iterations
    if not cfg.precompute_trajectory:
        # open-loop kickoff-only runs still tick the sim with zero commands
        cmds = torch.zeros_like(cmds)
    if noise is None:
        noise = philox_noise(seed, t_total, n_lm, b, lms.device)
    carry = init_carry(cfg, lms, n_lm)
    noise = noise.to(lms.device)
    clock.mark("inputs")
    final, outs = rollout(cfg, carry, cmds, noise, collect)
    clock.mark("rollout")
    results = _per_tick_results(cfg, final, outs)
    if cfg.filter == "pose_graph":
        clock.mark("solve")
    return results, final, outs


def _per_tick_results(cfg, final: RunCarry, outs) -> dict:
    """The results of a per-tick run from its final carry and, for the pose
    graph, its pose streams: each filter's per-world average error over the
    ticks it was alive and its divergence mask; for the pose graph also the
    secondary's and the bulk solve's (``_pg_bulk_solve``) metrics."""
    def avg(err_sum, ticks):
        return (err_sum / torch.clamp_min(ticks, 1).to(torch.float32)).cpu().numpy()

    results = {
        "err_" + cfg.filter: avg(final.err_sum_primary, final.ticks_primary),
        "diverged_" + cfg.filter: (~final.alive_primary).cpu().numpy(),
    }
    if cfg.filter == "pose_graph":
        sec = cfg.pose_graph.filter_to_compare
        results["err_" + sec] = avg(final.err_sum_secondary, final.ticks_secondary)
        results["diverged_" + sec] = (~final.alive_secondary).cpu().numpy()
        err_pg, err_pg_init = _pg_bulk_solve(
            cfg, final.primary, outs[0], final.primary.odom.shape[0])
        results["err_pose_graph_result"] = err_pg
        results["err_pose_graph_initial"] = err_pg_init
    return results


def sync_clock(device) -> float:
    """The host clock, after the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def replay_chunk(cfg, graphs, m_at, window: int | None = None):
    """Iterative mode: re-enact the per-tick incremental solves on the
    assembled graphs (``posegraph.replay_iterative``), in graph-prefix
    windows: tick t only involves graph rows <= t, so the ticks in [i, cap)
    run on tensors cut to cap rows, cap the next multiple of ``window``
    (default REPLAY_CAP_STEP), and the per-tick cost is O(cap K), not
    O(T K). Equivalent up to the order of float sums (~1e-5 on the final
    metrics): all factor rows >= cap are invalid at those ticks, all pose
    nodes > cap inactive, and every pose row is seeded again from
    ``poses_init`` when its own tick is replayed. A ``window`` of T or more
    is one window, the per-tick path's shapes."""
    t_total = cfg.num_iterations
    window = window or REPLAY_CAP_STEP
    t_live = t_total - 1
    p_sol, l_sol = graphs.poses_sol, graphs.lms_sol
    i = 0
    while i < t_live:
        cap = min(-(-(i + 1) // window) * window, t_live + 1)
        hi = min(cap, t_live)
        s_c = graphs.replace(
            poses_init=graphs.poses_init[:, :cap + 1],
            poses_sol=graphs.poses_sol[:, :cap + 1],
            odom=graphs.odom[:, :cap],
            odom_valid=graphs.odom_valid[:, :cap],
            meas_rb=graphs.meas_rb[:, :cap],
            meas_lm=graphs.meas_lm[:, :cap],
            meas_valid=graphs.meas_valid[:, :cap],
        )
        p_c, l_sol = posegraph.replay_iterative(
            cfg, s_c, range(i, hi), p_sol[:, :cap + 1], l_sol, m_at[:, :cap]
        )
        p_sol = torch.cat([p_c, p_sol[:, cap + 1:]], dim=1)
        i = hi
    g2 = graphs.replace(poses_sol=p_sol, lms_sol=l_sol)
    # the per-tick path runs solve_iteration on the last (non-live) tick
    # too: node T-1 seeded again from poses_init, one more solve
    return posegraph.solve_iteration(cfg, g2, g2.M, node_t=t_total - 1)


def _pg_bulk_solve(cfg, primary, true_poses, batch, solve_chunk=None):
    """Final bulk solve and metrics over a batched ``PoseGraphState``.
    Returns per-world (err_pose_graph_result, err_pose_graph_initial)
    arrays. ``solve_chunk`` worlds are solved at a time: by default all of
    them for the Schur solve (the JAX runner's 64 was what its device
    memory held), DENSE_CHUNK for the dense one, whose normal matrices
    grow as T^2.

    ``pose_graph.solver="dense"`` runs ``posegraph.solve`` (the graduated
    dense LM), warm-started from the per-tick solution in iterative mode.
    The Schur solve runs its own schedule, described below."""
    t_total = cfg.num_iterations
    pgc = cfg.pose_graph
    warm = pgc.solve_graph_every_iteration
    if pgc.solver not in ("schur", "dense"):
        raise ValueError(f"unknown pose_graph.solver {pgc.solver!r}")

    def segs(total):
        return ([BULK_SEG_GN] * (total // BULK_SEG_GN)
                + ([total % BULK_SEG_GN] if total % BULK_SEG_GN else []))

    # cold starts: a 16x / 4x / 1x graduated measurement-sigma schedule.
    # Warm starts (iterative mode) get a 1x polish, and a graduated solve
    # from the raw seeds runs beside it as the rescue for a warm start
    # stuck in a bad minimum: the lower residual of the two wins.
    stage_gn = max(8, pgc.bulk_gn_iters // 3)
    graduated = ([(16.0, n) for n in segs(stage_gn)]
                 + [(4.0, n) for n in segs(stage_gn)]
                 + [(1.0, n) for n in segs(pgc.bulk_gn_iters)])
    schedule = [(1.0, n) for n in segs(pgc.bulk_gn_iters)] if warm else graduated

    def run(sub, p, l, stages):
        e = None
        for sc, n in stages:
            p, l, e = posegraph.solve_schur_pcg(
                cfg, sub, p, l, n_gn=n, n_cg=pgc.bulk_cg_iters, meas_scale=sc)
        return p, e

    def mean_err(est, tr):
        return torch.linalg.vector_norm(est - tr, dim=-1).mean(dim=-1).cpu().numpy()

    err_pg, err_pg_init = [], []
    step = solve_chunk or (DENSE_CHUNK if pgc.solver == "dense" else batch)
    for i in range(0, batch, step):
        sub = primary.map(lambda a: a[i:i + step])
        if pgc.solver == "dense":
            warm_start = (sub.poses_sol, sub.lms_sol) if warm else ()
            p = posegraph.solve(cfg, sub, *warm_start)[0]
        elif warm:
            p, e = run(sub, sub.poses_sol, sub.lms_sol, schedule)
            pr, er = run(sub, sub.poses_init, sub.lms_init, graduated)
            p = torch.where((er < e)[:, None, None], pr, p)
        else:
            p, _ = run(sub, sub.poses_init, sub.lms_init, schedule)
        # graph nodes are 0..T-1: node 0 is the init pose and the last tick
        # adds no node (it solves instead), so node t+1 pairs with the truth
        # after tick t for t = 0..T-2
        tr = true_poses[i:i + step, :t_total - 1, :2]
        err_pg.append(mean_err(p[:, 1:t_total, :2], tr))
        # the error of the node values the graph was seeded with (the
        # reference's /state/pose_graph/initial metric), same alignment
        err_pg_init.append(mean_err(sub.poses_init[:, 1:t_total, :2], tr))
    return np.concatenate(err_pg), np.concatenate(err_pg_init)


def run_monte_carlo_pg_streams(cfg, batch: int, seed: int = 0,
                               solve_chunk: int | None = None,
                               world_chunk: int = 256, device=None, *,
                               lms=None, cmds=None, noise=None):
    """Fast pose-graph Monte Carlo: closed-form simulator streams, vectorised
    graph assembly and the bulk solve, with no per-tick accumulation.

    The simulator and the naive secondary are cumsums (``sim/streams.py``),
    the EKF and RI-EKF secondaries run in the fused kernel on the SAME noise
    draws (``fused_ekf_rollout(noise=..., emit_traj=True)``), and
    ``posegraph.assemble_streams`` builds every graph tensor in O(T N)
    vector ops. With ``pose_graph.solve_graph_every_iteration`` the per-tick
    incremental solves are replayed on the assembled graphs before the bulk
    solve. Worlds go through in chunks of ``world_chunk``; the noise of
    world w is the Philox stream keyed (seed, w) whatever the chunking.

    Returns (results, info, None): ``results`` holds the (B,) arrays
    ``err_<secondary>``, ``diverged_<secondary>``, ``err_pose_graph_result``,
    ``err_pose_graph_initial``, ``err_pose_graph`` and
    ``diverged_pose_graph``; ``info["seconds"]`` the host-clock seconds of
    each phase, summed over chunks, each ended by a device synchronise; each
    phase is the span ``les.pg.<phase>`` (``_Clock.phase``), and the host's
    moments between phases fall in none, so the phases sum to a little less
    than the study.
    ``lms`` (B, N, 2), ``cmds`` (B, T, 2) and ``noise`` (T, 2N+8, B) are
    test hooks that replace the maps, the command streams and the draws.
    ``device`` defaults to the card and raises when there is none.
    """
    if cfg.filter != "pose_graph":
        raise ValueError("run_monte_carlo_pg_streams requires filter=pose_graph")
    if cfg.pose_graph.update_landmarks_after_adding:
        raise ValueError(
            "streams path does not support update_landmarks_after_adding"
        )
    secondary = cfg.pose_graph.filter_to_compare
    if secondary not in PG_SECONDARIES:
        raise ValueError(
            "streams path supports naive/ekf_slam/iekf_slam secondary, "
            f"got {secondary}"
        )
    pin_fp32()
    device = resolve_device(device)
    t_total = cfg.num_iterations
    seconds = dict.fromkeys(
        ("inputs", "streams", "secondary", "assemble", "replay", "solve"), 0.0)
    clock = _Clock(device, seconds)
    with clock.phase("inputs"):
        if (lms is None) != (cmds is None):
            raise ValueError("give both lms and cmds, or neither")
        if lms is None:
            lms, cmds = mc_inputs(cfg, batch, seed, device)
        if not cfg.precompute_trajectory:
            cmds = torch.zeros((batch, t_total, 2), dtype=torch.float32,
                               device=device)
        n_lm = lms.shape[1]
        if tuple(lms.shape) != (batch, n_lm, 2) or tuple(cmds.shape) != (batch, t_total, 2):
            raise ValueError(
                f"lms {tuple(lms.shape)} and cmds {tuple(cmds.shape)} do not fit "
                f"batch {batch}, T {t_total}")

    parts = {k: [] for k in ("err_sec", "max_sec", "err_pg", "err_pgi")}
    tidx = torch.arange(t_total, device=device)
    for i in range(0, batch, world_chunk):
        clock.sync()
        with clock.phase("streams"):
            lms_c = lms[i:i + world_chunk].contiguous()
            cmds_c = cmds[i:i + world_chunk].contiguous()
            b_c = lms_c.shape[0]
            if noise is None:
                noise_c = philox_noise(seed, t_total, n_lm, b_c, device, world0=i)
            else:
                noise_c = noise[:, :, i:i + world_chunk].contiguous()
            st = sim_streams(cfg, lms_c, n_lm, cmds_c, noise_c)
        with clock.phase("secondary"):
            if secondary == "naive":
                est = naive_deadreckon(cfg, cmds_c)
            else:
                est = fused_ekf_rollout(
                    cfg, lms_c, cmds_c, seed, noise=noise_c, emit_traj=True,
                    filter_kind="iekf" if secondary == "iekf_slam" else "ekf",
                )["est_traj"]
        with clock.phase("assemble"):
            graphs = posegraph.assemble_streams(
                cfg, est, st["r"], st["b"], st["vis"], cmds_c)
            # the secondary's metric and what its divergence latch reads
            d_sec = torch.linalg.vector_norm(
                est[:, :, :2] - st["poses_true"][:, :, :2], dim=-1)
            parts["err_sec"].append(d_sec.mean(dim=1).cpu().numpy())
            parts["max_sec"].append(d_sec.amax(dim=1).cpu().numpy())
        with clock.phase("replay"):
            if cfg.pose_graph.solve_graph_every_iteration:
                # landmark counts at the end of each tick, for the replay:
                # m_at[t] = #{first sightings <= t}, on live ticks only
                vis_live = st["vis"] & (tidx < t_total - 1)[None, :, None]
                first_t = torch.where(vis_live, tidx[None, :, None], t_total).amin(dim=1)
                m_at = (first_t[:, None, :] <= tidx[None, :, None]).sum(
                    dim=2, dtype=torch.int32)
                graphs = replay_chunk(cfg, graphs, m_at)
        with clock.phase("solve"):
            # solved while the chunk's graph tensors are on the device; only
            # the per-world metric vectors come back
            err_pg_c, err_pgi_c = _pg_bulk_solve(
                cfg, graphs, st["poses_true"], b_c, solve_chunk)
            parts["err_pg"].append(err_pg_c)
            parts["err_pgi"].append(err_pgi_c)

    err_sec = np.concatenate(parts["err_sec"])
    max_sec = np.concatenate(parts["max_sec"])
    err_pg = np.concatenate(parts["err_pg"])
    diverged = ~np.isfinite(max_sec) | (max_sec > DIVERGENCE_RADIUS)
    results = {
        "err_" + secondary: err_sec,
        "diverged_" + secondary: diverged,
        "err_pose_graph_result": err_pg,
        "err_pose_graph_initial": np.concatenate(parts["err_pgi"]),
        "err_pose_graph": err_pg,
        "diverged_pose_graph": diverged,
    }
    return results, {"seconds": seconds}, None
