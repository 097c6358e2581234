"""Monte-Carlo evaluation of the fused filter rollouts and of pose-graph
SLAM on streams, in torch.

Counterpart of ``live_ekf_slam_tpu/eval/runner.py`` for two of its paths.
``run_monte_carlo(impl="fused")`` serves the four filters with a fused rollout
(``ekf_slam``, ``iekf_slam``, ``ukf_slam``, ``ukf_loc``) and
``collect="sums"``: random maps, TSP command streams, one fused rollout of
every world, and per-world average position error with a divergence latch.
``run_monte_carlo_pg_streams`` is the fast pose-graph Monte-Carlo: closed-form
simulator streams, the secondary filter (naive in closed form, EKF or RI-EKF
through the fused kernel's pose stream on the same noise), vectorised graph
assembly, the iterative replay and the bulk Schur / block-Thomas solve. The
per-tick path (``impl="xla"``), the naive filter on its own and the dense
pose-graph solver are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.models import posegraph
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

# a pose estimate farther than this from truth marks the world diverged
# (the map spans ~2*bound = 20 m; 50 m means the filter is unrecoverable)
DIVERGENCE_RADIUS = 50.0

# worlds that share one map and command stream under the shared protocol,
# for every filter, so that the four filters see the same maps
SHARED_BLOCK = 256

# the filters with a fused rollout (runner.py:393-394 of the JAX package)
FILTERS = ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")

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
    "filter={!r}: no fused rollout; naive and the per-tick pose_graph "
    "accumulation are not ported yet (ROADMAP.md, M9; pose_graph runs "
    "through run_monte_carlo_pg_streams)"
)


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
        raise NotImplementedError(_NOT_FUSED.format(cfg.filter))
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


def _sync(device) -> float:
    """The host clock, after the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def replay_chunk(cfg, graphs, m_at):
    """Iterative mode: re-enact the per-tick incremental solves on the
    assembled graphs (``posegraph.replay_iterative``), in graph-prefix
    windows: tick t only involves graph rows <= t, so the ticks in [i, cap)
    run on tensors cut to cap rows, and the per-tick cost is O(cap K), not
    O(T K). Equivalent up to the order of float sums (~1e-5 on the final
    metrics): all factor rows >= cap are invalid at those ticks, all pose
    nodes > cap inactive, and every pose row is seeded again from
    ``poses_init`` when its own tick is replayed."""
    t_total = cfg.num_iterations
    t_live = t_total - 1
    p_sol, l_sol = graphs.poses_sol, graphs.lms_sol
    i = 0
    while i < t_live:
        cap = min(-(-(i + 1) // REPLAY_CAP_STEP) * REPLAY_CAP_STEP, t_live + 1)
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
    arrays. ``solve_chunk`` worlds are solved at a time, by default all of
    them (the JAX runner's 64 was what its device memory held)."""
    t_total = cfg.num_iterations
    pgc = cfg.pose_graph
    warm = pgc.solve_graph_every_iteration
    if pgc.solver != "schur":
        raise NotImplementedError(
            f"pose_graph.solver={pgc.solver!r}: the dense Levenberg-Marquardt "
            "path is not ported yet (ROADMAP.md, dense solver)"
        )

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
    step = batch if solve_chunk is None else solve_chunk
    for i in range(0, batch, step):
        sub = primary.map(lambda a: a[i:i + step])
        if warm:
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
    each phase, summed over chunks, each ended by a device synchronise.
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
    t0 = _sync(device)
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
    seconds["inputs"] = _sync(device) - t0

    parts = {k: [] for k in ("err_sec", "max_sec", "err_pg", "err_pgi")}
    tidx = torch.arange(t_total, device=device)
    for i in range(0, batch, world_chunk):
        t0 = _sync(device)
        lms_c = lms[i:i + world_chunk].contiguous()
        cmds_c = cmds[i:i + world_chunk].contiguous()
        b_c = lms_c.shape[0]
        if noise is None:
            noise_c = philox_noise(seed, t_total, n_lm, b_c, device, world0=i)
        else:
            noise_c = noise[:, :, i:i + world_chunk].contiguous()
        st = sim_streams(cfg, lms_c, n_lm, cmds_c, noise_c)
        t1 = _sync(device)
        if secondary == "naive":
            est = naive_deadreckon(cfg, cmds_c)
        else:
            est = fused_ekf_rollout(
                cfg, lms_c, cmds_c, seed, noise=noise_c, emit_traj=True,
                filter_kind="iekf" if secondary == "iekf_slam" else "ekf",
            )["est_traj"]
        t2 = _sync(device)
        graphs = posegraph.assemble_streams(
            cfg, est, st["r"], st["b"], st["vis"], cmds_c)
        # the secondary's metric and what its divergence latch reads
        d_sec = torch.linalg.vector_norm(
            est[:, :, :2] - st["poses_true"][:, :, :2], dim=-1)
        parts["err_sec"].append(d_sec.mean(dim=1).cpu().numpy())
        parts["max_sec"].append(d_sec.amax(dim=1).cpu().numpy())
        t3 = _sync(device)
        if cfg.pose_graph.solve_graph_every_iteration:
            # landmark counts at the end of each tick, for the replay:
            # m_at[t] = #{first sightings <= t}, on live ticks only
            vis_live = st["vis"] & (tidx < t_total - 1)[None, :, None]
            first_t = torch.where(vis_live, tidx[None, :, None], t_total).amin(dim=1)
            m_at = (first_t[:, None, :] <= tidx[None, :, None]).sum(
                dim=2, dtype=torch.int32)
            graphs = replay_chunk(cfg, graphs, m_at)
        t4 = _sync(device)
        # solved while the chunk's graph tensors are on the device; only the
        # per-world metric vectors come back
        err_pg_c, err_pgi_c = _pg_bulk_solve(
            cfg, graphs, st["poses_true"], b_c, solve_chunk)
        parts["err_pg"].append(err_pg_c)
        parts["err_pgi"].append(err_pgi_c)
        t5 = _sync(device)
        for key, dt in zip(("streams", "secondary", "assemble", "replay", "solve"),
                           (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            seconds[key] += dt

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
