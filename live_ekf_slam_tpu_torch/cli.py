"""Command line of the port: the reference's launch files as presets.

    python -m live_ekf_slam_tpu_torch.cli filter_demo_live --filter ekf_slam
    python -m live_ekf_slam_tpu_torch.cli filter_demo_results_only \\
        --filter ukf_slam [--steps 200] [--base-dir out] [--device cpu]
    python -m live_ekf_slam_tpu_torch.cli sim_base
    python -m live_ekf_slam_tpu_torch.cli igvc1 [--filter ukf_loc]
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter ukf_slam \\
        --batch 256 --steps 1000 --seed 0 [--runs-dir data/run1]
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter naive \\
        --impl per_tick --landmark-map demo
    python -m live_ekf_slam_tpu_torch.cli monte_carlo --filter pose_graph \\
        --secondary ekf_slam --batch 16 --steps 200
    python -m live_ekf_slam_tpu_torch.cli bar_graphs --data-dir data \\
        --plots-dir plots/err_comparisons

Counterpart of ``live_ekf_slam_tpu/cli.py``, which mirrors
base_pkg/launch/{sim_base,filter_demo_live,filter_demo_results_only,
igvc1}.launch with their overrides (``--occ-map-img``, ``--landmark-map``,
``--plot-result-only``), plus a reference-format params.yaml via
``--params`` for every preset.

``sim_base``, ``filter_demo_live`` and ``filter_demo_results_only`` run one
world (B = 1) through the per-tick step (``eval/runner.make_step``): the
simulator, the online filter (or the pose graph with its secondary) and
the live viewer (``viz/live``; matplotlib, headless under
``MPLBACKEND=Agg``). The commands are the TSP trajectory, or with
``precompute_trajectory`` off clicked-goal pursuit (``eval/interactive``,
the native A*); the noise is the Philox kernel's stream, drawn once a run.
``plotter.async_viz`` steps the world in a producer thread and hands frames
to the viewer through the native ring buffer (``viz/async_feed``).
``--base-dir`` is where ``plotter.save_final_map`` writes
``plots/<filter>_demo.png`` and ``pose_graph.save_average_error_at_end``
appends ``data/<filter>.csv``; the demos print the JAX CLI's average-error
line. ``igvc1`` is the closed loop (``eval/closed_loop.run_closed_loop``)
on the igvc barrel course; it prints that CLI's line. ``monte_carlo`` runs
the five online filters and the pose graph and prints each result's mean
and std; ``--runs-dir`` appends them to per-result CSVs
(``eval/recorder``), which ``bar_graphs`` turns into the pose-graph
against filter bar charts. ``--impl fused`` (the default, but for
pose_graph) runs the four filters with a fused rollout kernel; ``--impl
per_tick`` (pose_graph's default) steps every world once a tick.
Every preset but ``bar_graphs`` runs on the card; ``--device cpu`` runs
the plain versions on the CPU instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.config import Config, load_config, preset
from live_ekf_slam_tpu_torch.eval import runner as R
from live_ekf_slam_tpu_torch.eval.closed_loop import run_closed_loop
from live_ekf_slam_tpu_torch.eval.interactive import GoalPursuit
from live_ekf_slam_tpu_torch.eval.recorder import make_all_bar_charts, write_run_csvs
from live_ekf_slam_tpu_torch.models import posegraph
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.sim import maps as sim_maps
from live_ekf_slam_tpu_torch.sim.trajectory import generate_trajectory
from live_ekf_slam_tpu_torch.sim.world import init_world, sim_step
from live_ekf_slam_tpu_torch.viz.async_feed import AsyncFrameFeed
from live_ekf_slam_tpu_torch.viz.live import Frame, LiveViewer

PRESETS = ("sim_base", "filter_demo_live", "filter_demo_results_only", "igvc1",
           "monte_carlo", "bar_graphs")


def _build_cfg(args):
    base = load_config(args.params) if args.params else Config()
    cfg = preset(args.preset, base) if args.preset != "monte_carlo" else base
    over = {}
    if args.filter:
        over["filter"] = args.filter
    if args.landmark_map:
        over["landmark_map"] = args.landmark_map
    if args.occ_map_img:
        over["occ_map_img"] = args.occ_map_img
    if args.steps:
        over["num_iterations"] = args.steps
    if args.plot_result_only:
        over["plot_result_only"] = True
    if args.secondary:
        over["pose_graph"] = dataclasses.replace(
            cfg.pose_graph, filter_to_compare=args.secondary)
    return cfg.replace(**over) if over else cfg


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _frame_from_state(cfg, name, state, t, true_pose, est_pose, path=None):
    """The viewer's Frame of world 0 of a batched filter state."""
    lm = cov = sig = None
    if name in ("ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"):
        m = int(state.M[0])
        # for iekf_slam P is expressed in right-invariant coordinates; the
        # ellipse rendering treats it as a world-frame covariance, which is
        # exact at identity error and a first-order approximation otherwise
        cov = _np(state.P[0])
        ids = _np(state.ids[0])[:m]
        base = 3 if name in ("ekf_slam", "iekf_slam") else 4
        xs = _np(state.x[0])
        lm = np.array(
            [[ids[i], xs[base + 2 * i], xs[base + 2 * i + 1]] for i in range(m)]
        ) if m else np.zeros((0, 3))
        if hasattr(state, "X"):
            sig = _np(state.X[0])
    return Frame(
        timestep=t,
        true_pose=np.asarray(true_pose),
        est_pose=np.asarray(est_pose),
        landmarks=lm,
        cov=cov,
        sigma_pts=sig,
        path=path,
    )


def populate_pg_frame(cfg, pg, t, fr):
    """Fill Frame.pg_initial / pg_result / pg_landmarks from world 0 of a
    batched PoseGraphState (plotting_node.py:444-455 panel semantics): the
    growing initial graph every tick, the per-tick solution when iterative
    mode keeps one, and on the final tick the full ``posegraph.finalize``
    solve overriding both. Returns (timestep, n_landmarks) for the caller's
    measurement-connection handling."""
    ts = int(pg.timestep[0])
    m = int(pg.M[0])
    fr.pg_initial = _np(pg.poses_init[0])[: ts + 1]
    if m:
        fr.pg_landmarks = _np(pg.lms_init[0])[:m]
    if cfg.pose_graph.solve_graph_every_iteration and bool(pg.solved[0]):
        fr.pg_result = _np(pg.poses_sol[0])[: ts + 1]
        if m:
            fr.pg_landmarks = _np(pg.lms_sol[0])[:m]
    if t + 1 >= cfg.num_iterations:
        solved = posegraph.finalize(cfg, pg)
        fr.pg_result = _np(solved.poses_sol[0])[: ts + 1]
        if m:
            fr.pg_landmarks = _np(solved.lms_sol[0])[:m]
    return ts, m


def _meas_pairs(pg, ts: int) -> list:
    """The (pose, landmark) pairs of world 0's graph row ts - 1."""
    mv_row = _np(pg.meas_valid[0, ts - 1])
    ml_row = _np(pg.meas_lm[0, ts - 1])
    return [(ts, int(ml_row[kk])) for kk in np.nonzero(mv_row)[0]]


def _one_world(cfg, seed: int, device, noise, traj_u):
    """What both demos set up for one world: (cfg with its slot capacities
    at the map's landmark count, occupancy grid, color map, landmarks
    (N, 2), landmarks (1, N, 2) on the device, the TSP commands (1, T, 2) or
    None, the noise (T, 2N+8, 1) on the device)."""
    rng = np.random.default_rng(seed)
    occ, color = sim_maps.load_occ_map(cfg)
    lms, n_active = sim_maps.make_landmarks(cfg, rng, occ)
    cfg = cfg.replace(num_landmark_slots=n_active, num_meas_slots=n_active)
    lms_t = torch.as_tensor(lms, device=device)[None]
    cmds = None
    if cfg.precompute_trajectory:
        gen = torch.Generator().manual_seed(seed)
        cmds = generate_trajectory(cfg, lms_t, n_active, generator=gen, u=traj_u)
    if noise is None:
        noise = philox_noise(seed + 1, cfg.num_iterations, n_active, 1, device)
    return cfg, occ, color, lms, lms_t, cmds, noise.to(device)


def _goal_pursuit(cfg, occ):
    """Clicked-goal pursuit from the start pose (goal_pursuit_node)."""
    gp = GoalPursuit(cfg, occ)
    gp._cur = list(cfg.init_pose)
    return gp


def run_sim_base(cfg, seed=0, base_dir=None, device=None, *, noise=None,
                 traj_u=None, viewer=LiveViewer):
    """sim_base.launch semantics: simulator + plotter + goal pursuit, NO
    localization node (sim_base.launch:11-15 starts only sim_node,
    plotting_node, goal_pursuit_node). The viewer shows the true vehicle and
    landmark map; commands come from the precomputed TSP trajectory, or from
    clicked-goal pursuit driving on the true pose when
    precompute_trajectory=false. ``noise`` (T, 2N+8, 1) and ``traj_u``
    (1, N, 2) replace the simulator's and the trajectory's draws (tests);
    ``viewer`` is the viewer class (``viz.live.FrameRecorder`` where there
    is no matplotlib)."""
    pin_fp32()
    device = R.resolve_device(device)
    cfg, occ, color, lms, lms_t, cmds, noise = _one_world(
        cfg, seed, device, noise, traj_u)
    world = init_world(cfg, lms_t, lms.shape[0])
    gp = None if cfg.precompute_trajectory else _goal_pursuit(cfg, occ)
    view = viewer(
        cfg, color_map=color, true_landmarks=lms,
        on_goal=(gp.set_goal if gp is not None else None),
    )
    cmd = torch.zeros((1, 2), dtype=torch.float32, device=device)
    for t in range(cfg.num_iterations):
        if gp is None:
            cmd = cmds[:, t]
        world, _ = sim_step(cfg, world, cmd, noise[t].T)
        tp = _np(world.pose[0])
        if gp is not None:
            # goal pursuit drives on the only pose there is: the truth
            cmd = torch.tensor([gp.on_state(tp)], dtype=torch.float32, device=device)
        frame = Frame(timestep=t + 1, true_pose=tp, est_pose=None)
        if gp is not None and gp.path is not None and len(gp.path):
            frame.path = np.asarray(gp.path)
        view.update(frame)
    if gp is not None:
        gp.close()
    view.finish(base_dir)
    return view


def _async_demo(cfg, step, carry, cmds, noise, view, base_dir):
    """The async branch of ``run_demo``: the world steps in a producer
    thread that pushes each tick's frame into the native ring buffer; this
    thread renders the newest frame at its own rate."""
    pg_mode = cfg.filter == "pose_graph"
    state_name = cfg.pose_graph.filter_to_compare if pg_mode else cfg.filter
    n = cfg.num_landmark_slots
    # frame layout sized to what this filter renders: covariance block,
    # UKF sigma-point block, pose-graph panel histories
    if state_name in ("ekf_slam", "iekf_slam"):
        d_cov = 3 + 2 * n
    elif state_name == "ukf_slam":
        d_cov = 4 + 2 * n
    elif state_name == "ukf_loc":
        d_cov = 4
    else:
        d_cov = 0
    du_sigma = d_cov if state_name.startswith("ukf") else 0
    feed = AsyncFrameFeed(
        n, d_cov=d_cov, du_sigma=du_sigma,
        t_pg=cfg.num_iterations if pg_mode else 0,
        n_pg_meas=(
            cfg.num_iterations * cfg.num_meas_slots
            if pg_mode and cfg.plotter.pg_show_meas_connections else 0
        ),
    )
    errors: list[float] = []
    done = threading.Event()
    producer_exc: list[BaseException] = []

    def producer():
        # done.set() must fire even if the rollout raises, or the render
        # loop below waits forever on a producer that already died; the
        # exception is raised again on this thread after join
        try:
            c = carry
            pg_pairs: list[tuple[int, int]] = []
            for t in range(cfg.num_iterations):
                c, (tp, ep) = step(c, cmds[:, t], noise[t].T, t)
                tp_, ep_ = _np(tp[0]), _np(ep[0])
                errors.append(float(np.linalg.norm(ep_[:2] - tp_[:2])))
                state = c.secondary if pg_mode else c.primary
                fr = _frame_from_state(cfg, state_name, state, t + 1, tp_, ep_)
                if pg_mode:
                    pg = c.primary
                    ts, m = populate_pg_frame(cfg, pg, t, fr)
                    if cfg.plotter.pg_show_meas_connections and ts > 0 and m:
                        # the newly added row only, as the sync branch does
                        pg_pairs += _meas_pairs(pg, ts)
                        if pg_pairs:
                            fr.pg_meas = np.asarray(pg_pairs, np.int64)
                feed.push(fr)
        except BaseException as e:  # noqa: BLE001 - raised again on the caller
            producer_exc.append(e)
        finally:
            done.set()

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    while not done.is_set() or len(feed.ring):
        frame = feed.pop_latest()
        if frame is None:
            time.sleep(0.005)
            continue
        view.update(frame)
    th.join()
    if producer_exc:
        feed.close()
        raise producer_exc[0]
    # the metric covers every tick (producer side), not just rendered ones
    view.errors = errors
    avg = view.finish(base_dir)
    print(
        f"Average error in {cfg.filter} from true vehicle pose history = "
        f"{avg} (async viz: {feed.dropped} frames skipped)"
    )
    feed.close()
    return avg


def run_demo(cfg, seed=0, live=True, base_dir=None, device=None, *, noise=None,
             traj_u=None, viewer=LiveViewer):
    """filter_demo_{live,results_only}: one world, precomputed TSP
    trajectory (or clicked-goal pursuit), online filter, viewer. Returns the
    average error the viewer computes. ``noise`` (T, 2N+8, 1) and ``traj_u``
    (1, N, 2) replace the simulator's and the trajectory's draws (tests);
    ``viewer`` is the viewer class (``viz.live.FrameRecorder`` where there
    is no matplotlib; ``FrameRecorder.into`` keeps the recorder for the
    caller). The viewer's ``on_goal`` is the clicked-goal pursuit's
    ``set_goal``."""
    pin_fp32()
    device = R.resolve_device(device)
    cfg, occ, color, lms, lms_t, cmds, noise = _one_world(
        cfg, seed, device, noise, traj_u)
    carry = R.init_carry(cfg, lms_t, lms.shape[0])
    step = R.make_step(cfg, collect="poses")

    # clicked-goal pursuit (goal_pursuit_node semantics) when the trajectory
    # is not precomputed; otherwise TSP replay (sim_node.py:55-60)
    gp = None if cfg.precompute_trajectory else _goal_pursuit(cfg, occ)
    view = viewer(
        cfg, color_map=color, true_landmarks=lms,
        on_goal=(gp.set_goal if gp is not None else None),
    )

    # async viewer feed (PlotterConfig.async_viz; native ring buffer).
    # Precomputed trajectories only: interactive goal pursuit needs the
    # click/render thread in the control loop
    if live and cfg.plotter.async_viz and gp is None:
        return _async_demo(cfg, step, carry, cmds, noise, view, base_dir)

    cmd = torch.zeros((1, 2), dtype=torch.float32, device=device)
    pg_meas_acc: list[tuple[int, int]] = []  # host-side (pose, lm) pairs
    for t in range(cfg.num_iterations):
        if gp is None:
            cmd = cmds[:, t]
        carry, (tp, ep) = step(carry, cmd, noise[t].T, t)
        if gp is not None:
            cmd = torch.tensor([gp.on_state(_np(ep[0]))], dtype=torch.float32,
                               device=device)
        if live or t + 1 >= cfg.num_iterations:
            name = cfg.filter
            state = carry.primary if name != "pose_graph" else carry.secondary
            state_name = (
                cfg.pose_graph.filter_to_compare
                if name == "pose_graph" else name
            )
            frame = _frame_from_state(
                cfg, state_name, state, t + 1, _np(tp[0]), _np(ep[0])
            )
            if name == "pose_graph":
                pg = carry.primary
                ts, m = populate_pg_frame(cfg, pg, t, frame)
                if cfg.plotter.pg_show_meas_connections and ts > 0 and m:
                    if live:
                        # fetch only the newly added row and accumulate the
                        # (pose, landmark) pairs host-side: re-reading the
                        # full (ts, K) tensors every tick is an O(T^2)
                        # device->host transfer pattern over the run
                        pg_meas_acc += _meas_pairs(pg, ts)
                        if pg_meas_acc:
                            frame.pg_meas = np.asarray(pg_meas_acc, np.int64)
                    else:
                        # results-only mode renders one final frame: one
                        # full read is the O(T) path here
                        mv = _np(pg.meas_valid[0])[:ts]
                        ml = _np(pg.meas_lm[0])[:ts]
                        rows, cols = np.nonzero(mv)
                        frame.pg_meas = np.stack(
                            [rows + 1, ml[rows, cols]], axis=1
                        )
            view.update(frame)
    if gp is not None:
        gp.close()
    avg = view.finish(base_dir)
    print(f"Average error in {cfg.filter} from true vehicle pose history = {avg}")
    return avg


def run_monte_carlo_cli(cfg, args):
    print(f"device: {args.device}", file=sys.stderr, flush=True)
    impl = args.impl or ("per_tick" if cfg.filter == "pose_graph" else "fused")
    res, _, _ = R.run_monte_carlo(
        cfg, batch=args.batch, seed=args.seed, impl=impl, device=args.device,
        collect="poses" if cfg.filter == "pose_graph" else "sums",
    )
    out = {k.replace("err_", ""): v for k, v in res.items()}
    for k, v in out.items():
        print(f"{k}: mean {np.mean(v):.4f} std {np.std(v):.4f}")
    if args.runs_dir:
        write_run_csvs(args.runs_dir, out)
    return res


def run_igvc(cfg, seed: int = 0, device="cuda", batch: int = 1):
    """igvc1: the closed-loop local-planner run (JAX ``run_igvc``)."""
    print(f"device: {device}", file=sys.stderr, flush=True)
    metrics, _, _ = run_closed_loop(cfg, batch, seed, device=device)
    err = metrics["err_" + cfg.filter]
    print(
        f"igvc closed loop: avg position error {np.mean(err):.4f} m, "
        f"final true pose {metrics['final_true_pose'][0]}"
    )
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser(prog="live_ekf_slam_tpu_torch")
    p.add_argument("preset", choices=PRESETS)
    p.add_argument("--params", help="reference-format params.yaml")
    p.add_argument("--filter", choices=R.ONLINE_FILTERS + ("pose_graph",),
                   help="default: the params' (ekf_slam)")
    p.add_argument("--secondary", choices=R.ONLINE_FILTERS,
                   help="pose_graph only: the filter that seeds the graph "
                        "(default: the config's, naive)")
    p.add_argument("--impl", choices=R.IMPLS,
                   help="monte_carlo: fused rollout kernel (default; "
                        "pose_graph: per_tick) or the per-tick path")
    p.add_argument("--landmark-map", dest="landmark_map",
                   choices=["random", "rand", "demo", "grid", "igvc1"])
    p.add_argument("--occ-map-img", dest="occ_map_img",
                   help="the map image (an 8-bit RGB or RGBA PNG, or blank.jpg)")
    p.add_argument("--steps", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--plot-result-only", action="store_true")
    p.add_argument("--runs-dir", help="CSV output dir (monte_carlo)")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--plots-dir", default="plots/err_comparisons")
    p.add_argument("--base-dir", help="artifact dir for plots/data")
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    if args.preset == "bar_graphs":
        make_all_bar_charts(args.data_dir, args.plots_dir)
        return 0

    cfg = _build_cfg(args)
    if args.preset == "monte_carlo":
        run_monte_carlo_cli(cfg, args)
        return 0
    if args.preset == "igvc1":
        run_igvc(cfg, args.seed, args.device)
        return 0
    print(f"device: {args.device}", file=sys.stderr, flush=True)
    if args.preset == "sim_base":
        run_sim_base(cfg, seed=args.seed, base_dir=args.base_dir, device=args.device)
    else:
        run_demo(cfg, seed=args.seed, live=args.preset == "filter_demo_live",
                 base_dir=args.base_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
