"""Configuration schema of the PyTorch port.

A copy of ``live_ekf_slam_tpu/config.py``, field for field: the port imports
nothing of the JAX package, so it keeps its own schema, and
``tests/test_torch_config.py`` holds the two trees equal (defaults,
``CompatConfig.all_on()`` and every preset).

Mirrors the single-YAML config of the reference
(`ekf_ws/src/base_pkg/config/params.yaml`) so an existing `params.yaml` loads
unchanged, held as frozen dataclasses. Launch files become named presets
(`preset("filter_demo_live")`, ...), mirroring
`base_pkg/launch/{sim_base,filter_demo_live,filter_demo_results_only,igvc1}
.launch`.

Knobs with no reference equivalent:
  * ``num_landmark_slots`` / ``num_meas_slots`` — fixed capacities replacing
    the reference's dynamically growing state (`conservativeResize`,
    ekf.cpp:146).
  * ``compat`` — reproduce the reference's numerical quirks bug-for-bug (see
    `CompatConfig`); default off = textbook-correct equations.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping


def _freeze(**kw):
    return dataclass(frozen=True, **kw)


@_freeze()
class CommandConstraints:
    # params.yaml:27-28
    d_max: float = 0.1
    th_max: float = 0.0546


@_freeze()
class VisionConstraints:
    # params.yaml:30-32
    range_max: float = 3.0
    fov_min: float = -1.57
    fov_max: float = 1.57


@_freeze()
class MeasurementConstraints:
    # params.yaml:35-36
    landmark_id_is_known: bool = True
    min_landmark_separation: float = 0.1


@_freeze()
class Constraints:
    commands: CommandConstraints = CommandConstraints()
    vision: VisionConstraints = VisionConstraints()
    measurements: MeasurementConstraints = MeasurementConstraints()


@_freeze()
class ProcessNoise:
    """Uniform half-widths on (fwd, ang) commands (params.yaml:39-45).

    The reference calls these 'cov' but the simulator draws U(-V, V) noise
    (sim_node.py:216-217); the filters use them directly as variances
    (filter.h:110-111).
    """

    v_d: float = 0.0   # mean on forward commands
    v_th: float = 0.0  # mean on angular commands
    V_00: float = 0.01
    V_11: float = 0.001


@_freeze()
class SensingNoise:
    # params.yaml:46-52; simulator draws U(-W, W) (sim_node.py:246-249).
    w_r: float = 0.0
    w_b: float = 0.0
    W_00: float = 0.01
    W_11: float = 0.01


@_freeze()
class UKFConfig:
    # params.yaml:55-56
    W_0: float = 0.2
    # Matrix square root used for the sigma points. "eigh" = the reference's
    # spectral-clamped symmetric sqrt (nearestSPD + principal sqrt,
    # ukf.cpp:106-123); "chol" = pivot-clamped Cholesky factor — any S with
    # S S^T = P yields a valid unscented transform (same propagated mean and
    # covariance to 2nd order), and Cholesky is O(D^3/3) with no
    # eigendecomposition, which the fused TPU kernel requires. The fused UKF
    # rollout always uses "chol"; this flag lets the XLA path match it for
    # parity testing.
    sigma_sqrt: str = "eigh"


@_freeze()
class PoseGraphConfig:
    # params.yaml:59-66
    filter_to_compare: str = "naive"  # ekf_slam | iekf_slam | ukf_loc | ukf_slam | naive
    implementation: str = "gn"  # TPU-native batched GN/LM (replaces "gtsam")
    verbose: bool = False
    update_landmarks_after_adding: bool = False
    solve_graph_every_iteration: bool = True
    save_average_error_at_end: bool = False
    # Solver knobs (no reference equivalent; GTSAM LM defaults are
    # lambdaInitial=1e-5, lambdaFactor=10, maxIterations=100).
    max_lm_iters: int = 25
    lambda_init: float = 1e-5
    lambda_factor: float = 10.0
    rel_err_tol: float = 1e-5
    prior_sigmas: tuple[float, float, float] = (1.3, 1.3, 1.2)  # pose_graph.cpp:83
    # Honest-mode pose-0 prior: the simulator hands every filter the EXACT
    # initial pose (/truth/init_veh_pose, localization_node.cpp:90-106), so
    # the statistically correct anchor is the filters' own init covariance
    # (filter.h/ekf.cpp P0 sigmas), not the reference's arbitrary (1.3, 1.3,
    # 1.2). The weak reference prior leaves the graph's global gauge nearly
    # free, which dominated PGS absolute error (0.26 m -> 0.034 m at 64
    # worlds, T=1000 when anchored honestly). Compat mode keeps the
    # reference value via prior_sigmas.
    prior_sigmas_honest: tuple[float, float, float] = (0.01, 0.01, 0.005)
    # Iterative-mode (solve_graph_every_iteration) per-tick incremental
    # solver: matrix-free Jacobi-PCG Gauss-Newton steps per tick.
    gn_steps_per_tick: int = 1
    pcg_iters: int = 12
    # Bulk/final solver choice: "schur" = Schur-complement PCG-GN with exact
    # block-tridiagonal (block-Thomas) preconditioning, O(T) per iteration —
    # reaches the dense optimum and batches thousands of worlds; "dense" =
    # the original graduated dense LM (O((3T+2N)^3) per iteration).
    solver: str = "schur"
    bulk_gn_iters: int = 50
    bulk_cg_iters: int = 40
    # Cold-start initialization for solve(): "secondary" seeds from the
    # secondary filter's node values (pose_graph.cpp:97-118, the reference
    # behavior); "chordal" rebuilds the initial iterate from the factors
    # alone (chain rotation averaging + linear position LS,
    # models/posegraph.py chordal_init) — the TPU-native analog of the
    # reference's hard-disabled SE-Sync path (pose_graph.cpp:31-63), robust
    # to arbitrary node seeding.
    init: str = "secondary"
    # Exact GTSAM Pose2 between-factor residual — Logmap(measured^-1 *
    # (pose_a^-1 pose_b)) with the V(theta)^-1 translation correction
    # (pose_graph.cpp:222, GTSAM Pose2::Logmap) — instead of the SE(2)
    # local-coordinates approximation. At reference step sizes
    # (<= 0.1 m, 0.055 rad) the two differ below the noise floor
    # (tests/test_posegraph.py quantifies the delta); off by default to keep
    # the cheaper residual on the per-tick incremental path.
    exact_logmap: bool = False


@_freeze()
class MapConfig:
    # params.yaml:69-76
    bound: float = 10.0
    num_landmarks: int = 20
    min_landmark_separation: float = 0.05
    grid_step: float = 4.0
    occ_map_size: int = 150
    occ_map_balloon_amt: int = 2


@_freeze()
class PathPlanningConfig:
    # params.yaml:79-85
    local_planner_dist: float = 1.8
    nav_method: str = "pp"  # pp | direct | simple
    lookahead_dist_init: float = 0.2
    lookahead_dist_max: float = 2.0
    astar_incl_diagonals: bool = True
    # TPU-native knobs: fixed capacities/iteration bounds for on-device planning.
    path_capacity: int = 512       # max path points held by pure pursuit
    astar_max_iters: int = 512     # min-plus relaxation sweeps bound (global A*)
    local_astar_max_iters: int = 96  # bound for the 1.8 m local plans
    # 0 = relax the full occ grid (exact; default). >0 = crop a static
    # (window, window) view centered on the start cell and plan inside it:
    # the local-planner loop only ever plans ~local_planner_dist ahead
    # (astar.py:12-56 ⇒ ~18 cells at grid_scale 0.1), so a 64-cell window
    # preserves those plans exactly while shrinking the relaxed area
    # (150/64)² ≈ 5.5x. Plans that would have to leave the window report
    # reached=False (the loop keeps its previous path, same as a bounded-
    # iteration miss). Used by the igvc closed-loop preset/bench.
    astar_window: int = 0
    replan_period: int = 5         # goal_pursuit_node.py:30 — replan every 5 ticks
    # Non-blocking local replanning: run A* on the native JobScheduler's
    # worker threads (C++ A* releases the GIL) and swap the new segment in
    # when it lands, instead of blocking the control loop like the
    # reference's planning node (goal_pursuit_node.py:30-40). Falls back to
    # synchronous planning when the native lib is unavailable.
    async_replan: bool = False


@_freeze()
class TrajectoryGenConfig:
    # params.yaml:89-91
    landmark_noise: float = 0.2
    visitation_threshold: float = 3.0


@_freeze()
class PlotterConfig:
    # params.yaml:94-113
    save_final_map: bool = False
    show_occ_map: bool = True
    show_entire_traj: bool = False
    show_true_traj: bool = True
    show_true_landmark_map: bool = True
    show_landmark_ellipses: bool = True
    show_veh_ellipse: bool = True
    arrow_len: float = 0.1
    cov_std_dev: float = 1.0
    plot_ukf_arrows: bool = True
    show_landmark_sigma_pts: bool = True
    display_region_mult: float = 1.0
    list_clicked_points: bool = False
    pg_show_normal_viz_alongside: bool = True
    pg_show_meas_connections: bool = False
    pg_show_cmd_connections: bool = False
    # Decouple device stepping from rendering via the native frame ring
    # buffer (native/src/ringbuf.cpp): the compute loop runs in a producer
    # thread pushing snapshots, the matplotlib loop renders the newest at
    # its own rate (latest-wins; skipped frames are counted). Requires the
    # built native lib; falls back to synchronous rendering otherwise.
    async_viz: bool = False


@_freeze()
class CompatConfig:
    """Bug-for-bug reproduction switches for the reference's numerical quirks.

    Each flag defaults to False (= textbook-correct behavior). `all_on()` is
    used by the parity test-suite so golden tests match the C++ numerics.
    """

    # readCommonParams overwrites V with the sensing-noise values and never
    # fills W, so every C++ filter runs with V=diag(W_00,W_11) and W=I2
    # (filter.h:110-117).
    noise_vw_swap: bool = False
    # EKF update reads landmark positions from the *committed* previous-tick
    # state x_t while the vehicle pose comes from the in-progress x_pred
    # (ekf.cpp:115-129).
    ekf_stale_landmarks: bool = False
    # EKF bearing innovation nu(1)=b-ang is not re-wrapped (ekf.cpp:131).
    ekf_unwrapped_innovation: bool = False
    # UKF measurement-mean loop only accumulates the range component; the
    # bearing mean stays 0 (ukf.cpp:310-314).
    ukf_zero_bearing_mean: bool = False
    # UKF sensing model reads yaw from the committed pre-predict state x_t
    # instead of the sigma point being evaluated (ukf.cpp:139).
    ukf_committed_yaw_in_sensing: bool = False
    # UKF process-noise diag uses SIGNED V*cos(yaw)/V*sin(yaw)
    # (ukf.cpp:183-186), which goes negative for half of all headings and
    # leaves P indefinite until the next tick's nearestSPD clamp repairs it.
    # Off (default) uses the correct PSD projection Q = G V G^T for the
    # (x, y, cos, sin) state.
    ukf_signed_process_noise: bool = False
    # GTSAM noise models built from variances passed as sigmas
    # (pose_graph.cpp:52-54).
    pg_variances_as_sigmas: bool = False

    @staticmethod
    def all_on() -> "CompatConfig":
        return CompatConfig(**{f.name: True for f in dataclasses.fields(CompatConfig)})


@_freeze()
class Config:
    # params.yaml:11 — ekf_slam | ukf_loc | ukf_slam | pose_graph | naive,
    # plus the beyond-reference iekf_slam (right-invariant EKF, models/iekf.py)
    filter: str = "ekf_slam"
    # params.yaml:14-15
    dt: float = 0.05
    num_iterations: int = 1000
    # params.yaml:19-22
    init_pose: tuple[float, float, float] = (0.0, 0.0, 0.0)

    constraints: Constraints = Constraints()
    process_noise: ProcessNoise = ProcessNoise()
    sensing_noise: SensingNoise = SensingNoise()
    ukf: UKFConfig = UKFConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    map: MapConfig = MapConfig()
    path_planning: PathPlanningConfig = PathPlanningConfig()
    trajectory_gen: TrajectoryGenConfig = TrajectoryGenConfig()
    plotter: PlotterConfig = PlotterConfig()
    compat: CompatConfig = CompatConfig()

    # ---- TPU-native capacities (static shapes) ----
    # Landmark slot capacity >= num_landmarks actually in the world.
    num_landmark_slots: int = 20
    # Measurement slots per tick. The sim can see at most all landmarks at
    # once, so the safe default equals the landmark count; smaller values
    # trade fidelity for speed (dropped detections are flagged).
    num_meas_slots: int = 20

    # Test seam: scales the simulator's noise draws without touching the
    # filters' assumed V/W (0.0 gives a fully deterministic world, which makes
    # the XLA and Pallas paths exactly comparable).
    sim_noise_scale: float = 1.0

    # Honest-mode refinement (core/noise.py): the EKF/UKF predict uses the
    # clip-aware expected executed command + true clipped-uniform process
    # variance, and the measurement noise uses the true U(-W, W) variance
    # W^2/3 — instead of the reference's half-width-as-variance convention
    # (filter.h:110-117). The same bias/variance correction the pose graph's
    # honest mode gets from _odom_moments. No effect in compat mode.
    calibrated_motion: bool = False

    # ---- launch-arg equivalents (sim_base.launch:11-15) ----
    occ_map_img: str = "blank.jpg"
    landmark_map: str = "random"  # demo | grid | random | igvc1
    precompute_trajectory: bool = True
    use_local_planner: bool = False
    tight_control: bool = False
    plot_result_only: bool = False

    # ------------------------------------------------------------------
    @property
    def state_dim(self) -> int:
        """EKF padded state dim 3+2N (naive uses 3; UKF uses 4+2N)."""
        return 3 + 2 * self.num_landmark_slots

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # Effective filter noise matrices, honoring the compat V/W swap.
    def filter_noise(self) -> tuple[tuple[float, float], tuple[float, float]]:
        """Returns ((V00, V11), (W00, W11)) as the *filters* should use them."""
        if self.compat.noise_vw_swap:
            # filter.h:110-117: V ends up holding (W_00, W_11); W stays I2.
            return (
                (self.sensing_noise.W_00, self.sensing_noise.W_11),
                (1.0, 1.0),
            )
        return (
            (self.process_noise.V_00, self.process_noise.V_11),
            (self.sensing_noise.W_00, self.sensing_noise.W_11),
        )

    # Grid <-> world transform params (sim_node.py:332-337).
    @property
    def grid_shift(self) -> float:
        return self.map.occ_map_size / 2.0

    @property
    def grid_scale(self) -> float:
        return self.map.bound / self.grid_shift


# ----------------------------------------------------------------------
# YAML loading (accepts the reference's params.yaml schema unchanged)
# ----------------------------------------------------------------------

def _get(d: Mapping[str, Any], *path, default=None):
    cur: Any = d
    for p in path:
        if not isinstance(cur, Mapping) or p not in cur:
            return default
        cur = cur[p]
    return cur


def config_from_dict(d: Mapping[str, Any], **overrides) -> Config:
    base = Config()

    def g(*path, default):
        v = _get(d, *path, default=default)
        return default if v is None else v

    cfg = Config(
        filter=g("filter", default=base.filter),
        dt=float(g("dt", default=base.dt)),
        num_iterations=int(g("num_iterations", default=base.num_iterations)),
        init_pose=(
            float(g("init_pose", "x", default=0.0)),
            float(g("init_pose", "y", default=0.0)),
            float(g("init_pose", "yaw", default=0.0)),
        ),
        constraints=Constraints(
            commands=CommandConstraints(
                d_max=float(g("constraints", "commands", "d_max", default=0.1)),
                th_max=float(g("constraints", "commands", "th_max", default=0.0546)),
            ),
            vision=VisionConstraints(
                range_max=float(g("constraints", "vision", "range_max", default=3.0)),
                fov_min=float(g("constraints", "vision", "fov_min", default=-1.57)),
                fov_max=float(g("constraints", "vision", "fov_max", default=1.57)),
            ),
            measurements=MeasurementConstraints(
                landmark_id_is_known=bool(
                    g("constraints", "measurements", "landmark_id_is_known", default=True)
                ),
                min_landmark_separation=float(
                    g("constraints", "measurements", "min_landmark_separation", default=0.1)
                ),
            ),
        ),
        process_noise=ProcessNoise(
            v_d=float(g("process_noise", "mean", "v_d", default=0.0)),
            v_th=float(g("process_noise", "mean", "v_th", default=0.0)),
            V_00=float(g("process_noise", "cov", "V_00", default=0.01)),
            V_11=float(g("process_noise", "cov", "V_11", default=0.001)),
        ),
        sensing_noise=SensingNoise(
            w_r=float(g("sensing_noise", "mean", "w_r", default=0.0)),
            w_b=float(g("sensing_noise", "mean", "w_b", default=0.0)),
            W_00=float(g("sensing_noise", "cov", "W_00", default=0.01)),
            W_11=float(g("sensing_noise", "cov", "W_11", default=0.01)),
        ),
        ukf=UKFConfig(W_0=float(g("ukf", "W_0", default=0.2))),
        pose_graph=PoseGraphConfig(
            filter_to_compare=g("pose_graph", "filter_to_compare", default="naive"),
            implementation=g("pose_graph", "implementation", default="gn"),
            verbose=bool(g("pose_graph", "verbose", default=False)),
            update_landmarks_after_adding=bool(
                g("pose_graph", "update_landmarks_after_adding", default=False)
            ),
            solve_graph_every_iteration=bool(
                g("pose_graph", "solve_graph_every_iteration", default=True)
            ),
            save_average_error_at_end=bool(
                g("pose_graph", "save_average_error_at_end", default=False)
            ),
        ),
        map=MapConfig(
            bound=float(g("map", "bound", default=10.0)),
            num_landmarks=int(g("map", "num_landmarks", default=20)),
            min_landmark_separation=float(g("map", "min_landmark_separation", default=0.05)),
            grid_step=float(g("map", "grid_step", default=4.0)),
            occ_map_size=int(g("map", "occ_map_size", default=150)),
            occ_map_balloon_amt=int(g("map", "occ_map_balloon_amt", default=2)),
        ),
        path_planning=PathPlanningConfig(
            local_planner_dist=float(g("path_planning", "local_planner_dist", default=1.8)),
            nav_method=g("path_planning", "nav_method", default="pp"),
            lookahead_dist_init=float(g("path_planning", "lookahead_dist_init", default=0.2)),
            lookahead_dist_max=float(g("path_planning", "lookahead_dist_max", default=2.0)),
            astar_incl_diagonals=bool(g("path_planning", "astar_incl_diagonals", default=True)),
        ),
        trajectory_gen=TrajectoryGenConfig(
            landmark_noise=float(g("trajectory_gen", "landmark_noise", default=0.2)),
            visitation_threshold=float(g("trajectory_gen", "visitation_threshold", default=3.0)),
        ),
        plotter=PlotterConfig(
            save_final_map=bool(g("plotter", "save_final_map", default=False)),
            show_occ_map=bool(g("plotter", "show_occ_map", default=True)),
            show_entire_traj=bool(g("plotter", "show_entire_traj", default=False)),
            show_true_traj=bool(g("plotter", "show_true_traj", default=True)),
            show_true_landmark_map=bool(g("plotter", "show_true_landmark_map", default=True)),
            show_landmark_ellipses=bool(g("plotter", "show_landmark_ellipses", default=True)),
            show_veh_ellipse=bool(g("plotter", "show_veh_ellipse", default=True)),
            arrow_len=float(g("plotter", "arrow_len", default=0.1)),
            cov_std_dev=float(g("plotter", "cov_std_dev", default=1.0)),
            plot_ukf_arrows=bool(g("plotter", "plot_ukf_arrows", default=True)),
            show_landmark_sigma_pts=bool(g("plotter", "show_landmark_sigma_pts", default=True)),
            display_region_mult=float(g("plotter", "display_region_mult", default=1.0)),
            list_clicked_points=bool(g("plotter", "list_clicked_points", default=False)),
            pg_show_normal_viz_alongside=bool(
                g("plotter", "pose_graph", "show_normal_viz_alongside", default=True)
            ),
            pg_show_meas_connections=bool(
                g("plotter", "pose_graph", "show_meas_connections", default=False)
            ),
            pg_show_cmd_connections=bool(
                g("plotter", "pose_graph", "show_cmd_connections", default=False)
            ),
        ),
    )
    # Capacity defaults track the configured landmark count.
    n = cfg.map.num_landmarks
    cfg = cfg.replace(num_landmark_slots=n, num_meas_slots=n)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def load_config(path: str, **overrides) -> Config:
    """Load a reference-format params.yaml into a frozen Config."""
    import yaml  # only this loader needs PyYAML

    with open(path, "r") as f:
        d = yaml.safe_load(f) or {}
    return config_from_dict(d, **overrides)


# ----------------------------------------------------------------------
# Presets (the reference's launch files; base_pkg/launch/*.launch)
# ----------------------------------------------------------------------

_PRESETS = {
    # sim_base.launch — sim + plotter + goal pursuit, no filter node.
    "sim_base": dict(
        occ_map_img="blank.jpg", landmark_map="random",
        precompute_trajectory=False, use_local_planner=False,
        tight_control=False, plot_result_only=False,
    ),
    # filter_demo_live.launch — adds localization, precomputed TSP trajectory.
    "filter_demo_live": dict(
        occ_map_img="blank.jpg", landmark_map="random",
        precompute_trajectory=True, use_local_planner=False,
        tight_control=False, plot_result_only=False,
    ),
    # filter_demo_results_only.launch — dt=0.005, only final frame drawn.
    "filter_demo_results_only": dict(
        occ_map_img="blank.jpg", landmark_map="random",
        precompute_trajectory=True, use_local_planner=False,
        tight_control=False, plot_result_only=True, dt=0.005,
    ),
    # igvc1.launch — igvc map + local planner + tight control, closed loop.
    "igvc1": dict(
        occ_map_img="igvc1.png", landmark_map="igvc1",
        precompute_trajectory=False, use_local_planner=True,
        tight_control=True, plot_result_only=False,
    ),
}


def preset(name: str, base: Config | None = None, **overrides) -> Config:
    if name not in _PRESETS:
        raise ValueError(f"Unknown preset {name!r}; options: {sorted(_PRESETS)}")
    cfg = (base or Config()).replace(**_PRESETS[name])
    # igvc start-pose override (sim_node.py:354-361).
    if cfg.occ_map_img == "igvc1.png":
        cfg = cfg.replace(init_pose=(0.0, -8.5, 0.0))
    elif cfg.occ_map_img == "igvc2.png":
        cfg = cfg.replace(init_pose=(8.0, 0.0, math.pi / 2))
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
