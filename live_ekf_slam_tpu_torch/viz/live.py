"""Host-side live viewer (rebuild of plotting_node.py); the port's copy of
``live_ekf_slam_tpu/viz/live.py``.

Architecture change from the reference: instead of per-topic callbacks racing
a plot timer (plotting_node.py:222-490 with its copy-and-null message guards),
the device runs the step and the viewer consumes frame snapshots pulled
off-device (``cli.run_demo``; with ``plotter.async_viz`` through
``viz/async_feed``) — the `/state/*` topics dissolve into a host-side frame
queue. matplotlib is imported by the viewer alone, so ``Frame`` and the
stepping code never need it.

Feature parity with the reference plotter:
  * true pose arrow, estimated pose arrow, trajectory history
  * vehicle + landmark covariance ellipses (cov_std_dev config)
  * true landmark map + estimated landmarks
  * UKF sigma points (vehicle arrows or dots, landmark points)
  * pose-graph panel (initial vs optimized pose history, landmark positions,
    optional measurement connections)
  * occupancy color map underlay, planned path + goal point
  * left-click publishes a navigation goal, right-click exits
    (plotting_node.py:131-144)
  * timestep counter, legend, average-error computation at the end
    (plotting_node.py:195-218), optional final-map PNG save + per-filter
    CSV append (plotting_node.py:117-129)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.viz.artists import (
    cov_to_ellipse,
    landmark_sigma_points_xy,
    pose_arrow_components,
    sigma_points_xy,
)


@dataclass
class Frame:
    """One tick's snapshot pulled from device."""

    timestep: int
    true_pose: np.ndarray            # (3,)
    est_pose: np.ndarray | None      # (3,); None in filterless sim_base runs
    landmarks: np.ndarray | None = None   # (M, 3) [id, x, y]
    cov: np.ndarray | None = None         # (D, D) active block
    sigma_pts: np.ndarray | None = None   # (Du, 2Du+1)
    pg_initial: np.ndarray | None = None  # (Tp, 3) pose history
    pg_result: np.ndarray | None = None
    pg_landmarks: np.ndarray | None = None
    # (C, 2) int (pose_index, landmark_index) bearing-range factor pairs
    # (PoseGraphState.msg meas_connections, plotting_node.py:444-455)
    pg_meas: np.ndarray | None = None
    path: np.ndarray | None = None        # (L, 2) planned path


@dataclass
class _Viewer:
    """What both viewers share: each frame's position error of the estimate,
    their average at the end (compute_average_error, plotting_node.py:195-218)
    and the per-filter CSV append (plotting_node.py:117-129)."""

    cfg: Config
    color_map: np.ndarray | None = None
    true_landmarks: np.ndarray | None = None  # (N, 2)
    on_goal: Callable | None = None  # callback(goal_xy) for clicked goals

    def _note_error(self, frame: Frame):
        # sim_base runs have no filter and therefore no estimate
        if frame.est_pose is not None:
            self.errors.append(
                float(np.linalg.norm(frame.est_pose[:2] - frame.true_pose[:2]))
            )

    def average_error(self):
        if not self.errors:
            return float("nan")
        return float(np.mean(self.errors))

    def _append_average(self, base_dir: str | None, name: str, avg: float):
        if base_dir and self.cfg.pose_graph.save_average_error_at_end:
            os.makedirs(os.path.join(base_dir, "data"), exist_ok=True)
            with open(os.path.join(base_dir, "data", f"{name}.csv"), "a") as f:
                f.write(f"{avg}\n")


@dataclass
class LiveViewer(_Viewer):
    title: str = ""
    _state: dict = field(default_factory=dict)

    def __post_init__(self):
        import matplotlib
        if os.environ.get("MPLBACKEND") is None and not os.environ.get("DISPLAY"):
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        plt.rcParams["figure.figsize"] = (9, 9)
        self.fig = plt.figure()
        pg_mode = self.cfg.filter == "pose_graph"
        if pg_mode and self.cfg.plotter.pg_show_normal_viz_alongside:
            self.ax = self.fig.add_subplot(1, 2, 1)
            self.ax_pg = self.fig.add_subplot(1, 2, 2)
            self.ax_pg.set_title("Pose graph progress")
        elif pg_mode:
            self.ax_pg = self.fig.add_subplot(1, 1, 1)
            self.ax = None
        else:
            self.ax = self.fig.add_subplot(1, 1, 1)
            self.ax_pg = None
        edge = self.cfg.map.bound * self.cfg.plotter.display_region_mult
        for ax in (self.ax, self.ax_pg):
            if ax is None:
                continue
            ax.set_xlim(-edge, edge)
            ax.set_ylim(-edge, edge)
            ax.set_aspect("equal")
            ax.set_xlabel("x (m)")
            ax.set_ylabel("y (m)")
        self._draw_static()
        self.fig.canvas.mpl_connect("button_press_event", self._on_click)
        self.errors: list[float] = []
        self.est_hist: list[np.ndarray] = []
        self.true_hist: list[np.ndarray] = []
        self._artists: dict = {}

    # ------------------------------------------------------------------
    def _draw_static(self):
        edge = self.cfg.map.bound
        for ax in (self.ax, self.ax_pg):
            if ax is None:
                continue
            if self.cfg.plotter.show_occ_map and self.color_map is not None:
                ax.imshow(
                    self.color_map, zorder=0, extent=[-edge, edge, -edge, edge]
                )
            if (
                self.cfg.plotter.show_true_landmark_map
                and self.true_landmarks is not None
            ):
                ax.scatter(
                    self.true_landmarks[:, 0],
                    self.true_landmarks[:, 1],
                    s=30,
                    color="white",
                    edgecolors="black",
                    zorder=2,
                    label="True Landmark Position",
                )

    def _on_click(self, event):
        if event.button == 3:  # right click: exit (plotting_node.py:133-136)
            self.close()
            raise SystemExit
        if event.button == 1 and self.on_goal and event.xdata is not None:
            if self.cfg.plotter.list_clicked_points:
                print((event.xdata, event.ydata))
            self.on_goal((event.xdata, event.ydata))

    def _remove(self, name):
        art = self._artists.pop(name, None)
        if art is None:
            return
        try:
            art.remove()
        except Exception:
            try:
                art[0].remove()
            except Exception:
                pass

    # ------------------------------------------------------------------
    def update(self, frame: Frame):
        cfg = self.cfg
        plot_now = not cfg.plot_result_only or (
            frame.timestep + 1 >= cfg.num_iterations
        )
        self.true_hist.append(frame.true_pose.copy())
        if frame.est_pose is not None:
            self.est_hist.append(frame.est_pose.copy())
        self._note_error(frame)
        if not plot_now or self.ax is None and self.ax_pg is None:
            return

        ax = self.ax if self.ax is not None else self.ax_pg
        al = cfg.plotter.arrow_len
        self._remove("timestep")
        self._artists["timestep"] = ax.text(
            -cfg.map.bound, cfg.map.bound, f"t = {frame.timestep}",
            ha="left", va="bottom", zorder=2,
        )
        if cfg.plotter.show_true_traj:
            self._remove("veh_true")
            dx, dy = pose_arrow_components(frame.true_pose[2], al)
            self._artists["veh_true"] = ax.arrow(
                frame.true_pose[0], frame.true_pose[1], dx, dy,
                color="blue", width=0.1, zorder=2,
            )
        if not cfg.plotter.show_entire_traj:
            self._remove("veh_est")
        if frame.est_pose is not None:
            dx, dy = pose_arrow_components(frame.est_pose[2], al)
            self._artists["veh_est"] = ax.arrow(
                frame.est_pose[0], frame.est_pose[1], dx, dy,
                facecolor="green", edgecolor="black", width=0.1, zorder=4,
            )
        if frame.cov is not None and cfg.plotter.show_veh_ellipse:
            ell = cov_to_ellipse(frame.cov[:2, :2], cfg.plotter.cov_std_dev)
            if not cfg.plotter.show_entire_traj:
                self._remove("veh_cov")
            self._artists["veh_cov"] = ax.plot(
                frame.est_pose[0] + ell[0], frame.est_pose[1] + ell[1],
                "lightgrey", zorder=1,
            )
        if frame.landmarks is not None and len(frame.landmarks):
            self._remove("lm_est")
            self._artists["lm_est"] = ax.scatter(
                frame.landmarks[:, 1], frame.landmarks[:, 2],
                s=30, color="red", edgecolors="black", zorder=3,
                label="Estimated Landmark Position",
            )
            if frame.cov is not None and cfg.plotter.show_landmark_ellipses:
                for i in range(len(frame.landmarks)):
                    li = 3 + 2 * i if frame.sigma_pts is None else 4 + 2 * i
                    if li + 2 > frame.cov.shape[0]:
                        continue
                    self._remove(f"lm_cov_{i}")
                    ell = cov_to_ellipse(
                        frame.cov[li:li + 2, li:li + 2],
                        cfg.plotter.cov_std_dev,
                    )
                    self._artists[f"lm_cov_{i}"] = ax.plot(
                        frame.landmarks[i, 1] + ell[0],
                        frame.landmarks[i, 2] + ell[1],
                        "orange", zorder=1,
                    )
        if frame.sigma_pts is not None:
            xs, ys, yaws = sigma_points_xy(frame.sigma_pts)
            self._remove("sigma")
            if cfg.plotter.plot_ukf_arrows:
                self._artists["sigma"] = ax.quiver(
                    xs, ys, al * np.cos(yaws), al * np.sin(yaws),
                    color="cyan", width=0.1, pivot="mid", minlength=1e-4,
                )
            else:
                self._artists["sigma"] = ax.scatter(
                    xs, ys, s=30, color="tab:cyan", zorder=2
                )
            if cfg.plotter.show_landmark_sigma_pts:
                lx, ly = landmark_sigma_points_xy(frame.sigma_pts)
                self._remove("sigma_lm")
                self._artists["sigma_lm"] = ax.scatter(
                    lx, ly, s=30, color="tab:cyan", zorder=1,
                    label="UKF Landmark Sigma Points",
                )
        if frame.path is not None and len(frame.path):
            self._remove("path")
            self._remove("goal")
            self._artists["path"] = ax.scatter(
                frame.path[:, 0], frame.path[:, 1], s=12, color="purple",
                zorder=1, label="Planned Path",
            )
            self._artists["goal"] = ax.scatter(
                frame.path[-1, 0], frame.path[-1, 1], color="yellow",
                edgecolors="black", s=40, zorder=2, label="Goal Point",
            )
        if self.ax_pg is not None:
            self._update_pg(frame)
        self.plt.pause(1e-9)

    def _update_pg(self, frame: Frame):
        ax = self.ax_pg
        al = self.cfg.plotter.arrow_len
        for name, hist, color in (
            ("pg_init", frame.pg_initial, "green"),
            ("pg_res", frame.pg_result, "purple"),
        ):
            if hist is None or not len(hist):
                continue
            self._remove(name)
            self._artists[name] = ax.quiver(
                hist[:, 0], hist[:, 1],
                al * np.cos(hist[:, 2]), al * np.sin(hist[:, 2]),
                color=color, width=0.1, zorder=5, pivot="mid",
                minlength=1e-4,
            )
        if frame.pg_landmarks is not None and len(frame.pg_landmarks):
            self._remove("pg_lms")
            self._artists["pg_lms"] = ax.scatter(
                frame.pg_landmarks[:, 0], frame.pg_landmarks[:, 1],
                s=30, color="darkred", edgecolors="black", zorder=2,
                label="Pose-Graph SLAM Result (Landmarks)",
            )

        # adjacent-pose (command) connections (plotting_node.py:443-446)
        hist = frame.pg_result if frame.pg_result is not None else frame.pg_initial
        if (
            self.cfg.plotter.pg_show_cmd_connections
            and hist is not None and len(hist) > 1
        ):
            self._remove("pg_cmd_conn")
            (self._artists["pg_cmd_conn"],) = ax.plot(
                hist[:, 0], hist[:, 1], color="blue", zorder=0,
                label="Pose-Graph Command Connection",
            )

        # measurement connections pose<->landmark (plotting_node.py:448-455);
        # one LineCollection instead of the reference's per-connection plot
        if (
            self.cfg.plotter.pg_show_meas_connections
            and frame.pg_meas is not None and len(frame.pg_meas)
            and hist is not None and frame.pg_landmarks is not None
            and len(frame.pg_landmarks)
        ):
            from matplotlib.collections import LineCollection

            iv = np.clip(frame.pg_meas[:, 0], 0, len(hist) - 1)
            il = np.clip(frame.pg_meas[:, 1], 0, len(frame.pg_landmarks) - 1)
            segs = np.stack(
                [hist[iv, :2], frame.pg_landmarks[il, :2]], axis=1
            )  # (C, 2, 2)
            self._remove("pg_meas_conn")
            lc = LineCollection(
                segs, colors="lightcoral", zorder=0, linewidths=0.8,
                label="Pose-Graph Measurement Connection",
            )
            ax.add_collection(lc)
            self._artists["pg_meas_conn"] = lc

    # ------------------------------------------------------------------
    def finish(self, base_dir: str | None = None, filter_name: str | None = None):
        """On-exit artifacts (plotting_node.py:117-129): optional PNG save and
        per-filter avg-error CSV append."""
        avg = self.average_error()
        name = filter_name or self.cfg.filter
        if base_dir:
            os.makedirs(os.path.join(base_dir, "plots"), exist_ok=True)
            if self.cfg.plotter.save_final_map:
                self.fig.savefig(
                    os.path.join(base_dir, "plots", f"{name}_demo.png"),
                    format="png",
                )
        self._append_average(base_dir, name, avg)
        return avg

    def close(self):
        self.plt.close(self.fig)


@dataclass
class FrameRecorder(_Viewer):
    """A viewer without matplotlib, with ``LiveViewer``'s interface: it
    keeps every frame it is given and computes the same average error; at
    ``finish`` it appends the per-filter CSV as ``LiveViewer`` does (there
    is no figure to save). For headless runs where matplotlib is absent, and
    for checks that hold the frames themselves."""

    def __post_init__(self):
        self.frames: list[Frame] = []
        self.errors: list[float] = []

    @classmethod
    def into(cls, made: list):
        """A viewer factory for ``cli.run_demo`` and ``cli.run_sim_base``
        that appends each recorder it makes to ``made``."""
        def make(*args, **kw):
            made.append(cls(*args, **kw))
            return made[-1]
        return make

    def update(self, frame: Frame):
        self.frames.append(frame)
        self._note_error(frame)

    def finish(self, base_dir: str | None = None, filter_name: str | None = None):
        avg = self.average_error()
        self._append_average(base_dir, filter_name or self.cfg.filter, avg)
        return avg
