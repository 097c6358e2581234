"""Interactive clicked-goal pursuit (the goal_pursuit_node's clicked-goal
mode, goal_pursuit_node.py:59-99 + plotting_node.py:131-144); the port's
copy of ``live_ekf_slam_tpu/eval/interactive.py``.

Host-driven loop: the viewer's left-click hands a goal to `GoalPursuit`, which
validates it against the occupancy grid, plans with the native C++
reference-semantics A* (``planning/host.AstarHost``), appends the segment to
the pure-pursuit queue (new segments start from the end of the previous
one), and produces one command per filter state. The device runs the
sim + filter step (``eval/runner.make_step``); the planner runs host-side
exactly like the reference's planning node.
"""

from __future__ import annotations

import numpy as np

from live_ekf_slam_tpu_torch import native
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.planning.host import (
    AstarHost,
    PurePursuitHost,
    tf_ekf_to_map,
)


class GoalPursuit:
    """Host-side planner/controller (goal_pursuit_node semantics).

    With PathPlanningConfig.async_replan, local-planner replans run on the
    native JobScheduler's worker threads (native/src/scheduler.cpp) instead
    of blocking the control loop: the vehicle keeps driving the previous
    path while the C++ A* (ctypes releases the GIL) computes the next
    segment, which is swapped in on completion. The reference's planning
    node blocks its state callback for the whole plan
    (goal_pursuit_node.py:30-40); this is the non-blocking upgrade.
    """

    def __init__(self, cfg: Config, occ: np.ndarray):
        self.cfg = cfg
        self.astar = AstarHost(cfg, occ)
        self.pp = PurePursuitHost(cfg)
        self.occ = occ
        self.using_blank_map = bool((occ > 0.5).all())
        self._sched = None
        self._pending = None
        self.async_replans = 0          # replans that landed (segment swapped)
        self.async_replans_blocked = 0  # replans that found no path (held 1 tick)
        self.cmd = (0.0, 0.0)           # the last command on_state returned
        if cfg.path_planning.async_replan:
            self._sched = native.JobScheduler(n_threads=2)

    def close(self):
        """Wait out a replan in flight and release the native thread pool."""
        if self._sched is not None:
            self._sched.close()
            self._sched = None

    # -- goal selection ------------------------------------------------
    def set_goal(self, goal_xy) -> bool:
        """Clicked-goal validation + path building (goal_pursuit_node.py:59-99).

        Returns False when the goal is off-map or in collision.
        """
        i, j = tf_ekf_to_map(self.cfg, goal_xy)
        s = self.cfg.map.occ_map_size
        if not (0 <= i < s and 0 <= j < s):
            return False  # outside map bounds
        if self.occ[i][j] == 0:
            return False  # in collision
        self._plan_to(goal_xy)
        return True

    def _plan_to(self, goal_xy):
        # "simple" mode / blank map: append the goal directly
        # (goal_pursuit_node.py:81-83)
        if self.cfg.path_planning.nav_method == "simple" or self.using_blank_map:
            self.pp.goal_queue.append(list(goal_xy))
            return
        # new segments start from the end of the previous one
        start = (
            self.pp.goal_queue[-1] if self.pp.goal_queue else self._cur[:2]
        )
        seg = self.astar.plan(start, goal_xy)
        if seg is None:
            return
        self.pp.goal_queue += [list(p) for p in seg]

    # -- control --------------------------------------------------------
    def _replan_local_async(self, cur):
        """Submit a local replan to the native thread pool; keep the current
        path until the result lands. At most one replan is in flight."""
        if self._pending is not None and not self._pending["done"]:
            return
        snapshot = list(cur)
        pending = {"done": False, "seg": None}

        def job():
            goal = self.astar.local_planner(snapshot)
            if goal is not None:
                if (
                    self.cfg.path_planning.nav_method == "simple"
                    or self.using_blank_map
                ):
                    pending["seg"] = [list(goal)]
                else:
                    seg = self.astar.plan(snapshot[:2], goal)
                    if seg is not None:
                        pending["seg"] = [list(p) for p in seg]
            pending["done"] = True

        self._pending = pending
        self._sched.submit(job)

    def on_state(self, est_pose) -> tuple:
        """One navigation tick from a filter state (goal_pursuit_node.py:42-52).

        Returns the (fwd, ang) command for the next sim tick, which ``cmd``
        keeps.
        """
        self.cmd = self._next_cmd(est_pose)
        return self.cmd

    def _next_cmd(self, est_pose) -> tuple:
        self._cur = list(np.asarray(est_pose, dtype=float))
        # Swap in a completed async replan before steering this tick. The
        # segment was planned from a pose snapshot up to replan_period ticks
        # old (<= replan_period * dt * max_fwd_cmd meters of drift); pure
        # pursuit's lookahead re-targets from the live pose, which absorbs
        # that bound. A blocked replan (seg=None) mirrors the sync path's
        # behavior exactly: emit ONE (0,0) stop tick and KEEP the existing
        # queue (the sync branch below returns (0,0) without clearing it),
        # so the vehicle resumes its still-valid path next tick.
        if self._pending is not None and self._pending["done"]:
            if self._pending["seg"] is not None:
                self.pp.goal_queue = self._pending["seg"]
                self.async_replans += 1
            else:
                self.async_replans_blocked += 1
                self._pending = None
                self._t = getattr(self, "_t", 0) + 1
                return (0.0, 0.0)
            self._pending = None
        if self.cfg.use_local_planner and getattr(self, "_t", 0) % \
                self.cfg.path_planning.replan_period == 0:
            if self._sched is not None:
                self._replan_local_async(self._cur)
            else:
                goal = self.astar.local_planner(self._cur)
                if goal is None:
                    self._t = getattr(self, "_t", 0) + 1
                    return (0.0, 0.0)
                self.pp.goal_queue = []
                self._plan_to(goal)
        self._t = getattr(self, "_t", 0) + 1
        if self.cfg.path_planning.nav_method == "pp":
            return self.pp.get_next_cmd(self._cur)
        return self.pp.direct_nav(self._cur)

    @property
    def path(self):
        return np.asarray(self.pp.goal_queue, dtype=float).reshape(-1, 2)
