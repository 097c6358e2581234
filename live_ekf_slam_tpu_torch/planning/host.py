"""Host-side (numpy) planners with exact reference semantics.

The port's copy of ``live_ekf_slam_tpu/planning/host.py``: the behaviour of
planning_pkg/src/astar.py and pure_pursuit.py down to expansion order, for
the interactive host loop (clicked goals, ``eval/interactive``), where
planning is infrequent and latency-insensitive. ``AstarHost.plan_cells``
runs the native C++ A* (``native.astar_plan``, native/src/astar.cpp);
``plan_cells_reference`` is its plain Python twin, the same algorithm
(sorted-open-list A*, Chebyshev / squared-Euclidean heuristics, the
collision-escape rule). Pure pursuit is a PID on the bearing with a growing
lookahead radius.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from live_ekf_slam_tpu_torch import native
from live_ekf_slam_tpu_torch.config import Config


def tf_ekf_to_map(cfg: Config, pt):
    return (
        int(cfg.grid_shift - pt[1] / cfg.grid_scale),
        int(cfg.grid_shift + pt[0] / cfg.grid_scale),
    )


def tf_map_to_ekf(cfg: Config, ij):
    return (
        (ij[1] - cfg.grid_shift) * cfg.grid_scale,
        -(ij[0] - cfg.grid_shift) * cfg.grid_scale,
    )


@dataclass
class _Node:
    ij: tuple
    parent: object = None
    g: float = 0.0
    h: float = 0.0
    in_collision: bool = False

    @property
    def f(self):
        return self.g + self.h + (1000.0 if self.in_collision else 0.0)


class AstarHost:
    """Reference-semantics A* (astar.py:59-127)."""

    def __init__(self, cfg: Config, occ: np.ndarray):
        self.cfg = cfg
        self.occ = occ
        self.nbrs = [(0, -1), (0, 1), (-1, 0), (1, 0)]
        if cfg.path_planning.astar_incl_diagonals:
            self.nbrs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]

    def _heuristic(self, a, goal):
        if self.cfg.path_planning.astar_incl_diagonals:
            return max(abs(goal[0] - a[0]), abs(goal[1] - a[1]))
        return (goal[0] - a[0]) ** 2 + (goal[1] - a[1]) ** 2

    def plan_cells(self, start_ij, goal_ij):
        """The cells start -> goal (without the start), or None: the native
        C++ planner (native/src/astar.cpp)."""
        return native.astar_plan(
            np.asarray(self.occ, np.float32), start_ij, goal_ij,
            self.cfg.path_planning.astar_incl_diagonals,
        )

    def plan_cells_reference(self, start_ij, goal_ij):
        """``plan_cells`` in Python, the same semantics (its plain twin)."""
        s = self.cfg.map.occ_map_size
        if not (0 <= start_ij[0] < s and 0 <= start_ij[1] < s):
            return None
        start = _Node(tuple(start_ij))
        start.in_collision = self.occ[start_ij[0]][start_ij[1]] == 0
        open_list = [start]
        seen_open = {start.ij: start}
        closed = set()
        while open_list:
            open_list.sort(key=lambda n: n.f)
            cur = open_list.pop(0)
            seen_open.pop(cur.ij, None)
            if cur.ij == tuple(goal_ij):
                rev = []
                while cur.parent is not None:
                    rev.append(cur.ij)
                    cur = cur.parent
                return list(reversed(rev))
            closed.add(cur.ij)
            for d in self.nbrs:
                ij = (cur.ij[0] + d[0], cur.ij[1] + d[1])
                if not (0 <= ij[0] < s and 0 <= ij[1] < s):
                    continue
                in_coll = self.occ[ij[0]][ij[1]] == 0
                if in_coll and not cur.in_collision:
                    continue
                if ij in closed:
                    continue
                g_new = cur.g + 1
                if ij in seen_open:
                    node = seen_open[ij]
                    if g_new < node.g:
                        node.g = g_new
                        node.parent = cur
                    continue
                node = _Node(ij, parent=cur, g=g_new, in_collision=in_coll)
                node.h = self._heuristic(ij, tuple(goal_ij))
                open_list.append(node)
                seen_open[ij] = node
        return None

    def plan(self, start_xy, goal_xy):
        """World-coordinate plan, start->goal excluding start, or None."""
        cells = self.plan_cells(
            tf_ekf_to_map(self.cfg, start_xy), tf_ekf_to_map(self.cfg, goal_xy)
        )
        if cells is None:
            return None
        return [tf_map_to_ekf(self.cfg, c) for c in cells]

    def local_planner(self, cur):
        """Nearest free point ~local_planner_dist ahead (astar.py:12-56)."""
        cfg = self.cfg
        s = cfg.map.occ_map_size
        d = cfg.path_planning.local_planner_dist
        pt = (cur[0] + d * math.cos(cur[2]), cur[1] + d * math.sin(cur[2]))
        gi = tf_ekf_to_map(cfg, pt)
        gi = (max(0, min(gi[0], s - 1)), max(0, min(gi[1], s - 1)))
        if self.occ[gi[0]][gi[1]] == 1:
            return tf_map_to_ekf(cfg, gi)
        queue = [gi]
        visited = {gi}
        while queue:
            cur_ij = queue.pop(0)
            for dd in [(0, -1), (0, 1), (-1, 0), (1, 0)]:
                nb = (cur_ij[0] + dd[0], cur_ij[1] + dd[1])
                if not (0 <= nb[0] < s and 0 <= nb[1] < s):
                    continue
                if self.occ[nb[0]][nb[1]] == 1:
                    return tf_map_to_ekf(cfg, nb)
                if nb in visited:
                    continue
                visited.add(nb)
                queue.append(nb)
        return None


class PurePursuitHost:
    """Reference-semantics pure pursuit (pure_pursuit.py), host-side."""

    def __init__(self, cfg: Config, tight: bool | None = None):
        self.cfg = cfg
        self.tight = cfg.tight_control if tight is None else tight
        self.goal_queue: list = []
        self.integ = 0.0
        self.err_prev = 0.0

    def _control(self, beta):
        dt = self.cfg.dt
        if self.tight:
            ang = 0.5 * beta
            fwd = 0.02 * (1 - abs(beta / math.pi)) ** 12 + 0.01
        else:
            ang = (
                0.9 * beta
                + 0.01 * self.integ
                + 0.4 * (beta - self.err_prev) / dt
            )
            fwd = (1 - abs(beta / math.pi)) ** 4 + 0.05
        return fwd, ang

    def pare_path(self, cur):
        for i, pt in enumerate(self.goal_queue):
            if math.hypot(cur[0] - pt[0], cur[1] - pt[1]) < 0.15:
                del self.goal_queue[: i + 1]
                return

    def choose_lookahead(self, cur, radius):
        if len(self.goal_queue) == 1:
            return self.goal_queue[0]
        look = None
        for i in range(1, len(self.goal_queue)):
            p0, p1 = self.goal_queue[i - 1], self.goal_queue[i]
            dx, dy = p1[0] - p0[0], p1[1] - p0[1]
            vx, vy = p0[0] - cur[0], p0[1] - cur[1]
            a = dx * dx + dy * dy
            b = 2 * (vx * dx + vy * dy)
            c = vx * vx + vy * vy - radius * radius
            disc = b * b - 4 * a * c
            if disc < 0 or a == 0:
                continue
            sq = math.sqrt(disc)
            for q in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
                if 0 <= q <= 1:
                    look = (p0[0] + q * dx, p0[1] + q * dy)
                    break
        return look

    def get_next_cmd(self, cur):
        self.pare_path(cur)
        if not self.goal_queue:
            return (0.0, 0.0)
        look = None
        radius = self.cfg.path_planning.lookahead_dist_init
        while look is None and radius <= self.cfg.path_planning.lookahead_dist_max:
            look = self.choose_lookahead(cur, radius)
            radius *= 1.25
        if look is None:
            look = self.goal_queue[0]
        gb = math.atan2(look[1] - cur[1], look[0] - cur[0])
        beta = math.remainder(gb - cur[2], 2 * math.pi)
        self.integ += beta * self.cfg.dt
        fwd, ang = self._control(beta)
        self.err_prev = beta
        d_max = self.cfg.constraints.commands.d_max
        th_max = self.cfg.constraints.commands.th_max
        return (
            max(0.0, min(fwd, d_max)),
            max(-th_max, min(ang, th_max)),
        )

    def direct_nav(self, cur):
        if not self.goal_queue:
            return (0.0, 0.0)
        goal = self.goal_queue[0]
        r = math.hypot(cur[0] - goal[0], cur[1] - goal[1])
        gb = math.atan2(goal[1] - cur[1], goal[0] - cur[0])
        beta = math.remainder(gb - cur[2], 2 * math.pi)
        th_max = self.cfg.constraints.commands.th_max
        d_max = self.cfg.constraints.commands.d_max
        fwd = (1 - abs(beta) / th_max) ** 3 + 0.05 if r > 0.1 else 0.0
        cmd = (max(0.0, min(fwd, d_max)), max(-th_max, min(beta, th_max)))
        if r < 0.15:
            self.goal_queue.pop(0)
        return cmd
