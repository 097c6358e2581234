"""Constraint-aware RRT (the port's copy of ``live_ekf_slam_tpu/planning/rrt.py``).

The reference ships planning_pkg/src/rrt.py as an incomplete skeleton that is
never imported by any node (its collision check returns False and find_path
returns after one iteration). For capability parity we provide the same API
surface, implemented as a small working host-side RRT over the occupancy grid
with unicycle motion constraints; it remains, as in the reference, unused by
the main pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.planning.host import tf_ekf_to_map


@dataclass
class Node:
    x: float
    y: float
    yaw: float
    parent_id: int
    children: list = field(default_factory=list)

    def add_child(self, child_id: int):
        self.children.append(child_id)


class RRT:
    def __init__(self, x_v, y_v, yaw_v, cfg: Config, occ_map=None):
        self.cfg = cfg
        self.occ = occ_map
        self.tree = [Node(x_v, y_v, yaw_v, 0)]
        self.rng = np.random.default_rng(0)

    def check_collision(self, x, y) -> bool:
        if self.occ is None:
            return False
        i, j = tf_ekf_to_map(self.cfg, (x, y))
        s = self.cfg.map.occ_map_size
        if not (0 <= i < s and 0 <= j < s):
            return True
        return self.occ[i][j] == 0

    def find_path(self, x_g, y_g, max_iters: int = 5000, goal_tol: float = 0.3):
        """Grow the tree until a node lands within goal_tol of the goal.

        Returns the list of (x, y) from start to goal, or None.
        """
        b = self.cfg.map.bound
        d_max = self.cfg.constraints.commands.d_max
        th_max = self.cfg.constraints.commands.th_max
        for _ in range(max_iters):
            if self.rng.random() > 0.1:
                target = (self.rng.uniform(-b, b), self.rng.uniform(-b, b))
            else:
                target = (x_g, y_g)
            # nearest node to the target
            d2 = [
                (n.x - target[0]) ** 2 + (n.y - target[1]) ** 2
                for n in self.tree
            ]
            nid = int(np.argmin(d2))
            n = self.tree[nid]
            gb = math.atan2(target[1] - n.y, target[0] - n.x)
            beta = math.remainder(gb - n.yaw, 2 * math.pi)
            beta = max(-th_max, min(beta, th_max))
            yaw = n.yaw + beta
            # several motion steps per extension to make progress
            x, y = n.x, n.y
            ok = True
            for _ in range(10):
                x += d_max * math.cos(yaw)
                y += d_max * math.sin(yaw)
                if self.check_collision(x, y):
                    ok = False
                    break
            if not ok:
                continue
            self.tree.append(Node(x, y, yaw, nid))
            self.tree[nid].add_child(len(self.tree) - 1)
            if math.hypot(x - x_g, y - y_g) < goal_tol:
                path = [(x, y)]
                cur = len(self.tree) - 1
                while cur != 0:
                    cur = self.tree[cur].parent_id
                    path.append((self.tree[cur].x, self.tree[cur].y))
                return list(reversed(path))
        return None
