"""Pure pursuit on a fixed-capacity path buffer, batched over worlds
(counterpart of ``live_ekf_slam_tpu/planning/pure_pursuit.py``).

Rebuild of planning_pkg/src/pure_pursuit.py: path paring within 0.15 m
(pure_pursuit.py:84-94), the lookahead point by segment-circle intersection
with a radius growing 0.2 -> 2.0 by 1.25x (pure_pursuit.py:54-63, 97-131),
PID heading control with the loose and tight gain sets (pure_pursuit.py:17-37),
command clamping (pure_pursuit.py:78-80) and the ``direct_nav``
point-to-point alternative (pure_pursuit.py:134-161).

The reference's goal queue is a (B, C, 2) buffer with per-world head and
length; its while-loop over radii is a tensor dimension of the 11 radii
with a first-match select. The divisions by constants are products with
the float32 reciprocal, as XLA compiles the JAX functions inside the closed
loop's scan (``ops/precision.reciprocal``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from live_ekf_slam_tpu_torch.core.types import StateFields
from live_ekf_slam_tpu_torch.ops.precision import constant, first_match, reciprocal

_TWO_PI = 6.283185307179586
_PI = math.pi


@dataclasses.dataclass(frozen=True)
class PursuitState(StateFields):
    """Per-world pursuit state: path (B, C, 2) waypoints in world coords,
    head (B,) int32 index of the first active waypoint, length (B,) int32
    active waypoints from head, integ (B,) the PID integral of the heading
    error, err_prev (B,) the previous heading error."""

    path: torch.Tensor
    head: torch.Tensor
    length: torch.Tensor
    integ: torch.Tensor
    err_prev: torch.Tensor


def init(cfg, batch: int, device="cpu") -> PursuitState:
    c = cfg.path_planning.path_capacity
    zi = torch.zeros(batch, dtype=torch.int32, device=device)
    zf = torch.zeros(batch, dtype=torch.float32, device=device)
    return PursuitState(
        path=torch.zeros((batch, c, 2), dtype=torch.float32, device=device),
        head=zi, length=zi.clone(), integ=zf, err_prev=zf.clone(),
    )


def select(mask: torch.Tensor, new: PursuitState, old: PursuitState) -> PursuitState:
    """Per world, ``new`` where ``mask`` (B,) is set, else ``old``."""
    def pick(a, b):
        m = mask.view((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)
    return PursuitState(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                           for f in dataclasses.fields(PursuitState)})


def set_path(s: PursuitState, pts: torch.Tensor, valid: torch.Tensor) -> PursuitState:
    """Replace each world's queue with a new path ((B, L, 2) + mask (B, L)):
    the valid points first, in order (a stable sort; the invalid ones follow
    as they are), cropped or zero-padded to the capacity."""
    b, c = s.path.shape[:2]
    n = torch.clamp(valid.to(torch.int32).sum(dim=1), max=c).to(torch.int32)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    compacted = torch.gather(pts, 1, order[:, :, None].expand(-1, -1, 2))
    ln = compacted.shape[1]
    if ln >= c:
        path = compacted[:, :c]
    else:
        path = torch.zeros((b, c, 2), dtype=compacted.dtype, device=pts.device)
        path[:, :ln] = compacted
    return s.replace(path=path.contiguous(), head=torch.zeros_like(s.head),
                     length=n)


def append_goal(s: PursuitState, goal: torch.Tensor) -> PursuitState:
    """Append one point (B, 2) to each queue (the ``simple`` / blank-map
    mode, goal_pursuit_node.py:81-83)."""
    c = s.path.shape[1]
    idx = torch.clamp(s.head + s.length, max=c - 1).long()
    path = s.path.clone()
    path[torch.arange(path.shape[0], device=path.device), idx] = goal
    return s.replace(path=path,
                     length=torch.minimum(s.length + 1, c - s.head))


def _active_mask(s: PursuitState) -> torch.Tensor:
    idx = torch.arange(s.path.shape[1], device=s.path.device)[None]
    return (idx >= s.head[:, None]) & (idx < (s.head + s.length)[:, None])


def _norm2(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def pare_path(s: PursuitState, cur: torch.Tensor) -> PursuitState:
    """Drop waypoints up to the first active one within 0.15 m
    (pure_pursuit.py:84-94)."""
    r = _norm2(s.path - cur[:, None, :2])
    hit, first = first_match(_active_mask(s) & (r < 0.15))
    first = first.to(torch.int32)
    new_head = torch.where(hit, first + 1, s.head)
    new_len = torch.where(hit, s.length - (first + 1 - s.head), s.length)
    return s.replace(head=new_head, length=torch.clamp(new_len, min=0))


def _lookahead_at_radius(s: PursuitState, cur: torch.Tensor,
                         radius: torch.Tensor):
    """Segment-circle intersections (pure_pursuit.py:97-131) at every radius
    (R,) at once: returns (points (B, R, 2), found (B, R)). Of the segments
    that intersect, the last one wins (the reference's loop overwrites), and
    in a segment the smaller root in [0, 1]."""
    c = s.path.shape[1]
    active = _active_mask(s)
    p_prev = s.path
    p_next = torch.roll(s.path, -1, dims=1)
    seg_valid = active & torch.roll(active, -1, dims=1)  # segment i: i -> i+1

    diff = p_next - p_prev
    v1 = p_prev - cur[:, None, :2]
    a = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])[:, None]
    b = (2.0 * (v1[..., 0] * diff[..., 0] + v1[..., 1] * diff[..., 1]))[:, None]
    r2 = (radius * radius)[None, :, None]
    cc = (v1[..., 0] * v1[..., 0] + v1[..., 1] * v1[..., 1])[:, None] - r2
    disc = b * b - 4.0 * a * cc                       # (B, R, C)
    ok = seg_valid[:, None] & (disc >= 0.0) & (a > 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    den = torch.where(a > 0, 2.0 * a, 1.0)
    q0 = (-b - sq) / den
    q1 = (-b + sq) / den
    v0 = ok & (q0 >= 0.0) & (q0 <= 1.0)
    v1ok = ok & (q1 >= 0.0) & (q1 <= 1.0)
    q = torch.where(v0, q0, q1)
    any_valid = v0 | v1ok
    idx = torch.arange(c, device=s.path.device)
    last = torch.where(any_valid, idx, -1).amax(dim=2).clamp(min=0)  # (B, R)
    g = last[:, :, None, None].expand(-1, -1, 1, 2)
    pts = (torch.gather(p_prev[:, None].expand(-1, radius.shape[0], -1, -1), 2, g)
           + torch.gather(q, 2, last[:, :, None])[..., None]
           * torch.gather(diff[:, None].expand(-1, radius.shape[0], -1, -1), 2, g))
    return pts[:, :, 0], any_valid.any(dim=2)


def radii(cfg, device) -> torch.Tensor:
    """The growing lookahead radii r0 * 1.25^k up to r_max (float32)."""
    r0 = cfg.path_planning.lookahead_dist_init
    rmax = cfg.path_planning.lookahead_dist_max
    n_radii = max(1, int(math.floor(math.log(rmax / r0, 1.25))) + 1)
    return constant(tuple(r0 * 1.25 ** k for k in range(n_radii)),
                    torch.float32, torch.device(device))


def choose_lookahead(cfg, s: PursuitState, cur: torch.Tensor) -> torch.Tensor:
    """Growing-radius search (pure_pursuit.py:54-63): the first radius that
    intersects the path wins; else the first waypoint, which a one-point
    path always takes (pure_pursuit.py:61-63). Returns (B, 2)."""
    pts, founds = _lookahead_at_radius(s, cur, radii(cfg, cur.device))
    found, first = first_match(founds)
    c = s.path.shape[1]
    rows = torch.arange(cur.shape[0], device=cur.device)
    first_pt = s.path[rows, torch.clamp(s.head, 0, c - 1).long()]
    pt = torch.where(found[:, None], pts[rows, first], first_pt)
    return torch.where((s.length == 1)[:, None], first_pt, pt)


def _wrap(theta: torch.Tensor) -> torch.Tensor:
    """``utils.geometry.wrap_angle`` as XLA compiles it inside the scan."""
    return theta - _TWO_PI * torch.round(theta * reciprocal(_TWO_PI, theta.device))


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an integer n >= 1 by JAX's ``integer_pow``: binary
    exponentiation, the same products in the same order."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _pid(cfg, s: PursuitState, beta: torch.Tensor, tight: bool):
    """cmd_loose / cmd_tight gain sets (pure_pursuit.py:17-37): (fwd, ang)."""
    inv_pi = reciprocal(_PI, beta.device)
    if tight:
        ang = 0.5 * beta
        fwd = 0.02 * _ipow(1.0 - torch.abs(beta * inv_pi), 12) + 0.01
    else:
        ang = (0.9 * beta + 0.01 * s.integ
               + (0.4 * (beta - s.err_prev)) * reciprocal(cfg.dt, beta.device))
        fwd = _ipow(1.0 - torch.abs(beta * inv_pi), 4) + 0.05
    return fwd, ang


def get_next_cmd(cfg, s: PursuitState, cur: torch.Tensor, tight: bool | None = None):
    """One navigation tick (pure_pursuit.py:40-81) for poses cur (B, 3):
    returns (cmd (B, 2), state'). A world without a path gets a zero
    command and keeps its (pared) state."""
    tight = cfg.tight_control if tight is None else tight
    s = pare_path(s, cur)
    have_path = s.length >= 1

    look = choose_lookahead(cfg, s, cur)
    gb = torch.atan2(look[:, 1] - cur[:, 1], look[:, 0] - cur[:, 0])
    beta = _wrap(gb - cur[:, 2])

    s_upd = s.replace(integ=s.integ + beta * cfg.dt)
    fwd, ang = _pid(cfg, s_upd, beta, tight)
    s_out = s_upd.replace(err_prev=beta)

    lim = cfg.constraints.commands
    cmd = torch.stack([torch.clamp(fwd, 0.0, lim.d_max),
                       torch.clamp(ang, -lim.th_max, lim.th_max)], dim=1)
    cmd = torch.where(have_path[:, None], cmd, 0.0)
    return cmd, select(have_path, s_out, s)


def direct_nav(cfg, s: PursuitState, cur: torch.Tensor):
    """Point-to-point alternative (pure_pursuit.py:134-161): steer at the
    head waypoint, drop it within 0.15 m. Returns (cmd (B, 2), state')."""
    have_path = s.length >= 1
    c = s.path.shape[1]
    rows = torch.arange(cur.shape[0], device=cur.device)
    goal = s.path[rows, torch.clamp(s.head, 0, c - 1).long()]
    diff = goal - cur[:, :2]
    r = _norm2(diff)
    gb = torch.atan2(diff[:, 1], diff[:, 0])
    beta = _wrap(gb - cur[:, 2])
    lim = cfg.constraints.commands
    fwd = torch.where(
        r > 0.1,
        _ipow(1.0 - torch.abs(beta) * reciprocal(lim.th_max, cur.device), 3) + 0.05,
        0.0)
    cmd = torch.stack([torch.clamp(fwd, 0.0, lim.d_max),
                       torch.clamp(beta, -lim.th_max, lim.th_max)], dim=1)
    cmd = torch.where(have_path[:, None], cmd, 0.0)
    arrived = have_path & (r < 0.15)
    return cmd, s.replace(head=torch.where(arrived, s.head + 1, s.head),
                          length=torch.where(arrived, s.length - 1, s.length))
