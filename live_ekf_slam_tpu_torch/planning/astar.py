"""Occupancy-grid path planning of the closed loop, batched over worlds
(counterpart of ``live_ekf_slam_tpu/planning/astar.py``).

The reference's A* (planning_pkg/src/astar.py) is a sequential priority-queue
search with uniform step cost (diagonals too) and a collision-escape rule:
a cell in collision is entered only from a parent in collision
(astar.py:80-127). The JAX package re-expresses it as bounded min-plus
relaxation over the grid, one ``lax.while_loop`` per world under ``vmap``;
here every world of a batch relaxes at once, a leading axis B, and the one
(S, S) grid is shared. ``local_planner`` (astar.py:12-56), the nearest free
cell to a point ~1.8 m ahead, is the same relaxation through blocked cells
with 4-neighbours.

A sweep is a handful of batched tensor ops: the neighbours' distances read
from a padded copy, the "allowed" masks (fixed for a plan, made once), the
minimum over the shifts. Relaxation is monotone and reaches a fixed point,
so any number of sweeps between "every world has converged" and
``max_iters`` gives JAX's field bit for bit: the loop tests convergence once
every ``check_every`` sweeps (one host sync), or never with 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from live_ekf_slam_tpu_torch.ops.precision import constant, reciprocal

# float32 1e9 (astar.py:29 of the JAX package): 1e9 + 1 rounds back to 1e9,
# and the "< _INF" tests depend on it
_INF = 1e9

# neighbour shifts: 4-connected first, then diagonals (goal_pursuit_node.py:149)
SHIFTS4 = ((0, -1), (0, 1), (-1, 0), (1, 0))
SHIFTS8 = SHIFTS4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))

# sweeps between two convergence tests of a relaxation; 0 runs every sweep
CHECK_EVERY = 8

_I32_MAX_F = 2147483520.0  # the largest float32 below 2^31


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero, saturating, NaN to 0 (XLA's
    conversion; torch's is undefined out of range)."""
    v = torch.nan_to_num(v, nan=0.0).clamp(-2147483648.0, _I32_MAX_F)
    return v.to(torch.int32)


def tf_ekf_to_map(cfg, xy: torch.Tensor) -> torch.Tensor:
    """World (..., 2) float32 -> grid indices (..., 2) int32, truncating
    toward zero in float32 (astar.py:137-139), the division by grid_scale
    as the JAX function compiles it (``ops/precision.reciprocal``)."""
    inv = reciprocal(cfg.grid_scale, xy.device)
    i = cfg.grid_shift - xy[..., 1] * inv
    j = cfg.grid_shift + xy[..., 0] * inv
    return torch.stack([_to_int32(i), _to_int32(j)], dim=-1)


def tf_map_to_ekf(cfg, ij: torch.Tensor) -> torch.Tensor:
    """Grid indices (..., 2) -> world coords (..., 2) float32 (astar.py:131-133)."""
    x = (ij[..., 1].to(torch.float32) - cfg.grid_shift) * cfg.grid_scale
    y = -((ij[..., 0].to(torch.float32) - cfg.grid_shift) * cfg.grid_scale)
    return torch.stack([x, y], dim=-1)


def _shifted(a: torch.Tensor, shifts, fill) -> torch.Tensor:
    """(B, K, S, S): a (B, S, S) moved by each (di, dj) of ``shifts``, so
    that out[:, k, i, j] = a[:, i - di, j - dj], vacated cells ``fill``
    (the JAX package's ``_shift_impl`` for every shift at once)."""
    s = a.shape[-1]
    pad = torch.full(a.shape[:-2] + (s + 2, s + 2), fill, dtype=a.dtype,
                     device=a.device)
    pad[..., 1:-1, 1:-1] = a
    return torch.stack([pad[:, 1 - di:1 - di + s, 1 - dj:1 - dj + s]
                        for di, dj in shifts], dim=1)


def _one_hot_cells(ij: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S, S) bool, True at each world's cell ij (B, 2)."""
    flat = (ij[:, 0] * s + ij[:, 1]).long()
    out = torch.zeros((ij.shape[0], s * s), dtype=torch.bool, device=ij.device)
    out.scatter_(1, flat[:, None], True)
    return out.view(-1, s, s)


def _relax(start: torch.Tensor, allowed: torch.Tensor, shifts, max_iters: int,
           check_every: int = CHECK_EVERY) -> torch.Tensor:
    """Min-plus relaxation from the one-hot ``start`` (B, S, S): each sweep
    takes, in every cell, the least of its distance and neighbour + 1 over
    the shifts whose ``allowed`` mask (B, K, S, S) is set. Stops at
    ``max_iters`` sweeps or once a sweep changes no world, tested every
    ``check_every`` sweeps (0: never)."""
    dist = torch.where(start, 0.0, _INF)
    it, step = 0, check_every or max_iters
    while it < max_iters:
        for _ in range(min(step, max_iters - it)):
            cand = torch.where(allowed, _shifted(dist, shifts, _INF) + 1.0, _INF)
            last, dist = dist, torch.minimum(dist, cand.amin(dim=1))
        it += min(step, max_iters - it)
        if it < max_iters and not bool((dist < last).any()):
            break
    return dist


def _batched(occ: torch.Tensor, b: int) -> torch.Tensor:
    return occ.expand(b, *occ.shape[-2:]) if occ.dim() == 2 else occ


def distance_field(occ: torch.Tensor, start_ij: torch.Tensor, max_iters: int,
                   diagonals: bool = True,
                   check_every: int = CHECK_EVERY) -> torch.Tensor:
    """(B, S, S) float32 min-plus distances from each world's ``start_ij``
    (B, 2) under the reference's traversal rule: into a free cell always,
    into a blocked cell only from a blocked cell (the collision-escape
    chain, astar.py:99-101); 1e9 where unreachable, cost 1 a step, diagonals
    included (astar.py:164). ``occ`` (S, S), shared, or (B, S, S): 1 free,
    0 blocked."""
    b, s = start_ij.shape[0], occ.shape[-1]
    free = _batched(occ > 0.5, b)
    shifts = SHIFTS8 if diagonals else SHIFTS4
    # allowed into a cell: free here, or blocked here and a blocked parent
    allowed = free[:, None] | ~_shifted(free, shifts, False)
    return _relax(_one_hot_cells(start_ij, s), allowed, shifts, max_iters,
                  check_every)


def extract_path(dist: torch.Tensor, goal_ij: torch.Tensor, max_len: int,
                 diagonals: bool = True):
    """Greedy descent from the goal along the distance field (astar.py:86-91).

    Returns (path_ij (B, L, 2) int32 ordered start->goal, the start cell
    excluded, valid (B, L) bool, reached (B,) bool), as the JAX function's
    ``max_len``-step scan gives them: from a cell the walk takes the first
    neighbour (in shift order, indices clipped to the grid) of least
    distance below its own, else stays. Each cell's step is computed once
    for the whole field, and the walk's L cells by pointer doubling:
    log2(L) gathers instead of L dependent steps.
    """
    b, s = dist.shape[0], dist.shape[-1]
    shifts = SHIFTS8 if diagonals else SHIFTS4
    dev = dist.device
    # neighbour distances with clipped indices: a replicated border
    pad = F.pad(dist[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    d_n = torch.stack([pad[:, 1 + di:1 + di + s, 1 + dj:1 + dj + s]
                       for di, dj in shifts], dim=1)
    pick = torch.where(d_n < dist[:, None], d_n, _INF).argmin(dim=1)
    step_ok = d_n.gather(1, pick[:, None])[:, 0] < dist
    sh = constant(shifts, torch.int64, dev)[pick]  # (B, S, S, 2)
    rows = torch.arange(s, device=dev)
    ni = (rows[None, :, None] + sh[..., 0]).clamp(0, s - 1)
    nj = (rows[None, None, :] + sh[..., 1]).clamp(0, s - 1)
    here = rows[None, :, None] * s + rows[None, None, :]
    nxt = torch.where(step_ok, ni * s + nj, here).reshape(b, s * s)

    t = torch.arange(max_len, device=dev)
    pos = (goal_ij[:, 0] * s + goal_ij[:, 1]).long()[:, None].expand(b, max_len)
    jump = nxt
    n_bits = max(max_len - 1, 0).bit_length()
    for bit in range(n_bits):
        pos = torch.where(((t >> bit) & 1).bool(), jump.gather(1, pos), pos)
        if bit + 1 < n_bits:
            jump = jump.gather(1, jump)
    flat = dist.reshape(b, s * s)
    reached = flat.gather(1, pos[:, :1])[:, 0] < _INF
    valid = flat.gather(1, pos) > 0
    cells = torch.stack([pos // s, pos % s], dim=-1).to(torch.int32)
    # the walk is goal->start; flip to start->goal
    return cells.flip(1), valid.flip(1) & reached[:, None], reached


def _window_offset(center_ij: torch.Tensor, window: int, s: int) -> torch.Tensor:
    """Top-left corner of a (window, window) crop centred on ``center_ij``
    (B, 2), clamped so the crop stays inside the (s, s) grid."""
    return (center_ij - window // 2).clamp(0, s - window)


def _crop(occ: torch.Tensor, off: torch.Tensor, window: int) -> torch.Tensor:
    """(B, window, window): each world's crop of the shared (S, S) grid at
    its offset (B, 2), the JAX function's per-world ``dynamic_slice``."""
    ar = torch.arange(window, device=occ.device)
    r = off[:, 0, None].long() + ar
    c = off[:, 1, None].long() + ar
    return occ[r[:, :, None], c[:, None, :]]


def astar(cfg, occ: torch.Tensor, start_xy: torch.Tensor, goal_xy: torch.Tensor,
          max_iters=None, max_len=None):
    """Plan in world coordinates for every world (astar.py:59-155): returns
    (path_xy (B, L, 2), valid (B, L), reached (B,)), start->goal, the start
    excluded. ``occ`` is the shared (S, S) grid, start_xy and goal_xy (B, 2).

    With ``cfg.path_planning.astar_window`` > 0 the relaxation runs on a
    (window, window) crop centred on each world's start cell; a goal
    outside it reports reached=False.
    """
    it = max_iters or cfg.path_planning.astar_max_iters
    ln = max_len or it
    diag = cfg.path_planning.astar_incl_diagonals
    win = cfg.path_planning.astar_window
    s = occ.shape[-1]
    start_ij = tf_ekf_to_map(cfg, start_xy).clamp(0, s - 1)
    goal_ij = tf_ekf_to_map(cfg, goal_xy).clamp(0, s - 1)
    if win and win < s:
        off = _window_offset(start_ij, win, s)
        goal_w = goal_ij - off
        inside = ((goal_w >= 0) & (goal_w < win)).all(dim=1)
        dist = distance_field(_crop(occ, off, win), start_ij - off, it, diag)
        cells, valid, reached = extract_path(dist, goal_w.clamp(0, win - 1),
                                             ln, diag)
        return (tf_map_to_ekf(cfg, cells + off[:, None, :]),
                valid & inside[:, None], reached & inside)
    dist = distance_field(occ, start_ij, it, diag)
    cells, valid, reached = extract_path(dist, goal_ij, ln, diag)
    return tf_map_to_ekf(cfg, cells), valid, reached


def local_planner(cfg, occ: torch.Tensor, cur_pose: torch.Tensor, max_iters=None):
    """A free point ~local_planner_dist ahead of each pose (B, 3)
    (astar.py:12-56). Returns (goal_xy (B, 2), ok (B,)).

    If the ideal cell is blocked, the nearest free cell by 4-connected BFS
    distance through the blocked region is chosen, the first in row-major
    order among equals. With a window the search runs on a crop centred on
    the ideal cell (so its goal may lie outside ``astar``'s start-centred
    window: the JAX package's behaviour, kept).
    """
    it = max_iters or cfg.path_planning.local_astar_max_iters
    d = cfg.path_planning.local_planner_dist
    pt = torch.stack([cur_pose[:, 0] + d * torch.cos(cur_pose[:, 2]),
                      cur_pose[:, 1] + d * torch.sin(cur_pose[:, 2])], dim=1)
    full = occ.shape[-1]
    b = cur_pose.shape[0]
    ij = tf_ekf_to_map(cfg, pt).clamp(0, full - 1)
    win = cfg.path_planning.astar_window
    if win and win < full:
        off = _window_offset(ij, win, full)
        occ_l, s = _crop(occ, off, win), win
    else:
        off = torch.zeros_like(ij)
        occ_l, s = _batched(occ, b), full
    ij_l = ij - off
    free = occ_l > 0.5
    start = _one_hot_cells(ij_l, s)
    ideal_free = (free & start).flatten(1).any(dim=1)
    # BFS from the ideal cell through blocked cells only: a parent passes
    # its distance on if it is blocked or is the ideal cell itself (the
    # only cell at distance 0); free cells receive one but do not pass it
    # on (astar.py:38-54)
    parent_ok = ~_shifted(free, SHIFTS4, True) | _shifted(start, SHIFTS4, False)
    dist = _relax(start, parent_ok, SHIFTS4, it)
    masked = torch.where(free, dist, _INF).flatten(1)
    flat = masked.argmin(dim=1)
    best_ij = torch.stack([flat // s, flat % s], dim=1).to(torch.int32) + off
    found = masked.gather(1, flat[:, None])[:, 0] < _INF
    out_ij = torch.where(ideal_free[:, None], ij, best_ij)
    return tf_map_to_ekf(cfg, out_ij), ideal_free | found
