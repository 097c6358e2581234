"""Random landmark maps on the blank occupancy grid, in numpy.

A copy of the random-map part of ``live_ekf_slam_tpu/sim/maps.py``:
importing that module runs ``live_ekf_slam_tpu/sim/__init__.py``, which
imports the simulator and so jax. Given the same ``np.random.Generator`` it
gives bit-identical maps (the tests hold it to that). Image-backed occupancy
maps are not ported yet; ``load_occ_map`` raises for them.
"""

from __future__ import annotations

import numpy as np


def tf_ekf_to_map(cfg, pt):
    """World (x, y) -> occupancy grid (row, col); truncates toward zero."""
    i = int(cfg.grid_shift - pt[1] / cfg.grid_scale)
    j = int(cfg.grid_shift + pt[0] / cfg.grid_scale)
    return [i, j]


def blank_occ_map(cfg) -> np.ndarray:
    """All-free grid (the blank.jpg world)."""
    s = cfg.map.occ_map_size
    return np.ones((s, s), dtype=np.float32)


def load_occ_map(cfg):
    """(occ_grid {0=blocked,1=free}, color_map) for the blank world."""
    name = cfg.occ_map_img
    if name in (None, "", "blank.jpg", "blank"):
        occ = blank_occ_map(cfg)
        color = np.full(
            (cfg.map.occ_map_size, cfg.map.occ_map_size, 3), 255, np.uint8
        )
        return occ, color
    raise NotImplementedError(
        f"occupancy map {name!r}: image maps are not ported yet "
        "(ROADMAP.md, M11)"
    )


def random_landmarks(cfg, rng: np.random.Generator, occ=None) -> np.ndarray:
    """Rejection-sampled random landmarks (sim_node.py:177-188): uniform over
    the +/-bound box, not on an obstacle, min separation apart."""
    n = cfg.map.num_landmarks
    out = np.zeros((n, 2), np.float32)
    count = 0
    while count < n:
        pos = rng.uniform(-cfg.map.bound, cfg.map.bound, size=2)
        if occ is not None:
            i, j = tf_ekf_to_map(cfg, pos)
            if not (0 <= i < occ.shape[0] and 0 <= j < occ.shape[1]):
                continue
            if occ[i, j] < 0.5:
                continue
        if count and np.any(
            np.linalg.norm(out[:count] - pos[None], axis=1)
            < cfg.map.min_landmark_separation
        ):
            continue
        out[count] = pos
        count += 1
    return out


def random_landmarks_batched(
    cfg, rng: np.random.Generator, batch: int, occ=None
) -> np.ndarray:
    """(B, N, 2) random landmark maps, vectorized redraw-until-clean; any
    stragglers after 8 rounds fall back to the exact sampler."""
    n = cfg.map.num_landmarks
    pts = rng.uniform(-cfg.map.bound, cfg.map.bound, size=(batch, n, 2)).astype(
        np.float32
    )

    def bad_mask(p):
        d = np.linalg.norm(p[:, :, None, :] - p[:, None, :, :], axis=-1)
        iu = np.triu_indices(n, 1)
        bad = np.zeros((batch, n), bool)
        close = d < cfg.map.min_landmark_separation
        # mark the later of each too-close pair for redraw
        bad[:, iu[1]] |= close[:, iu[0], iu[1]]
        if occ is not None:
            i = (cfg.grid_shift - p[:, :, 1] / cfg.grid_scale).astype(int)
            j = (cfg.grid_shift + p[:, :, 0] / cfg.grid_scale).astype(int)
            i = np.clip(i, 0, occ.shape[0] - 1)
            j = np.clip(j, 0, occ.shape[1] - 1)
            bad |= occ[i, j] < 0.5
        return bad

    for _ in range(8):
        bad = bad_mask(pts)
        if not bad.any():
            break
        redraw = rng.uniform(-cfg.map.bound, cfg.map.bound, size=(batch, n, 2))
        pts = np.where(bad[:, :, None], redraw, pts).astype(np.float32)
    else:
        for wi in np.argwhere(bad_mask(pts).any(axis=1)).ravel():
            pts[wi] = random_landmarks(cfg, rng, occ)
    return pts
