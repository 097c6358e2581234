"""Landmark maps and occupancy grids, in numpy.

A copy of ``live_ekf_slam_tpu/sim/maps.py``: importing that module runs
``live_ekf_slam_tpu/sim/__init__.py``, which imports the simulator and so
jax. The fixed maps are the same float32 constants, and given the same
``np.random.Generator`` the random maps are bit-identical (the tests hold
both to that). ``DEMO_MAP`` and ``IGVC1_BARRELS`` are data constants of the
reference world definitions (sim_node.py:26-30 and sim_node.py:190).

``load_occ_map`` reads the map images of the JAX package's assets
(``live_ekf_slam_tpu/assets/maps``, as data) without Pillow: ``sim/png``
decodes the PNG and copies Pillow's bilinear reduce bit for bit, so the grid
equals the JAX package's Pillow path exactly.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from live_ekf_slam_tpu_torch.sim.png import read_png, resize_bilinear

# RSS demo landmark map (20 landmarks), sim_node.py:26-30.
DEMO_MAP = np.array(
    [
        (6.2945, 8.1158), (-7.4603, 8.2675), (2.6472, -8.0492), (-4.4300, 0.9376),
        (9.1501, 9.2978), (-6.8477, 9.4119), (9.1433, -0.2925), (6.0056, -7.1623),
        (-1.5648, 8.3147), (5.8441, 9.1898), (3.1148, -9.2858), (6.9826, 8.6799),
        (3.5747, 5.1548), (4.8626, -2.1555), (3.1096, -6.5763), (4.1209, -9.3633),
        (-4.4615, -9.0766), (-8.0574, 6.4692), (3.8966, -3.6580), (9.0044, -9.3111),
    ],
    dtype=np.float32,
)

# IGVC course barrel positions (37 landmarks), sim_node.py:190.
IGVC1_BARRELS = np.array(
    [
        (8.16017316017316, -8.037518037518037), (7.727272727272725, -5.324675324675325),
        (8.419913419913419, -2.813852813852815), (8.910394265232974, -2.6695526695526706),
        (5.909090909090908, -1.2842712842712842), (6.457431457431456, -1.0822510822510836),
        (7.813852813852813, 0.3318903318903317), (6.688311688311687, 2.4675324675324664),
        (8.679653679653677, 5.064935064935064), (7.3232323232323235, 6.68109668109668),
        (8.535353535353535, 8.239538239538238), (5.995670995670993, 9.393939393939394),
        (0.7720057720057714, 5.728715728715727), (0.7142857142857135, 5.20923520923521),
        (2.7633477633477614, 4.458874458874458), (2.445887445887445, 4.141414141414142),
        (1.1183261183261166, 2.871572871572871), (0.916305916305916, 2.525252525252524),
        (2.5901875901875897, 1.9480519480519476), (2.6767676767676765, -3.795093795093795),
        (0.9740259740259738, -3.679653679653681), (-0.7287157287157289, -4.978354978354979),
        (-3.1818181818181834, -4.7186147186147185), (-2.129032258064516, -2.121212121212121),
        (-3.4992784992784998, -0.6493506493506498), (-1.5656565656565675, 1.5440115440115427),
        (-1.2770562770562783, 2.4098124098124085), (-2.0274170274170285, 3.9971139971139955),
        (-1.5079365079365097, 4.1991341991342), (-4.451659451659452, 4.805194805194805),
        (-7.9148629148629155, 3.1024531024531026), (-7.597402597402598, 1.0533910533910529),
        (-7.1067821067821075, 0.9668109668109661), (-7.53968253968254, -2.092352092352092),
        (-7.251082251082252, -4.054834054834055), (-9.040404040404042, -5.440115440115441),
        (-7.04906204906205, -7.373737373737375),
    ],
    dtype=np.float32,
)


# the map images are the JAX package's assets, read as data
ASSET_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "live_ekf_slam_tpu", "assets", "maps"))


def tf_ekf_to_map(cfg, pt):
    """World (x, y) -> occupancy grid (row, col); truncates toward zero."""
    i = int(cfg.grid_shift - pt[1] / cfg.grid_scale)
    j = int(cfg.grid_shift + pt[0] / cfg.grid_scale)
    return [i, j]


def tf_map_to_ekf(cfg, pt):
    """Occupancy grid (row, col) -> world (x, y)."""
    return [
        (pt[1] - cfg.grid_shift) * cfg.grid_scale,
        -(pt[0] - cfg.grid_shift) * cfg.grid_scale,
    ]


def blank_occ_map(cfg) -> np.ndarray:
    """All-free grid (the blank.jpg world)."""
    s = cfg.map.occ_map_size
    return np.ones((s, s), dtype=np.float32)


def _balloon(occ: np.ndarray, amt: int) -> np.ndarray:
    """Dilate obstacles by ``amt`` cells in every direction
    (sim_node.py:286-299): the reference's index-clamped writes stay inside
    the grid, so this is binary dilation with a (2 amt + 1)^2 kernel."""
    out = occ.copy()
    blocked = occ < 0.5
    s = occ.shape[0]
    for di in range(-amt, amt + 1):
        for dj in range(-amt, amt + 1):
            if di == 0 and dj == 0:
                continue
            shifted = np.zeros_like(blocked)
            src = blocked[
                max(0, -di): s - max(0, di), max(0, -dj): s - max(0, dj)
            ]
            shifted[max(0, di): s + min(0, di), max(0, dj): s + min(0, dj)] = src
            out[shifted] = 0.0
    return out


@functools.lru_cache(maxsize=8)
def _image(path: str) -> np.ndarray:
    """The decoded image, read once a process (read-only)."""
    arr = read_png(path)
    arr.flags.writeable = False
    return arr


def load_occ_map(cfg):
    """Image file -> (occ_grid {0=blocked,1=free}, color_map)
    (sim_node.py:255-315): alpha as white, the bilinear reduce to
    occ_map_size^2, the ITU-R 601 grayscale, threshold > 200, the balloon.
    ``blank.jpg`` is the all-free grid; other images must be 8-bit RGB or
    RGBA PNGs (``sim/png.read_png`` raises for the rest)."""
    name = cfg.occ_map_img
    if name in (None, "", "blank.jpg", "blank"):
        occ = blank_occ_map(cfg)
        color = np.full(
            (cfg.map.occ_map_size, cfg.map.occ_map_size, 3), 255, np.uint8
        )
        return occ, color
    path = name if os.path.isabs(name) else os.path.join(ASSET_DIR, name)
    arr = _image(path)
    if arr.shape[2] == 4:
        # Treat transparency as white: add inverted alpha to each channel,
        # clipping (sim_node.py:264-267).
        a1 = 255 - arr[:, :, 3].astype(np.int32)
        rgb = np.clip(arr[:, :, :3].astype(np.int32) + a1[:, :, None], 0, 255)
        arr = rgb.astype(np.uint8)
    color = arr.copy()

    s = cfg.map.occ_map_size
    small = np.asarray(resize_bilinear(arr, s, s), dtype=np.float32)
    # Grayscale with the standard ITU-R 601 weights (cv2 BGR2GRAY equivalent).
    gray = 0.299 * small[:, :, 0] + 0.587 * small[:, :, 1] + 0.114 * small[:, :, 2]
    occ = (gray > 200).astype(np.float32)  # threshold 200 then floor-to-binary
    occ = _balloon(occ, cfg.map.occ_map_balloon_amt)
    return occ.astype(np.float32), color


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


def grid_landmarks(cfg) -> np.ndarray:
    """Landmarks on a regular grid filling the bounds (sim_node.py:167-176)."""
    shift = cfg.map.grid_step / 2.0
    coords = np.arange(-cfg.map.bound + shift, cfg.map.bound, cfg.map.grid_step)
    pts = [(r, c) for r in coords for c in coords]
    return np.array(pts, dtype=np.float32)


def make_landmarks(cfg, rng: np.random.Generator | None = None, occ=None):
    """(landmarks (N, 2) float32, n_active) for ``cfg.landmark_map``, as
    sim_node.generate_landmarks dispatches."""
    kind = cfg.landmark_map
    if kind == "demo":
        lms = DEMO_MAP
    elif kind == "grid":
        lms = grid_landmarks(cfg)
    elif kind in ("random", "rand"):
        rng = rng or np.random.default_rng()
        lms = random_landmarks(cfg, rng, occ)
    elif kind == "igvc1":
        lms = IGVC1_BARRELS
    else:
        raise ValueError(f"Invalid landmark_map {kind!r}")
    return lms.astype(np.float32), lms.shape[0]
