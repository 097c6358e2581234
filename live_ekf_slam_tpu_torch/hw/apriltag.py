"""Hardware landmark frontend: AprilTag detections -> [id, range, bearing].

Rebuild of landmark_detection_pkg/src/tag_detection_node.py: converts 3-D tag
poses (translation + quaternion, as published by an AprilTag detector) into
the same flat [id, r, b]* measurement format the simulator emits, so real
camera detections can drive the filters as a drop-in for the sim's `/landmark`
stream (tag_detection_node.py:28-64). We assume landmarks are orientation
invariant, like the reference.

Note the reference computes the bearing as ``tan(t_y / t_z)``
(tag_detection_node.py:57) — almost certainly a typo for atan2. Default here
is the correct planar bearing; `compat_tan_bearing=True` reproduces the
reference formula.

The port's copy of ``live_ekf_slam_tpu/hw/apriltag.py``: the numpy parts as
they are; the measurement slots are the port's batched ``Measurements`` of
one world, and the replay steps the per-tick filters of ``eval/runner`` at
B = 1 on a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from live_ekf_slam_tpu_torch.core.types import Measurements


def quat_to_mat(w, x, y, z):
    """Rotation matrix from a (w, x, y, z) quaternion."""
    n = math.sqrt(w * w + x * x + y * y + z * z) or 1.0
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


_TAG_FAMILIES = (
    "tagStandard52h13", "tagStandard41h12", "tag36h11", "tag25h9",
    "tag16h5", "tagCustom48h12", "tagCircle21h7", "tagCircle49h12",
)


@dataclass
class DetectorSettings:
    """AprilTag detector configuration, the reference's
    landmark_detection_pkg/config/settings.yaml schema (apriltag_ros
    parameter names) — loads the reference file unchanged."""

    tag_family: str = "tag36h11"
    tag_threads: int = 2
    tag_decimate: float = 1.0
    tag_blur: float = 0.0
    tag_refine_edges: int = 1
    tag_debug: int = 0
    max_hamming_dist: int = 2
    publish_tf: bool = True
    transport_hint: str = "raw"

    def __post_init__(self):
        if self.tag_family not in _TAG_FAMILIES:
            raise ValueError(
                f"unknown tag_family {self.tag_family!r}; "
                f"options: {_TAG_FAMILIES}"
            )
        if self.max_hamming_dist < 0:
            raise ValueError("max_hamming_dist must be >= 0")

    @classmethod
    def from_yaml(cls, path):
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {k: raw[k] for k in cls.__dataclass_fields__ if k in raw}
        return cls(**known)


@dataclass
class StandaloneTag:
    """One entry of tags.yaml's standalone_tags (id, size in meters,
    optional name)."""

    id: int
    size: float
    name: str | None = None


@dataclass
class TagRegistry:
    """The reference's landmark_detection_pkg/config/tags.yaml schema:
    standalone tag definitions (+ tag bundles, carried but unused like the
    reference's empty list). Only registered tags become landmark
    measurements — the detector-side id filter the reference delegates to
    apriltag_ros."""

    standalone_tags: list = None
    tag_bundles: list = None

    def __post_init__(self):
        self.standalone_tags = [
            t if isinstance(t, StandaloneTag) else StandaloneTag(**t)
            for t in (self.standalone_tags or [])
        ]
        self.tag_bundles = list(self.tag_bundles or [])
        ids = [t.id for t in self.standalone_tags]
        if len(ids) != len(set(ids)):
            raise ValueError("duplicate tag ids in standalone_tags")

    @classmethod
    def from_yaml(cls, path):
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls(
            standalone_tags=raw.get("standalone_tags", []),
            tag_bundles=raw.get("tag_bundles", []),
        )

    @property
    def ids(self):
        return {t.id for t in self.standalone_tags}

    def size_of(self, tag_id: int):
        for t in self.standalone_tags:
            if t.id == tag_id:
                return t.size
        return None

    def filter_detections(self, detections):
        """Keep only detections of registered tags (unknown ids are noise —
        apriltag_ros only estimates poses for configured tags)."""
        return [d for d in detections if d.tag_id in self.ids]


def load_detector_config(settings_path, tags_path):
    """Load the reference's (settings.yaml, tags.yaml) pair unchanged."""
    return DetectorSettings.from_yaml(settings_path), TagRegistry.from_yaml(
        tags_path
    )


@dataclass
class TagDetection:
    tag_id: int
    translation: tuple  # (x, y, z) in the camera frame
    quaternion: tuple = (1.0, 0.0, 0.0, 0.0)  # (w, x, y, z)


def detections_to_measurements(
    detections, compat_tan_bearing: bool = False
):
    """AprilTag detections -> flat [id, r, b]* list (tag_detection_node.py:28-64)."""
    out = []
    for det in detections:
        t = det.translation
        rng = math.hypot(t[0], t[1])
        if compat_tan_bearing:
            b = math.tan(t[1] / t[2]) if t[2] != 0 else 0.0
        else:
            b = math.atan2(t[1], t[0])
        out += [float(det.tag_id), rng, b]
    return out


def se3(translation, quaternion=(1.0, 0.0, 0.0, 0.0)) -> np.ndarray:
    """(t, q) -> 4x4 affine (the reference's pose-from-tf construction,
    tag_detection_node.py:67-91)."""
    T = np.eye(4)
    T[:3, :3] = quat_to_mat(*quaternion)
    T[:3, 3] = translation
    return T


class FrameTransforms:
    """Static frame registry replacing the reference's tf lookup
    (tag_detection_node.py:67-91, get_transform(TF_TO, TF_FROM)).

    Without ROS there is no live transform service; fixed mounting
    transforms (e.g. camera -> base_link) are registered once and looked up
    by frame pair, with the inverse direction derived automatically.
    Returns None for unknown pairs, like the reference's failed lookup.
    """

    def __init__(self):
        self._t: dict[tuple[str, str], np.ndarray] = {}

    def register(self, tf_to: str, tf_from: str, transform: np.ndarray):
        self._t[(tf_to, tf_from)] = np.asarray(transform, float)

    def get_transform(self, tf_to: str, tf_from: str):
        if tf_to == tf_from:
            return np.eye(4)
        if (tf_to, tf_from) in self._t:
            return self._t[(tf_to, tf_from)]
        if (tf_from, tf_to) in self._t:
            return np.linalg.inv(self._t[(tf_from, tf_to)])
        return None


def transform_detections(detections, T):
    """Re-express detections' translations in another frame (the intended
    use of the reference's TF helper: camera-frame tag poses -> robot base
    frame before the range/bearing conversion)."""
    out = []
    for det in detections:
        p = T @ np.array([*det.translation, 1.0])
        out.append(
            TagDetection(
                tag_id=det.tag_id,
                translation=tuple(p[:3]),
                quaternion=det.quaternion,
            )
        )
    return out


def replay_detection_log(cfg, log, cmds, filter_name="ekf_slam", T_base_cam=None,
                         device=None):
    """Feed a recorded per-tick AprilTag detection log through a filter.

    log: list over ticks of lists of TagDetection (camera frame);
    cmds: (T, 2) commanded odometry aligned with the log. This closes the
    hardware loop the reference only sketches (tag_detection_node publishes
    /landmark/apriltag but nothing subscribes): recorded detections drive
    the same filters the simulator does, one world (B = 1) on ``device``
    (the card by default; ``eval.runner.resolve_device``). Returns the
    filter's final state (batched, B = 1) and the (T, 3) per-tick poses.
    """
    from live_ekf_slam_tpu_torch.eval.runner import (
        _filter_init, _filter_pose, _filter_update, resolve_device,
    )
    from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

    pin_fp32()
    device = resolve_device(device)
    k = cfg.num_meas_slots
    state = _filter_init(cfg, filter_name, 1, device)
    cmds = torch.as_tensor(np.asarray(cmds, np.float32), device=device)
    poses = []
    for t, dets in enumerate(log):
        if T_base_cam is not None:
            dets = transform_detections(dets, T_base_cam)
        meas = flat_to_measurement_slots(detections_to_measurements(dets), k,
                                         device)
        state = _filter_update(cfg, filter_name, state, cmds[t][None], meas)
        poses.append(_filter_pose(filter_name, state)[0])
    if not poses:
        return state, np.zeros((0, 3))
    return state, torch.stack(poses).cpu().numpy()


def flat_to_measurement_slots(flat, k_slots: int, device="cpu") -> Measurements:
    """Flat [id, r, b]* -> the filters' fixed-capacity Measurements of one
    world (every field with a leading axis of 1) on ``device``."""
    n = len(flat) // 3
    ids = np.full(k_slots, -1, np.int32)
    r = np.zeros(k_slots, np.float32)
    b = np.zeros(k_slots, np.float32)
    valid = np.zeros(k_slots, bool)
    for j in range(min(n, k_slots)):
        ids[j] = int(flat[3 * j])
        r[j] = flat[3 * j + 1]
        b[j] = flat[3 * j + 2]
        valid[j] = True

    def t(a):
        return torch.as_tensor(a[None], device=device)

    return Measurements(ids=t(ids), r=t(r), b=t(b), valid=t(valid),
                        overflow=t(np.asarray(n > k_slots)))
