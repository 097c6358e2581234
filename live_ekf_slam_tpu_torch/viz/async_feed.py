"""Async viewer feed over the native frame ring buffer (the port's copy of
``live_ekf_slam_tpu/viz/async_feed.py``, on the port's ``native.FrameRing``).

The reference plotter decouples from the filter nodes by ROS queues and keeps
only the latest message (plotting_node.py:233-252). Here:
the device-stepping loop runs in a producer thread and pushes fixed-layout
frame snapshots into `native.FrameRing` (C++, overwrite-oldest); the
matplotlib main thread pops the NEWEST frame at its own cadence. Rendering
never stalls device work; skipped frames are counted by the ring.

Frame layout (fixed capacity, float32), configured at construction:
  header (16): [timestep, true_pose(3), est_pose(3), m_lm, has_cov,
                has_sigma, n_pg_init, n_pg_res, m_pg, n_pg_meas, pad(2)]
  landmarks:   N * 3 as (id, x, y)
  cov:         d_cov * d_cov          (covariance ellipses; 0 to disable)
  sigma:       du * (2 du + 1)        (UKF sigma points; 0 to disable)
  pose graph:  2 * (t_pg + 1) * 3 + N * 2   (initial + result pose
               histories with counts, landmark positions; 0 to disable)
  pg meas:     n_pg_meas * 2 as (pose_idx, lm_idx) measurement-connection
               pairs (newest kept on overflow; 0 to disable)

Every artist the synchronous path renders (cov ellipses, sigma points, the
pose-graph panel) round-trips through the ring (plotting_node.py:337-372,
444-455 parity).
"""

from __future__ import annotations

import numpy as np

from live_ekf_slam_tpu_torch import native
from live_ekf_slam_tpu_torch.viz.live import Frame

_HDR = 16


class AsyncFrameFeed:
    """Encode/decode viewer frames through the native ring buffer."""

    def __init__(
        self,
        n_landmark_slots: int,
        d_cov: int = 0,
        du_sigma: int = 0,
        t_pg: int = 0,
        n_slots: int = 8,
        n_pg_meas: int = 0,
    ):
        self.n = int(n_landmark_slots)
        self.d = int(d_cov)
        self.du = int(du_sigma)
        self.t_pg = int(t_pg)
        self.n_pg_meas = int(n_pg_meas)
        self.off_lm = _HDR
        self.off_cov = self.off_lm + 3 * self.n
        self.off_sig = self.off_cov + self.d * self.d
        self._sig_cols = 2 * self.du + 1
        self.off_pg = self.off_sig + self.du * self._sig_cols
        pg_floats = 2 * (self.t_pg + 1) * 3 + 2 * self.n if self.t_pg else 0
        self.off_meas = self.off_pg + pg_floats
        self.slot_floats = self.off_meas + 2 * self.n_pg_meas
        self.ring = native.FrameRing(self.slot_floats, n_slots)

    # -- producer side (compute thread) --------------------------------
    def push(self, frame: Frame) -> bool:
        buf = np.zeros(self.slot_floats, np.float32)
        buf[0] = frame.timestep
        buf[1:4] = np.asarray(frame.true_pose, np.float32)
        if frame.est_pose is not None:
            buf[4:7] = np.asarray(frame.est_pose, np.float32)
        m = 0
        if frame.landmarks is not None and len(frame.landmarks):
            m = min(len(frame.landmarks), self.n)
            buf[self.off_lm: self.off_lm + 3 * m] = np.asarray(
                frame.landmarks[:m], np.float32
            ).reshape(-1)
        buf[7] = m
        if self.d and frame.cov is not None:
            d = min(frame.cov.shape[0], self.d)
            cov = np.zeros((self.d, self.d), np.float32)
            cov[:d, :d] = np.asarray(frame.cov[:d, :d], np.float32)
            buf[self.off_cov: self.off_sig] = cov.reshape(-1)
            buf[8] = 1.0
        if self.du and frame.sigma_pts is not None:
            sig = np.zeros((self.du, self._sig_cols), np.float32)
            s = np.asarray(frame.sigma_pts, np.float32)
            sig[: s.shape[0], : s.shape[1]] = s
            buf[self.off_sig: self.off_pg] = sig.reshape(-1)
            buf[9] = 1.0
        if self.t_pg:
            off = self.off_pg
            cap = self.t_pg + 1
            for idx, hist in ((10, frame.pg_initial), (11, frame.pg_result)):
                cnt = 0
                if hist is not None and len(hist):
                    cnt = min(len(hist), cap)
                    buf[off: off + 3 * cnt] = np.asarray(
                        hist[:cnt], np.float32
                    ).reshape(-1)
                buf[idx] = cnt
                off += 3 * cap
            mpg = 0
            if frame.pg_landmarks is not None and len(frame.pg_landmarks):
                mpg = min(len(frame.pg_landmarks), self.n)
                buf[off: off + 2 * mpg] = np.asarray(
                    frame.pg_landmarks[:mpg], np.float32
                ).reshape(-1)
            buf[12] = mpg
        if self.n_pg_meas and frame.pg_meas is not None and len(frame.pg_meas):
            # keep the NEWEST pairs on overflow (the overlay accumulates
            # over the run; recent connections matter most mid-run)
            pairs = np.asarray(frame.pg_meas, np.float32)[-self.n_pg_meas:]
            cnt = pairs.shape[0]
            buf[self.off_meas: self.off_meas + 2 * cnt] = pairs.reshape(-1)
            buf[13] = cnt
        return self.ring.push(buf)

    # -- consumer side (render thread) ----------------------------------
    def pop_latest(self) -> Frame | None:
        buf = self.ring.pop_latest()
        if buf is None:
            return None
        m = int(buf[7])
        lms = (
            buf[self.off_lm: self.off_lm + 3 * m].reshape(m, 3).copy()
            if m else None
        )
        cov = None
        if self.d and buf[8] > 0:
            cov = buf[self.off_cov: self.off_sig].reshape(self.d, self.d).copy()
        sig = None
        if self.du and buf[9] > 0:
            sig = (
                buf[self.off_sig: self.off_pg]
                .reshape(self.du, self._sig_cols).copy()
            )
        pg_init = pg_res = pg_lms = None
        if self.t_pg:
            off = self.off_pg
            cap = self.t_pg + 1
            n_init = int(buf[10])
            if n_init:
                pg_init = buf[off: off + 3 * n_init].reshape(n_init, 3).copy()
            off += 3 * cap
            n_res = int(buf[11])
            if n_res:
                pg_res = buf[off: off + 3 * n_res].reshape(n_res, 3).copy()
            off += 3 * cap
            mpg = int(buf[12])
            if mpg:
                pg_lms = buf[off: off + 2 * mpg].reshape(mpg, 2).copy()
        pg_meas = None
        if self.n_pg_meas:
            cnt = int(buf[13])
            if cnt:
                pg_meas = (
                    buf[self.off_meas: self.off_meas + 2 * cnt]
                    .reshape(cnt, 2).astype(np.int64)
                )
        return Frame(
            timestep=int(buf[0]),
            true_pose=buf[1:4].copy(),
            est_pose=buf[4:7].copy(),
            landmarks=lms,
            cov=cov,
            sigma_pts=sig,
            pg_initial=pg_init,
            pg_result=pg_res,
            pg_landmarks=pg_lms,
            pg_meas=pg_meas,
        )

    @property
    def dropped(self) -> int:
        return self.ring.dropped

    def close(self):
        self.ring.close()
