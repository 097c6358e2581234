"""Tracing and throughput utilities of the port.

Counterpart of ``live_ekf_slam_tpu/utils/profiling.py``:

- ``trace(log_dir)``: context manager around any region; writes a Chrome
  trace of the CPU and, on a card, the CUDA activity into ``log_dir``.
- ``Throughput``: steps/sec(/world) counter for run loops.
- The fused EKF and RI-EKF rollouts' ``profile_mode`` ("sim", "nolm", "full")
  attributes a rollout's time to the simulator, the predict and the landmark
  loop (``ops/fused_rollout.py``); ``live_ekf_slam_tpu_torch/tools`` times the
  primitives of a tick one by one.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a block: ``with trace("out"): run()``
    writes ``<log_dir>/trace_<n>.json``, to be opened in a Chrome trace
    viewer; yields the profiler. A kernel that is launched through ``ctypes``,
    as this package's are, may show no device time in it: CUDA events around
    the launch are the record of a kernel's time (``chip_smoke.timed_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(f.startswith("trace_") for f in os.listdir(log_dir))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


class Throughput:
    """Steps/sec(/world) counter with exponential smoothing."""

    def __init__(self, n_worlds: int = 1, alpha: float = 0.2):
        self.n_worlds = n_worlds
        self.alpha = alpha
        self.rate = None
        self._t = None
        self._steps = 0

    def tick(self, steps: int = 1):
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / max(now - self._t, 1e-9)
            self.rate = (
                inst if self.rate is None
                else self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._t = now
        self._steps += steps
        return self.rate

    @property
    def steps_per_sec_per_world(self):
        return self.rate

    @property
    def aggregate_steps_per_sec(self):
        return None if self.rate is None else self.rate * self.n_worlds
