"""Tracing of the port: spans and counters on the profiler's clock, and the
Chrome-trace exporter.

- ``span(name)``: a context around one layer's work. While a
  ``torch.profiler`` is recording it is ``record_function(name)``, so the
  span lands in the profiler's trace beside the device activity and on its
  clock; otherwise it is one shared no-op context and creates nothing. The
  port's spans are named ``les.<layer>`` (the library's C prefix), apart
  from a caller's own.
- ``count(name, value)``: adds ``value``, a Python int or a 0-d tensor, to a
  counter while a profiler is recording (a tensor is summed on its device
  and not read back); ``counters()`` reads them as host ints after the
  traced window. ``tracing()`` says whether a profiler is recording, for a
  caller whose value costs work to compute.
- ``trace(log_dir)``: context manager around any region; writes a Chrome
  trace of the CPU and, on a card, the CUDA activity into ``log_dir``, the
  ``les.*`` spans among them.
- The fused EKF and RI-EKF rollouts' ``profile_mode`` ("sim", "nolm", "full")
  attributes a rollout's time to the simulator, the predict and the landmark
  loop (``ops/fused_rollout.py``); ``live_ekf_slam_tpu_torch/tools`` times the
  primitives of a tick one by one.

torch is imported inside the functions that need it: with torch not loaded,
no profiler can be recording.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

_OFF = contextlib.nullcontext()
# counter name -> its sum (a Python int, or a tensor on the device it counts)
_COUNTERS: dict = {}
_LOCK = threading.Lock()


def tracing() -> bool:
    """Whether a torch profiler is recording in this process."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def span(name: str):
    """``with span("les.<layer>"):`` records the block as a span while a
    profiler is recording; otherwise a shared no-op context."""
    if not tracing():
        return _OFF
    return sys.modules["torch.autograd.profiler"].record_function(name)


def count(name: str, value) -> None:
    """Adds ``value`` (an int or a 0-d tensor) to the counter ``name`` while
    a profiler is recording; nothing otherwise. Threads may count at once
    (a sharded rollout drives each card from a thread of its own); a tensor
    joins the counter on the device of the counter's first tensor."""
    if tracing():
        with _LOCK:
            prev = _COUNTERS.get(name, 0)
            if hasattr(prev, "device") and hasattr(value, "device"):
                value = value.to(prev.device)
            _COUNTERS[name] = prev + value


def counters() -> dict[str, int]:
    """Every counter as a host int (reading a device counter synchronises).
    The counters only grow: a caller compares readings or takes ratios."""
    return {name: int(v) for name, v in _COUNTERS.items()}


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
