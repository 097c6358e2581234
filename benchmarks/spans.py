"""The program's own spans in a trace: the ``les.*`` names that
``live_ekf_slam_tpu_torch/utils/profiling.span`` records while the profiler
runs, as CPU events on the trace's clock. Where the program records no such
span (a version without them), every function here finds nothing and its
reader returns None."""

from __future__ import annotations

import numpy as np


def intervals(trace, name: str) -> np.ndarray:
    """(M, 2) ns intervals of the spans called ``name``, clipped to the
    window; those wholly outside it are dropped."""
    idx = [i for i, n in enumerate(trace.cpu_names) if n == name]
    s = np.clip(trace.cpu_start[idx], trace.w0, trace.w1)
    e = np.clip(trace.cpu_end[idx], trace.w0, trace.w1)
    keep = e > s
    return np.stack([s[keep], e[keep]], axis=1)


def seconds_per_study(ctx, name: str) -> float | None:
    """Summed seconds of the spans called ``name`` over the traced studies."""
    if ctx.trace is None:
        return None
    iv = intervals(ctx.trace, name)
    if not len(iv):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9 / ctx.records["studies"]
