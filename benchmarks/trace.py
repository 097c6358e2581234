"""The device trace of a traced run, and what the metric readers take from it.

``Tracer`` runs the window under ``torch.profiler`` (CPU and CUDA activity)
inside a span named ``bench.window``. From the raw events it keeps each
device activity's name and interval (kernels, copies, sets), the CPU events
(the benchmark's own ``bench.*`` spans and the operators under them) and
the window's bounds on the trace's clock. Busy time is the union of the
device intervals inside the window, so overlapping work is counted once.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its trailing parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() or name
    return name


class Trace:
    def __init__(self, events):
        dev, cpu = [], []
        w0 = w1 = None
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not (e.is_user_annotation() or e.name().startswith("bench.")):
                    # (a host span mirrored on the device is no device work)
                    dev.append((e.name(), start, end))
            else:
                if e.name() == WINDOW_SPAN:
                    w0, w1 = start, end
                cpu.append((e.name(), start, end))
        if w0 is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        self.w0, self.w1 = w0, w1
        self.window_s = (w1 - w0) * 1e-9
        self.dev_names = [n for n, _, _ in dev]
        self.dev_start = np.array([s for _, s, _ in dev], dtype=np.int64)
        self.dev_end = np.array([e for _, _, e in dev], dtype=np.int64)
        self.cpu_names = [n for n, _, _ in cpu]
        self.cpu_start = np.array([s for _, s, _ in cpu], dtype=np.int64)
        self.cpu_end = np.array([e for _, _, e in cpu], dtype=np.int64)

    def kernel_seconds(self, match) -> list[float]:
        """Device seconds of each device activity whose name satisfies
        ``match``, in launch order, inside the window."""
        out = []
        for i in np.argsort(self.dev_start, kind="stable"):
            if self.dev_start[i] >= self.w0 and self.dev_end[i] <= self.w1 \
                    and match(self.dev_names[i]):
                out.append((self.dev_end[i] - self.dev_start[i]) * 1e-9)
        return out

    def busy_intervals(self) -> np.ndarray:
        """(M, 2) disjoint sorted ns intervals: the union of device activity
        clipped to the window."""
        s = np.clip(self.dev_start, self.w0, self.w1)
        e = np.clip(self.dev_end, self.w0, self.w1)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return np.zeros((0, 2), dtype=np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > e[:-1]
        idx = np.flatnonzero(new)
        starts = s[idx]
        ends = np.append(e[idx[1:] - 1], e[-1])
        return np.stack([starts, ends], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def device_ops(self) -> list:
        """The TOP device activities by summed seconds in the window."""
        tot = defaultdict(float)
        inside = (self.dev_start >= self.w0) & (self.dev_end <= self.w1)
        for i in np.flatnonzero(inside):
            tot[_short(self.dev_names[i])] += (self.dev_end[i] - self.dev_start[i]) * 1e-9
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:TOP]

    def idle_gaps(self, scan: int = 200) -> list:
        """The TOP idle gaps' seconds, summed by what the host was doing at
        each gap's middle: the benchmark span and the innermost operator
        under it (the ``scan`` longest gaps are looked at)."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.w0], iv.ravel(), [self.w1]]).reshape(-1, 2)
        lens = edges[:, 1] - edges[:, 0]
        tot = defaultdict(float)
        for i in np.argsort(-lens)[:scan]:
            if lens[i] <= 0:
                break
            mid = (edges[i, 0] + edges[i, 1]) // 2
            cover = np.flatnonzero((self.cpu_start <= mid) & (self.cpu_end >= mid))
            spans = [j for j in cover if self.cpu_names[j].startswith("bench.")
                     and self.cpu_names[j] != WINDOW_SPAN]
            ops = [j for j in cover if not self.cpu_names[j].startswith("bench.")]
            span = min(spans, key=lambda j: self.cpu_end[j] - self.cpu_start[j]) if spans else None
            op = min(ops, key=lambda j: self.cpu_end[j] - self.cpu_start[j]) if ops else None
            name = " / ".join(self.cpu_names[j] for j in (span, op) if j is not None) or "host idle"
            tot[name] += lens[i] * 1e-9
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:TOP]


class Tracer:
    """``with tracer.window():`` profiles what runs inside; ``trace`` is the
    ``Trace`` afterwards, or None without tracing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None

    @contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                yield
        self.trace = Trace(prof.profiler.kineto_results.events())


def span(name: str):
    """A benchmark span around a call into one layer of the program."""
    return torch.profiler.record_function(name)
