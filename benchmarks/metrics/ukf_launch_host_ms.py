"""Host milliseconds of a UKF-SLAM rollout's launch path: the mean length of
the program's ``les.fused_ukf_rollout`` spans in the traced window (the
checks, the outputs' allocation, the kernel's parameters, the ctypes launch,
which returns before the kernel ends, and the counters)."""

from benchmarks import spans


def read(ctx):
    if ctx.trace is None:
        return None
    iv = spans.intervals(ctx.trace, "les.fused_ukf_rollout")
    if not len(iv):
        return None
    return 1e-6 * float((iv[:, 1] - iv[:, 0]).mean())
