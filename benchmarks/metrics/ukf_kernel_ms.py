"""Device milliseconds of the fused UKF-SLAM rollout kernel (K4), averaged
over the traced window's launches, from the profiler trace by kernel name."""

import numpy as np

KERNEL = "fused_ukf_rollout_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.kernel_seconds(lambda name: KERNEL in name)
    return 1e3 * float(np.mean(s)) if s else None
