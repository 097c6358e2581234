"""95th percentile over every rollout of the window of its time from before
the launch to its per-world results in host memory, on the device's clock
(CUDA events; a 10 ms rollout is below what the host clock resolves)."""

import numpy as np


def read(ctx):
    lat = ctx.records["latency_ms"]
    if not len(lat) or not np.isfinite(lat).all():
        return None
    return float(np.percentile(lat, 95))
