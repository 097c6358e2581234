"""Seconds of a study's accumulation: the program's phase clocks of the
streams, the EKF secondary (K3) and the graph assembly, averaged over the
traced studies."""

import numpy as np


def read(ctx):
    return float(np.mean([p["streams"] + p["secondary"] + p["assemble"]
                          for p in ctx.records["phases"]]))
