"""Seconds of a study's bulk solve, the program's phase clock
(``info["seconds"]["solve"]``), averaged over the traced studies."""

import numpy as np


def read(ctx):
    return float(np.mean([p["solve"] for p in ctx.records["phases"]]))
