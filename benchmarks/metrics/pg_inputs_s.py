"""Seconds of a study's inputs phase (maps and command streams), the
program's own phase clock (``info["seconds"]["inputs"]``, ended by a device
synchronise), averaged over the traced studies."""

import numpy as np


def read(ctx):
    return float(np.mean([p["inputs"] for p in ctx.records["phases"]]))
