"""Device activities (kernels, copies, sets) a Gauss-Newton step: those that
start inside the program's ``les.pg.solve`` spans (each ends in a device
synchronise, so none spills out), over the number of its ``les.pg.gn``
spans. Nothing without device activity in the trace."""

import numpy as np

from benchmarks import spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not len(tr.dev_start):
        return None
    solve = spans.intervals(tr, "les.pg.solve")
    steps = len(spans.intervals(tr, "les.pg.gn"))
    if not len(solve) or not steps:
        return None
    inside = np.zeros(len(tr.dev_start), dtype=bool)
    for s, e in solve:
        inside |= (tr.dev_start >= s) & (tr.dev_start < e)
    return float(inside.sum()) / steps
