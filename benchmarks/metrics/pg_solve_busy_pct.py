"""Share of the bulk solve in which the device was busy: the union of
device activity (``Trace.busy_intervals``) inside the program's
``les.pg.solve`` spans, over those spans' length. Nothing without device
activity in the trace."""

from benchmarks import spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not len(tr.dev_start):
        return None
    solve = spans.intervals(tr, "les.pg.solve")
    if not len(solve):
        return None
    busy = tr.busy_intervals()
    inside = 0
    for s, e in solve:
        inside += int((busy[:, 1].clip(max=e) - busy[:, 0].clip(min=s)).clip(min=0).sum())
    return 100.0 * inside / float((solve[:, 1] - solve[:, 0]).sum())
