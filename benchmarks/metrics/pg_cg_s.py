"""Seconds a study of the program's ``les.pg.gn.cg`` spans: each
Gauss-Newton step's CG loop (the first preconditioner solve and every CG
step: P2, P1's solve and the torch passes between them), summed over the
traced studies and divided by their number."""

from benchmarks import spans


def read(ctx):
    return spans.seconds_per_study(ctx, "les.pg.gn.cg")
