"""Seconds a study of the program's ``les.pg.gn.system`` spans: each
Gauss-Newton step's system (the Schur system, P1's factor and the reduced
right-hand side), summed over the traced studies and divided by their
number."""

from benchmarks import spans


def read(ctx):
    return spans.seconds_per_study(ctx, "les.pg.gn.system")
