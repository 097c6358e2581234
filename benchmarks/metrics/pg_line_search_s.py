"""Seconds a study of the program's ``les.pg.gn.line_search`` spans: each
Gauss-Newton step's landmark back-substitution, both trial points and their
graph errors, the accept and the damping update, summed over the traced
studies and divided by their number."""

from benchmarks import spans


def read(ctx):
    return spans.seconds_per_study(ctx, "les.pg.gn.line_search")
