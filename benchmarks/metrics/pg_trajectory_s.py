"""Seconds a study of the program's ``les.inputs.trajectory`` spans: the
inputs phase's trajectory generator (the command streams, with the relabel
and repeat), summed over the traced studies and divided by their number."""

from benchmarks import spans


def read(ctx):
    return spans.seconds_per_study(ctx, "les.inputs.trajectory")
