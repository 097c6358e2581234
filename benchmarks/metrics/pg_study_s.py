"""The window's host-clock seconds over the studies it completed, every
study counted whole (the window ends with the study that crosses its
length)."""


def read(ctx):
    r = ctx.records
    return r["window_s"] / r["studies"]
