"""Worlds x ticks of every rollout the window completed, over the window's
host-clock seconds."""


def read(ctx):
    r = ctx.records
    return r["rollouts"] * r["worlds"] * r["ticks"] / r["window_s"]
