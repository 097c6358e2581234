"""Share of the traced window in which no device activity ran (the window
less the union of kernel, copy and set intervals); nothing without device
activity in the trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not len(tr.dev_start):
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
