"""Share of the worlds' Gauss-Newton steps whose line search was accepted,
from the program's counters (``utils/profiling.counters``: ``pg.gn_accepted``
over ``pg.gn_world_steps``), which count only while the profiler runs, so
only the traced studies. A rejected step is a step spent for nothing on its
world. Nothing where the program keeps no such counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    from live_ekf_slam_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    steps = c.get("pg.gn_world_steps", 0)
    if not steps:
        return None
    return 100.0 * c.get("pg.gn_accepted", 0) / steps
