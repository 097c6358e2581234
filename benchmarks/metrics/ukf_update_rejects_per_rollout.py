"""Updates the UKF's innovation sanity gate refused, summed over the worlds
of a rollout, per rollout: the program's counters (``utils/profiling.
counters``: ``ukf.update_rejects`` over ``ukf.rollouts``), which count only
while the profiler runs, so only the traced window. A refused update is an
update computed for nothing: the world coasts. Nothing where the program
keeps no such counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    from live_ekf_slam_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    rollouts = c.get("ukf.rollouts", 0)
    if not rollouts:
        return None
    return c.get("ukf.update_rejects", 0) / rollouts
