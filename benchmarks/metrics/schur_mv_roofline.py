"""P2's share of its roofline: each launch's bytes (``counts/
posegraph_bytes.schur_mv`` at the study's shapes: every input read once,
S v written) over peak HBM bytes/s, summed over the traced launches, over
their summed device time in the trace."""

from benchmarks.counts import posegraph_bytes

KERNEL = "schur_mv_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    s = ctx.trace.kernel_seconds(lambda name: KERNEL in name)
    if not s:
        return None
    cfg = ctx.run.ref_cfg
    b = min(ctx.run.traffic["world_chunk"], ctx.run.worlds)
    nbytes = posegraph_bytes.schur_mv(b, cfg.num_iterations, cfg.num_meas_slots,
                                      cfg.num_landmark_slots)
    return 100.0 * len(s) * nbytes / ctx.peaks["hbm_bytes_per_s"] / sum(s)
