"""P1's share of its roofline, factor and solve together: each launch's
bytes (``counts/posegraph_bytes``) over peak HBM bytes/s, summed over the
traced launches of both kernels, over their summed device time."""

from benchmarks.counts import posegraph_bytes


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    fac = ctx.trace.kernel_seconds(lambda name: "block_thomas_factor_kernel" in name)
    sol = ctx.trace.kernel_seconds(lambda name: "block_thomas_solve_kernel" in name)
    if not fac or not sol:
        return None
    b = min(ctx.run.traffic["world_chunk"], ctx.run.worlds)
    t = ctx.run.ref_cfg.num_iterations
    nbytes = (len(fac) * posegraph_bytes.block_thomas_factor(b, t)
              + len(sol) * posegraph_bytes.block_thomas_solve(b, t))
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / (sum(fac) + sum(sol))
