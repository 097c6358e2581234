"""K4's share of its roofline: the least time the H100 could take for a
UKF-SLAM rollout (the larger of its operations over peak float32 FLOP/s and
its bytes over peak HBM bytes/s, counted by ``counts/ukf_rollout_work`` on
the cell's scenario with the first two traced rollouts' noise seeds), over
the kernel's mean device time in the trace."""

import torch

from benchmarks.counts import ukf_rollout_work

KERNEL = "fused_ukf_rollout_kernel"
SEEDS_COUNTED = 2


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    s = ctx.trace.kernel_seconds(lambda name: KERNEL in name)
    if not s:
        return None
    run = ctx.run
    b, n = run.lms.shape[:2]
    bounds = []
    for seed in ctx.records["seeds"][:SEEDS_COUNTED]:
        g = ukf_rollout_work.gate_counts(run.ref_cfg, run.lms, run.cmds, [seed] * b,
                                         torch.arange(b))
        flops, nbytes = ukf_rollout_work.work(g, b, run.ticks, n)
        bounds.append(max(flops / ctx.peaks["fp32_flops_per_s"],
                          nbytes / ctx.peaks["hbm_bytes_per_s"]))
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(s) / len(s))
