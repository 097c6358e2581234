"""What the fused UKF-SLAM rollout must do on given inputs.

A frozen copy of ``chip_smoke.gate_counts`` (its UKF terms) and the one
copy of the UKF-SLAM operation count, which ``chip_smoke.work`` calls
(``chip_smoke.gate_counts`` keeps its own replay, which counts every
filter's events in one pass; ``tests/test_bench_ukf_slam.py`` holds the two
replays equal): the filter's events (updates, insertions, the active
dimension n_act = 4 + 2 (landmarks seen before the tick) and its powers, a
tick and an update) replayed from the simulator and the kernels' Philox
stream, times the operations each event costs as the kernel's algebra
spells it; bytes are each input read once and each output written once
(the noise is drawn in the kernel).
"""

from __future__ import annotations

import torch

from benchmarks.reference import philox
from benchmarks.reference.kernel_math import atan2, wrap
from benchmarks.reference.ukf_rollout import kernel_params

KEYS = ("updates", "insertions", "visible", "act1", "act2", "act3", "act1u", "act2u")


def gate_counts(cfg, lms, cmds, seeds, worlds) -> dict:
    """Counts summed over worlds and ticks; column w of (lms, cmds) is world
    ``worlds[w]`` of a rollout keyed by ``seeds[w]``."""
    b, n, _ = lms.shape
    t_total = cmds.shape[1]
    noise = philox.noise(seeds, worlds, t_total, n, lms.device)
    kp = kernel_params(cfg)
    tx = torch.full((b,), kp.x0, dtype=torch.float32, device=lms.device)
    ty = torch.full_like(tx, kp.y0)
    tth = torch.full_like(tx, kp.yaw0)
    seen = torch.zeros((b, n), dtype=torch.bool, device=lms.device)
    tot = {k: torch.zeros((), dtype=torch.float64, device=lms.device) for k in KEYS}
    for t in range(t_total):
        u = noise[t]
        d_n = torch.clamp(cmds[:, t, 0] + kp.v00s * u[0], 0.0, kp.d_max)
        h_n = torch.clamp(cmds[:, t, 1] + kp.v11s * u[1], -kp.th_max, kp.th_max)
        tx = tx + d_n * torch.cos(tth)
        ty = ty + d_n * torch.sin(tth)
        tth = tth + h_n
        dx = lms[:, :, 0] - tx[:, None]
        dy = lms[:, :, 1] - ty[:, None]
        r = torch.sqrt(dx * dx + dy * dy)
        beta = wrap(atan2(dy, dx) - tth[:, None])
        vis = (r <= kp.r_max) & (beta > kp.fov_min) & (beta < kp.fov_max)
        n_act = (4 + 2 * seen.sum(dim=1)).to(torch.float64)
        n_upd = (vis & seen).sum(dim=1).to(torch.float64)
        for key, v in (("updates", n_upd), ("insertions", (vis & ~seen).sum(dim=1)),
                       ("visible", vis.sum(dim=1)), ("act1", n_act), ("act2", n_act ** 2),
                       ("act3", n_act ** 3), ("act1u", n_upd * n_act),
                       ("act2u", n_upd * n_act ** 2)):
            tot[key] += v.sum()
        seen |= vis
    out = {k: float(v) for k, v in tot.items()}
    out["ticks"] = float(b * t_total)
    return out


def work(g: dict, b: int, t_total: int, n: int) -> tuple[float, float]:
    """(flops, bytes) of a UKF-SLAM rollout of ``b`` worlds whose events are
    ``g`` (counted over the same ``b`` worlds)."""
    ticks = g["ticks"]
    sense = 40.0 * n * ticks + 20.0 * ticks  # per landmark and tick; truth, error
    # per tick over the n_act active dimensions: Cholesky n^3/3, four
    # triangular matvecs (4 n^2), sigma rows and sums (~130 n); per update:
    # two triangular matvecs (2 n^2), half a Joseph pass of ~15 flops an
    # entry (7.5 n^2), z-stats and sums (~200 n); insertion ~30
    flops = sense + g["act3"] / 3.0 + 4.0 * g["act2"] + 130.0 * g["act1"] \
        + 9.5 * g["act2u"] + 200.0 * g["act1u"] + g["insertions"] * 30.0
    du = 4 + 2 * n
    nbytes = 4.0 * (b * t_total * 2 + b * n * 2) + 4.0 * b * (du * du + du + 8) + b * n
    return flops, nbytes
