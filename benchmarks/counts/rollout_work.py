"""What the fused EKF-SLAM rollout must do on given inputs.

A frozen copy of ``chip_smoke.gate_counts`` and the EKF branch of
``chip_smoke.work``: the filter's events (updates, insertions, the seen
block D_act = 3 + 2 (1 + the highest id seen or visible) and its square, a
tick and an update) replayed from the simulator and the kernels' Philox
stream, times the operations each event costs as the kernel's algebra
spells it; bytes are each input read once and each output written once
(the noise is drawn in the kernel).
"""

from __future__ import annotations

import torch

from benchmarks.reference import philox
from benchmarks.reference.ekf_rollout import kernel_params
from benchmarks.reference.kernel_math import atan2, wrap

KEYS = ("updates", "insertions", "visible", "dact1", "dact2", "dact1u", "dact2u")


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
    ids = torch.arange(1, n + 1, device=lms.device)
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
        n_upd = (vis & seen).sum(dim=1).to(torch.float64)
        dact = (3 + 2 * torch.where(vis | seen, ids, 0).amax(dim=1)).to(torch.float64)
        for key, v in (("updates", n_upd), ("insertions", (vis & ~seen).sum(dim=1)),
                       ("visible", vis.sum(dim=1)), ("dact1", dact), ("dact2", dact ** 2),
                       ("dact1u", n_upd * dact), ("dact2u", n_upd * dact ** 2)):
            tot[key] += v.sum()
        seen |= vis
    out = {k: float(v) for k, v in tot.items()}
    out["ticks"] = float(b * t_total)
    return out


def work(g: dict, b: int, t_total: int, n: int) -> tuple[float, float]:
    """(flops, bytes) of an EKF-SLAM rollout of ``b`` worlds whose events
    are ``g`` (counted over the same ``b`` worlds)."""
    d = 3 + 2 * n
    ticks = g["ticks"]
    sense = 40.0 * n * ticks + 20.0 * ticks
    # over the seen block D_act: predict, two rank-1 row and two column
    # passes; update, gain and H P (~34 D) and the rank-2 downdate (4 D^2);
    # insertion, two rows
    flops = (sense + 8.0 * g["dact1"] + 4.0 * g["dact2u"] + 34.0 * g["dact1u"]
             + g["insertions"] * (4.0 * d + 30.0))
    nbytes = 4.0 * (b * t_total * 2 + b * n * 2) + 4.0 * b * (d * d + d + 8) + b * n
    return flops, nbytes
