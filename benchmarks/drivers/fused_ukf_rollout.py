"""Fused UKF-SLAM rollouts over a fixed scenario, noise seeds swept.

Set-up, the window, the readback and the latency are those of
``drivers/fused_rollout`` (``Cell``), whose program entry
``eval.runner.fused_rollout`` runs K4 for a configuration whose filter is
``ukf_slam``.

The check differs, because UKF-SLAM worlds go chaotic (ROADMAP F6): once a
world's covariance turns indefinite, its clamped Cholesky pivots and its
sanity gate turn on the last bits, and two roundings of the same algebra
(the card's fused multiply-adds against the reference's separate roundings)
follow different estimates, metres apart in a few worlds by T = 1000. A
world-by-world check like the EKF cell's would fail on sound runs. So the
reference decides, by itself, which worlds it can hold one by one: it runs
the sampled worlds on their Philox noise and again on that noise scaled by
each of NUDGES, and a world is chaotic when a nudge alone moves its average
error by more than CHAOS_SHARE of CHAOS_TOL, or when any of these runs'
sanity gate refused an update. The other worlds are calm. The program plays
no part in that split, and no world is chosen by what the program gave:
this is the filter's own chaos, not a choice of data that hides a defect.

Compared, over the calm worlds the reference keeps: the widest relative
gaps of the per-world average and maximum error (a value that is not
finite is a gap of GAP_INF), and, over every calm world, the worlds whose
divergence latch differs. Over every sampled world the reference keeps,
chaotic ones included: the relative gap of the median average error. The
gaps of the mean average error and of the diverged shares are reported
beside them (both move with the chaotic worlds in sound runs), and
``worlds_calm`` beside ``worlds_compared``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmarks.drivers import fused_rollout
from benchmarks.drivers.fused_rollout import GAP_INF, latch
from benchmarks.reference import philox, ukf_rollout

# The nudges of the noise that name chaotic worlds: each moves the
# measurements by ~1e-7 m, the size of a float32 rounding of a metre-scale
# state (chip_smoke.NUDGE); two, of both signs, because a world that one
# leaves alone may still part under rounding (on an H100: 4 such worlds in
# 15 seeds with the first alone, none with both).
NUDGES = (1.0 + 2.0 ** -16, 1.0 - 2.0 ** -16)
# A world is chaotic when a nudge moves its average error by more than
# CHAOS_SHARE of atol + rtol |error| (chip_smoke's CHAOS_RATIO of PT_CARD_TOL,
# the per-tick path's card-against-CPU criterion): 1e-7 m + 1e-4 of it.
CHAOS_SHARE = 0.1
CHAOS_TOL = (1e-6, 1e-3)


def chaotic(err, rejects, nudged) -> np.ndarray:
    """(S,) bool: the worlds the reference cannot hold one by one, from its
    average errors and refusals and those, ``nudged``, of its runs with the
    noise scaled by each of NUDGES."""
    atol, rtol = CHAOS_TOL
    out = rejects > 0
    for e, r in nudged:
        out |= ~(np.abs(e - err) <= CHAOS_SHARE * (atol + rtol * np.abs(err))) | (r > 0)
    return out


def _gap(a, b):
    """|a - b| / b in float64, GAP_INF where it is not finite."""
    d = np.abs(a.astype(np.float64) - b) / b
    return np.where(np.isfinite(d), d, GAP_INF)


def compare(got, ref, calm: np.ndarray, ticks: int, radius: float) -> dict:
    """The numbers the check compares: ``got`` and ``ref`` are (err_sum,
    err_max) of the same sampled worlds, ``calm`` the worlds the reference
    holds one by one."""
    e_p, d_p = latch(got[0], got[1], ticks, radius)
    e_r, d_r = latch(ref[0], ref[1], ticks, radius)
    kept = ~d_r
    held = kept & calm
    with np.errstate(invalid="ignore", divide="ignore"):
        gap_err, gap_max = _gap(e_p, e_r), _gap(got[1], ref[1])
        e_p_inf = np.where(np.isfinite(e_p), e_p, np.inf)
        med_r = float(np.median(e_r[kept])) if kept.any() else 0.0
        med_p = float(np.median(e_p_inf[kept])) if kept.any() else 0.0
        mean_r = float(np.mean(e_r[kept], dtype=np.float64)) if kept.any() else 0.0
        mean_p = float(np.mean(e_p[kept], dtype=np.float64)) if kept.any() else 0.0
    median_gap = abs(med_p - med_r) / med_r if med_r > 0 else 0.0
    mean_gap = abs(mean_p - mean_r) / mean_r if mean_r > 0 else 0.0
    return {"calm_err_rel_gap": float(np.max(gap_err[held], initial=0.0)),
            "calm_err_max_rel_gap": float(np.max(gap_max[held], initial=0.0)),
            "calm_diverged_mismatch": int((calm & (d_p != d_r)).sum()),
            "median_err_rel_gap": median_gap if np.isfinite(median_gap) else GAP_INF,
            "mean_err_rel_gap": mean_gap if np.isfinite(mean_gap) else GAP_INF,
            "diverged_share_gap": abs(float(d_p.mean()) - float(d_r.mean())),
            "worlds_calm": int(calm.sum()), "worlds_compared": len(calm)}


class Cell(fused_rollout.Cell):
    def reference(self, pairs, dtype=torch.float32, nudged: bool = False):
        """The reference's (err_sum, err_max, update_rejects) for the
        (rollout, world) pairs; with ``nudged`` also a list of those of the
        same worlds with their noise scaled by each of NUDGES, all run in
        one batch."""
        seeds = [self.records["seeds"][r] for r, _ in pairs]
        worlds = [w for _, w in pairs]
        idx = torch.as_tensor(worlds, device=self.device)
        noise = philox.noise(seeds, worlds, self.ticks, self.lms.shape[1], self.device)
        lms, cmds = self.lms[idx], self.cmds[idx]
        k = 1 + len(NUDGES) if nudged else 1
        if nudged:
            noise = torch.cat([noise] + [noise * s for s in NUDGES], dim=2)
        ref = ukf_rollout.rollout(self.ref_cfg, lms.repeat(k, 1, 1), cmds.repeat(k, 1, 1),
                                  noise, dtype=dtype)
        out = [tuple(v) for v in zip(*(ref[key].float().cpu().numpy().reshape(k, -1)
                                       for key in ("err_sum", "err_max", "update_rejects")))]
        return (out[0], out[1:]) if nudged else out[0]

    def check(self, control: bool = False) -> dict:
        """The compared numbers of this run's sample; with ``control`` the
        reference in bfloat16 stands in the program's place. The sample,
        the reference's answers and its calm worlds are drawn and computed
        once a run, so the control is read on the program's sample."""
        if self._sample is None:
            pairs = self.sample()
            ref, nudged = self.reference(pairs, nudged=True)
            self._held = ref, ~chaotic(ref[0] / self.ticks, ref[2],
                                       [(e / self.ticks, r) for e, _, r in nudged])
        pairs = self._sample
        ref, calm = self._held
        if control:
            got = self.reference(pairs, dtype=torch.bfloat16)[:2]
        else:
            got = tuple(np.array([self.records[k][r, w] for r, w in pairs])
                        for k in ("err_sum", "err_max"))
        out = compare(got, ref[:2], calm, self.ticks, self.conf["divergence_radius"])
        print(f"check: {out['worlds_calm']} calm of {out['worlds_compared']} worlds compared, "
              f"{out['calm_diverged_mismatch']} calm latches differ; widest calm gaps "
              f"{out['calm_err_rel_gap']:.3g} (average), {out['calm_err_max_rel_gap']:.3g} "
              f"(maximum); mean's gap "
              f"{out['mean_err_rel_gap']:.3g}; diverged shares' gap {out['diverged_share_gap']:.3g}",
              file=sys.stderr)
        return out
