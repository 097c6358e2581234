"""Fused EKF-SLAM rollouts over a fixed scenario, noise seeds swept.

Set-up makes the scenario (maps and command streams) with the benchmark's
generator, from the traffic's ``scenario_seed`` or, where that is null,
from the run's seed, and hands it to the program; the window
runs ``eval.runner.fused_rollout`` (K1) back to back, each rollout with a
fresh noise seed, and brings each rollout's per-world ``err_sum`` and
``err_max`` back to the host, where the divergence latch is applied as
``run_monte_carlo`` applies it. Each rollout is timed on the device's clock
by CUDA events, from before the launch to the end of the copies back.

The check draws, from the run's seed, rollouts of the window and worlds of
each, works out their noise again (``reference/philox``) and runs the plain
reference rollout over them (``reference/ekf_rollout``): the program's
per-world average error, maximum error and divergence flag are held
against the reference's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmarks import scenario
from benchmarks.params import namespace, port_config
from benchmarks.reference import ekf_rollout, philox
from benchmarks.trace import span

SEED_SPAN = 2 ** 31 - 1
SEEDS_AHEAD = 1 << 17
GAP_INF = 1e30  # the gap of an answer that is not finite (JSON has no infinity)


def latch(err_sum: np.ndarray, err_max: np.ndarray, ticks: int, radius: float):
    """(per-world average error, diverged): the runner's divergence latch
    on the running maximum of the error."""
    err = err_sum / ticks
    return err, ~np.isfinite(err_max) | (err_max > radius) | ~np.isfinite(err)


class Cell:
    def __init__(self, conf: dict, traffic: dict, seed: int, device, program=None):
        """Set-up: the library, the scenario and a warm-up rollout at the
        cell's shapes. ``program`` replaces the program's rollout (tests
        pass a broken one)."""
        from live_ekf_slam_tpu_torch.eval.runner import fused_rollout
        from live_ekf_slam_tpu_torch.ops import _build
        from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

        self.conf, self.traffic, self.device = conf, traffic, torch.device(device)
        self.cfg = port_config(conf["params"])
        self.ref_cfg = namespace(conf["params"])
        self.program = program or fused_rollout
        self.rng = np.random.default_rng(seed)
        self.check_rng = np.random.default_rng([seed, 1])
        self._sample = None
        pin_fp32()
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.load()
        t1 = time.perf_counter()
        scenario_seed = traffic["scenario_seed"]
        if scenario_seed is None:
            scenario_seed = int(self.rng.integers(SEED_SPAN))
        self.lms, self.cmds = scenario.inputs(
            self.ref_cfg, traffic["worlds"], traffic["maps"], traffic["relabel"],
            scenario_seed, self.device)
        t2 = time.perf_counter()
        self.ticks = self.cmds.shape[1]
        self.worlds = self.lms.shape[0]
        cuda = self.device.type == "cuda"
        self.host = [torch.empty(self.worlds, dtype=torch.float32, pin_memory=cuda)
                     for _ in range(2)]
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        self._rollout(int(self.rng.integers(SEED_SPAN)))
        print(f"set-up: library {t1 - t0:.3f} s, scenario {t2 - t1:.3f} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
        self.records = {}

    def _rollout(self, seed: int):
        """One rollout: (err_sum, err_max) on the host and its device ms."""
        cuda = self.device.type == "cuda"
        if cuda:
            e0, e1 = self.events
            e0.record()
        with span("bench.rollout.launch"):
            out = self.program(self.cfg, self.lms, self.cmds, seed)
        with span("bench.rollout.readback"):
            self.host[0].copy_(out["err_sum"], non_blocking=cuda)
            self.host[1].copy_(out["err_max"], non_blocking=cuda)
            if cuda:
                e1.record()
                e1.synchronize()
        ms = e0.elapsed_time(e1) if cuda else float("nan")
        return self.host[0].numpy().copy(), self.host[1].numpy().copy(), ms

    def window(self, seconds: float, tracer):
        seeds, sums, maxes, lat = [], [], [], []
        # drawn ahead: far more than a window's rollouts
        draws = self.rng.integers(SEED_SPAN, size=SEEDS_AHEAD).tolist()
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                seed = draws[len(seeds)]
                s, m, ms = self._rollout(seed)
                seeds.append(seed)
                sums.append(s)
                maxes.append(m)
                lat.append(ms)
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        bad = sum(not np.isfinite(s).any() for s in sums)
        self.records = dict(attempted=len(seeds), failed=bad,
                            rollouts=len(seeds), worlds=self.worlds, ticks=self.ticks,
                            window_s=window_s, latency_ms=np.array(lat), seeds=seeds,
                            err_sum=np.stack(sums), err_max=np.stack(maxes))
        print(f"window {len(seeds)} rollouts in {window_s:.3f} s: {1e3 * window_s / len(seeds):.3f} "
              f"ms a rollout, latency median {np.median(lat):.3f} ms", file=sys.stderr)
        return self.records

    def sample(self):
        """(rollout index, world index) pairs of the check, drawn from the
        run's seed."""
        chk = self.conf["check"]
        n = self.records["rollouts"]
        picks = self.check_rng.choice(n, size=min(chk["rollouts"], n), replace=False)
        self._sample = [(int(r), int(w)) for r in np.sort(picks) for w in
                        np.sort(self.check_rng.choice(self.worlds, chk["worlds_per_rollout"],
                                                      replace=False))]
        return self._sample

    def reference(self, pairs, dtype=torch.float32):
        """The reference's (err_sum, err_max) for the (rollout, world) pairs."""
        seeds = [self.records["seeds"][r] for r, _ in pairs]
        worlds = [w for _, w in pairs]
        idx = torch.as_tensor(worlds, device=self.device)
        noise = philox.noise(seeds, worlds, self.ticks, self.lms.shape[1], self.device)
        ref = ekf_rollout.rollout(self.ref_cfg, self.lms[idx], self.cmds[idx], noise, dtype=dtype)
        return (ref["err_sum"].float().cpu().numpy(), ref["err_max"].float().cpu().numpy())

    def free(self):
        """Drop what the program holds on the device before the check."""
        self.host = None

    def compared(self, pairs, got, ref) -> dict:
        """The numbers the check compares: the widest relative gaps of the
        per-world average and maximum error over the worlds the reference
        keeps (a value that is not finite is a gap of GAP_INF), and the
        worlds whose divergence flag differs."""
        radius = self.conf["divergence_radius"]
        e_p, d_p = latch(got[0], got[1], self.ticks, radius)
        e_r, d_r = latch(ref[0], ref[1], self.ticks, radius)

        def rel(a, b):
            d = np.abs(a[~d_r].astype(np.float64) - b[~d_r]) / b[~d_r]
            return float(np.max(np.where(np.isfinite(d), d, GAP_INF), initial=0.0))

        return {"err_rel_gap": rel(e_p, e_r), "err_max_rel_gap": rel(got[1], ref[1]),
                "diverged_mismatch": int((d_p != d_r).sum()), "worlds_compared": len(pairs)}

    def check(self, control: bool = False) -> dict:
        """The compared numbers of this run's sample; with ``control`` the
        reference in bfloat16 stands in the program's place."""
        pairs = self.sample()
        ref = self.reference(pairs)
        if control:
            got = self.reference(pairs, dtype=torch.bfloat16)
        else:
            got = tuple(np.array([self.records[k][r, w] for r, w in pairs])
                        for k in ("err_sum", "err_max"))
        return self.compared(pairs, got, ref)
