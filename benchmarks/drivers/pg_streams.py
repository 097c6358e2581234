"""Bulk pose-graph studies back to back.

Each study is ``eval.runner.run_monte_carlo_pg_streams`` on worlds of its
own seed: the program makes the maps, the command streams and the noise,
runs the simulator's streams, the EKF-SLAM secondary (K3, the fused
rollout's pose stream), assembles the graphs and solves them in bulk
(Schur-complement PCG with P1 and P2), and returns per-world errors with
the phase clocks it keeps (``info["seconds"]``). Set-up runs one study at
the cell's shapes. A traced run traces at most ``trace_studies`` studies.

The check draws, from the run's seed, studies of the window and worlds of
each and works their inputs out again from the study's seed with the
benchmark's generator (``scenario``) and Philox stream; the reference runs
the streams, the EKF rollout and the assembly as plain torch and solves
the graphs by dense float64 Gauss-Newton (``reference/posegraph``). The
program's per-world errors of the secondary, of the seeded graph and of the
solved graph, and its divergence flags, are held against the reference's.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmarks import scenario
from benchmarks.params import namespace, port_config
from benchmarks.reference import ekf_rollout, philox, posegraph, streams
from benchmarks.trace import span

SEED_SPAN = 2 ** 31 - 1
GAP_INF = 1e30  # the gap of an answer that is not finite (JSON has no infinity)
KEYS = ("err_ekf_slam", "err_pose_graph_initial", "err_pose_graph_result", "diverged_pose_graph")


class Cell:
    def __init__(self, conf: dict, traffic: dict, seed: int, device, program=None):
        from live_ekf_slam_tpu_torch.eval.runner import run_monte_carlo_pg_streams
        from live_ekf_slam_tpu_torch.ops import _build

        self.conf, self.traffic, self.device = conf, traffic, torch.device(device)
        self.cfg = port_config(conf["params"])
        self.ref_cfg = namespace(conf["params"])
        if self.cfg.pose_graph.filter_to_compare != "ekf_slam":
            raise ValueError("this driver compares an EKF-SLAM secondary")
        self.program = program or run_monte_carlo_pg_streams
        self.rng = np.random.default_rng(seed)
        self.check_rng = np.random.default_rng([seed, 1])
        self._sample = None
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.load()
        t1 = time.perf_counter()
        self.worlds = traffic["worlds"]
        self._study(int(self.rng.integers(SEED_SPAN)))
        print(f"set-up: library {t1 - t0:.3f} s, warm-up study {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)
        self.records = {}

    def _study(self, seed: int):
        with span("bench.study"):
            res, info, _ = self.program(self.cfg, self.worlds, seed=seed,
                                        world_chunk=self.traffic["world_chunk"],
                                        device=self.device)
        return {k: np.asarray(res[k]) for k in KEYS}, dict(info["seconds"])

    def window(self, seconds: float, tracer):
        cap = self.traffic["trace_studies"] if tracer.enabled else None
        seeds, results, phases = [], [], []
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                seed = int(self.rng.integers(SEED_SPAN))
                res, sec = self._study(seed)
                seeds.append(seed)
                results.append(res)
                phases.append(sec)
                if time.perf_counter() - t0 >= seconds or len(seeds) == cap:
                    break
            window_s = time.perf_counter() - t0
        for seed, sec in zip(seeds, phases):
            print(f"study {seed}: " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items()),
                  file=sys.stderr)
        bad = sum(not np.isfinite(r["err_pose_graph_result"]).any() for r in results)
        self.records = dict(attempted=len(seeds), failed=bad, studies=len(seeds),
                            worlds=self.worlds, window_s=window_s, seeds=seeds,
                            results=results, phases=phases)
        return self.records

    def free(self):
        pass

    def sample(self):
        """(study index, its worlds) of the check, drawn from the run's seed
        (once a run)."""
        if self._sample is not None:
            return self._sample
        chk = self.conf["check"]
        n = self.records["studies"]
        picks = np.sort(self.check_rng.choice(n, size=min(chk["studies"], n), replace=False))
        self._sample = [(int(s), np.sort(self.check_rng.choice(
            self.worlds, chk["worlds_per_study"], replace=False))) for s in picks]
        return self._sample

    def reference(self, pairs, dtype=torch.float32, solve_dtype=torch.float64) -> dict:
        """The reference's per-world results for the (study, worlds) pairs,
        every world in one batch: the inputs worked out again from each
        study's seed, then the streams, the EKF rollout and the assembly in
        ``dtype`` and the solve in ``solve_dtype``."""
        cfg, dev = self.ref_cfg, self.device
        lms, cmds, seeds, worlds = [], [], [], []
        for study, ws in pairs:
            seed = self.records["seeds"][study]
            l_all, c_all = scenario.inputs(cfg, self.worlds, self.worlds, False, seed, dev)
            idx = torch.as_tensor(ws, device=dev)
            lms.append(l_all[idx])
            cmds.append(c_all[idx])
            seeds += [seed] * len(ws)
            worlds += [int(w) for w in ws]
        lms, cmds = torch.cat(lms), torch.cat(cmds)
        noise = philox.noise(seeds, worlds, cfg.num_iterations, lms.shape[1], dev)
        lms, cmds, noise = lms.to(dtype), cmds.to(dtype), noise.to(dtype)
        st = streams.sim_streams(cfg, lms, cmds, noise)
        est = ekf_rollout.rollout(cfg, lms, cmds, noise, dtype=dtype, emit_traj=True)["est_traj"]
        d_sec = torch.linalg.vector_norm(est[:, :, :2] - st["poses_true"][:, :, :2], dim=-1)
        graph = streams.assemble(cfg, est, st["r"], st["b"], st["vis"], cmds)
        solver = posegraph.Graph(cfg, graph, solve_dtype)
        poses = solver.solve()
        t = cfg.num_iterations
        tr = st["poses_true"][:, :t - 1, :2].to(solve_dtype)
        err = lambda p: torch.linalg.vector_norm(p[:, 1:t, :2].to(solve_dtype) - tr, dim=-1).mean(-1)  # noqa: E731
        max_sec = d_sec.amax(dim=1).float().cpu().numpy()
        diverged = ~np.isfinite(max_sec) | (max_sec > self.conf["divergence_radius"])
        return {"err_ekf_slam": d_sec.mean(dim=1).float().cpu().numpy(),
                "err_pose_graph_initial": err(solver.g["poses_init"]).float().cpu().numpy(),
                "err_pose_graph_result": err(poses).float().cpu().numpy(),
                "diverged_pose_graph": diverged}

    def compared(self, got: dict, ref: dict) -> dict:
        """The widest per-world gaps (metres) of the secondary's, the seeded
        graph's and the solved graph's average position error over the
        worlds the reference keeps (a value that is not finite is a gap of
        GAP_INF), the median gap of the solved graph's (the widest swings
        with the float32 solve's last steps), and the worlds whose
        divergence flag differs."""
        keep = ~ref["diverged_pose_graph"]

        def gaps(key):
            d = np.abs(got[key][keep].astype(np.float64) - ref[key][keep])
            return np.where(np.isfinite(d), d, GAP_INF)

        def gap(key):
            return float(np.max(gaps(key), initial=0.0))

        return {"secondary_err_gap_m": gap("err_ekf_slam"),
                "initial_err_gap_m": gap("err_pose_graph_initial"),
                "result_err_gap_m": gap("err_pose_graph_result"),
                "result_err_median_gap_m": float(np.median(gaps("err_pose_graph_result")))
                if keep.any() else 0.0,
                "diverged_mismatch": int((got["diverged_pose_graph"]
                                          != ref["diverged_pose_graph"]).sum()),
                "worlds_compared": int(len(keep))}

    def check(self, control: bool = False) -> dict:
        """The compared numbers of this run's sample; with ``control`` the
        reference in bfloat16 stands in the program's place."""
        pairs = self.sample()
        ref = self.reference(pairs)
        if control:
            got = self.reference(pairs, torch.bfloat16, torch.bfloat16)
        else:
            got = {k: np.concatenate([self.records["results"][s][k][ws] for s, ws in pairs])
                   for k in KEYS}
        return self.compared(got, ref)
