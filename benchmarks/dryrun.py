"""A dry run of every cell on the CPU at a tiny size.

    python -m benchmarks.dryrun [--workload NAME]

Each cell runs through ``run.run_cell`` with its configuration cut to 30
ticks, 8 worlds and a check of 2 x 4 worlds (the pose graph: one study of 4
worlds, 2 of them checked), once without and once with tracing. It
exercises the generator, the drivers, the references, the check and the
metric arithmetic; the port runs its plain versions. Its numbers are CPU
numbers: they are printed under ``cpu_dry_run``, never as device metrics.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

from benchmarks import spec
from benchmarks.run import run_cell

TICKS = 30


def tiny(cell: dict) -> tuple[dict, dict]:
    conf = copy.deepcopy(spec.config(cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    conf["params"]["num_iterations"] = TICKS
    if conf["driver"] == "fused_rollout":
        traffic["maps"] = 2 if traffic["maps"] < traffic["worlds"] else 8
        traffic["worlds"] = 8
        conf["check"] = {"rollouts": 2, "worlds_per_rollout": 4}
    else:
        traffic.update(worlds=4, world_chunk=4, trace_studies=1)
        conf["check"] = {"studies": 1, "worlds_per_study": 2}
        conf["params"]["pose_graph"]["bulk_gn_iters"] = 8
    return conf, traffic


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmarks.dryrun")
    p.add_argument("--workload", default=None)
    args = p.parse_args(argv)
    bench = spec.benchmark()
    for cell in bench["workloads"]:
        if args.workload and cell["name"] != args.workload:
            continue
        conf, traffic = tiny(cell)
        for trace in (False, True):
            out = run_cell(bench, cell, 12345, 0.2, trace, "cpu", conf=conf,
                           traffic=traffic, t_start=time.perf_counter())
            print(json.dumps({"cpu_dry_run": cell["name"], "trace": trace,
                              "not_device_metrics": out["metrics"],
                              "correct": out["correct"], "attempted": out["attempted"],
                              "checked": out["checked"]}), flush=True)


if __name__ == "__main__":
    main()
