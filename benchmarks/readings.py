"""The two readings a limit is set from, on the card.

    python3 -m benchmarks.readings --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--seconds 3]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the check's numbers of the program and, for the control
seeds, of the control (the reference in bfloat16 in the program's place,
on the same sample). One JSON line a seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmarks import spec
from benchmarks.trace import Tracer


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmarks.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("the readings need a CUDA device")
    cell = spec.cell(args.workload, spec.benchmark())
    conf, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    drv = spec.driver(conf["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = drv.Cell(conf, traffic, seed, "cuda")
        run.window(args.seconds, Tracer(False))
        run.free()
        t1 = time.perf_counter()
        out = {"workload": args.workload, "seed": seed,
               "attempted": run.records["attempted"], "program": run.check()}
        out["check_s"] = time.perf_counter() - t1
        if seed in args.control_seeds:
            out["control"] = run.check(control=True)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
