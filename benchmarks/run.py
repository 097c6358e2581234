"""Run one cell of the benchmark and print its result line.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernel library, the cell's scenario
and a warm-up at its shapes) is timed from the start of this module to the
first timed work as ``setup_s``. The window then runs for ``--seconds``;
with ``--trace 1`` it runs under the profiler and the cell's per-layer
metrics are read from the trace and the program's phase clocks, with
``--trace 0`` its end-to-end metrics. After the window the device memory
peak is read, the program's state is freed and the check compares what the
window produced with the plain reference (see the cell's driver). The last
lines on standard error and the last key of the result line give each
number compared beside its limit. Without as many CUDA devices as the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmarks import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "live_ekf_slam_tpu")
# build and kernel caches stay inside the checkout, at fixed paths
CACHE = spec.ROOT / ".bench_cache"


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``live_ekf_slam_tpu_torch`` is not ``live_ekf_slam_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def peaks(kind: str) -> dict | None:
    return json.loads((spec.HERE / "peaks.json").read_text()).get(kind)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str, program=None, t_start: float = T_START,
             conf: dict | None = None, traffic: dict | None = None) -> dict:
    """The result object of one run of ``cell`` on ``device``. ``program``,
    ``conf`` and ``traffic`` replace the program's entry, the configuration
    and the traffic mix (the tests' broken programs and the CPU dry run's
    small sizes)."""
    import torch

    from benchmarks.trace import Tracer

    log(f"imports {time.perf_counter() - t_start:.3f} s")
    conf = conf or spec.config(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    drv = spec.driver(conf["driver"])
    run = drv.Cell(conf, traffic, seed, device, program=program)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    tracer = Tracer(trace)
    rec = run.window(seconds, tracer)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(records=rec, trace=tracer.trace, run=run,
                          peaks=peaks(kind) if cuda else None)
    metrics = {}
    for m in spec.metrics_of(cell["name"], bench, "per_layer" if trace else "end_to_end"):
        value = setup_s if m["name"] == "setup_s" else spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": peak}
    out = {"correct": False, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if tracer.trace is not None:
        tr = tracer.trace
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}

    run.free()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = run.check()
    log(f"check {time.perf_counter() - t0:.1f} s")
    limits = conf["limits"]
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    out["correct"] = bool(rec["attempted"] > 0 and rec["failed"] == 0
                          and all(v["value"] <= v["limit"] for v in checked.values()))
    out["checked"] = checked
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmarks.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; the benchmark may not load JAX "
            "or the JAX package")
        return 3
    for name, v in out["checked"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    log(f"correct {out['correct']}")
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
