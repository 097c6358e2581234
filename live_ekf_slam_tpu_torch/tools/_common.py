"""What the three microbenchmark tools share: arguments, inputs, timing and
the printed row."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from live_ekf_slam_tpu_torch.eval.runner import resolve_device
from live_ekf_slam_tpu_torch.ops import micro_ops
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32

WORLDS = 4096  # the bench's batch
DIM = 48       # D = 43 (EKF) and Du = 44 (UKF) at N = 20, padded as the JAX scripts pad
REPS = 5


def parse_args(prog: str, description: str, argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--worlds", type=int, default=WORLDS)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu, which "
                        "runs the plain versions")
    p.add_argument("--passes", type=int, default=None,
                   help="passes per launch for every row (default: per row, "
                        "sized so that a launch takes 1-50 ms at 4096 worlds)")
    return p.parse_args(argv)


def start(args) -> torch.device:
    """The device the tool runs on: the card, unless ``--device cpu``."""
    pin_fp32()
    return resolve_device(args.device)


def normal(rng: np.random.Generator, shape, scale: float, device) -> torch.Tensor:
    """float32 normals times ``scale``, drawn with numpy, on ``device``."""
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.as_tensor(a, device=device)


def time_op(fn, device: torch.device, reps: int) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def case(name: str, op: str, args: tuple, passes: int, per_pass_elems: int,
         **meta) -> dict:
    """One operation to time: ``getattr(micro_ops, op)(*args)`` is one launch
    of ``passes`` passes, each over ``per_pass_elems`` elements of the batch;
    ``meta`` names the variant."""
    return {"name": name, "op": op, "args": args, "passes": passes,
            "per_pass_elems": per_pass_elems, **meta}


def timed_row(c: dict, device: torch.device, reps: int) -> dict:
    """Time a case: its launch's median milliseconds, microseconds per pass
    and the elements it updated per second; the case's other fields stay,
    its tensors go."""
    seconds = time_op(lambda: getattr(micro_ops, c["op"])(*c["args"]), device, reps)
    passes = c["passes"]
    out = {k: v for k, v in c.items() if k != "args"}
    out.update(ms=seconds * 1e3, us_per_pass=seconds / passes * 1e6,
               g_elem_per_s=c["per_pass_elems"] * passes / seconds / 1e9)
    return out


def print_per_pass(rows: list, width: int) -> None:
    for r in rows:
        print(f"{r['name']:{width}s} {r['us_per_pass']:8.2f} us/pass   "
              f"{r['g_elem_per_s']:9.2f} G elem-op/s", flush=True)
