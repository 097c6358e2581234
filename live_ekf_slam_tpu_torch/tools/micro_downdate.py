"""Microbenchmark: the EKF downdate primitives on the card.

    python3 -m live_ekf_slam_tpu_torch.tools.micro_downdate [--worlds 4096] [--device cuda]

Counterpart of ``scripts/micro_downdate.py``. It answers, for one warp per
world walking a (D, D) covariance in shared memory:

1. what back-to-back rank-2 downdates of every world's covariance cost, the
   dominant operation of the fused EKF and RI-EKF rollouts;
2. whether fusing R rank-1 updates into one read-modify-write pass beats R
   separate passes;
3. what a per-world dynamic column gather costs, as a select-and-sum over
   the row and as an indexed read.

One line per operation: milliseconds per launch (median of 5, CUDA
events) and G element-updates per second over the batch. Inputs come from
``np.random.default_rng(0)``. Runs on the card and fails without one, unless
``--device cpu`` asks for the plain versions (then pass a small ``--worlds``
and ``--passes``).
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.ops import micro_ops
from live_ekf_slam_tpu_torch.tools import _common

# rank-1 updates per launch, whatever the rank per pass: passes = STEPS // R
STEPS = 8192
GATHERS = {"select": 6000, "take": 60000}  # gathers per launch
GATHER_NAMES = {"select": "select-and-sum gather", "take": "indexed-read gather"}


def cases(worlds: int, device, passes: int | None = None,
          dim: int = _common.DIM) -> list:
    """The operations this tool times, one ``_common.case`` per line."""
    rng = np.random.default_rng(0)
    p = _common.normal(rng, (worlds, dim, dim), 1e-3, device)
    idx = micro_ops.check_index(torch.as_tensor(
        rng.integers(0, dim, worlds).astype(np.int32), device=device), dim)
    elems = worlds * dim * dim
    out = []
    # 1/2: rank-R fused passes, the same total rank per launch
    for rank in micro_ops.RANKS:
        n = passes or STEPS // rank
        k = _common.normal(rng, (worlds, rank, dim), 1e-4, device)
        h = _common.normal(rng, (worlds, rank, dim), 1e-4, device)
        out.append(_common.case(f"rank-{rank:<2d} fused x{n} passes",
                                "rank_update", (p, k, h, n), n, rank * elems,
                                variant=f"R={rank}", rank=rank))
    # 3: per-world dynamic column gather
    for spelling, default in GATHERS.items():
        n = passes or default
        out.append(_common.case(f"{GATHER_NAMES[spelling]} x{n}",
                                "column_gather", (p, idx, n, spelling), n, elems,
                                variant=spelling, spelling=spelling))
    return out


def run(worlds: int, device, reps: int = _common.REPS, passes: int | None = None,
        dim: int = _common.DIM) -> list:
    """Time every operation; returns one ``_common.timed_row`` per line."""
    return [_common.timed_row(c, device, reps)
            for c in cases(worlds, device, passes, dim)]


def main(argv=None) -> int:
    args = _common.parse_args("live_ekf_slam_tpu_torch.tools.micro_downdate",
                              "EKF downdate primitives, one warp per world",
                              argv)
    device = _common.start(args)
    d = _common.DIM
    print(f"shapes: P=({args.worlds},{d},{d}) f32 on {device}; "
          f"per pass = {args.worlds * d * d} elems", flush=True)
    for r in run(args.worlds, device, passes=args.passes):
        print(f"{r['name']:34s} {r['ms']:8.2f} ms   "
              f"{r['g_elem_per_s']:9.2f} G elem-updates/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
