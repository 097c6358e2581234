"""Microbenchmark: the per-tick operations of the fused UKF rollout, alone.

    python3 -m live_ekf_slam_tpu_torch.tools.micro_ukf [--worlds 4096] [--device cuda]

Counterpart of ``scripts/micro_ukf.py``: each dominant operation of a UKF-SLAM
tick (``ops/fused_ukf.py``) runs standalone, one warp per world, so that the
passes a tick must execute can be summed and held against the rollout
kernel's measured time per tick. The inventory, at Du = 44 of D = 48:

1. the pivot-loop Cholesky, every tick: (a) full-width trailing update,
   (b) trailing columns only, (c) the lower triangle only, which is the
   rollout kernel's loop;
2. the L-matvec: four per predict, two per landmark update;
3. the one-pass symmetric Joseph update, per landmark update, as the
   rollouts' nine-product expression and with the symmetric products hoisted;
4. the z-stats block (range and bearing of both sigma halves, weighted
   means, S entries), per landmark update.

One line per operation: microseconds per pass over the batch (median of
5, CUDA events) and G element-operations per second. Inputs come
from ``np.random.default_rng(0)``; the Cholesky input is symmetric positive
definite. Runs on the card and fails without one, unless ``--device cpu``
asks for the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from live_ekf_slam_tpu_torch.ops import micro_ops
from live_ekf_slam_tpu_torch.tools import _common

PAD = 4          # D - Du: the rows the JAX scripts pad to a multiple of 8
CHOL_N = 100     # factorisations per launch
MATVEC_N = 1000  # passes of MATVEC_A matvecs each
MATVEC_A = 4
JOSEPH_N = 2000
ZSTATS_N = 4000
CHOL_NAMES = {"full": "chol full-width", "trail": "chol trailing-cols",
              "lower": "chol lower-triangle (rollout)"}


def spd(rng: np.random.Generator, worlds: int, dim: int, device) -> torch.Tensor:
    """A A^T / D + I per world, from float32 normals."""
    a = rng.standard_normal((worlds, dim, dim), dtype=np.float32)
    p = np.matmul(a, a.transpose(0, 2, 1)) / np.float32(dim) + np.eye(dim, dtype=np.float32)
    return torch.as_tensor(p.astype(np.float32), device=device)


def chol_elems(variant: str, dim: int, du: int) -> int:
    """Entries the trailing updates of one factorisation walk, a world."""
    total = 0
    for j in range(du - 1):
        if variant == "lower":
            total += sum(i - j for i in range(j + 1, dim))
        else:
            c0 = 0 if variant == "full" else ((j + 1) // 8) * 8
            total += (dim - j - 1) * (dim - c0)
    return total


def cases(worlds: int, device, passes: int | None = None,
          dim: int = _common.DIM, du: int | None = None) -> list:
    """The operations this tool times, one ``_common.case`` per line; ``du``
    pivots of the ``dim`` rows (default ``dim - PAD``)."""
    rng = np.random.default_rng(0)
    du = max(dim - PAD, 1) if du is None else du
    p = spd(rng, worlds, dim, device)
    l0 = _common.normal(rng, (worlds, dim, dim), 1.0, device)
    g = _common.normal(rng, (worlds, MATVEC_A, dim), 1.0, device)
    k0 = _common.normal(rng, (worlds, dim), 0.1, device)
    k1 = _common.normal(rng, (worlds, dim), 0.1, device)
    cr = _common.normal(rng, (worlds, dim), 1.0, device)
    cb = _common.normal(rng, (worlds, dim), 1.0, device)
    s = _common.normal(rng, (worlds, 3), 1.0, device).abs()
    sp = _common.normal(rng, (worlds, 3, dim), 1.0, device)
    wm = _common.normal(rng, (worlds, dim), 1.0, device).abs()
    lm = _common.normal(rng, (worlds, 2), 1.0, device)
    elems = worlds * dim * dim
    out = []

    n = passes or CHOL_N
    for variant in micro_ops.CHOL_VARIANTS:
        out.append(_common.case(CHOL_NAMES[variant], "chol", (p, n, variant, du),
                                n, worlds * chol_elems(variant, dim, du),
                                variant=variant, du=du))
    n = passes or MATVEC_N
    out.append(_common.case("matvec_l (L @ g)", "matvec", (l0, g, n, "row"),
                            MATVEC_A * n, elems, variant=f"row x{MATVEC_A}",
                            order="row"))
    n = passes or JOSEPH_N
    for spelling in ("prod9", "hoist"):
        out.append(_common.case(f"joseph one-pass [{spelling}]", "joseph",
                                (p, k0, k1, cr, cb, s, n, spelling), n, elems,
                                variant=spelling, spelling=spelling))
    n = passes or ZSTATS_N
    out.append(_common.case("z-stats block (per landmark)", "zstats",
                            (sp, sp, lm, wm, n), n, worlds * 2 * 3 * dim,
                            variant="zstats"))
    return out


def run(worlds: int, device, reps: int = _common.REPS, passes: int | None = None,
        dim: int = _common.DIM) -> list:
    """Time every operation; returns one ``_common.timed_row`` per line."""
    return [_common.timed_row(c, device, reps)
            for c in cases(worlds, device, passes, dim)]


def main(argv=None) -> int:
    args = _common.parse_args("live_ekf_slam_tpu_torch.tools.micro_ukf",
                              "per-tick operations of the fused UKF rollout",
                              argv)
    device = _common.start(args)
    d = _common.DIM
    print(f"shapes: P=({args.worlds},{d},{d}) f32 on {device}, "
          f"{d - PAD} pivots", flush=True)
    _common.print_per_pass(
        run(args.worlds, device, passes=args.passes), 36)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
