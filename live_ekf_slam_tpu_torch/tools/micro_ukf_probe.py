"""Probe: where the UKF operations part from the downdate's rate.

    python3 -m live_ekf_slam_tpu_torch.tools.micro_ukf_probe [--worlds 4096] [--device cuda]

Counterpart of ``scripts/micro_ukf_probe.py``. In one harness: the EKF rank-2
downdate as the reference point, the Joseph expression built up term by term
(1, 2, 4 and all 7 outer-product terms), and the matvec in its three orders:
by rows with a per-lane sequential dot, by columns (L^T g) with lane-strided
partial sums and a butterfly, and unrolled into D rank-1 terms added onto the
output. One line per operation: microseconds per pass over the batch (median
of 5, CUDA events) and G element-operations per second. Inputs come
from ``np.random.default_rng(0)``. Runs on the card and fails without one,
unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import numpy as np

from live_ekf_slam_tpu_torch.ops import micro_ops
from live_ekf_slam_tpu_torch.tools import _common

DOWNDATE_N = 2000
JOSEPH_N = 2000
MATVEC_N = {"row": 4000, "col": 2000, "unrolled": 4000}
TERMS = (1, 2, 4, 7)
MATVEC_NAMES = {"row": "matvec by rows (sequential dot)",
                "col": "matvec by columns (L^T g, butterfly)",
                "unrolled": "matvec unrolled rank-1"}


def cases(worlds: int, device, passes: int | None = None,
          dim: int = _common.DIM) -> list:
    """The operations this tool times, one ``_common.case`` per line."""
    rng = np.random.default_rng(0)
    p = _common.normal(rng, (worlds, dim, dim), 1.0, device)
    k = _common.normal(rng, (worlds, 4, dim), 0.01, device)
    s = _common.normal(rng, (worlds, 3), 1.0, device).abs()
    kk, hh = k[:, :2].contiguous(), k[:, 2:].contiguous()
    k0, k1, cr, cb = (k[:, i].contiguous() for i in range(4))
    g = k[:, :1].contiguous()
    elems = worlds * dim * dim
    out = []

    n = passes or DOWNDATE_N
    out.append(_common.case("rank-2 downdate", "rank_update", (p, kk, hh, n), n,
                            2 * elems, variant="R=2 (probe)", rank=2))
    n = passes or JOSEPH_N
    for nt in TERMS:
        out.append(_common.case(f"joseph terms={nt}", "joseph",
                                (p, k0, k1, cr, cb, s, n, "terms", nt), n, elems,
                                variant=f"terms={nt}", spelling="terms",
                                n_terms=nt))
    for order in micro_ops.MATVEC_ORDERS:
        n = passes or MATVEC_N[order]
        out.append(_common.case(MATVEC_NAMES[order], "matvec", (p, g, n, order),
                                n, elems, variant=order, order=order))
    return out


def run(worlds: int, device, reps: int = _common.REPS, passes: int | None = None,
        dim: int = _common.DIM) -> list:
    """Time every operation; returns one ``_common.timed_row`` per line."""
    return [_common.timed_row(c, device, reps)
            for c in cases(worlds, device, passes, dim)]


def main(argv=None) -> int:
    args = _common.parse_args("live_ekf_slam_tpu_torch.tools.micro_ukf_probe",
                              "Joseph terms and matvec orders against the downdate",
                              argv)
    device = _common.start(args)
    d = _common.DIM
    print(f"shapes: P=({args.worlds},{d},{d}) f32 on {device}",
          flush=True)
    _common.print_per_pass(
        run(args.worlds, device, passes=args.passes), 44)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
