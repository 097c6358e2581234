"""Bytes the pose graph's bulk solve kernels must move in one call.

Frozen from ``tools/kernel_ab.schur_mv_bytes`` and ``chip_smoke``'s
``block_thomas_main_shape`` counts: every input read once, every output
written once, float32 (4 bytes) and int32 slot indices. A batch of ``b``
worlds, graphs of T ticks (T + 1 nodes), K measurement slots a tick and N
landmark slots.
"""

from __future__ import annotations


def schur_mv(b: int, t: int, k: int, n: int) -> float:
    """P2: five (B, T, K) coefficient arrays, the chain blocks d (B, T+1, 3,
    3) and u (B, T, 3, 3), the landmark inverses (B, N, 3), the slot map
    (B, K), v read and S v written (B, T+1, 3)."""
    return 4.0 * (5 * b * t * k + 9 * b * (t + 1) + 9 * b * t + 3 * b * n + b * k
                  + 2 * 3 * b * (t + 1))


def block_thomas_factor(b: int, t: int) -> float:
    """P1's factor: d and u read, sinv (B, T+1, 3, 3), l and the scaled u
    (B, T, 3, 3) and the scales (B, T+1, 3) written."""
    d, u = 9 * b * (t + 1), 9 * b * t
    return 4.0 * (2 * d + 3 * u + 3 * b * (t + 1))


def block_thomas_solve(b: int, t: int) -> float:
    """P1's solve: sinv, l and u read with the scales and the rhs, x written."""
    return 4.0 * (9 * b * (t + 1) + 2 * 9 * b * t + 9 * b * (t + 1))
