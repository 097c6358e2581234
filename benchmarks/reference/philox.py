"""Philox-4x32-10 (Salmon et al., SC'11): the rollouts' noise stream.

Frozen copy of the port's ``ops/philox.philox_noise_reference``, widened so
that each column has a seed and a world of its own: key = (seed, world),
counter = (t, block, 0, 0); block k gives noise rows 4k..4k+3 of tick t.
"""

from __future__ import annotations

import torch

from benchmarks.reference.kernel_math import uniform_pm1

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
T_CHUNK = 64


def _mulhilo(a: int, b: torch.Tensor):
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    s = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v, dtype=torch.int64)
                              for v in (c0, c1, c2, c3, k0, k1))
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def noise(seeds, worlds, t_total: int, n_lm: int, device) -> torch.Tensor:
    """(T, 2N+8, S) float32 in [-1, 1): column s is world ``worlds[s]`` of
    a rollout keyed by ``seeds[s]``, as the kernels draw it."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device) & MASK32
    worlds = torch.as_tensor(worlds, dtype=torch.int64, device=device)
    rows = 2 * n_lm + 8
    n_blk = (rows + 3) // 4
    s = seeds.numel()
    out = torch.empty((t_total, rows, s), dtype=torch.float32, device=device)
    blk = torch.arange(n_blk, dtype=torch.int64, device=device)[None, :, None]
    for t0 in range(0, t_total, T_CHUNK):
        t1 = min(t0 + T_CHUNK, t_total)
        t = torch.arange(t0, t1, dtype=torch.int64, device=device)[:, None, None]
        words = philox4x32(t, blk, 0, 0, seeds[None, None], worlds[None, None])
        words = torch.stack(torch.broadcast_tensors(*words), dim=2)
        signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        out[t0:t1] = uniform_pm1(signed).reshape(t1 - t0, n_blk * 4, s)[:, :rows]
    return out
