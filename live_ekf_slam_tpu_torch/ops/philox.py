"""Philox-4x32-10 counter-based generator in torch: the rollout's noise stream.

The TPU kernel draws its simulator noise from the core's own generator
(``pltpu.prng_seed`` / ``prng_random_bits``), which no other device can
reproduce. The port uses Philox-4x32-10 (Salmon et al., SC'11, the Random123
generator) instead, written out by hand in ``csrc/philox.cuh`` for the kernel
and here in int64 torch arithmetic, so the plain version can replay exactly
the stream the kernel draws.

Stream layout: key = (seed, world), counter = (t, block, 0, 0). Block ``k``
gives noise rows 4k..4k+3 of tick ``t``; each 32-bit word, read as a signed
int32, maps to [-1, 1) through ``uniform_pm1``. ``philox_noise`` lays the
draws out as the rollout's injected-noise tensor (T, 2N+8, B): on a CUDA
tensor it launches the standalone kernel of ``csrc/philox_noise.cu``, on the
CPU it runs ``philox_noise_reference``.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.kernel_math import uniform_pm1

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
T_CHUNK = 64  # ticks per batch of int64 temporaries in the plain version


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b, for a constant a and int64 b in
    [0, 2^32). The 64-bit product would overflow int64, so it is built from
    a's two 16-bit halves."""
    p_lo = b * (a & 0xFFFF)          # < 2^48
    p_hi = b * (a >> 16)             # < 2^48
    s = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32 on int64 tensors (or ints) holding uint32 values;
    returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v, dtype=torch.int64)
                              for v in (c0, c1, c2, c3, k0, k1))
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits read as signed int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words)


# launches of the philox_noise kernel (not of the plain version)
launches = 0


def philox_noise_reference(seed: int, t_total: int, n_lm: int, batch: int,
                           device=None) -> torch.Tensor:
    """(T, 2N+8, B) float32 noise in [-1, 1): exactly what the rollout kernel
    draws in-kernel for this seed. Plain torch, built T_CHUNK ticks at a
    time to bound the int64 temporaries."""
    rows = 2 * n_lm + 8
    n_blk = (rows + 3) // 4
    out = torch.empty((t_total, rows, batch), dtype=torch.float32,
                      device=device)
    blk = torch.arange(n_blk, dtype=torch.int64, device=device)[None, :, None]
    world = torch.arange(batch, dtype=torch.int64, device=device)[None, None]
    key0 = int(seed) & MASK32
    for t0 in range(0, t_total, T_CHUNK):
        t1 = min(t0 + T_CHUNK, t_total)
        t = torch.arange(t0, t1, dtype=torch.int64, device=device)[:, None, None]
        words = philox4x32(t, blk, 0, 0, key0, world)
        words = torch.stack(torch.broadcast_tensors(*words), dim=2)
        vals = uniform_pm1(to_int32(words))  # (t, n_blk, 4, B)
        out[t0:t1] = vals.reshape(t1 - t0, n_blk * 4, batch)[:, :rows]
    return out


def philox_noise(seed: int, t_total: int, n_lm: int, batch: int,
                 device="cpu") -> torch.Tensor:
    """``philox_noise_reference``'s tensor, from the CUDA kernel when
    ``device`` is a CUDA device."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return philox_noise_reference(seed, t_total, n_lm, batch, device)
    if device.type != "cuda":
        raise ValueError(f"philox_noise runs on cpu or cuda, not {device}")
    out = torch.empty((t_total, 2 * n_lm + 8, batch), dtype=torch.float32,
                      device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.les_philox_noise(int(seed) & MASK32, t_total, n_lm, batch,
                                  out.data_ptr(), stream)
    _build.check(rc, "philox_noise kernel")
    launches += 1
    return out
