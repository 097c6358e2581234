"""Full-fp32 matrix products for the filter algebra.

Counterpart of ``live_ekf_slam_tpu/ops/precision.py``, which pins every
accuracy-critical contraction to ``Precision.HIGHEST`` because the TPU's
default feeds the matrix unit bf16 (a 0.3% error on a covariance insertion
block was observed there). On Hopper the hazard is TF32: a float32 product or
convolution may run with a 10-bit mantissa, about three decimal digits, which
Kalman covariance algebra cannot take. ``pin_fp32()`` turns TF32 off for
cuBLAS and cuDNN. The fused EKF rollout has no matrix product, but the
per-tick filters (UKF above all) and the pose graph do, so every entry point
calls it. ``sel_cols`` and ``first_match`` are the per-tick filters' slot
reads, spelled as the JAX package spells them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pin_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@functools.lru_cache(maxsize=None)
def constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` (a number or a tuple of numbers) as a tensor on ``device``,
    made once and kept. Made anew in every call, a constant on the card is a
    copy from pageable host memory, which synchronises the stream: in a
    per-tick loop that is a wait on the card per call. Callers must not
    write to it."""
    t = torch.tensor(value, dtype=dtype, device=device)
    if t.is_cuda:
        # made on the current stream, then read on any (a world mesh's
        # shards each have their own): complete its copy before it is handed out
        torch.cuda.current_stream(t.device).synchronize()
    return t


def reciprocal(value: float, device: torch.device) -> torch.Tensor:
    """The float32 reciprocal of ``value``, 1.0f / float32(value), as a
    constant on ``device``. XLA compiles JAX's division by a constant as a
    product with this reciprocal, so ``x * reciprocal(c, dev)`` gives the
    bits of ``x / c`` inside a jitted or scanned JAX function (the closed
    loop, a ``lax.while_loop`` body); outside one, JAX divides. torch too
    multiplies by it for a Python divisor on the card but divides on the
    CPU, so the port spells the product out to agree on both."""
    return constant(float(np.float32(1.0) / np.float32(value)), torch.float32,
                    torch.device(device))


def sel_cols(dim: int, li: torch.Tensor, k: int = 2) -> torch.Tensor:
    """(B, dim, k) one-hot selection of columns li .. li+k-1 for each world
    (the JAX package's ``sel_cols`` with a leading world axis).

    A read through it, ``(x[:, :, None] * e).sum(1)`` or a batched product,
    is exact (a single non-zero term), and like the JAX version's one-hot
    product it spreads a NaN anywhere in x to the read, where a gather would
    not: a diverged world goes non-finite on the same tick in both. An
    out-of-range li gives zero columns.
    """
    iota = torch.arange(dim, device=li.device)
    return torch.stack(
        [(iota[None, :] == (li[:, None] + j)).to(torch.float32) for j in range(k)],
        dim=2,
    )


def first_match(match: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(found (B,), i (B,)) for a (B, N) bool match: whether any slot
    matches, and the smallest matching index, 0 when none does (the JAX
    package's ``jnp.argmax`` of a bool row, which picks the first True)."""
    n = match.shape[1]
    idx = torch.arange(n, device=match.device)
    first = torch.where(match, idx, n).amin(dim=1)
    found = first < n
    return found, torch.where(found, first, 0)
