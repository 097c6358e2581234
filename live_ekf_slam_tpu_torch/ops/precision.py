"""Full-fp32 matrix products for the filter algebra.

Counterpart of ``live_ekf_slam_tpu/ops/precision.py``, which pins every
accuracy-critical contraction to ``Precision.HIGHEST`` because the TPU's
default feeds the matrix unit bf16 (a 0.3% error on a covariance insertion
block was observed there). On Hopper the hazard is TF32: a float32 product or
convolution may run with a 10-bit mantissa, about three decimal digits, which
Kalman covariance algebra cannot take. ``pin_fp32()`` turns TF32 off for
cuBLAS and cuDNN. The fused EKF rollout has no matrix product, but the slices
to come (UKF, pose graph) do, so every entry point calls it.
"""

from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
