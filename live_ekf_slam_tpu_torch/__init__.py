"""live_ekf_slam_tpu_torch: the PyTorch / CUDA port of live_ekf_slam_tpu.

It runs the Monte-Carlo filter comparison (random maps, TSP command streams,
a fused sim + filter rollout of EKF-SLAM, RI-EKF-SLAM, UKF-SLAM or UKF-Loc,
per-world average error) on an NVIDIA GPU: plain tensor code in PyTorch, each
rollout a hand-written CUDA kernel for Hopper (``csrc/``), built with nvcc at
first use. The layout mirrors the JAX package (``core/``, ``sim/``,
``ops/``, ``eval/``, ``utils/``), which stays the reference the port is
tested against. Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
