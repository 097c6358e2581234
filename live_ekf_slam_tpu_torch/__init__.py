"""live_ekf_slam_tpu_torch: the PyTorch / CUDA port of live_ekf_slam_tpu.

It runs the Monte-Carlo EKF-SLAM rollout (random maps, TSP command streams,
the fused sim + EKF kernel, per-world average error) on an NVIDIA GPU: plain
tensor code in PyTorch, the rollout as a hand-written CUDA kernel for Hopper
(``csrc/``), built with nvcc at first use. The layout mirrors the JAX
package (``core/``, ``sim/``, ``ops/``, ``eval/``, ``utils/``), which stays
the reference the port is tested against. Nothing here imports jax.
"""

__version__ = "0.1.0"
