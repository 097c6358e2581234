"""live_ekf_slam_tpu_torch: the PyTorch / CUDA port of live_ekf_slam_tpu.

It runs the Monte-Carlo filter comparison (random or fixed maps, TSP command
streams, a fused sim + filter rollout of EKF-SLAM, RI-EKF-SLAM, UKF-SLAM or
UKF-Loc, per-world average error) on an NVIDIA GPU: plain tensor code in
PyTorch, each rollout a hand-written CUDA kernel for Hopper (``csrc/``), built
with nvcc at first use. ``eval.runner.run_monte_carlo(impl="per_tick")`` is
the JAX package's default per-tick path: the simulator (``sim/world``) and
the five online filters (``models/``: naive, EKF-SLAM with known or unknown
ids, RI-EKF-SLAM, UKF-SLAM, UKF-Loc) stepped once a tick as batched tensor
ops, on the same Philox noise as the fused kernels. ``eval.runner.run_monte_carlo_pg_streams`` is the pose-graph
study on top of it: closed-form simulator streams, graphs assembled in vector
ops, and a Schur / block-Thomas Gauss-Newton solver whose sequential
recursions are a hand-written kernel too. ``eval.closed_loop.run_closed_loop``
is the igvc closed loop: the simulator and an online filter, a batched
local planner and A* replan every 5 ticks (``planning/``) and pure pursuit,
on the igvc1 map read from its PNG without Pillow (``sim/png``). ``tools/`` and the rollouts'
``profile_mode`` say where a rollout kernel's time goes: each primitive of a
tick as a standalone kernel (``ops/micro_ops``), timed alone. The layout
mirrors the JAX package (``core/``, ``sim/``, ``models/``, ``ops/``,
``planning/``, ``eval/``, ``utils/``; ``tools/`` holds what the JAX package keeps under
``scripts/``), which stays the reference the port is tested against. Nothing
here imports jax or the JAX package.
"""

__version__ = "0.1.0"
