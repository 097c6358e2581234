"""The benchmark of the PyTorch and CUDA port (``live_ekf_slam_tpu_torch``).

``python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name: its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<mix>.json``, the loop its window drives in
``drivers/<driver>.py`` (named by the configuration), and each per-layer
metric's reader in ``metrics/<metric>.py``. The plain references are in
``reference/``, the frozen operation and byte counts in ``counts/``.
Nothing here imports JAX or the JAX package.
"""
