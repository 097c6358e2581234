"""See the package docstring of live_ekf_slam_tpu_torch."""
