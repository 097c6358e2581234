"""Configuration schema of the PyTorch port: the JAX package's own classes.

``Config``, ``CompatConfig``, ``preset`` and ``load_config`` are re-exported
from ``live_ekf_slam_tpu.config``, not copied. That module imports only the
standard library and ``yaml``, and the JAX package's ``__init__`` imports
nothing but it, so this pulls in no jax.
"""

from live_ekf_slam_tpu.config import CompatConfig, Config, load_config, preset

__all__ = ["Config", "CompatConfig", "preset", "load_config"]
