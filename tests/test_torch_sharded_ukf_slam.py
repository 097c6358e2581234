"""The port's sharded UKF-SLAM rollout against the JAX package's sharded
wrapper in interpret mode on 8 virtual devices: the ukf_slam case of
test_torch_sharded_rollout.py's comparison, the same body, inputs and
tolerances, in a file of its own so that it runs on a pytest-xdist worker
of its own."""

import pytest

from port_harness import few_threads  # noqa: F401  (fixture)
from test_torch_sharded_rollout import check_sharded_matches_jax

pytestmark = pytest.mark.usefixtures("few_threads")


def test_sharded_ukf_slam_matches_jax_sharded_wrapper():
    check_sharded_matches_jax("ukf_slam")
