"""The port's fused UKF-SLAM plain version against the JAX Pallas kernel in
interpret mode at N = 14 landmarks: the wide case slam-default-N14 of
test_torch_fused_ukf.py's ``test_plain_matches_pallas_kernel``, the same
body and inputs, in a file of its own so that it runs on a pytest-xdist
worker of its own."""

import pytest

from port_harness import few_threads  # noqa: F401  (fixture)
from test_torch_fused_ukf import check_plain_matches_pallas_kernel

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("slam, kind, n_lm", [
    pytest.param(True, "default", 14, id="slam-default-N14")])
def test_plain_matches_pallas_kernel(slam, kind, n_lm):
    check_plain_matches_pallas_kernel(slam, kind, n_lm)
