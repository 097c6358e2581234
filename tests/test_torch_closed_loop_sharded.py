"""The port's closed loop on an 8-shard CPU world mesh
(``eval/closed_loop.run_closed_loop_sharded``: ``BlockStep`` through
``parallel.mesh.sharded_step``, the occupancy grid replicated) against the
unsharded ``run_closed_loop`` on the same worlds: igvc1, 16 worlds, T = 40,
the caps of JAX's ``test_igvc_closed_loop_sharded_bitwise``
(``tests/test_closed_loop.py``), which holds its sharded closed loop to the
single-placement run bit for bit; so does this test, at the course's start.

Started among the barrels instead, where the filters update, the two part
in the last bit: on the CPU torch.atan2 rounds a value otherwise in the
scalar tail of a tensor than in its vectorised body (test_torch_mesh.py's
note), and a shard's tail is not the whole batch's. There the runs are held
to the closed-loop tolerances of test_torch_closed_loop.py (metres), the
integer plans exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from live_ekf_slam_tpu_torch.config import preset
from live_ekf_slam_tpu_torch.eval import closed_loop as cl
from live_ekf_slam_tpu_torch.parallel import mesh as pmesh
from live_ekf_slam_tpu_torch.utils.checkpoint import leaves
from port_harness import few_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

B, T, SEED = 16, 40, 11
ERR_ATOL = 1e-5
POSE_ATOL = 1e-4


def _cfg(**kw):
    cfg = preset("igvc1", num_iterations=T).replace(
        num_landmark_slots=37, num_meas_slots=12, **kw)
    return cfg.replace(path_planning=dataclasses.replace(
        cfg.path_planning, astar_max_iters=96, local_astar_max_iters=48,
        path_capacity=128))


def _both(cfg):
    m1, f1, _ = cl.run_closed_loop(cfg, B, SEED, device="cpu")
    m2, f2 = cl.run_closed_loop_sharded(cfg, pmesh.make_mesh(8, "cpu"), B, SEED)
    assert set(m1) == set(m2)
    return (m1, f1), (m2, f2)


def test_sharded_closed_loop_is_bitwise_the_unsharded_one():
    (m1, f1), (m2, f2) = _both(_cfg())
    assert type(f2) is type(f1)
    for a, b in zip(leaves(f1), leaves(f2)):
        assert torch.equal(a, b)
    for k in m1:
        np.testing.assert_array_equal(m1[k], m2[k])
    assert int(f1.timestep.min()) == T


def test_sharded_closed_loop_among_the_barrels():
    (m1, f1), (m2, f2) = _both(_cfg(init_pose=(0.5, 0.0, 1.57)))
    assert int(f1.filt.M.min()) >= 2  # the filters did update
    np.testing.assert_allclose(m2["err_ekf_slam"], m1["err_ekf_slam"],
                               rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(m2["final_true_pose"], m1["final_true_pose"],
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(f2.filt.x.numpy(), f1.filt.x.numpy(),
                               rtol=0, atol=POSE_ATOL)
    for f in ("path", "head", "length"):
        assert torch.equal(getattr(f2.pursuit, f), getattr(f1.pursuit, f)), f
    assert torch.equal(f2.filt.M, f1.filt.M) and torch.equal(f2.timestep, f1.timestep)
