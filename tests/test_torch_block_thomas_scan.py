"""The block-Thomas solve's plain version, a segment scan, against the
sequential loop it replaced, the JAX package's ``_tridiag_solve`` (a
``lax.scan``, under ``jax.vmap``) and a float64 dense solve.

The systems are real: the chain blocks and first right-hand side that
``solve_schur_pcg`` factors on the pose graphs of the streams path
(``bench.chain_blocks``, 4 worlds, seed 1), at the first and the last
measurement scale of the schedule, and beside them a seeded random
right-hand side of the same scale (the short chains' gradients can be zero).
The card holds the kernel against this plain version (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.models import posegraph as jpg
from live_ekf_slam_tpu_torch.bench import chain_blocks, pg_config, pg_graphs
from live_ekf_slam_tpu_torch.models import posegraph as pg

WORLDS = 4
# The scan re-associates the chain (segment maps composed, then scanned),
# so it rounds differently from a loop of the same float32 algebra; over
# 1000 steps of blocks with condition numbers near 100 the two part by
# about 1e-5 of the solution's scale (measured: 1.3e-5 at most).
SEQ_RTOL = 1e-4
# float32 against float64 on a system whose raw entries span 1e7: the
# tolerance the existing test of the sequential loop holds
# (test_torch_posegraph.py).
DENSE_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _graphs(steps: int):
    cfg = pg_config(steps, "ekf_slam", False)
    return cfg, pg_graphs(cfg, WORLDS, torch.device("cpu"), seed=1)[0]


def _system(steps: int, scale: float):
    """(factor, [gradient rhs, random rhs], d, u) of one chain system."""
    cfg, graphs = _graphs(steps)
    d, u, rhs = chain_blocks(cfg, graphs, scale)
    rng = np.random.default_rng(steps)
    noise = torch.as_tensor(rng.normal(size=tuple(rhs.shape)).astype(np.float32))
    top = max(float(rhs.abs().max()), 1.0)
    return pg._tridiag_factor(d, u), [rhs, noise * top], d, u


def _dense(d, u):
    """The block-tridiagonal matrix of one world, float64."""
    t1 = d.shape[0]
    a = np.zeros((3 * t1, 3 * t1))
    for t in range(t1):
        a[3 * t:3 * t + 3, 3 * t:3 * t + 3] = d[t]
        if t + 1 < t1:
            a[3 * t:3 * t + 3, 3 * t + 3:3 * t + 6] = u[t]
            a[3 * t + 3:3 * t + 6, 3 * t:3 * t + 3] = u[t].T
    return a


def _close(got, want, rtol, what):
    """|got - want| <= rtol * max|want| (the scale of the solution: its
    entries span orders of magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("segments", [32, 128])
@pytest.mark.parametrize("scale", [16.0, 1.0])
@pytest.mark.parametrize("steps", [1000, 200, 37, 30, 1])
def test_segment_scan_matches_the_loop_jax_and_float64(steps, scale, segments):
    fac, rhss, d, u = _system(steps, scale)
    jfac = jax.vmap(jpg._tridiag_factor)(jnp.asarray(d.numpy()), jnp.asarray(u.numpy()))
    for name, rhs in zip(("gradient", "random"), rhss):
        x = pg._tridiag_solve_reference(fac, rhs, segments)
        assert x.shape == rhs.shape and x.dtype == torch.float32
        assert bool(torch.isfinite(x).all())
        what = f"T={steps} scale={scale} S={segments} {name}"
        _close(x, pg._tridiag_solve_sequential(fac, rhs), SEQ_RTOL, what + " loop")
        jx = jax.vmap(jpg._tridiag_solve)(jfac, jnp.asarray(rhs.numpy()))
        _close(x, jx, SEQ_RTOL, what + " JAX")
        for w in range(WORLDS):
            want = np.linalg.solve(_dense(d[w].double().numpy(), u[w].double().numpy()),
                                   rhs[w].double().numpy().reshape(-1))
            _close(x[w].reshape(-1), want, DENSE_RTOL, f"{what} world {w} float64")


@pytest.mark.parametrize("steps", [0, 1, 31, 32, 33, 127, 129])
def test_segment_scan_handles_empty_short_and_ragged_chains(steps):
    # random SPD chains (diagonally dominant); fewer steps than segments,
    # one more or one less than a warp's or a block's: the empty segments
    # are identity maps and the result is the loop's
    rng = np.random.default_rng(steps)
    m = rng.normal(size=(3, steps + 1, 3, 3))
    d = torch.as_tensor(m @ m.transpose(0, 1, 3, 2) + 6 * np.eye(3), dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(3, steps, 3, 3)), dtype=torch.float32)
    rhs = torch.as_tensor(rng.normal(size=(3, steps + 1, 3)), dtype=torch.float32)
    fac = pg._tridiag_factor(d, u)
    want = pg._tridiag_solve_sequential(fac, rhs)
    for segments in (32, 128):
        x = pg._tridiag_solve_reference(fac, rhs, segments)
        _close(x, want, SEQ_RTOL, f"T={steps} S={segments}")
    if steps == 0:  # one node: x = inv(d_0) rhs_0
        torch.testing.assert_close(x[:, 0], torch.linalg.solve(d[:, 0], rhs[:, 0]))


def test_cpu_solve_runs_the_plain_scan_at_the_kernels_segments():
    fac, rhss, _, _ = _system(200, 1.0)
    before = dict(pg.launches)
    x = pg._tridiag_solve(fac, rhss[1])
    assert pg.launches == before  # the CPU ran the plain version
    assert torch.equal(x, pg._tridiag_solve_reference(fac, rhss[1], pg.SOLVE_SEGMENTS))
    with pytest.raises(ValueError, match="multiple of 32"):
        pg._tridiag_solve_reference(fac, rhss[1], 48)
