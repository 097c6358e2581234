"""The Schur-complement matvec of the bulk pose-graph solve (``_schur_mv``,
P2) against the JAX package's, and the block-Thomas factor's plain version
against JAX's ``_tridiag_factor``.

On the CPU ``posegraph._schur_mv`` runs ``_schur_mv_reference``, the kernel's
order of sums with its threads as a dimension; ``_schur_mv_torch`` is the
torch spelling the solver ran before the kernel. Both are held against the
JAX composition that ``solve_schur_pcg``'s ``schur_mv`` closure computes
(live_ekf_slam_tpu/models/posegraph.py), built here from JAX's own
functions under ``jax.vmap`` on the graphs of test_torch_posegraph.py. The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from live_ekf_slam_tpu.models import posegraph as jpg
from live_ekf_slam_tpu.ops.precision import einsum32
from live_ekf_slam_tpu_torch.bench import pg_config, pg_graphs
from live_ekf_slam_tpu_torch.models import posegraph as pg
from test_torch_posegraph import VARIANTS, _graph, close


def _system(cfg, s, p, l, slots, meas_scale=1.0):
    """The blocks one Gauss-Newton step of solve_schur_pcg hands the matvec,
    and its gradient as a vector to apply it to."""
    jac = pg._jacobians(cfg, s, p, l, meas_scale, slots)
    coeffs, r_meas = pg._meas_coeffs(cfg, s, p, l, meas_scale, slots)
    d, u, _ = pg._pose_blocks(cfg, s, jac, coeffs, 1e-4)
    hll_inv, _ = pg._lm_hessian_inv(cfg, s, jac, coeffs, 1e-4, slots)
    gp, _ = pg._grad(cfg, s, jac, coeffs, r_meas, slots)
    return d, u, hll_inv, coeffs, gp


def _jax_schur_mv(d, u, hll_inv, coeffs, s, vp):
    """solve_schur_pcg's schur_mv, one world."""
    hv = einsum32("tij,tj->ti", d, vp)
    hv = hv.at[:-1].add(einsum32("tij,tj->ti", u, vp[1:]))
    hv = hv.at[1:].add(einsum32("tji,tj->ti", u, vp[:-1]))
    w = jpg._hll_inv_apply(hll_inv, jpg._hpl_t_apply(s, coeffs, vp))
    return hv - jpg._hpl_apply(s, coeffs, w)


@pytest.mark.parametrize("kind,exact", VARIANTS)
def test_schur_mv_matches_jax(kind, exact):
    cfg, _, s, js, (p, l), _ = _graph(kind, exact)
    d, u, hll_inv, coeffs, vp = _system(cfg, s, p, l, pg.LmSlots(s))
    want = jax.vmap(_jax_schur_mv)(*(jnp.asarray(a.numpy()) for a in (d, u, hll_inv)),
                                   tuple(jnp.asarray(c.numpy()) for c in coeffs),
                                   js, jnp.asarray(vp.numpy()))
    for slots in (pg.LmSlots(s), pg.LmSlots(s, detect=False)):
        for fn in (pg._schur_mv, pg._schur_mv_reference, pg._schur_mv_torch):
            # float32 sums in other orders, and XLA's CPU code contracts
            # products into FMAs: 1e-4 of the output's scale, as the _hpl_*
            # pieces are held in test_torch_posegraph.py
            close(fn(d, u, hll_inv, coeffs, slots, vp), want, 1e-4,
                  f"{fn.__name__} by_column={slots.by_column}")
    assert pg.launches["schur_mv"] == 0  # the CPU ran the plain version


@pytest.mark.parametrize("meas_scale", [16.0, 1.0])
def test_schur_mv_reference_matches_the_torch_spelling(meas_scale):
    # a longer graph from the port's own pipeline (T K = 1200 measurements a
    # world: several per thread, and a tree over all of them), at the first
    # and the last measurement scale of the solver's schedule
    cfg = pg_config(60, "ekf_slam", False)
    s = pg_graphs(cfg, 2, torch.device("cpu"), seed=1)[0]
    for slots in (pg.LmSlots(s), pg.LmSlots(s, detect=False)):
        d, u, hll_inv, coeffs, vp = _system(cfg, s, s.poses_init, s.lms_init,
                                            slots, meas_scale)
        want = pg._schur_mv_torch(d, u, hll_inv, coeffs, slots, vp)
        got = pg._schur_mv_reference(d, u, hll_inv, coeffs, slots, vp)
        close(got, want, 1e-5, f"by_column={slots.by_column}")
    assert slots.shape[1] * slots.shape[2] > 4 * pg.SCHUR_THREADS


def test_schur_mv_is_deterministic_and_routes_by_device():
    cfg, _, s, _, (p, l), _ = _graph("default", True)
    slots = pg.LmSlots(s)
    args = _system(cfg, s, p, l, slots)
    d, u, hll_inv, coeffs, vp = args
    a = pg._schur_mv(d, u, hll_inv, coeffs, slots, vp)
    b = pg._schur_mv(d, u, hll_inv, coeffs, slots, vp.clone())
    assert torch.equal(a, b)
    assert torch.equal(a, pg._schur_mv_reference(d, u, hll_inv, coeffs, slots, vp))
    with pytest.raises(ValueError, match="cpu or cuda"):
        pg._schur_mv(d, u, hll_inv, coeffs, slots, vp.to("meta"))


@pytest.mark.parametrize("kind,exact", VARIANTS)
def test_block_thomas_factor_matches_jax(kind, exact):
    # the plain factor, in the kernel's order of operations (whose
    # quotients are the IEEE ones of the adjugate by the determinant, as
    # here and in JAX), against JAX's scan at all four variants: products
    # summed in other orders and contracted by XLA differ by a rounding a
    # step, which the Schur blocks of weakly observed nodes (entries of
    # sinv up to ~100) carry along the 30 steps; the inverses alone agree
    # to a few ulps
    cfg, _, s, _, (p, l), _ = _graph(kind, exact)
    d, u, _, _, _ = _system(cfg, s, p, l, pg.LmSlots(s))
    fac = pg._tridiag_factor(d, u)
    jfac = jax.vmap(jpg._tridiag_factor)(jnp.asarray(d.numpy()), jnp.asarray(u.numpy()))
    for k in fac:
        close(fac[k], jfac[k], 1e-3, k)
    blocks = fac["sinv"].reshape(-1, 3, 3)
    a = torch.linalg.inv(blocks.double()).float()  # SPD blocks of O(1) entries
    close(pg._inv3(a), jpg._inv3(jnp.asarray(a.numpy())), 1e-6, "inv3")
    assert pg.launches["factor"] == 0
