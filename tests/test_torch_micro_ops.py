"""The port's standalone primitives (``ops/micro_ops.py``): each plain
version against the Pallas kernel of the JAX microbenchmark script it stands
for, in interpret mode, and against float64 numpy models. The CUDA kernels are
held against the plain versions on the card in test_torch_cuda.py.

The scripts under ``scripts/`` are loaded as they are and handed a ``pl``
whose ``pallas_call`` adds ``interpret=`` and keeps the kernel's whole output
(the scripts return only its sum). Inputs are made with numpy from a seed, at
the scripts' own shapes, and go to both sides through
``convert.micro_inputs_from_numpy``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as real_pl
from jax.experimental.pallas import tpu as pltpu

from live_ekf_slam_tpu_torch.convert import (
    micro_inputs_from_numpy,
    micro_output_to_numpy,
)
from live_ekf_slam_tpu_torch.ops import micro_ops as mo

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
DP = 48
PASSES = 3
# |plain - Pallas| <= RTOL * max|Pallas|: the same float32 algebra; XLA's CPU
# reductions sum in another order than the warp's, and its sqrt, sin, cos and
# the Cholesky's 44 dependent pivots carry last-bit differences further
RTOL = 1e-5
RTOL_LONG = 1e-4  # chol and zstats


class _RecordingPallas:
    """``jax.experimental.pallas`` with a ``pallas_call`` that runs in
    interpret mode and keeps every call's output."""

    def __init__(self, interpret):
        self.interpret = interpret
        self.outputs = []

    def __getattr__(self, name):
        return getattr(real_pl, name)

    def pallas_call(self, kernel, **kw):
        call = real_pl.pallas_call(kernel, interpret=self.interpret, **kw)

        def run(*args):
            out = call(*args)
            self.outputs.append(out)
            return out

        return run


def load_script(name: str, interpret=True):
    spec = importlib.util.spec_from_file_location(f"_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _RecordingPallas(interpret)
    return mod


def pallas_output(mod, run, *arrays) -> np.ndarray:
    """The kernel's whole output array, and a check that the script's own
    return value is its sum."""
    with jax.disable_jit():
        total = run(*(jnp.asarray(a) for a in arrays))
    out = np.asarray(mod.pl.outputs[-1])
    np.testing.assert_allclose(float(total), out.sum(dtype=np.float64),
                               rtol=1e-3, atol=1e-3)
    return out


def close(got: torch.Tensor, want: np.ndarray, rtol: float = RTOL):
    got = micro_output_to_numpy(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def spd(rng, bl):
    a = normal(rng, DP, DP, bl)
    return (np.einsum("ijb,kjb->ikb", a, a) / DP
            + np.eye(DP)[:, :, None]).astype(np.float32)


# ---------------------------------------------------------------- rank_update
@pytest.mark.parametrize("rank", mo.RANKS)
def test_rank_update_matches_pallas_kernel(rank):
    md = load_script("micro_downdate")
    rng = np.random.default_rng(0)
    p = normal(rng, DP, DP, md.BL, scale=1e-3)
    k = normal(rng, rank, DP, md.BL, scale=1e-4)
    h = normal(rng, rank, DP, md.BL, scale=1e-4)
    want = pallas_output(md, md.make_rank_kernel(rank, PASSES), k, h, p)
    pt, kt, ht = micro_inputs_from_numpy(p, k, h)
    got = mo.rank_update(pt, kt, ht, PASSES)
    close(got, want)
    # float64 model: P - passes * sum_r k_r h_r^T
    model = p.astype(np.float64) - PASSES * np.einsum(
        "rib,rjb->ijb", k.astype(np.float64), h.astype(np.float64))
    np.testing.assert_allclose(micro_output_to_numpy(got), model, rtol=0,
                               atol=1e-6 * np.abs(model).max())


@pytest.mark.parametrize("bl", [128, 256])
def test_rank2_downdate_matches_probe_kernel(bl):
    mp = load_script("micro_ukf_probe")
    rng = np.random.default_rng(1)
    p = normal(rng, DP, DP, bl)
    k = normal(rng, 4, DP, bl, scale=0.01)
    want = pallas_output(mp, mp.make_downdate(bl, PASSES), k[:2], k[2:], p)
    pt, kt, ht = micro_inputs_from_numpy(p, k[:2], k[2:])
    close(mo.rank_update(pt, kt, ht, PASSES), want)


# -------------------------------------------------------------- column_gather
def _gather_inputs(bl):
    rng = np.random.default_rng(0)
    p = normal(rng, DP, DP, bl, scale=1e-3)
    idx = rng.integers(0, DP, (1, bl)).astype(np.int32)
    return p, idx


@pytest.mark.parametrize("spelling", mo.GATHER_SPELLINGS)
def test_column_gather_is_the_indexed_column_summed_n_times(spelling):
    p, idx = _gather_inputs(64)
    pt, it = micro_inputs_from_numpy(p, idx)
    assert it.shape == (64,) and it.dtype == torch.int32
    got = micro_output_to_numpy(mo.column_gather(pt, it, PASSES, spelling))
    col = p[np.arange(DP)[:, None], idx[0][None, :], np.arange(64)[None, :]]
    want = np.zeros_like(col)
    for _ in range(PASSES):
        want = want + col
    np.testing.assert_array_equal(got, want)  # exact: one nonzero term a row


@pytest.mark.parametrize("spelling,maker", [("select", "make_gather_kernel"),
                                            ("take", "make_take_kernel")])
def test_column_gather_matches_pallas_kernel_from_zeroed_memory(spelling, maker):
    # the scripts' gather kernels add into an output they never initialise
    # (NaN in plain interpret mode); with the interpreter's uninitialised
    # memory set to zero they give what the port computes from zero
    md = load_script("micro_downdate",
                     pltpu.InterpretParams(uninitialized_memory="zero"))
    p, idx = _gather_inputs(md.BL)
    run = getattr(md, maker)(PASSES)
    total = float(run(jnp.asarray(p), jnp.asarray(idx)))
    pt, it = micro_inputs_from_numpy(p, idx)
    got = mo.column_gather(pt, it, PASSES, spelling)
    assert np.isfinite(total)
    np.testing.assert_allclose(float(got.double().sum()), total,
                               rtol=1e-4, atol=1e-6)


def _non_finite_gather_inputs(bl):
    """The gather inputs with an infinity or a NaN in every fifth world, in a
    row and a column away from the world's idx: (p, idx, {world: row})."""
    p, idx = _gather_inputs(bl)
    bad = {}
    for w in range(0, bl, 5):
        a, c = (7 * w) % DP, (int(idx[0, w]) + 1 + w % (DP - 1)) % DP
        p[a, c, w] = (np.inf, -np.inf, np.nan)[w % 3]
        bad[w] = a
    return p, idx, bad


def test_column_gather_parts_on_a_non_finite_entry():
    # take reads the entry, as the script's take kernel does; select
    # multiplies the row by the one-hot, and inf * 0 or NaN * 0 turns the
    # whole row NaN: the script's select expression evaluated op by op in
    # JAX does so too, but its Pallas kernel in interpret mode gives the
    # entry, since XLA rewrites a product by a converted comparison into a
    # select. Every other value is equal bit for bit (one nonzero term).
    md = load_script("micro_downdate",
                     pltpu.InterpretParams(uninitialized_memory="zero"))
    p, idx, bad = _non_finite_gather_inputs(md.BL)
    want = {}
    for maker in ("make_gather_kernel", "make_take_kernel"):
        with jax.disable_jit():
            getattr(md, maker)(PASSES)(jnp.asarray(p), jnp.asarray(idx))
        want[maker] = np.asarray(md.pl.outputs[-1])
    pt, it = micro_inputs_from_numpy(p, idx)
    got = {sp: micro_output_to_numpy(mo.column_gather(pt, it, PASSES, sp))
           for sp in mo.GATHER_SPELLINGS}
    nan_rows = np.zeros_like(got["take"], bool)
    for w, a in bad.items():
        nan_rows[a, w] = True
    np.testing.assert_array_equal(got["take"], want["make_take_kernel"])
    assert np.isfinite(got["take"]).all()
    np.testing.assert_array_equal(np.isnan(got["select"]), nan_rows)
    np.testing.assert_array_equal(got["select"][~nan_rows], want["make_gather_kernel"][~nan_rows])
    # the Pallas select kernel under XLA: the entry, the take kernel's value
    np.testing.assert_array_equal(want["make_gather_kernel"], want["make_take_kernel"])
    # the script's select expression, op by op: NaN in exactly those rows
    iota = jax.lax.broadcasted_iota(jnp.int32, p.shape, 1)
    sel = (iota == jnp.asarray(idx)[0][None, None, :]).astype(jnp.float32)
    eager = np.asarray(jnp.sum(jnp.asarray(p) * sel, axis=1))
    np.testing.assert_array_equal(np.isnan(eager), nan_rows)


def test_pallas_gather_kernels_never_initialise_their_output():
    # the reference finding itself: in plain interpret mode both return NaN
    md = load_script("micro_downdate")
    p, idx = _gather_inputs(md.BL)
    for maker in (md.make_gather_kernel, md.make_take_kernel):
        assert np.isnan(float(maker(1)(jnp.asarray(p), jnp.asarray(idx))))


# ----------------------------------------------------------------------- chol
@pytest.mark.parametrize("variant", ["full", "trail"])
def test_chol_matches_pallas_kernel(variant):
    mu = load_script("micro_ukf")
    p = spd(np.random.default_rng(0), mu.BL)
    with jax.disable_jit():
        total = mu.make_chol(variant, 2)(jnp.asarray(p))
    (pt,) = micro_inputs_from_numpy(p)
    got = mo.chol(pt, 2, variant, du=mu.DU)
    # the script keeps the last pivot, summed over both factorisations
    last = got[:, mu.DU - 1, mu.DU - 1].double()
    np.testing.assert_allclose(float(2 * last.sum()), float(total), rtol=RTOL_LONG)
    assert np.asarray(mu.pl.outputs[-1]).shape == (8, mu.BL)
    np.testing.assert_allclose(2 * last.numpy(), np.asarray(mu.pl.outputs[-1])[0],
                               rtol=RTOL_LONG)


@pytest.mark.parametrize("variant", mo.CHOL_VARIANTS)
def test_chol_matches_float64_cholesky(variant):
    du = 44
    p = spd(np.random.default_rng(2), 16)
    (pt,) = micro_inputs_from_numpy(p)
    got = mo.chol(pt, 1, variant, du=du).double().numpy()
    pw = np.moveaxis(p.astype(np.float64), -1, 0)
    want = np.linalg.cholesky(pw[:, :du, :du])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:, :du, :du], want, rtol=0,
                               atol=RTOL_LONG * scale)
    # rows below the pivots: L21 = P21 L11^-T
    l21 = np.linalg.solve(want, pw[:, :du, du:]).transpose(0, 2, 1)
    np.testing.assert_allclose(got[:, du:, :du], l21, rtol=0,
                               atol=RTOL_LONG * scale)
    if variant == "lower":
        assert np.array_equal(got, np.tril(got))
    else:  # past the pivots: the Schur complement of all pivots but the
        # last, which (as in the rollout) updates nothing behind it
        part = l21[:, :, :du - 1]
        schur = pw[:, du:, du:] - part @ part.transpose(0, 2, 1)
        np.testing.assert_allclose(got[:, du:, du:], schur, rtol=0,
                                   atol=RTOL_LONG * scale)


def test_chol_variants_share_the_lower_triangle_and_clamp_small_pivots():
    rng = np.random.default_rng(3)
    p = spd(rng, 8)
    # two worlds with a dead direction: row and column 5 zero, pivot 9 tiny
    p[5, :, :2] = 0.0
    p[:, 5, :2] = 0.0
    p[9, 9, 2:4] = 1e-9
    (pt,) = micro_inputs_from_numpy(p)
    full = mo.chol(pt, 1, "full")
    for variant in ("trail", "lower"):
        other = mo.chol(pt, 2, variant)
        assert torch.equal(torch.tril(full), torch.tril(other)), variant
    eps_root = float(np.sqrt(np.float32(mo.CHOL_EPS)))
    assert torch.equal(full[:2, 6:, 5], torch.zeros(2, DP - 6))
    assert full[0, 5, 5].item() == pytest.approx(eps_root)
    assert torch.isfinite(full).all()


# --------------------------------------------------------------------- matvec
def test_matvec_matches_pallas_kernel_four_vectors_a_pass():
    mu = load_script("micro_ukf")
    rng = np.random.default_rng(0)
    l0 = normal(rng, DP, DP, mu.BL)
    g = normal(rng, 4, DP, mu.BL)
    want = pallas_output(mu, mu.make_matvec(4, PASSES), l0, g)
    lt, gt = micro_inputs_from_numpy(l0, g)
    close(mo.matvec(lt, gt, PASSES, "row"), want)


@pytest.mark.parametrize("order", mo.MATVEC_ORDERS)
def test_matvec_orders_match_probe_kernels(order):
    mp = load_script("micro_ukf_probe")
    bl = 128
    rng = np.random.default_rng(1)
    l0 = normal(rng, DP, DP, bl)
    g = normal(rng, 4, DP, bl, scale=0.01)
    run = (mp.make_matvec_unrolled(bl, PASSES) if order == "unrolled" else
           mp.make_matvec_axis(bl, 1 if order == "row" else 0, PASSES))
    want = pallas_output(mp, run, l0, g)
    lt, gt = micro_inputs_from_numpy(l0, g[:1])  # the probes read g[0] alone
    got = mo.matvec(lt, gt, PASSES, order)
    close(got, want)
    lw = np.moveaxis(l0.astype(np.float64), -1, 0)
    gw = g[0].astype(np.float64).T
    model = PASSES * np.einsum("bij,bi->bj" if order == "col" else "bij,bj->bi",
                               lw, gw)
    np.testing.assert_allclose(got.numpy(), model, rtol=0,
                               atol=RTOL * np.abs(model).max())


# --------------------------------------------------------------------- joseph
def _joseph_inputs(bl, seed=0, gain=0.1):
    rng = np.random.default_rng(seed)
    p = spd(rng, bl)
    k0, k1 = (normal(rng, DP, bl, scale=gain) for _ in range(2))
    cr, cb = (normal(rng, DP, bl) for _ in range(2))
    s = np.abs(normal(rng, 8, bl))
    return p, k0, k1, cr, cb, s


@pytest.mark.parametrize("spelling", ["prod9", "hoist"])
def test_joseph_matches_pallas_kernel(spelling):
    mu = load_script("micro_ukf")
    p, k0, k1, cr, cb, s = _joseph_inputs(mu.BL)
    want = pallas_output(mu, mu.make_joseph(spelling, PASSES), k0, k1, cr, cb, s, p)
    pt, k0t, k1t, crt, cbt, st = micro_inputs_from_numpy(p, k0, k1, cr, cb, s[:3])
    got = mo.joseph(pt, k0t, k1t, crt, cbt, st, PASSES, spelling)
    close(got, want)
    # both spellings compute both triangles; without FMA contraction every
    # pair u_i v_j + v_i u_j is symmetric, so P stays exactly symmetric
    assert torch.equal(got, got.transpose(1, 2))
    f = [a.astype(np.float64) for a in (k0, k1, cr, cb)]
    outer = lambda a, b: np.einsum("ib,jb->ijb", a, b)  # noqa: E731
    model = p + PASSES * (
        -(outer(f[0], f[2]) + outer(f[2], f[0]))
        - (outer(f[1], f[3]) + outer(f[3], f[1]))
        + s[0] * outer(f[0], f[0]) + s[2] * outer(f[1], f[1])
        + s[1] * (outer(f[0], f[1]) + outer(f[1], f[0])))
    np.testing.assert_allclose(micro_output_to_numpy(got), model, rtol=0,
                               atol=RTOL * np.abs(model).max())


@pytest.mark.parametrize("n_terms", [1, 2, 4, 7])
def test_joseph_terms_match_probe_kernel(n_terms):
    mp = load_script("micro_ukf_probe")
    bl = 128
    rng = np.random.default_rng(1)
    p = normal(rng, DP, DP, bl)
    k = normal(rng, 4, DP, bl, scale=0.01)
    s = np.abs(normal(rng, 8, bl))
    want = pallas_output(mp, mp.make_joseph_n(bl, n_terms, PASSES), k, s, p)
    pt, k0, k1, cr, cb, st = micro_inputs_from_numpy(p, k[0], k[1], k[2], k[3], s[:3])
    got = mo.joseph(pt, k0, k1, cr, cb, st, PASSES, "terms", n_terms)
    close(got, want)


def test_joseph_all_seven_terms_is_the_full_update_in_another_order():
    p, k0, k1, cr, cb, s = _joseph_inputs(16, seed=4)
    args = micro_inputs_from_numpy(p, k0, k1, cr, cb, s[:3])
    full = mo.joseph(*args, 1, "prod9")
    terms = mo.joseph(*args, 1, "terms", 7)
    assert not torch.equal(full, terms)
    torch.testing.assert_close(full, terms, rtol=0,
                               atol=RTOL * float(full.abs().max()))
    # an odd number of the paired terms leaves P asymmetric
    one = mo.joseph(*args, 1, "terms", 1)
    assert not torch.equal(one, one.transpose(1, 2))


# --------------------------------------------------------------------- zstats
def test_zstats_matches_pallas_kernel():
    mu = load_script("micro_ukf")
    rng = np.random.default_rng(0)
    sp = normal(rng, 3, DP, mu.BL)
    sm = normal(rng, 3, DP, mu.BL)
    wm = np.abs(normal(rng, DP, mu.BL))
    lm = normal(rng, 8, mu.BL)
    want = pallas_output(mu, mu.make_zstats(PASSES), sp, sm, lm, wm)
    spt, smt, lmt, wmt = micro_inputs_from_numpy(sp, sm, lm[:2], wm)
    got = mo.zstats(spt, smt, lmt, wmt, PASSES)
    assert got.shape == (mu.BL,)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0,
                               atol=RTOL_LONG * float(np.abs(want[0]).max()))
    assert not want[1:].any()  # the kernel writes row 0 of its (8, BL) alone


# ------------------------------------------------------------------- wrappers
def test_wrappers_check_their_inputs():
    p = torch.zeros(2, 6, 6)
    v = torch.zeros(2, 6)
    with pytest.raises(ValueError, match=r"\(B, D, D\)"):
        mo.rank_update(torch.zeros(2, 6, 5), v[:, None], v[:, None], 1)
    with pytest.raises(ValueError, match="R in"):
        mo.rank_update(p, torch.zeros(2, 3, 6), torch.zeros(2, 3, 6), 1)
    with pytest.raises(TypeError, match="float32"):
        mo.rank_update(p.double(), v[:, None], v[:, None], 1)
    with pytest.raises(ValueError, match="at least one pass"):
        mo.rank_update(p, v[:, None], v[:, None], 0)
    with pytest.raises(ValueError, match=r"\[0, 6\)"):
        mo.check_index(torch.full((2,), 6, dtype=torch.int32), 6)
    with pytest.raises(TypeError, match="int32"):
        mo.column_gather(p, torch.zeros(2, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="unknown variant"):
        mo.chol(p, 1, "upper")
    with pytest.raises(ValueError, match="du must lie"):
        mo.chol(p, 1, "full", du=7)
    with pytest.raises(ValueError, match="unknown order"):
        mo.matvec(p, v[:, None], 1, "diag")
    with pytest.raises(ValueError, match="n_terms"):
        mo.joseph(p, v, v, v, v, torch.zeros(2, 3), 1, "terms", 8)
    with pytest.raises(ValueError, match="shape"):
        mo.zstats(torch.zeros(2, 3, 6), torch.zeros(2, 3, 6), torch.zeros(2, 3), v, 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mo.chol(p.to("meta"))
    assert not any(mo.launches.values())  # the plain versions count nothing


def test_micro_layout_round_trip():
    rng = np.random.default_rng(5)
    a = normal(rng, 4, DP, 16)
    idx = rng.integers(0, DP, (1, 16)).astype(np.int64)
    t, it = micro_inputs_from_numpy(a, idx)
    assert t.shape == (16, 4, DP) and t.is_contiguous()
    assert it.shape == (16,) and it.dtype == torch.int32
    np.testing.assert_array_equal(micro_output_to_numpy(t), a)
