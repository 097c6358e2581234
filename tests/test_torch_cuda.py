"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; each takes the ``cuda_device``
fixture, which skips it where ``torch.cuda.is_available()`` is false. This
file imports only torch, numpy and the port (no jax, no flax), so it also
runs on a GPU machine without the JAX package's dependencies:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py -q
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from live_ekf_slam_tpu_torch.config import CompatConfig, Config
from live_ekf_slam_tpu_torch.bench import chain_blocks, pg_config, pg_graphs, schur_system
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo,
    run_monte_carlo_pg_streams,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import micro_ops as mo
from live_ekf_slam_tpu_torch.sim.streams import naive_deadreckon, sim_streams
from live_ekf_slam_tpu_torch.tools import _common, micro_ukf_probe
from port_harness import cuda_device, small_cfg  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda

KINDS = ["default", "compat", "calibrated"]
B, T, N = 250, 200, 20  # 250 worlds: a ragged edge for 4-world blocks

# nvcc contracts a*b + c into FMA, the plain version does not; over 200
# ticks the last-bit differences stay within these, as |kernel - plain| <=
# atol + rtol * scale with the scale of chip_smoke.py (per-world scalars by
# their value, vectors and matrices by their largest magnitude in the world).
CARD_TOL = {"true_pose": (1e-5, 1e-5), "err_sum": (1e-3, 1e-3),
            "err_max": (1e-3, 1e-4), "x": (1e-4, 1e-4), "P": (1e-3, 1e-6)}


# kernel of each filter: (launch counter, key)
LAUNCHES = {"ekf_slam": (fr.launches, "ekf"), "iekf_slam": (fr.launches, "iekf"),
            "ukf_slam": (fu.launches, "slam"), "ukf_loc": (fu.launches, "loc")}


def _inputs(kind, dev, seed=3, filt="ekf_slam"):
    cfg = small_cfg(Config, CompatConfig, kind, T, N).replace(filter=filt)
    lms, cmds = mc_inputs(cfg, B, seed, dev)
    noise = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, (T, 2 * N + 8, B)).astype(np.float32), device=dev)
    return cfg, lms, cmds, noise


def test_philox_kernel_matches_torch(cuda_device):
    before = philox.launches
    nz = philox.philox_noise(11, T, N, B, device=cuda_device)
    ref = philox.philox_noise_reference(11, T, N, B, device=cuda_device)
    assert philox.launches == before + 1
    assert torch.equal(nz, ref)


def test_philox_kernel_matches_torch_with_a_partial_block(cuda_device):
    # the closed loop's N = 37: 2N+8 = 82 rows, so the last 4-row block of
    # each tick is half full
    nz = philox.philox_noise(11, 50, 37, 1024, device=cuda_device)
    ref = philox.philox_noise_reference(11, 50, 37, 1024, device=cuda_device)
    assert torch.equal(nz, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(kind, cuda_device):
    cfg, lms, cmds, noise = _inputs(kind, cuda_device)
    before = fr.launches["ekf"]
    k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise)
    torch.cuda.synchronize()
    assert fr.launches["ekf"] == before + 1
    p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, noise=noise)
    assert torch.equal(k["seen"], p["seen"])
    for name, (rtol, atol) in CARD_TOL.items():
        ref = p[name]
        scale = ref.abs() if ref.dim() == 1 else ref.abs().amax(
            dim=tuple(range(1, ref.dim())), keepdim=True)
        assert bool(((k[name] - ref).abs() <= atol + rtol * scale).all()), name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filt", ["iekf_slam", "ukf_slam", "ukf_loc"])
def test_new_kernels_match_plain(filt, kind, cuda_device):
    # chip_smoke.compare's rule: TOL per world; for the UKFs, the worlds the
    # plain version itself flags as chaotic are reported but exempt
    cfg, lms, cmds, noise = _inputs(kind, cuda_device, filt=filt)
    ctr, key = LAUNCHES[filt]
    before = ctr[key]
    k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
    torch.cuda.synchronize()
    assert ctr[key] == before + 1
    p, exempt = chip_smoke.plain_run(cfg, lms, cmds, noise, chip_smoke.TOL)
    chip_smoke.compare(k, p, chip_smoke.TOL, exempt, chip_smoke.AGG_RTOL)
    if filt.startswith("ukf"):
        assert torch.equal(k["P"], k["P"].transpose(1, 2))


@pytest.mark.parametrize("filt", ["ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"])
def test_predicated_and_philox_replay_are_bitwise(filt, cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device, filt=filt)
    a = fused_rollout(cfg, lms, cmds, 11)
    b = fused_rollout(cfg, lms, cmds, 11, predicated=False)
    nz = philox.philox_noise(11, T, N, B, device=cuda_device)
    c = fused_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    for key in a:
        assert torch.equal(a[key], b[key]), key
        assert torch.equal(a[key], c[key]), key


def test_ukf_covariance_stays_exactly_symmetric_at_t1000(cuda_device):
    # ROADMAP hazard F3: nvcc's FMA contraction must not skew the Joseph
    # update; the kernel computes each entry once and mirrors it
    cfg = Config(num_iterations=1000).replace(filter="ukf_slam")
    lms, cmds = mc_inputs(cfg, 256, 0, cuda_device, shared=True, relabel=True)
    out = fu.fused_ukf_rollout(cfg, lms, cmds, 0)
    torch.cuda.synchronize()
    assert torch.equal(out["P"], out["P"].transpose(1, 2))
    assert bool(torch.isfinite(out["err_sum"]).all())


@pytest.mark.parametrize("filt", ["ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc"])
def test_kernel_without_fma_equals_plain_bitwise(filt, cuda_device):
    # with contraction off the kernel rounds exactly like the plain version:
    # the two are then the same algorithm to the last bit, in every world
    for kind in KINDS:
        cfg, lms, cmds, noise = _inputs(kind, cuda_device, filt=filt)
        with _build.without_fma():
            k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        p = fused_rollout(cfg, lms, cmds, 0, noise=noise, plain=True)
        for key in k:
            assert torch.equal(k[key], p[key]), (kind, key)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_pose_stream_kernel_matches_plain(filter_kind, kind, cuda_device):
    # K3: the pose streams at the tolerances of x and true_pose; the rest of
    # the result bit for bit what emit_traj=False gives; with contraction
    # off, the streams bit for bit the plain version's
    cfg, lms, cmds, noise = _inputs(kind, cuda_device)
    kw = dict(noise=noise, filter_kind=filter_kind)
    before = fr.launches[filter_kind + "_traj"]
    k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
    torch.cuda.synchronize()
    assert fr.launches[filter_kind + "_traj"] == before + 1
    k0 = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
    for key in k0:
        assert torch.equal(k0[key], k[key]), key
    assert torch.equal(k["est_traj"][:, -1], k["x"][:, :3])
    assert torch.equal(k["true_traj"][:, -1], k["true_pose"])
    p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, emit_traj=True, **kw)
    chip_smoke.compare(chip_smoke.stream_of(k), chip_smoke.stream_of(p),
                       {o: chip_smoke.TOL[o] for o in ("x", "true_pose")})
    with _build.without_fma():
        kn = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
    for key in kn:
        assert torch.equal(kn[key], p[key]), key


# 20: fewer steps than the solve has segments; 37: a ragged last segment
@pytest.mark.parametrize("steps", [20, 37, 200, 1000])
def test_block_thomas_kernels_match_plain(steps, cuda_device):
    # P1 on the blocks of real graphs: the default build within
    # chip_smoke.P1_RTOL of each output's scale, its solve also of the
    # sequential loop, the -fmad=false build bit for bit
    # (block_thomas_compare raises otherwise)
    cfg = pg_config(steps, "ekf_slam", False)
    graphs = pg_graphs(cfg, 9, cuda_device, seed=1)[0]
    for sc in (16.0, 1.0):
        d, u, rhs = chain_blocks(cfg, graphs, sc)
        res = chip_smoke.block_thomas_compare(d, u, rhs, f"T={steps} scale={sc}")
        assert all(res["no_fma_bitwise_equal"].values())
        assert res["x_vs_sequential"]["rel_to_scale"] <= chip_smoke.P1_RTOL
    with pytest.raises(ValueError, match="expected float32"):
        pg._tridiag_factor(d.double(), u)
    with pytest.raises(ValueError, match="expected float32"):
        pg._tridiag_solve(pg._tridiag_factor(d, u), rhs[:, :-1])


@pytest.mark.parametrize("e", [-24, -12, -1, 1, 12, 23])
def test_block_thomas_factor_inverse_at_every_significand(e, cuda_device):
    # the factor's inverse takes one reciprocal of the determinant and two
    # FMAs a quotient, which gives the IEEE quotient only if that reciprocal
    # is RN(1 / det): held here at every float significand of det at
    # exponent e. The blocks [[1, 1, -2^e], [1 - 2^e, 1, 0], [r, 0, 1]], r
    # = j 2^-23 (j < 2^23), have det 2^e (1 + r) exactly as the adjugate
    # rounds it, and cofactors in [2^-60, 2^60] (the fast path) but for j =
    # 0. With unit diagonals (dsc = 1) and no couplings every s_t is its
    # block, so sinv is _inv3 of the blocks, and the -fmad=false build gives
    # its bits
    r = torch.arange(2 ** 23, device=cuda_device, dtype=torch.float64) * 2.0 ** -23
    d = torch.eye(3, device=cuda_device).repeat(2 ** 23, 1, 1)
    d[:, 0, 1], d[:, 0, 2], d[:, 1, 0] = 1.0, -2.0 ** e, 1.0 - 2.0 ** e
    d[:, 2, 0] = r.float()
    d = d.reshape(1024, 2 ** 13, 3, 3)
    u = d.new_zeros((1024, 2 ** 13 - 1, 3, 3))
    with _build.without_fma():
        fac = pg._tridiag_factor(d, u)
    assert bool((fac["dsc"] == 1.0).all())
    want = pg._inv3(d)
    same = torch.eq(fac["sinv"].view(torch.int32), want.view(torch.int32))
    assert bool(same.all()), f"{int((~same).sum())} entries differ"


# 5000 steps: y in more than 48 KB of shared memory; 20000: y kept in x
@pytest.mark.parametrize("steps", [5000, 20000])
def test_block_thomas_solve_on_long_chains(steps, cuda_device):
    # random diagonally dominant SPD chains, both launch branches of the
    # solve: bit for bit its plain version under -fmad=false, the default
    # build within P1_RTOL of it and of the sequential loop
    rng = np.random.default_rng(steps)
    m = rng.normal(size=(2, steps + 1, 3, 3))
    d = torch.as_tensor(m @ m.transpose(0, 1, 3, 2) + 6 * np.eye(3),
                        dtype=torch.float32, device=cuda_device)
    u = torch.as_tensor(rng.normal(size=(2, steps, 3, 3)), dtype=torch.float32,
                        device=cuda_device)
    rhs = torch.as_tensor(rng.normal(size=(2, steps + 1, 3)), dtype=torch.float32,
                          device=cuda_device)
    fac = pg._tridiag_factor_reference(d, u)
    x = pg._tridiag_solve(fac, rhs)
    px = pg._tridiag_solve_reference(fac, rhs)
    with _build.without_fma():
        assert torch.equal(pg._tridiag_solve(fac, rhs), px)
    for want in (px, pg._tridiag_solve_sequential(fac, rhs)):
        err = float((x - want).abs().max())
        assert err <= chip_smoke.P1_RTOL * float(want.abs().max()), err


def test_block_thomas_solve_does_not_spill(cuda_device):
    # at the pose-graph study's T: y in shared memory, no local memory
    occ = pg.solve_occupancy(1000)
    rep = chip_smoke.solve_ptxas(chip_smoke.ptxas_report("block_thomas.cu"))
    assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] >= 1, occ
    assert rep["spill_store_bytes"] == 0 and rep["spill_load_bytes"] == 0, rep


# 20: fewer pose rows than the kernel has threads; 37: a ragged tile of
# measurements; 1000: four tiles of rows
@pytest.mark.parametrize("steps", [20, 37, 200, 1000])
def test_schur_mv_kernel_matches_plain(steps, cuda_device):
    # P2 on the blocks of real graphs, both forms of the slot map: the
    # default build within chip_smoke.SCHUR_RTOL of both plain versions in
    # every world, two launches equal, the -fmad=false build bit for bit
    # (schur_mv_compare raises otherwise)
    cfg = pg_config(steps, "ekf_slam", False)
    graphs = pg_graphs(cfg, 9, cuda_device, seed=1)[0]
    for sc in (16.0, 1.0):
        for slots in (pg.LmSlots(graphs), pg.LmSlots(graphs, detect=False)):
            sy = schur_system(cfg, graphs, sc, slots)
            res = chip_smoke.schur_mv_compare(sy, chip_smoke.cg_direction(sy),
                                              f"T={steps} scale={sc}")
            assert all(res["no_fma_bitwise_equal"].values())
            assert res["repeat_bitwise_equal"]
    args = [sy["d"], sy["u"], sy["hll_inv"], sy["coeffs"], sy["slots"], sy["rhs"]]
    with pytest.raises(ValueError, match="expected float32"):
        pg._schur_mv(*args[:5], args[5].double())
    with pytest.raises(ValueError, match="slot map"):
        pg._schur_mv(*args[:5], args[5][:, :-1])
    # more landmarks than a block's shared memory holds partials for: the
    # launch is refused, and nothing falls back to torch
    slots = pg.LmSlots(graphs)
    slots.n = 4096
    hll_wide = sy["hll_inv"].new_zeros((9, 4096, 3))
    with pytest.raises(RuntimeError, match="Schur matvec kernel failed"):
        pg._schur_mv(*args[:2], hll_wide, args[3], slots, args[5])


@pytest.mark.parametrize("steps", [37, 200, 1000])
def test_p1_and_p2_match_plain_on_chordal_systems(steps, cuda_device):
    # chordal_init's linear solve (fix_theta): the heading rows and columns
    # of the chain blocks are zero but for the pinned diagonal, cb is zero;
    # P1 and P2 held to their plain versions as on the Schur systems (the
    # compare functions raise otherwise)
    cfg = pg_config(steps, "ekf_slam", False)
    graphs = pg_graphs(cfg, 9, cuda_device, seed=1)[0]
    sy = schur_system(cfg, graphs, 1.0, chordal=True)
    assert not bool(sy["coeffs"][2].any()) and not bool(sy["rhs"][..., 2].any())
    res = chip_smoke.block_thomas_compare(sy["d"], sy["u"], sy["rhs"],
                                          f"chordal T={steps}")
    assert all(res["no_fma_bitwise_equal"].values())
    x = pg._tridiag_solve(pg._tridiag_factor(sy["d"], sy["u"]), sy["rhs"])
    assert not bool(x[..., 2].any())  # the headings do not move
    res = chip_smoke.schur_mv_compare(sy, chip_smoke.cg_direction(sy),
                                      f"chordal T={steps}")
    assert all(res["no_fma_bitwise_equal"].values()) and res["repeat_bitwise_equal"]


def test_schur_mv_does_not_spill(cuda_device):
    occ = pg.schur_mv_occupancy(20, 20)
    rep = next(v for k, v in chip_smoke.ptxas_report("schur_mv.cu").items()
               if "schur_mv_kernel" in k)
    assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] >= 1, occ
    assert rep["spill_store_bytes"] == 0 and rep["spill_load_bytes"] == 0, rep


def test_pg_streams_path_runs_on_the_card_and_repeats(cuda_device):
    cfg = pg_config(200, "iekf_slam", False)
    runs = [run_monte_carlo_pg_streams(cfg, 32, seed=2)[0] for _ in range(2)]
    for key, v in runs[0].items():
        assert np.array_equal(v, runs[1][key]), key
    assert not runs[0]["diverged_pose_graph"].any()
    assert (runs[0]["err_pose_graph_result"].mean()
            < runs[0]["err_pose_graph_initial"].mean())
    # the same study on the CPU, through the plain versions: the kernels'
    # FMA rounding and the card's sum orders, amplified by the CG, stay
    # within the 5e-3 the CPU tests hold the port to against JAX
    cpu = run_monte_carlo_pg_streams(cfg, 4, seed=2, device="cpu")[0]
    card = run_monte_carlo_pg_streams(cfg, 4, seed=2)[0]
    np.testing.assert_allclose(card["err_iekf_slam"], cpu["err_iekf_slam"],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(card["err_pose_graph_result"],
                               cpu["err_pose_graph_result"], rtol=0, atol=5e-3)


@pytest.mark.parametrize("mode", ["sim", "nolm"])
@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_profile_mode_kernels_match_plain(filter_kind, mode, cuda_device):
    # K1p: each cut instantiation within the card tolerances of the default
    # build and, with contraction off, bit for bit the plain version's; it
    # counts its own launches
    key = fr.launch_key(filter_kind, mode)
    for kind in KINDS:
        cfg, lms, cmds, noise = _inputs(kind, cuda_device)
        kw = dict(noise=noise, filter_kind=filter_kind, profile_mode=mode)
        before = dict(fr.launches)
        k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
        torch.cuda.synchronize()
        assert fr.launches == {**before, key: before[key] + 1}
        p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, **kw)
        chip_smoke.compare(k, p, chip_smoke.TOL)
        assert not bool(k["seen"].any())
        with _build.without_fma():
            kn = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
        for name in kn:
            assert torch.equal(kn[name], p[name]), (kind, name)
    if mode == "sim":  # the estimate stays where it started
        assert float(k["x"][:, 3:].abs().max()) == 0.0
        assert float(k["P"][:, 3:, :].abs().max()) == 0.0


@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_downdate_mode_is_the_full_kernel(filter_kind, cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device)
    before = fr.launches[filter_kind]
    a = fr.fused_ekf_rollout(cfg, lms, cmds, 11, filter_kind=filter_kind)
    b = fr.fused_ekf_rollout(cfg, lms, cmds, 11, filter_kind=filter_kind,
                             profile_mode="downdate")
    torch.cuda.synchronize()
    assert fr.launches[filter_kind] == before + 2
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("tool", ["micro_downdate", "micro_ukf", "micro_ukf_probe"])
def test_micro_kernels_match_plain(tool, cuda_device):
    # every case of the tool at 250 worlds (a ragged last block), 3 passes:
    # the default build within chip_smoke.MICRO_RTOL of the output's scale,
    # the -fmad=false build bit for bit (micro_compare raises otherwise)
    mod = importlib.import_module(f"live_ekf_slam_tpu_torch.tools.{tool}")
    # 43: the EKF's own D, an odd row stride and 4-byte words by itself; 44:
    # the UKF's; both leave rows and columns of the register tile padded
    for dim in (48, 44, 43):
        for c in mod.cases(250, cuda_device, passes=3, dim=dim):
            res = chip_smoke.micro_compare(c, 250)
            assert res["no_fma_bitwise_equal"], c["name"]
            if "asymmetry" in res:
                # prod9 and hoist compute both triangles, each entry from
                # its own expression: exactly symmetric without contraction,
                # off by roundings of the scale with it
                assert res["asymmetry_no_fma"] == 0.0, c["name"]
                assert 0.0 < res["asymmetry"] <= 1e-5 * res["scale"], c["name"]


def test_micro_joseph_every_term_count_matches_plain(cuda_device):
    # the tools time 1, 2, 4 and 7 terms; every count of the kernel's
    # template against the plain version, at each D of the register tile
    for dim in (48, 44, 43):
        probe = micro_ukf_probe.cases(250, cuda_device, passes=3, dim=dim)
        base = next(c for c in probe if c["op"] == "joseph")
        for nt in range(1, mo.JOSEPH_TERMS + 1):
            c = _common.case(f"joseph terms={nt}", "joseph", base["args"][:7] + ("terms", nt),
                             3, 0, variant=f"terms={nt}", spelling="terms", n_terms=nt)
            res = chip_smoke.micro_compare(c, 250)
            assert res["no_fma_bitwise_equal"], (dim, nt)


def test_register_micro_kernels_keep_p_in_registers(cuda_device):
    # no local memory (an array not held in registers lives there) for any
    # instantiation, and 8 or 16 worlds an SM: whole waves at 4096 worlds
    for r in mo.RANKS:
        occ = mo.occupancy("rank_update", mo.TILE, rank=r)
        assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] in (8, 16), (r, occ)
    for sp in mo.JOSEPH_SPELLINGS:
        for nt in range(1, mo.JOSEPH_TERMS + 1) if sp == "terms" else (mo.JOSEPH_TERMS,):
            occ = mo.occupancy("joseph", mo.TILE, spelling=sp, n_terms=nt)
            assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] in (8, 16), (sp, nt, occ)
    for variant in mo.CHOL_VARIANTS:
        occ = mo.occupancy("chol", mo.TILE, variant=variant)
        assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] in (8, 16), (variant, occ)
    for order in mo.MATVEC_ORDERS:
        for vectors in (1, 4):
            occ = mo.occupancy("matvec", mo.TILE, order=order, vectors=vectors)
            assert occ["local_bytes"] == 0 and occ["worlds_per_sm"] in (8, 16), (order, occ)


def test_register_micro_kernels_refuse_d_past_the_tile(cuda_device):
    d = mo.TILE + 1
    p = torch.zeros(4, d, d, device=cuda_device)
    v = torch.zeros(4, d, device=cuda_device)
    s = torch.zeros(4, 3, device=cuda_device)
    before = dict(mo.launches)
    with pytest.raises(ValueError, match=f"D <= {mo.TILE}"):
        mo.rank_update(p, v[:, None], v[:, None], 1)
    with pytest.raises(ValueError, match=f"D <= {mo.TILE}"):
        mo.joseph(p, v, v, v, v, s, 1)
    with pytest.raises(ValueError, match=f"D <= {mo.TILE}"):
        mo.chol(p + torch.eye(d, device=cuda_device), 1, "lower")
    with pytest.raises(ValueError, match=f"D <= {mo.TILE}"):
        mo.matvec(p, v[:, None], 1, "col")
    assert mo.launches == before
    # the C entry points refuse it as well, before any launch
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(p)
    assert lib.les_micro_rank_update(p.data_ptr(), v.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), 4, d, 1, 1, stream) != 0
    assert lib.les_micro_joseph(p.data_ptr(), *(v.data_ptr(),) * 4, s.data_ptr(),
                                out.data_ptr(), 4, d, 1, 0, 7, stream) != 0
    assert lib.les_micro_chol(p.data_ptr(), out.data_ptr(), 4, d, d, 1, 2, stream) != 0
    assert lib.les_micro_matvec(p.data_ptr(), v.data_ptr(), out.data_ptr(), 4, d, 1, 1, 0,
                                stream) != 0
    # the plain versions serve any D
    assert mo.rank_update(p.cpu(), v[:, None].cpu(), v[:, None].cpu(), 1).shape == (4, d, d)
    assert mo.matvec(p.cpu(), v[:, None].cpu(), 1, "row").shape == (4, d)


def _spd_with_clamped_pivots(dim, dev):
    # as test_torch_micro_ops's clamped-pivot case, world-major: eight SPD
    # worlds, two with a dead direction (row and column 5 zero), two with a
    # tiny pivot 9
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, dim, dim), dtype=np.float32)
    p = np.matmul(a, a.transpose(0, 2, 1)) / np.float32(dim) + np.eye(dim, dtype=np.float32)
    p[:2, 5, :] = 0.0
    p[:2, :, 5] = 0.0
    p[2:4, 9, 9] = 1e-9
    return torch.as_tensor(p.astype(np.float32), device=dev)


@pytest.mark.parametrize("dim", [48, 44, 43])
def test_chol_without_fma_equals_plain_at_clamped_pivots(dim, cuda_device):
    # the register Cholesky's -fmad=false build against the plain version,
    # value for value, on worlds whose pivots clamp, at du = 1, 44 and D,
    # for every variant; the default build within MICRO_RTOL of the scale
    p = _spd_with_clamped_pivots(dim, cuda_device)
    for variant in mo.CHOL_VARIANTS:
        for du in sorted({1, min(44, dim), dim}):
            c = _common.case(f"chol {variant} du={du}", "chol", (p, 3, variant, du), 3, 0,
                             variant=variant, du=du)
            res = chip_smoke.micro_compare(c, 8)
            assert res["no_fma_bitwise_equal"] and res["rel_to_scale"] <= chip_smoke.MICRO_RTOL
            out = mo.chol(p, 1, variant, du)
            assert torch.isfinite(out).all(), (variant, du)
            if du > 5:
                # the dead direction: column 5 zero below the pivot, whose
                # diagonal is sqrt(CHOL_EPS)
                assert torch.equal(out[:2, 6:, 5], torch.zeros_like(out[:2, 6:, 5]))
                assert out[0, 5, 5].item() == pytest.approx(float(np.sqrt(np.float32(mo.CHOL_EPS))))


@pytest.mark.parametrize("vectors", [1, 4])
def test_matvec_without_fma_equals_plain_for_one_and_four_vectors(vectors, cuda_device):
    # every order with one and four vectors a pass, at each D of the
    # register lines, 250 worlds (a ragged last block of eight)
    rng = np.random.default_rng(5)
    for dim in (48, 44, 43):
        l0 = torch.as_tensor(rng.standard_normal((250, dim, dim), dtype=np.float32),
                             device=cuda_device)
        g = torch.as_tensor(rng.standard_normal((250, vectors, dim), dtype=np.float32),
                            device=cuda_device)
        for order in mo.MATVEC_ORDERS:
            c = _common.case(f"matvec {order}", "matvec", (l0, g, 5, order), 5 * vectors, 0,
                             variant=order, order=order)
            res = chip_smoke.micro_compare(c, 250)
            assert res["no_fma_bitwise_equal"], (dim, order)


def test_micro_wrappers_reject_bad_inputs(cuda_device):
    p = torch.zeros(4, 8, 8, device=cuda_device)
    v = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="is on"):
        mo.rank_update(p, v[:, None].cpu(), v[:, None], 1)
    with pytest.raises(ValueError, match="contiguous"):
        mo.rank_update(p.transpose(1, 2), v[:, None], v[:, None], 1)
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        mo.check_index(torch.full((4,), 8, dtype=torch.int32,
                                  device=cuda_device), 8)
    before = dict(mo.launches)
    out = mo.chol(p + torch.eye(8, device=cuda_device), 2, "lower")
    torch.cuda.synchronize()
    assert mo.launches == {**before, "chol": before["chol"] + 1}
    assert torch.equal(out, torch.eye(8, device=cuda_device).expand(4, 8, 8))


def test_wrapper_rejects_bad_inputs(cuda_device):
    cfg, lms, cmds, noise = _inputs("default", cuda_device)
    with pytest.raises(TypeError, match="float32"):
        fr.fused_ekf_rollout(cfg, lms.double(), cmds, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_ekf_rollout(cfg, lms, cmds.transpose(0, 1).contiguous()
                             .transpose(0, 1), 0)
    with pytest.raises(ValueError, match="shape"):
        fr.fused_ekf_rollout(cfg, lms, cmds, 0, noise=noise[:, :, :10])
    with pytest.raises(ValueError, match="is on"):
        fr.fused_ekf_rollout(cfg, lms, cmds.cpu(), 0)


def test_ukf_slam_keeps_16_worlds_resident_per_sm(cuda_device):
    # K4's packed layout: 16 worlds on an SM at N = 20 (the register file's
    # limit at 128 registers a thread; full squares of P and L let only 8
    # share an SM's shared memory), and no local memory beyond the stack
    for slam in (True, False):
        occ = fu.occupancy(N, slam)
        assert occ["worlds_per_sm"] >= 16, occ
        assert occ["registers"] <= 128, occ


@pytest.mark.parametrize("slam, n_lm", [(True, 3), (True, 14), (True, 20),
                                        (True, 31), (False, 20)],
                         ids=["slam-N3", "slam-N14", "slam-N20", "slam-N31", "loc"])
def test_ukf_without_fma_equals_plain_at_the_lane_schedules_edges(slam, n_lm,
                                                                  cuda_device):
    # Du = 10, 32, 44, 66: one warp's width and past it, for the triangle
    # lines, the row rounds of the matvecs and the two register-held sigma
    # columns of each lane
    cfg = small_cfg(Config, CompatConfig, "default", T, n_lm).replace(
        filter="ukf_slam" if slam else "ukf_loc")
    lms, cmds = mc_inputs(cfg, B, 3, cuda_device)
    noise = torch.as_tensor(np.random.default_rng(n_lm).uniform(
        -1, 1, (T, 2 * n_lm + 8, B)).astype(np.float32), device=cuda_device)
    with _build.without_fma():
        k = fu.fused_ukf_rollout(cfg, lms, cmds, 0, slam=slam, noise=noise)
    p = fu.fused_ukf_rollout_reference(cfg, lms, cmds, 0, slam=slam, noise=noise)
    for key in k:
        assert torch.equal(k[key], p[key]), key
    if slam:
        assert int(k["seen"].sum(dim=1).max()) >= 2


def test_ukf_phase_clock_build_counts_every_phase(cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device, filt="ukf_slam")
    cycles, res = fu.phase_clocks(cfg, lms, cmds, 5)
    assert set(cycles) == set(fu.PHASES)
    assert all(v > 0 for v in cycles.values()), cycles
    assert bool(torch.isfinite(res["err_sum"]).all())
    with pytest.raises(RuntimeError, match="CUDA error"):  # the default build has none
        _build.check(_build.load().les_ukf_phase_clocks(
            (ctypes.c_uint64 * len(fu.PHASES))(), len(fu.PHASES), 0), "clocks")


@pytest.mark.parametrize("n_lm, relabel", [(1, False), (20, False), (40, False),
                                           (20, True)],
                         ids=["N1", "N20", "N40", "N20-relabelled"])
@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_ekf_without_fma_equals_plain_at_the_walks_edges(filter_kind, n_lm,
                                                         relabel, cuda_device):
    # K1 / K2: one landmark; 20 in map order, where unseen ids sit between
    # seen ones (the seen block's bound, D_act, then covers +0 rows); 40,
    # two ballot words (D = 83). With contraction off, bit for bit the plain
    # version's; predicated bit for bit unpredicated in the default build
    b, t = 64, T
    cfg = small_cfg(Config, CompatConfig, "default", t, n_lm).replace(
        filter=filter_kind + "_slam")
    lms, cmds = mc_inputs(cfg, b, 3, cuda_device, relabel=relabel)
    noise = torch.as_tensor(np.random.default_rng(n_lm).uniform(
        -1, 1, (t, 2 * n_lm + 8, b)).astype(np.float32), device=cuda_device)
    kw = dict(noise=noise, filter_kind=filter_kind)
    with _build.without_fma():
        k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
    p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, **kw)
    for key in k:
        assert torch.equal(k[key], p[key]), key
    a = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
    u = fr.fused_ekf_rollout(cfg, lms, cmds, 0, predicated=False, **kw)
    for key in a:
        assert torch.equal(a[key], u[key]), key
    assert int(k["seen"].sum(dim=1).max()) >= min(n_lm, 2)


def test_ekf_kernels_keep_16_worlds_resident_per_sm(cuda_device):
    # K1 and K2 at N = 20: 9.1 KB of shared memory a world would let 24
    # share an SM, the registers (at most 128 a thread) let 16, without
    # spilling (ptxas's spill bytes). A budget of 80 registers for 24 worlds
    # spilled and ran slower
    report = chip_smoke.ptxas_report("fused_ekf_rollout.cu")
    for name in ("fused_ekf_rollout", "fused_iekf_rollout"):
        kind, mode, traj, targs = chip_smoke.EKF_INSTANCES[name]
        occ = fr.occupancy(N, kind, mode, traj)
        assert occ["worlds_per_sm"] >= chip_smoke.EKF_RESIDENT, (name, occ)
        assert occ["registers"] <= 128, (name, occ)
        stem = "fused_ekf_rollout_kernel" + chip_smoke.mangled_args(targs)
        r = next(v for k, v in report.items() if stem in k)
        assert r["spill_store_bytes"] == 0 and r["spill_load_bytes"] == 0, (name, r)


@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_ekf_phase_clock_build_counts_every_phase(filter_kind, cuda_device):
    cfg, lms, cmds, _ = _inputs("default", cuda_device, filt=filter_kind + "_slam")
    cycles, res = fr.phase_clocks(cfg, lms, cmds, 5, filter_kind=filter_kind)
    assert set(cycles) == set(fr.PHASES)
    assert all(v > 0 for v in cycles.values()), cycles
    assert bool(torch.isfinite(res["err_sum"]).all())
    with pytest.raises(RuntimeError, match="CUDA error"):  # the default build has none
        _build.check(_build.load().les_ekf_phase_clocks(
            (ctypes.c_uint64 * len(fr.PHASES))(), len(fr.PHASES), 0), "clocks")


# ---- the per-tick path (run_monte_carlo(impl="per_tick")) on the card


@pytest.mark.parametrize("mode", list(chip_smoke.PT_MODES))
def test_per_tick_on_the_card_matches_the_cpu(mode, cuda_device):
    # the same inputs (made on the CPU) and noise on both devices, 64 worlds
    # x 200 ticks, held as chip_smoke holds them (it raises on a failure)
    chip_smoke.per_tick_card_vs_cpu(cuda_device, 20, (mode,))


@pytest.mark.parametrize("mode", list(chip_smoke.PT_AGAINST))
def test_per_tick_matches_the_fused_kernel_on_the_same_worlds(mode, cuda_device):
    # run_monte_carlo's two paths at 64 worlds x 200 ticks on one seed see
    # the same worlds; held as chip_smoke holds them at the main path's size
    cfg = chip_smoke.per_tick_config(Config(num_iterations=200), mode)
    filt = cfg.filter
    res, _, _ = run_monte_carlo(cfg, 64, seed=0, impl="per_tick", device=cuda_device)
    lms, cmds = mc_inputs(cfg, 64, 0, cuda_device)
    noise = philox.philox_noise(0, 200, 20, 64, cuda_device)
    if filt == "naive":
        st = sim_streams(cfg, lms, 20, cmds, noise)
        est = naive_deadreckon(cfg, cmds)
        ref = (torch.linalg.vector_norm(est[:, :, :2] - st["poses_true"][:, :, :2],
                                        dim=-1).mean(dim=1).cpu().numpy(),
               np.zeros(64, dtype=bool), None)
    else:
        res_f, out_f, _ = run_monte_carlo(cfg, 64, seed=0, device=cuda_device)
        ref = (res_f["err_" + filt], res_f["diverged_" + filt],
               out_f["update_rejects"].cpu().numpy() if filt.startswith("ukf") else None)
    chip_smoke.held_against_fused(mode, cfg, res["err_" + filt],
                                  res["diverged_" + filt], ref, lms, cmds, noise)


def test_per_tick_run_launches_only_the_philox_kernel(cuda_device):
    cfg = Config(num_iterations=20).replace(filter="ekf_slam")
    chip_smoke.zero_counts()
    res, fin, _ = run_monte_carlo(cfg, 256, seed=0, impl="per_tick", device=cuda_device)
    counts = chip_smoke.counts()
    assert counts == {k: int(k == "philox_noise") for k in counts}
    assert np.isfinite(res["err_ekf_slam"]).all() and fin.primary.x.is_cuda


def test_closed_loop_on_the_card_matches_the_cpu(cuda_device):
    # 16 worlds x 100 ticks of the scale test's configuration, card against
    # the CPU on the same Philox noise, each world held until its first
    # replan or pare that differs between the two (ROADMAP F15)
    line = chip_smoke.cl_card_vs_cpu(cuda_device, 16, 100, 3)
    assert not line["worlds_failed"] and not line["nan_worlds"]


def test_checkpoint_saved_on_the_card_resumes_on_the_cpu(cuda_device, tmp_path):
    from live_ekf_slam_tpu_torch.eval.runner import init_carry, make_step
    from live_ekf_slam_tpu_torch.utils import checkpoint as ckpt

    cfg = Config(num_iterations=20)
    lms, cmds = mc_inputs(cfg, 4, 3, torch.device("cpu"))
    noise = philox.philox_noise_reference(3, 20, lms.shape[1], 4)
    step = make_step(cfg)
    carry = init_carry(cfg, lms.to(cuda_device), lms.shape[1])
    for t in range(10):
        carry, _ = step(carry, cmds[:, t].to(cuda_device), noise[t].T.to(cuda_device), t)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, carry)
    like = ckpt.tree_map(carry, lambda x: x.cpu())
    back = ckpt.restore(path, like)
    for a, b in zip(ckpt.leaves(back), ckpt.leaves(like)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    on_card = ckpt.restore(path, carry)
    assert all(x.device.type == "cuda" for x in ckpt.leaves(on_card))
    for t in range(10, 20):
        carry, _ = step(carry, cmds[:, t].to(cuda_device), noise[t].T.to(cuda_device), t)
        back, _ = step(back, cmds[:, t], noise[t].T, t)
    torch.testing.assert_close(back.primary.x, carry.primary.x.cpu(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("kname", list(chip_smoke.MD_KERNELS))
@pytest.mark.parametrize("mesh_kind", ["real", "virtual"])
def test_sharded_rollouts_on_the_card(kname, mesh_kind, cuda_device):
    # chip_smoke's multi-device checks at B = 256, T = 200: one launch a
    # shard, every shard its single launch at its seed bit for bit, shard 1
    # within the T = 1000 tolerance of the plain version and bit for bit
    # the -fmad=false build, injected noise sharded == unsharded
    from live_ekf_slam_tpu_torch.parallel import mesh as pmesh

    cfg = Config(num_iterations=T)
    lms, cmds = mc_inputs(cfg, 256, 3, cuda_device)
    mesh = pmesh.make_mesh() if mesh_kind == "real" else pmesh.virtual_mesh(4, cuda_device)
    line = chip_smoke.md_rollout_checks(kname, mesh, cfg, lms, cmds, 5, 16)
    assert line["launches"] == mesh.size and line["no_fma_bitwise_equal"]


def test_sharded_per_tick_step_and_checkpoint_on_the_card(cuda_device, tmp_path):
    from live_ekf_slam_tpu_torch.eval.runner import init_carry
    from live_ekf_slam_tpu_torch.parallel import mesh as pmesh

    cfg = Config(num_iterations=10)
    lms, cmds = mc_inputs(cfg, 256, 3, cuda_device)
    mesh = pmesh.virtual_mesh(4, cuda_device)
    line = chip_smoke.md_per_tick(cuda_device, mesh, lms, cmds, 10)
    assert line["worlds_out_of_tol"] == 0 and line["alive_equal"]
    carry = pmesh.shard_batch(init_carry(cfg, lms, lms.shape[1]), mesh)
    assert chip_smoke.md_checkpoint(mesh, carry, tmp_path / "s.npz")["bitwise_equal"]


def test_weak_scaling_rows_on_the_card(cuda_device):
    from live_ekf_slam_tpu_torch.tools import weak_scaling

    for row in (weak_scaling.run_row(2, 8, 5, device=cuda_device),
                weak_scaling.run_row(1, 8, 5, real=True)):
        assert np.isfinite(row["mean_err"]) and row["device_kind"] != "cpu"


def test_sharded_closed_loop_on_the_card_is_the_unsharded_one(cuda_device):
    # igvc1, 16 worlds, 40 ticks on 8 virtual shards: every leaf of the
    # final carry equal to the unsharded run's (chip_smoke's multi_device
    # group runs the same check)
    assert chip_smoke.md_closed_loop(cuda_device)["bitwise_equal"]
