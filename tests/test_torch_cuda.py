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
from live_ekf_slam_tpu_torch.bench import pg_config
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo_pg_streams,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import micro_ops as mo
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


@pytest.mark.parametrize("steps", [37, 200])  # 37: a ragged last chunk
def test_block_thomas_kernels_match_plain(steps, cuda_device):
    # P1 on the blocks of real graphs: the default build within
    # chip_smoke.P1_RTOL of each output's scale, the -fmad=false build bit
    # for bit (block_thomas_compare raises otherwise)
    cfg = pg_config(steps, "ekf_slam", False)
    graphs = chip_smoke.pg_graphs(cfg, 9, cuda_device, seed=1)[0]
    for sc in (16.0, 1.0):
        d, u, rhs = chip_smoke.chain_blocks(cfg, graphs, sc)
        res = chip_smoke.block_thomas_compare(d, u, rhs, f"T={steps} scale={sc}")
        assert all(res["no_fma_bitwise_equal"].values())
    with pytest.raises(ValueError, match="expected float32"):
        pg._tridiag_factor(d.double(), u)
    with pytest.raises(ValueError, match="expected float32"):
        pg._tridiag_solve(pg._tridiag_factor(d, u), rhs[:, :-1])


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
    for dim in (48, 43):  # 43: the EKF's own D, an odd row stride by itself
        for c in mod.cases(250, cuda_device, passes=3, dim=dim):
            res = chip_smoke.micro_compare(c, 250)
            assert res["no_fma_bitwise_equal"], c["name"]
            if "asymmetry" in res:
                # prod9 and hoist compute both triangles, each entry from
                # its own expression: exactly symmetric without contraction,
                # off by roundings of the scale with it
                assert res["asymmetry_no_fma"] == 0.0, c["name"]
                assert 0.0 < res["asymmetry"] <= 1e-5 * res["scale"], c["name"]


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
