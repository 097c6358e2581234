"""The Gauss-Newton system of the bulk pose-graph solve (``_schur_system``,
P3 on the card) against the torch passes it replaced.

On the CPU ``posegraph._schur_system`` runs ``_schur_system_torch``, the
torch passes over the (B, T, K) slots; ``_schur_system_reference`` spells the
kernel's order of sums with its threads as a dimension. Here the reference is
held to the torch passes within SYSTEM_RTOL of each output's scale on graphs
from the port's pipeline (``bench.pg_graphs``) and their variants, and the
hoisted odometry moments are held to change no bit of the CPU solve. On the
card (tests marked ``cuda``) ``csrc/gn_system.cu``'s ``-fmad=false`` build
equals the reference bit for bit, the default build stays within
CARD_RTOL, two launches are equal, and ``solve_schur_pcg`` with the kernel
stays within SOLVE_TOL of the same solve on the torch passes. This file
imports no JAX, so it also runs on a card machine without the JAX package's
dependencies.
"""

import dataclasses
import functools

import pytest
import torch

from live_ekf_slam_tpu_torch.bench import pg_config, pg_graphs
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build
from port_harness import cuda_device, few_threads  # noqa: F401  (fixtures)

OUTPUTS = ("d", "u", "hll_inv", "gp", "gl", "rhs", "p_active", "l_active")
COEFFS = ("ab", "bb", "cb", "ar", "br")
# the reference against the torch passes: the same float32 terms summed in
# other orders (by slot, by thread and tree, against ATen's reductions and
# the one-hot placement), largest 7e-8 of an output's scale at T = 60
SYSTEM_RTOL = 1e-6
# the default build against the reference, per world of each output's scale:
# nvcc contracts products and sums into FMAs (largest 1.4e-5, g_l at the
# fixed-heading seeds, on an NVIDIA H100)
CARD_RTOL = 1e-4
# solve_schur_pcg on the card, with the kernel against the torch passes: the
# FMA rounding of the system, carried through CG and the line search (8
# steps of 8 worlds at T = 200: 1.4e-6 and 0.15 mm; 16 steps of 64 worlds at
# T = 1000: 2.0e-5 and 0.49 mm, on an NVIDIA H100)
SOLVE_TOL = {"err_rel": 2e-4, "poses_m": 5e-3}

CASES = ["by_column", "flat", "fix_theta", "exact_logmap", "compat",
         "meas_scale_16", "no_measurements", "inactive", "one_world", "wide"]
DAMPING = (1e-4, 1e-2, 3.0)  # each world its own


@functools.lru_cache(maxsize=None)
def _graphs(steps: int, batch: int, dev: str):
    cfg = pg_config(steps, "ekf_slam", False)
    return cfg, pg_graphs(cfg, batch, torch.device(dev), seed=1)[0]


def _case(name: str, dev: str, steps: int = 60, batch: int = 3) -> dict:
    """One system's arguments: the study's graphs at (steps, batch) and
    their variant ``name``."""
    batch = 1 if name == "one_world" else batch
    cfg, s = _graphs(steps, batch, dev)
    s = s.map(lambda a: a.clone())
    pgc = cfg.pose_graph
    poses, lms = s.poses_init, s.lms_init
    kw = dict(meas_scale=1.0, fix_theta=False, detect=name != "flat")
    if name == "fix_theta":  # chordal_init's linear solve
        kw["fix_theta"] = True
        poses, lms = pg.chordal_seed(cfg, s)
    elif name == "exact_logmap":
        cfg = cfg.replace(pose_graph=dataclasses.replace(pgc, exact_logmap=True))
    elif name == "compat":
        cfg = cfg.replace(compat=dataclasses.replace(cfg.compat,
                                                     pg_variances_as_sigmas=True))
    elif name == "meas_scale_16":
        kw["meas_scale"] = 16.0
    elif name == "no_measurements":  # a world that saw nothing
        s.meas_valid[0] = False
        s.M[0] = 0
    elif name == "inactive":  # a world whose graph is half built
        half = steps // 2
        s.timestep[1] = half
        s.M[1] = max(int(s.M[1]) - 3, 0)
        s.odom_valid[1, half:] = False
        s.meas_valid[1, half:] = False
    elif name == "wide":  # 45 landmark slots: more than one walk's group
        lm = s.meas_lm
        s = s.replace(meas_lm=torch.where(lm % 2 == 1, lm + 20, lm).to(torch.int32),
                      lms_init=torch.cat([s.lms_init, s.lms_init + 0.5,
                                          s.lms_init[:, :5] - 0.3], 1),
                      M=torch.full_like(s.M, 45))
        lms = s.lms_init
    slots = pg.LmSlots(s, detect=kw.pop("detect"))
    damping = torch.tensor([DAMPING[i % len(DAMPING)] for i in range(s.M.shape[0])],
                           device=s.M.device)
    return dict(cfg=cfg, s=s, poses=poses, lms=lms, damping=damping,
                slots=slots, **kw)


def _system(fn, c: dict) -> dict:
    sy = fn(c["cfg"], c["s"], c["poses"], c["lms"], c["meas_scale"], c["damping"],
            c["slots"], c["fix_theta"])
    return dict(sy, **dict(zip(COEFFS, sy["coeffs"])))


def _world_rel(got, want) -> float:
    """The largest over worlds of max|got - want| / max|want| in the world."""
    b = want.shape[0]
    err = (got - want).abs().reshape(b, -1).amax(dim=1)
    return float((err / want.abs().reshape(b, -1).amax(dim=1).clamp_min(1e-30)).max())


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("name", CASES)
def test_reference_matches_the_torch_system(name):
    c = _case(name, "cpu")
    if name == "flat":
        assert not c["slots"].by_column
    elif name in ("by_column", "wide"):
        assert c["slots"].by_column
    want = _system(pg._schur_system, c)
    got = _system(pg._schur_system_reference, c)
    for key in OUTPUTS + COEFFS:
        scale = float(want[key].abs().max())
        err = float((got[key] - want[key]).abs().max())
        assert err <= SYSTEM_RTOL * max(scale, 1e-30), (key, err, scale)
    assert pg.launches["system"] == 0  # the CPU ran the torch passes
    if name == "fix_theta":
        assert not bool(got["cb"].any()) and not bool(got["gp"][..., 2].any())
    if name == "no_measurements":
        assert not bool(got["gl"][0].any()) and not bool(got["ab"][0].any())
    if name == "inactive":
        half = int(c["s"].timestep[1])
        assert not bool(got["p_active"][1, half + 1:].any())
        assert not bool(got["l_active"][1, int(c["s"].M[1]):].any())


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("fix_theta", [False, True])
def test_hoisted_odometry_moments_change_no_bits(monkeypatch, fix_theta):
    # solve_schur_pcg makes _odom_moments once a call; the system made them
    # itself at every step before: the same solve with the system's own
    # moments equals it bit for bit on the CPU
    c = _case("by_column", "cpu")
    args = (c["cfg"], c["s"], c["poses"], c["lms"])
    kw = dict(n_gn=3, n_cg=6, meas_scale=4.0, fix_theta=fix_theta)
    hoisted = pg.solve_schur_pcg(*args, **kw)
    system = pg._schur_system

    def own_moments(cfg, s, poses, lms, meas_scale, damping, slots, fix_theta,
                    moments=None, work=None):
        return system(cfg, s, poses, lms, meas_scale, damping, slots, fix_theta)

    monkeypatch.setattr(pg, "_schur_system", own_moments)
    each_step = pg.solve_schur_pcg(*args, **kw)
    for h, e in zip(hoisted, each_step):
        assert torch.equal(h, e)


def test_system_routes_by_device():
    c = _case("by_column", "cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pg._schur_system(c["cfg"], c["s"], c["poses"].to("meta"), c["lms"],
                         1.0, c["damping"], c["slots"])


# ---- on the card


def _card_compare(c: dict, what: str) -> dict:
    """P3 against the reference on one system: the -fmad=false build bit for
    bit, the default build within CARD_RTOL per world of each output's
    scale, two launches equal and counted."""
    before = pg.launches["system"]
    got = _system(pg._schur_system, c)
    again = _system(pg._schur_system, c)
    torch.cuda.synchronize()
    assert pg.launches["system"] == before + 2, what
    ref = _system(pg._schur_system_reference, c)
    with _build.without_fma():
        exact = _system(pg._schur_system, c)
    errs = {}
    for key in OUTPUTS + COEFFS:
        assert torch.equal(got[key], again[key]), (what, key, "two launches")
        assert torch.equal(exact[key], ref[key]), (what, key, "-fmad=false")
        errs[key] = _world_rel(got[key], ref[key])
        assert errs[key] <= CARD_RTOL, (what, key, errs[key])
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_system_kernel_matches_plain(name, cuda_device):
    _card_compare(_case(name, "cuda", steps=200, batch=3), name)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1])
def test_system_kernel_matches_plain_at_the_study_shape(batch, cuda_device):
    # T = 1000, K = 20: four rows a thread, both slot maps, the first and
    # the last measurement scale of the schedule
    for name in ("by_column", "flat"):
        for scale in (16.0, 1.0):
            c = _case(name, "cuda", steps=1000, batch=batch)
            c["meas_scale"] = scale
            _card_compare(c, f"{name} B={batch} scale={scale}")


@pytest.mark.cuda
def test_solve_schur_pcg_with_the_kernel_matches_the_torch_system(monkeypatch, cuda_device):
    c = _case("by_column", "cuda", steps=200, batch=8)
    args = (c["cfg"], c["s"], c["s"].poses_init, c["s"].lms_init)
    kw = dict(n_gn=8, n_cg=40, meas_scale=4.0)
    before = pg.launches["system"]
    poses, lms, err = pg.solve_schur_pcg(*args, **kw)
    assert pg.launches["system"] == before + kw["n_gn"]

    def torch_system(cfg, s, poses, lms, meas_scale, damping, slots, fix_theta, work):
        return pg._schur_system_torch(cfg, s, poses, lms, meas_scale, damping,
                                      slots, fix_theta)

    monkeypatch.setattr(pg, "_gn_system", torch_system)
    poses_t, lms_t, err_t = pg.solve_schur_pcg(*args, **kw)
    assert pg.launches["system"] == before + kw["n_gn"]
    rel = float(((err - err_t).abs() / err_t.abs()).max())
    assert rel <= SOLVE_TOL["err_rel"], rel
    dist = float((poses - poses_t)[..., :2].norm(dim=-1).max())
    assert dist <= SOLVE_TOL["poses_m"], dist


# the only local memory: sinf's and cosf's buffer for reducing arguments
# beyond 105615 (Payne-Hanek), which the angles here never reach
LIBRARY_STACK_BYTES = 32


@pytest.mark.cuda
def test_system_kernel_does_not_spill(cuda_device):
    import chip_smoke

    occ = pg.system_occupancy(20, 20)
    rep = next(v for k, v in chip_smoke.ptxas_report("gn_system.cu").items()
               if "gn_system_kernel" in k)
    assert occ["local_bytes"] <= LIBRARY_STACK_BYTES and occ["worlds_per_sm"] >= 2, occ
    assert rep["spill_store_bytes"] == 0 and rep["spill_load_bytes"] == 0, rep
