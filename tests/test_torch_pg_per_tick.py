"""The port's per-tick pose graph against the JAX package's.

``run_monte_carlo(impl="per_tick", collect="poses")`` with
``filter="pose_graph"`` against the JAX runner's ``impl="xla"`` at B = 4
worlds, T = 40 ticks, N = 6 landmarks, for the naive, EKF-SLAM and UKF-SLAM
secondaries in iterative and bulk mode and with
update_landmarks_after_adding: both get the same maps, and the port's
trajectory and simulator draws are rebuilt from JAX's key chain. The bulk
solve runs 8 + 8 + 12 Gauss-Newton steps of 12 CG steps here (both
packages, the same config): the comparison needs the same schedule, not a
converged one. Also one ``update`` tick from a shared state (slot
resolution, first sightings, a full slot table), the landmark refresh, a
run continued from a shared mid-run state, ``update`` against the port's
own ``assemble_streams``, and the CLI and bench on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.core.types import Measurements as JMeasurements
from live_ekf_slam_tpu.core.types import PoseGraphState as JPoseGraphState
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.models import posegraph as jpg
from live_ekf_slam_tpu_torch import bench, cli
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import posegraph_state_from_numpy, run_carry_from_numpy
from live_ekf_slam_tpu_torch.core.types import Measurements
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.models import posegraph as pg
from port_harness import few_threads, key_chain, tick_noise  # noqa: F401  (few_threads: a fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

B, T, N, SEED = 4, 40, 6, 3
SOLVER = dict(bulk_gn_iters=12, bulk_cg_iters=12)
# Tolerances. The secondaries' average errors and the seeded graph: both
# packages run the same float32 algebra, the CPU transcendentals of XLA and
# torch differ in the last bit (measured: 2e-7 m on the errors, 7e-7 on the
# graph's values), so 1e-5. The solved graph and the bulk solve's metric:
# 12 CG steps a Gauss-Newton step and a PCG solve every tick carry those
# bits further (measured: 3.5e-6 on the per-tick solution, 4.4e-5 m on
# err_pose_graph_result), so 1e-4 and 5e-4 m.
ERR_ATOL = 1e-5
GRAPH_ATOL = 1e-5
SOL_ATOL = 1e-4
RESULT_ATOL = 5e-4

# name -> (secondary, solve_graph_every_iteration, other pose_graph fields)
MODES = {
    "naive-iterative": ("naive", True, {}),
    "naive-bulk": ("naive", False, {}),
    "ekf_slam-iterative": ("ekf_slam", True, {}),
    "ekf_slam-bulk": ("ekf_slam", False, {}),
    "ukf_slam-iterative": ("ukf_slam", True, {}),
    "ukf_slam-bulk": ("ukf_slam", False, {}),
    "ekf_slam-bulk-update_landmarks": ("ekf_slam", False,
                                       {"update_landmarks_after_adding": True}),
}


def make_cfg(cls, secondary="naive", iterative=True, t=T, **pg_kw):
    cfg = cls(num_iterations=t).replace(num_landmark_slots=N, num_meas_slots=N,
                                        filter="pose_graph")
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=N, bound=3.0))
    return cfg.replace(pose_graph=dataclasses.replace(
        cfg.pose_graph, filter_to_compare=secondary,
        solve_graph_every_iteration=iterative, **SOLVER, **pg_kw))


_RUNS = {}


def runs(mode):
    """(JAX (results, final carry, outs), the port's), once a module."""
    if mode not in _RUNS:
        sec, it, kw = MODES[mode]
        jcfg, cfg = make_cfg(JConfig, sec, it, **kw), make_cfg(Config, sec, it, **kw)
        j = jrunner.run_monte_carlo(jcfg, jax.random.PRNGKey(SEED), B,
                                    seed=SEED, jit=False, collect="poses")
        traj_u, noise = key_chain(jax.random.PRNGKey(SEED), B, T, N)
        p = runner.run_monte_carlo(cfg, B, seed=SEED, impl="per_tick",
                                   device="cpu", collect="poses", noise=noise,
                                   traj_u=traj_u)
        _RUNS[mode] = (j, p)
    return _RUNS[mode]


EXACT_FIELDS = ("odom_valid", "meas_lm", "meas_valid", "ids", "M", "timestep")


def check_graph(js, s, sol_atol=SOL_ATOL):
    """The port's PoseGraphState against JAX's, field for field."""
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    for f, atol in (("poses_init", GRAPH_ATOL), ("lms_init", GRAPH_ATOL),
                    ("odom", GRAPH_ATOL), ("meas_rb", GRAPH_ATOL),
                    ("cur_pose", GRAPH_ATOL), ("poses_sol", sol_atol),
                    ("lms_sol", sol_atol)):
        np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("mode", MODES)
def test_per_tick_pose_graph_matches_jax(mode):
    sec, iterative, _ = MODES[mode]
    (res_j, fin_j, outs_j), (res, fin, outs) = runs(mode)
    assert set(res) == set(res_j) == {
        "err_pose_graph", "diverged_pose_graph", "err_" + sec, "diverged_" + sec,
        "err_pose_graph_result", "err_pose_graph_initial"}
    for k in res:
        if k.startswith("diverged"):
            np.testing.assert_array_equal(res[k], res_j[k], err_msg=k)
            assert not res[k].any()
    for k, atol in (("err_pose_graph", ERR_ATOL), ("err_" + sec, ERR_ATOL),
                    ("err_pose_graph_initial", ERR_ATOL),
                    ("err_pose_graph_result", RESULT_ATOL)):
        np.testing.assert_allclose(res[k], res_j[k], rtol=0, atol=atol, err_msg=k)
    # the solve improves on the seeds, as in JAX
    assert (res["err_pose_graph_result"] < res["err_pose_graph_initial"]).all()
    # the published pose is the secondary's; its mask mirrors the primary's
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(outs_j[1]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(fin.ticks_secondary.numpy(), fin.ticks_primary.numpy())
    check_graph(fin_j.primary, fin.primary)
    assert int(fin.primary.M.min()) >= 2
    # per-tick solves ran (iterative) or not (bulk)
    assert bool(fin.primary.solved.all()) == iterative


def test_update_landmarks_after_adding_refreshes_the_seeds():
    (_, fin_j, _), (_, fin, _) = runs("ekf_slam-bulk-update_landmarks")
    _, (_, off, _) = runs("ekf_slam-bulk")
    m = fin.primary.M
    assert torch.equal(m, off.primary.M)
    active = torch.arange(N)[None, :] < m[:, None]
    # the same worlds: the flag changes the landmark values the graph holds
    # (the EKF's refined estimates, not the first-sighting projections)
    d = (fin.primary.lms_init - off.primary.lms_init).abs().amax(dim=2)
    assert bool((d[active] > 1e-6).any())
    np.testing.assert_allclose(fin.primary.lms_init.numpy(),
                               np.asarray(fin_j.primary.lms_init), rtol=0, atol=GRAPH_ATOL)


def _tick_inputs(rng, n_cap=5, k=5, t_cap=9, tick=4, m0=3):
    """A mid-run graph of B = 4 worlds (m0 landmarks known, world 3's table
    one short of full) and one tick's measurements: known ids, new ids
    (world 3 more than its free slot), empty slots, a repeated id order."""
    b = 4
    s = dict(
        poses_init=rng.normal(0, 1, (b, t_cap + 1, 3)),
        lms_init=rng.normal(0, 2, (b, n_cap, 2)),
        odom=rng.uniform(0, 0.1, (b, t_cap, 2)),
        odom_valid=np.arange(t_cap)[None].repeat(b, 0) < tick,
        meas_rb=rng.uniform(0.5, 3, (b, t_cap, k, 2)),
        meas_lm=rng.integers(0, m0, (b, t_cap, k)),
        meas_valid=(rng.random((b, t_cap, k)) < 0.5) & (np.arange(t_cap)[None, :, None] < tick),
        ids=np.full((b, n_cap), -1),
        M=np.array([m0, m0, 0, n_cap - 1]),
        timestep=np.full(b, tick),
        cur_pose=rng.normal(0, 1, (b, 3)),
        poses_sol=rng.normal(0, 1, (b, t_cap + 1, 3)),
        lms_sol=rng.normal(0, 1, (b, n_cap, 2)),
        solved=np.zeros(b, bool),
    )
    for w in range(b):
        s["ids"][w, :s["M"][w]] = rng.permutation(12)[:s["M"][w]] + 10 * (w == 3)
    known = s["ids"]
    meas_ids = np.full((b, k), -1)
    meas_ids[0] = [known[0, 2], 20, -1, known[0, 0], 21]      # known + 2 new
    meas_ids[1] = [-1, -1, -1, -1, -1]                        # sees nothing
    meas_ids[2] = [30, 31, 32, -1, 33]                        # first sightings
    meas_ids[3] = [40, known[3, 1], 41, 42, known[3, 3]]      # 3 new, 1 free slot
    meas = dict(ids=meas_ids, r=rng.uniform(0.5, 3, (b, k)),
                b=rng.uniform(-1.5, 1.5, (b, k)), valid=meas_ids >= 0,
                overflow=np.zeros(b, bool))
    cmd = rng.uniform(0, 0.1, (b, 2))
    return s, meas, cmd


def _np32(d):
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else
                v.astype(np.int32) if v.dtype.kind in "iu" else v) for k, v in d.items()}


@pytest.mark.parametrize("tick", [4, 8])
def test_one_update_tick_matches_jax(tick):
    # tick 8 of T = 9 is the last: it adds nothing (the reference solves)
    rng = np.random.default_rng(21)
    s_np, meas_np, cmd = _tick_inputs(rng, tick=tick)
    s_np, meas_np = _np32(s_np), _np32(meas_np)
    cmd = cmd.astype(np.float32)
    jcfg = JConfig(num_iterations=9).replace(num_landmark_slots=5, num_meas_slots=5)
    cfg = Config(num_iterations=9).replace(num_landmark_slots=5, num_meas_slots=5)
    js = JPoseGraphState(**{k: jnp.asarray(v) for k, v in s_np.items()})
    jm = JMeasurements(**{k: jnp.asarray(v) for k, v in meas_np.items()})
    want = jax.vmap(lambda s_, c_, m_: jpg.update(jcfg, s_, c_, m_, tick=tick))(
        js, jnp.asarray(cmd), jm)
    s = posegraph_state_from_numpy(js)
    meas = Measurements(**{k: torch.tensor(v) for k, v in meas_np.items()})
    got = pg.update(cfg, s, torch.from_numpy(cmd), meas, tick=tick)
    check_graph(want, got, sol_atol=0.0)
    if tick == 4:
        # world 0: two new ids take slots 3 and 4; world 3: one takes the
        # last slot, the next two are dropped (no factor, no slot)
        np.testing.assert_array_equal(got.M.numpy(), [5, 3, 4, 5])
        assert got.meas_valid[3, tick].tolist() == [True, True, False, False, True]
        assert got.meas_valid[1, tick].sum() == 0 and bool(got.odom_valid[:, tick].all())
    else:
        assert not bool(got.odom_valid[:, tick].any())


def test_landmark_refresh_matches_jax():
    rng = np.random.default_rng(5)
    s_np, _, _ = _tick_inputs(rng)
    s_np = _np32(s_np)
    ns = 5
    sec_ids = np.full((4, ns), -1, np.int32)
    sec_m = np.array([4, 2, 0, 5], np.int32)
    for w in range(4):
        # the secondary holds some of the graph's ids and others, in
        # another order
        pool = np.concatenate([s_np["ids"][w][s_np["ids"][w] >= 0], [50, 51, 52, 53, 54]])
        sec_ids[w, :sec_m[w]] = rng.permutation(pool)[:sec_m[w]]
    sec_lms = rng.normal(0, 3, (4, ns, 2)).astype(np.float32)
    sec_pose = rng.normal(0, 1, (4, 3 + 2 * ns)).astype(np.float32)
    js = JPoseGraphState(**{k: jnp.asarray(v) for k, v in s_np.items()})
    want = jax.vmap(lambda s_, p_, l_, i_, m_: jpg.update_naive_estimate(
        s_, p_, l_, i_, m_, update_landmarks=True))(
        js, jnp.asarray(sec_pose), jnp.asarray(sec_lms), jnp.asarray(sec_ids),
        jnp.asarray(sec_m))
    got = pg.update_naive_estimate(
        posegraph_state_from_numpy(js), torch.from_numpy(sec_pose),
        torch.from_numpy(sec_lms), torch.from_numpy(sec_ids),
        torch.from_numpy(sec_m), update_landmarks=True)
    for f in ("cur_pose", "lms_init", "lms_sol"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert not np.array_equal(got.lms_init.numpy(), s_np["lms_init"])


def test_continues_from_a_shared_mid_run_state():
    t1, t2 = 15, 25
    jcfg = make_cfg(JConfig, "ekf_slam", True, t=t1 + t2)
    cfg = make_cfg(Config, "ekf_slam", True, t=t1 + t2)
    lms = np.random.default_rng(5).uniform(-3, 3, (B, N, 2)).astype(np.float32)
    traj_u, _ = key_chain(jax.random.PRNGKey(1), B, t1 + t2, N)
    cmds = runner.generate_trajectory(cfg, torch.from_numpy(lms), N, u=traj_u).numpy()
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    tick_keys = jax.vmap(lambda k: jax.random.split(k, t1 + t2))(keys)  # (B, T)
    step = jrunner.make_step(jcfg)

    def scan(carry, lo, hi):
        def batched(c, inp):
            return jax.vmap(step, in_axes=(0, (0, 0, None)))(c, inp)
        return jax.lax.scan(batched, carry, (
            jnp.swapaxes(jnp.asarray(cmds[:, lo:hi]), 0, 1),
            jnp.swapaxes(tick_keys[:, lo:hi], 0, 1), jnp.arange(lo, hi)))[0]

    c0 = jax.vmap(lambda l: jrunner.init_carry(jcfg, l, N))(lms)
    c_mid = scan(c0, 0, t1)
    fin_j = scan(c_mid, t1, t1 + t2)

    noise = np.stack([tick_noise(tick_keys[w, t1:], N) for w in range(B)], axis=2)
    carry = run_carry_from_numpy(c_mid, "pose_graph", "ekf_slam")
    assert carry.secondary.x.shape == (B, 3 + 2 * N)
    fin, _ = runner.rollout(cfg, carry, torch.from_numpy(cmds[:, t1:].copy()),
                            torch.from_numpy(noise), t0=t1)
    check_graph(fin_j.primary, fin.primary)
    np.testing.assert_allclose(fin.err_sum_secondary.numpy(),
                               np.asarray(fin_j.err_sum_secondary), rtol=0,
                               atol=ERR_ATOL * (t1 + t2))
    np.testing.assert_allclose(fin.secondary.x.numpy(), np.asarray(fin_j.secondary.x),
                               rtol=0, atol=1e-4)


def test_update_matches_the_ports_assemble_streams():
    # the per-tick graph of a stream of secondary poses and detections (slot
    # j = landmark id j, as the simulator emits them) is the graph
    # assemble_streams builds from the whole streams at once
    t_cap, n, b = 14, 5, 3
    cfg = Config(num_iterations=t_cap).replace(filter="pose_graph",
                                               num_landmark_slots=n, num_meas_slots=n)
    rng = np.random.default_rng(11)
    cmds = torch.tensor(np.stack([rng.uniform(0, 0.1, (b, t_cap)),
                                  rng.uniform(-0.05, 0.05, (b, t_cap))], -1), dtype=torch.float32)
    est = torch.tensor(np.cumsum(rng.normal(0, 0.1, (b, t_cap, 3)), axis=1), dtype=torch.float32)
    r = torch.tensor(rng.uniform(0.5, 3.0, (b, t_cap, n)), dtype=torch.float32)
    br = torch.tensor(rng.uniform(-1.5, 1.5, (b, t_cap, n)), dtype=torch.float32)
    vis = rng.random((b, t_cap, n)) < 0.3
    vis[:, :, 4] = False                  # a landmark never seen
    vis[:, :3, :2] = False
    vis[:, 3, 0] = vis[:, 3, 1] = True    # two first sightings in one tick
    vis = torch.from_numpy(vis)
    want = pg.assemble_streams(cfg, est, r, br, vis, cmds)
    s = pg.init(cfg, b)
    ids_row = torch.arange(n, dtype=torch.int32)
    for t in range(t_cap):
        s = pg.update_naive_estimate(s, est[:, t])
        meas = Measurements(ids=torch.where(vis[:, t], ids_row, -1), r=r[:, t],
                            b=br[:, t], valid=vis[:, t],
                            overflow=torch.zeros(b, dtype=torch.bool))
        s = pg.update(cfg, s, cmds[:, t], meas, tick=t)
    for f in EXACT_FIELDS:
        assert torch.equal(getattr(s, f), getattr(want, f)), f
    for f in ("poses_init", "lms_init", "odom", "meas_rb", "cur_pose"):
        torch.testing.assert_close(getattr(s, f), getattr(want, f), rtol=0, atol=1e-6)


def test_cli_and_bench_run_the_pose_graph_on_the_cpu(capsys, monkeypatch):
    # the entry points as they are, on configs whose bulk solve is short
    def short(**kw):
        cfg = Config(**kw)
        return cfg.replace(pose_graph=dataclasses.replace(
            cfg.pose_graph, bulk_gn_iters=2, bulk_cg_iters=2))

    monkeypatch.setattr(cli, "Config", short)
    monkeypatch.setattr(bench, "Config", short)
    assert cli.main(["monte_carlo", "--filter", "pose_graph", "--secondary",
                     "ukf_loc", "--batch", "2", "--steps", "12", "--device",
                     "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = [line.split(":")[0] for line in lines]
    assert names == ["pose_graph", "diverged_pose_graph", "ukf_loc", "diverged_ukf_loc",
                     "pose_graph_result", "pose_graph_initial"]
    bench.main(["--impl", "per_tick", "--filter", "pose_graph", "--secondary",
                "ekf_slam", "--device", "cpu", "--worlds", "2", "--steps", "12"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unit"] == "steps/s/world" and line["value"] > 0
    assert "the CPU, not a device metric" in line["metric"]
    assert line["rollout_s"] > 0 and line["solve_s"] > 0 and line["diverged"] == 0
    assert np.isfinite(line["mean_err_pose_graph_result"])
