"""The port's main path as a whole: run_monte_carlo against the JAX
composition of the same steps for each of the four filters, the command
line, the card-by-default rule and the no-jax rule."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.ops.fused_rollout import fused_ekf_rollout as j_rollout
from live_ekf_slam_tpu.ops.fused_ukf import fused_ukf_rollout as j_ukf_rollout
from live_ekf_slam_tpu.sim.trajectory import generate_trajectory as j_gen
from live_ekf_slam_tpu_torch import bench, cli
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small(cls, t, n, bound):
    cfg = cls(num_iterations=t).replace(num_landmark_slots=n, num_meas_slots=n)
    return cfg.replace(map=cfg.map.__class__(num_landmarks=n, bound=bound))


def test_run_monte_carlo_matches_jax_composition():
    b, t, n, seed = 8, 60, 6, 4
    cfg = _small(Config, t, n, 4.0)
    jcfg = _small(JConfig, t, n, 4.0)
    noise = np.random.default_rng(9).uniform(
        -1, 1, (t, 2 * n + 8, b)).astype(np.float32)

    # the JAX side, step by step: maps, trajectories, kernel, latch
    jcfg, lms = jrunner._gen_maps(jcfg, np.random.default_rng(seed), b)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    cmds = jax.vmap(lambda l, k: j_gen(jcfg, l, n, k))(lms, keys)
    out_j = j_rollout(jcfg, lms, cmds, seed, block_worlds=b,
                      noise=jnp.asarray(noise), interpret=True)
    err_max_j = np.asarray(out_j["err_max"])
    err_j = np.asarray(out_j["err_sum"]) / t
    div_j = (~np.isfinite(err_max_j) | (err_max_j > jrunner.DIVERGENCE_RADIUS)
             | ~np.isfinite(err_j))
    u = jax.vmap(lambda k: jax.random.uniform(k, (n, 2), jnp.float32, -1.0, 1.0))(keys)

    res, out, _ = runner.run_monte_carlo(
        cfg, b, seed=seed, device="cpu", noise=torch.from_numpy(noise),
        traj_u=torch.tensor(np.asarray(u)))
    assert set(res) == {"err_ekf_slam", "diverged_ekf_slam"}
    assert out["seen"].sum(1).min() >= 2, "a world saw <2 landmarks"
    np.testing.assert_array_equal(out["seen"].numpy(), np.asarray(out_j["seen"]))
    # trajectories and the rollout each differ from JAX in the last bit of
    # XLA's vs torch's CPU transcendentals; over 60 ticks the average error
    # stays within 1e-4 relative
    np.testing.assert_allclose(res["err_ekf_slam"], err_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(res["diverged_ekf_slam"], div_j)


@pytest.mark.parametrize("filt", ["iekf_slam", "ukf_slam", "ukf_loc"])
def test_run_monte_carlo_matches_jax_composition_for_each_filter(filt):
    # the JAX runner's fused routing (runner.py:402-430) for the filters the
    # port gained after EKF-SLAM, at the CPU tests' small size
    b, t, n, seed = 4, 30, 4, 4
    cfg = _small(Config, t, n, 3.0).replace(filter=filt)
    jcfg = _small(JConfig, t, n, 3.0).replace(filter=filt)
    noise = np.random.default_rng(9).uniform(
        -1, 1, (t, 2 * n + 8, b)).astype(np.float32)

    jcfg, lms = jrunner._gen_maps(jcfg, np.random.default_rng(seed), b)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    cmds = jax.vmap(lambda l, k: j_gen(jcfg, l, n, k))(lms, keys)
    kw = dict(block_worlds=b, noise=jnp.asarray(noise), interpret=True)
    if filt == "iekf_slam":
        out_j = j_rollout(jcfg, lms, cmds, seed, filter_kind="iekf", **kw)
    else:
        out_j = j_ukf_rollout(jcfg, lms, cmds, seed, slam=filt == "ukf_slam", **kw)
    err_max_j = np.asarray(out_j["err_max"])
    err_j = np.asarray(out_j["err_sum"]) / t
    div_j = (~np.isfinite(err_max_j) | (err_max_j > jrunner.DIVERGENCE_RADIUS)
             | ~np.isfinite(err_j))
    u = jax.vmap(lambda k: jax.random.uniform(k, (n, 2), jnp.float32, -1.0, 1.0))(keys)

    res, out, _ = runner.run_monte_carlo(
        cfg, b, seed=seed, device="cpu", noise=torch.from_numpy(noise),
        traj_u=torch.tensor(np.asarray(u)))
    assert set(res) == {"err_" + filt, "diverged_" + filt}
    np.testing.assert_array_equal(out["seen"].numpy(), np.asarray(out_j["seen"]))
    if filt.startswith("ukf"):
        # kept in `out`, and no divergence by itself (runner.py:416-419)
        np.testing.assert_array_equal(out["update_rejects"].numpy(),
                                      np.asarray(out_j["update_rejects"]))
    else:
        assert out["seen"].sum(1).max() >= 2, "no world saw 2 landmarks"
    # as for EKF-SLAM above: last-bit differences of the CPU transcendentals
    np.testing.assert_allclose(res["err_" + filt], err_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(res["diverged_" + filt], div_j)


def test_divergence_latch_reads_the_running_max(monkeypatch):
    cfg = Config(num_iterations=10)
    fake = {"err_sum": torch.tensor([1.0, 2.0, float("nan"), 3.0]),
            "err_max": torch.tensor([0.5, 60.0, 1.0, float("inf")])}
    monkeypatch.setattr(runner, "fused_ekf_rollout", lambda *a, **k: fake)
    monkeypatch.setattr(runner, "mc_inputs", lambda *a, **k: (None, None))
    res, _, _ = runner.run_monte_carlo(cfg, 4, device="cpu")
    np.testing.assert_allclose(res["err_ekf_slam"][[0, 1, 3]], [0.1, 0.2, 0.3])
    np.testing.assert_array_equal(res["diverged_ekf_slam"],
                                  [False, True, True, True])


def test_shared_protocol_repeats_maps_relabelled_by_tour():
    cfg = Config(num_iterations=5)
    lms, cmds = runner.mc_inputs(cfg, 512, 0, "cpu", shared=True, relabel=True)
    assert lms.shape == (512, 20, 2) and cmds.shape == (512, 5, 2)
    assert torch.equal(lms[0], lms[255]) and not torch.equal(lms[0], lms[256])
    assert torch.equal(cmds[256], cmds[511])
    # relabelled: the same two maps, landmark ids renumbered in visit order
    raw, _ = runner.mc_inputs(cfg, 2, 0, "cpu")
    for w, blk in [(0, 0), (1, 256)]:
        assert sorted(map(tuple, raw[w].tolist())) == sorted(map(tuple, lms[blk].tolist()))


def test_out_of_scope_runs_raise():
    cfg = Config(num_iterations=5)
    for kw, item in [({"impl": "xla"}, "M9"), ({"collect": "poses"}, "M9")]:
        with pytest.raises(NotImplementedError, match=item):
            runner.run_monte_carlo(cfg, 2, **kw)
    with pytest.raises(NotImplementedError, match="M9"):
        runner.run_monte_carlo(cfg.replace(filter="naive"), 2)
    with pytest.raises(NotImplementedError, match="run_monte_carlo_pg_streams"):
        runner.run_monte_carlo(cfg.replace(filter="pose_graph"), 2)
    with pytest.raises(NotImplementedError, match="M9"):
        runner.run_monte_carlo(cfg.replace(landmark_map="demo"), 2,
                               device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(num_iterations=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_monte_carlo(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["monte_carlo", "--batch", "2", "--steps", "5"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_monte_carlo_pg_streams(cfg.replace(filter="pose_graph"), 2)
    assert runner.resolve_device("cpu") == torch.device("cpu")


def test_cli_monte_carlo_prints_mean_and_std(capsys):
    assert cli.main(["monte_carlo", "--batch", "4", "--steps", "30",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("ekf_slam: mean ") and " std " in lines[0]
    assert lines[1].startswith("diverged_ekf_slam: mean ")


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main(["--worlds", "4", "--steps", "2"])
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main(["--filter", "pose_graph", "--worlds", "4", "--steps", "2"])


def test_bench_pose_graph_config_and_summary():
    # the study's config as the JAX bench script builds it: high noise,
    # honest sigmas, the chosen secondary and solve mode
    cfg = bench.pg_config(50, "iekf_slam", True)
    assert (cfg.filter, cfg.num_iterations) == ("pose_graph", 50)
    assert (cfg.process_noise.V_00, cfg.process_noise.V_11) == (0.01, 0.001)
    assert (cfg.sensing_noise.W_00, cfg.sensing_noise.W_11) == (0.01, 0.01)
    assert cfg.pose_graph.filter_to_compare == "iekf_slam"
    assert cfg.pose_graph.solve_graph_every_iteration
    assert not cfg.compat.pg_variances_as_sigmas
    res = {"err_naive": np.array([1.0, 3.0]),
           "err_pose_graph_initial": np.array([1.0, 2.0]),
           "err_pose_graph_result": np.array([0.5, 0.25]),
           "diverged_pose_graph": np.array([False, True])}
    info = {"seconds": dict(inputs=9.0, streams=0.1, secondary=0.2,
                            assemble=0.2, replay=3.0, solve=4.0)}
    out = bench.pg_summary(res, info, 50, "naive")
    assert out["accum_steps_per_s_per_world"] == pytest.approx(100.0)
    assert (out["replay_s"], out["solve_s"], out["diverged"]) == (3.0, 4.0, 1)
    assert out["mean_err_pose_graph_result"] == pytest.approx(0.375)


def test_port_runs_its_slice_without_jax():
    # every module of the port and chip_smoke (imported, not run), the three
    # microbenchmark tools on the CPU at a tiny size, then the
    # CPU slice of all four filters and the pose-graph streams path in both
    # solve modes; no module of jax, jaxlib, flax or the
    # JAX package may be loaded (split on "." so that the port's own name,
    # live_ekf_slam_tpu_torch, does not match)
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from live_ekf_slam_tpu_torch.config import Config\n"
        "from live_ekf_slam_tpu_torch.eval.runner import FILTERS, run_monte_carlo\n"
        "import live_ekf_slam_tpu_torch.bench, live_ekf_slam_tpu_torch.cli\n"
        "import live_ekf_slam_tpu_torch.convert\n"
        "import live_ekf_slam_tpu_torch.ops.micro_ops\n"
        "import live_ekf_slam_tpu_torch.utils.profiling\n"
        "from live_ekf_slam_tpu_torch.tools import (micro_downdate, micro_ukf,\n"
        "                                           micro_ukf_probe)\n"
        "tiny = ['--device', 'cpu', '--worlds', '2', '--passes', '1']\n"
        "for tool in (micro_downdate, micro_ukf, micro_ukf_probe):\n"
        "    assert tool.main(tiny) == 0\n"
        "cfg = Config(num_iterations=5)\n"
        "res, out, _ = run_monte_carlo(cfg, 2, device='cpu')\n"
        "for f in FILTERS:\n"
        "    cfg = Config(num_iterations=10).replace(filter=f)\n"
        "    res, out, _ = run_monte_carlo(cfg, 4, device='cpu')\n"
        "    assert res['err_' + f].shape == (4,)\n"
        "    assert out['x'].shape == (4, 4 if f == 'ukf_loc' else\n"
        "                              44 if f == 'ukf_slam' else 43)\n"
        "import dataclasses\n"
        "from live_ekf_slam_tpu_torch.eval.runner import run_monte_carlo_pg_streams\n"
        "for sec, it in (('ekf_slam', False), ('naive', True)):\n"
        "    cfg = Config(num_iterations=8).replace(filter='pose_graph')\n"
        "    cfg = cfg.replace(pose_graph=dataclasses.replace(\n"
        "        cfg.pose_graph, filter_to_compare=sec, bulk_gn_iters=2,\n"
        "        bulk_cg_iters=2, solve_graph_every_iteration=it))\n"
        "    res, _, _ = run_monte_carlo_pg_streams(cfg, 2, device='cpu')\n"
        "    assert res['err_pose_graph_result'].shape == (2,)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'live_ekf_slam_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    # the three tools printed their rows: 7 + 7 + 8, each under a header
    assert sum(line.startswith("shapes: P=(2,48,48)") for line in lines) == 3
    assert sum("G elem-" in line for line in lines) == 22


@pytest.mark.parametrize("tool", ["micro_downdate", "micro_ukf", "micro_ukf_probe"])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, monkeypatch, capsys):
    import importlib

    mod = importlib.import_module(f"live_ekf_slam_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--worlds", "4", "--passes", "1"])
    assert mod.main(["--device", "cpu", "--worlds", "2", "--passes", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("shapes: P=(2,48,48) f32 on cpu")
    assert all(("us/pass" in line) or (" ms " in line) for line in out[1:])
