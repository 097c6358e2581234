"""The port's single-world demo presets against the JAX CLI's:
``run_demo`` (filter_demo_live, filter_demo_results_only) for the five
online filters (the pose graph's in ``test_torch_demo_pose_graph.py``, so
that its JAX compiles take a worker of their own), ``run_sim_base`` in both
trajectory modes, the async frame feed and the async demos, and
``--base-dir``.

Both packages get the same map and the same draws: the port's trajectory
and simulator draws are JAX's own (the trajectory's from PRNGKey(seed), the
ticks' from split(PRNGKey(seed + 1), T), ``port_harness.tick_noise``). Each
side's viewer is a frame recorder (``viz.live.FrameRecorder``: the frames
the viewer receives, and its average error), and the frames are held at the
per-tick path's tolerances (``tests/test_torch_per_tick_runner.py``), the
pose graph's final solve at the per-tick pose graph's
(``tests/test_torch_pg_per_tick.py``). B = 1, T = 40, N = 6 in a +/-3 m
box; the pose
graph's bulk schedule cut to 8 + 8 + 8 Gauss-Newton steps of 12 CG steps on
both sides, as the per-tick pose graph's tests cut it. JAX's async branch
needs its own native library, which is not built here, so the port's async
frames are held against JAX's synchronous frames of the same ticks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu import cli as jcli
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.config import preset as jpreset
from live_ekf_slam_tpu.viz import live as jlive
from live_ekf_slam_tpu_torch import cli
from live_ekf_slam_tpu_torch.config import Config, preset
from live_ekf_slam_tpu_torch.viz.async_feed import AsyncFrameFeed
from live_ekf_slam_tpu_torch.viz.live import Frame, FrameRecorder
from port_harness import few_threads, tick_noise  # noqa: F401  (few_threads: a fixture)

matplotlib.use("Agg")
pytestmark = pytest.mark.usefixtures("few_threads")

T, N, SEED = 40, 6, 0
ERR_ATOL = 1e-5     # the average error (tests/test_torch_per_tick_runner.py:35)
POSE_ATOL = 1e-4    # every array of a frame (:36)
RESULT_ATOL = 5e-4  # the pose graph's final solve (tests/test_torch_pg_per_tick.py:54)
FILTERS = ("naive", "ekf_slam", "iekf_slam", "ukf_slam", "ukf_loc")
MODES = {"live": "filter_demo_live", "results_only": "filter_demo_results_only"}
FIELDS = ("true_pose", "est_pose", "landmarks", "cov", "sigma_pts", "pg_initial",
          "pg_result", "pg_landmarks", "pg_meas", "path")


def small(cfg, filt=None, **kw):
    """``cfg`` at T ticks and N landmarks in a +/-3 m box (so that the
    vehicle meets several in T ticks), the pose graph's schedule cut."""
    cfg = cfg.replace(num_iterations=T,
                      map=dataclasses.replace(cfg.map, num_landmarks=N, bound=3.0),
                      pose_graph=dataclasses.replace(cfg.pose_graph, bulk_gn_iters=8,
                                                     bulk_cg_iters=12), **kw)
    return cfg.replace(filter=filt) if filt else cfg


def draws(seed=SEED):
    """JAX's draws of one world as the port's test hooks: the simulator's
    (T, 2N+8, 1) and the trajectory's (1, N, 2)."""
    noise = tick_noise(jax.random.split(jax.random.PRNGKey(seed + 1), T), N)
    u = jax.random.uniform(jax.random.PRNGKey(seed), (N, 2), jnp.float32, -1.0, 1.0)
    return (torch.tensor(np.array(noise))[..., None],
            torch.tensor(np.array(u))[None])


def jax_run(fn, monkeypatch=None, **kw):
    """A JAX CLI function with a frame recorder for its viewer: (its return
    value, the recorder)."""
    made = []

    class Recorder(FrameRecorder):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    saved = jlive.LiveViewer
    jlive.LiveViewer = Recorder
    try:
        out = fn(**kw)
    finally:
        jlive.LiveViewer = saved
    return out, made[0]


_JAX = {}


def jax_demo(filt, mode):
    """JAX run_demo of one filter and mode, run once a module."""
    if (filt, mode) not in _JAX:
        cfg = small(jpreset(MODES[mode], JConfig()), filt)
        _JAX[filt, mode] = jax_run(jcli.run_demo, cfg=cfg, seed=SEED,
                                   live=mode == "live")
    return _JAX[filt, mode]


def port_demo(filt, mode, **kw):
    noise, u = draws()
    views = []
    cfg = small(preset(MODES[mode], Config()), filt, **kw)
    avg = cli.run_demo(cfg, seed=SEED, live=mode == "live", device="cpu",
                       noise=noise, traj_u=u, viewer=FrameRecorder.into(views))
    return avg, views[0]


def check_frames(got, want, final_atol=RESULT_ATOL):
    assert [f.timestep for f in got] == [f.timestep for f in want]
    last = want[-1].timestep if want else None
    for a, b in zip(got, want):
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), (a.timestep, k)
            if x is None:
                continue
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            assert x.shape == y.shape, (a.timestep, k, x.shape, y.shape)
            final = a.timestep == last and k in ("pg_result", "pg_landmarks")
            np.testing.assert_allclose(x, y, rtol=0, atol=final_atol if final else POSE_ATOL,
                                       err_msg=f"tick {a.timestep} {k}")


def check_demo(filt, mode, capsys):
    """The port's demo of one filter and mode against JAX's: the frames the
    viewer receives, the average error and the printed line."""
    avg_j, rec_j = jax_demo(filt, mode)
    line_j = capsys.readouterr().out.strip().splitlines()[-1]
    avg, view = port_demo(filt, mode)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    frames = view.frames
    # live mode renders every tick, results-only mode the last one
    assert len(frames) == (T if mode == "live" else 1)
    check_frames(frames, rec_j.frames)
    np.testing.assert_allclose(avg, avg_j, rtol=0, atol=ERR_ATOL)
    # the printed line is JAX's, word for word, up to the number
    prefix = f"Average error in {filt} from true vehicle pose history = "
    assert line.startswith(prefix) and line_j.startswith(prefix)
    assert abs(float(line[len(prefix):]) - float(line_j[len(prefix):])) <= ERR_ATOL
    return frames[-1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("filt", FILTERS)
def test_demo_frames_match_jax(filt, mode, capsys):
    last = check_demo(filt, mode, capsys)
    if filt != "naive" and filt != "ukf_loc":
        assert len(last.landmarks) >= 2
    if filt.startswith("ukf"):
        du = 4 + 2 * N if filt == "ukf_slam" else 4
        assert last.sigma_pts.shape == (du, 2 * du + 1)


@pytest.mark.parametrize("precompute", [True, False])
def test_sim_base_matches_jax(precompute):
    cfg_j = small(jpreset("sim_base", JConfig()), precompute_trajectory=precompute)
    cfg = small(preset("sim_base", Config()), precompute_trajectory=precompute)
    _, rec_j = jax_run(jcli.run_sim_base, cfg=cfg_j, seed=SEED)
    noise, u = draws()
    view = cli.run_sim_base(cfg, seed=SEED, device="cpu", noise=noise, traj_u=u,
                            viewer=FrameRecorder)
    # filterless: no estimate, no error
    assert all(f.est_pose is None for f in view.frames) and not view.errors
    assert np.isnan(view.finish())
    check_frames(view.frames, rec_j.frames)
    if precompute:  # the TSP trajectory drives
        moved = view.frames[-1].true_pose[:2] - np.asarray(cfg.init_pose[:2])
        assert np.linalg.norm(moved) > 0.5
    else:  # goal pursuit without a clicked goal has no path
        assert all(f.path is None for f in view.frames)


def test_sim_base_renders_headless(tmp_path):
    cfg = small(preset("sim_base", Config()))
    cfg = cfg.replace(num_iterations=8, plotter=dataclasses.replace(
        cfg.plotter, save_final_map=True))
    cli.run_sim_base(cfg, seed=SEED, base_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "plots" / "ekf_slam_demo.png").stat().st_size > 0


def test_async_frame_feed_roundtrip():
    rng = np.random.default_rng(2)
    du = 14  # 4 + 2*5
    feed = AsyncFrameFeed(n_landmark_slots=5, d_cov=13, du_sigma=du, t_pg=10,
                          n_pg_meas=4)
    lms = np.array([[0, 1.0, 2.0], [3, -1.0, 0.5]], np.float32)
    cov = rng.normal(size=(13, 13)).astype(np.float32)
    sig = rng.normal(size=(du, 2 * du + 1)).astype(np.float32)
    pg_i = rng.normal(size=(8, 3)).astype(np.float32)
    pg_r = rng.normal(size=(8, 3)).astype(np.float32)
    pg_l = rng.normal(size=(3, 2)).astype(np.float32)
    pg_m = np.array([[1, 0], [2, 2], [3, 1], [5, 0], [6, 2]], np.int64)
    feed.push(Frame(timestep=7, true_pose=np.array([1.0, 2.0, 0.3]),
                    est_pose=np.array([1.1, 2.1, 0.25]), landmarks=lms, cov=cov,
                    sigma_pts=sig, pg_initial=pg_i, pg_result=pg_r,
                    pg_landmarks=pg_l, pg_meas=pg_m))
    fr = feed.pop_latest()
    assert fr is not None and fr.timestep == 7
    np.testing.assert_allclose(fr.true_pose, [1.0, 2.0, 0.3], atol=1e-6)
    np.testing.assert_allclose(fr.est_pose, [1.1, 2.1, 0.25], atol=1e-6)
    for got, want in ((fr.landmarks, lms), (fr.cov, cov), (fr.sigma_pts, sig),
                      (fr.pg_initial, pg_i), (fr.pg_result, pg_r),
                      (fr.pg_landmarks, pg_l)):
        np.testing.assert_array_equal(got, want)
    # 5 pairs into capacity 4: the NEWEST 4 survive, dtype back to int
    np.testing.assert_array_equal(fr.pg_meas, pg_m[-4:])
    assert fr.pg_meas.dtype == np.int64
    assert feed.pop_latest() is None
    feed.close()
    # the minimal layout still round-trips (no optional blocks)
    feed2 = AsyncFrameFeed(n_landmark_slots=5)
    feed2.push(Frame(timestep=1, true_pose=np.zeros(3), est_pose=np.ones(3),
                     landmarks=lms))
    fr2 = feed2.pop_latest()
    assert fr2.cov is None and fr2.sigma_pts is None and fr2.pg_initial is None
    np.testing.assert_array_equal(fr2.landmarks, lms)
    feed2.close()


def _async(cfg):
    return cfg.replace(plotter=dataclasses.replace(cfg.plotter, async_viz=True))


def check_async_demo(filt, capsys):
    """The port's async demo against JAX's live demo (synchronous): the
    average over every tick, and each frame the viewer rendered."""
    avg_j, rec_j = jax_demo(filt, "live")
    capsys.readouterr()
    noise, u = draws()
    views = []
    cfg = _async(small(preset("filter_demo_live", Config()), filt))
    avg = cli.run_demo(cfg, seed=SEED, live=True, device="cpu", noise=noise,
                       traj_u=u, viewer=FrameRecorder.into(views))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # the frames the ring dropped are those the viewer never rendered
    frames = views[0].frames
    assert frames and frames[-1].timestep == T
    assert line == (f"Average error in {filt} from true vehicle pose history = "
                    f"{avg} (async viz: {T - len(frames)} frames skipped)")
    # the metric covers every tick, the rendered frames or not
    np.testing.assert_allclose(avg, avg_j, rtol=0, atol=ERR_ATOL)
    # each rendered frame, through the ring's float32 layout, is JAX's frame
    # of its tick
    by_tick = {f.timestep: f for f in rec_j.frames}
    check_frames(frames, [by_tick[f.timestep] for f in frames])


@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_slam"])
def test_async_demo_matches_jax_sync(filt, capsys):
    check_async_demo(filt, capsys)


def test_base_dir_writes_png_and_csv(tmp_path, capsys):
    params = tmp_path / "params.yaml"
    params.write_text("plotter: {save_final_map: true}\n"
                      "pose_graph: {save_average_error_at_end: true}\n"
                      f"map: {{num_landmarks: {N}, bound: 3.0}}\n")
    out = tmp_path / "out"
    argv = ["filter_demo_results_only", "--params", str(params), "--filter",
            "ekf_slam", "--steps", "20", "--device", "cpu", "--base-dir", str(out)]
    for _ in range(2):
        assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("Average error in ekf_slam from true vehicle pose "
                                "history = ")
    avg = float(lines[-1].rsplit(" ", 1)[1])
    assert (out / "plots" / "ekf_slam_demo.png").stat().st_size > 0
    # one line appended a run
    assert [float(x) for x in (out / "data" / "ekf_slam.csv").read_text().split()] == [avg] * 2
    # --plot-result-only on the live preset: one rendered frame, same metric
    assert cli.main(["filter_demo_live", "--plot-result-only", "--params", str(params),
                     "--steps", "20", "--device", "cpu"]) == 0
    assert float(capsys.readouterr().out.strip().rsplit(" ", 1)[1]) > 0


def test_demo_presets_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small(preset("filter_demo_results_only", Config()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_demo(cfg, live=False, viewer=FrameRecorder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_sim_base(cfg, viewer=FrameRecorder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["filter_demo_results_only", "--steps", "5"])
