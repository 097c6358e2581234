"""The port's single-world demos of the pose graph against the JAX CLI's
(``test_torch_demo.py`` holds the other filters and says how): both demo
modes and the async demo, each frame the viewer receives, the final
frame's ``posegraph.finalize`` solve included; and the async demo on the
real viewer (matplotlib, Agg), its measurement connections drawn. A file of
its own: JAX compiles the per-tick pose graph for each mode, ~20 s each."""

import dataclasses

import numpy as np
import pytest

from live_ekf_slam_tpu_torch import cli
from live_ekf_slam_tpu_torch.config import Config, preset
from live_ekf_slam_tpu_torch.viz.live import LiveViewer
from port_harness import few_threads  # noqa: F401  (fixture)
from test_torch_demo import MODES, SEED, T, _async, check_async_demo, check_demo, small

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("mode", MODES)
def test_pose_graph_demo_frames_match_jax(mode, capsys):
    last = check_demo("pose_graph", mode, capsys)
    # the graph of T ticks (its timestep ends at T - 1) and its landmarks
    assert last.pg_result.shape == last.pg_initial.shape == (T, 3)
    assert len(last.pg_landmarks) >= 2
    assert last.pg_meas is None  # pg_show_meas_connections is off by default


def test_pose_graph_async_demo_matches_jax_sync(capsys):
    check_async_demo("pose_graph", capsys)


def test_async_demo_headless_on_the_live_viewer():
    cfg = _async(small(preset("filter_demo_live", Config()), "pose_graph"))
    cfg = cfg.replace(num_iterations=12, plotter=dataclasses.replace(
        cfg.plotter, pg_show_meas_connections=True))
    views = []

    def viewer(*args, **kw):
        views.append(LiveViewer(*args, **kw))
        return views[-1]

    avg = cli.run_demo(cfg, seed=SEED, live=True, device="cpu", viewer=viewer)
    assert np.isfinite(avg) and len(views[0].errors) == 12
    views[0].close()
