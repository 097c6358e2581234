"""The port's host tools against the JAX package's: the recorder's CSVs and
bar charts (``eval/recorder``) with ``cli monte_carlo --runs-dir`` and the
``bar_graphs`` preset, the covariance ellipse (``viz/artists``), the
AprilTag bridge, its recorded replay (the poses against JAX's replay) and
its detector-config schema (``hw/apriltag``), and checkpoints of the
per-tick run state (``utils/checkpoint``): the round trip, a resumed run
equal bit for bit, and a state restored onto another device and dtype."""

import math
import os
import textwrap

import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import recorder as jrecorder
from live_ekf_slam_tpu.hw import apriltag as japriltag
from live_ekf_slam_tpu.viz import artists as jartists
from live_ekf_slam_tpu_torch import cli
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval import recorder
from live_ekf_slam_tpu_torch.eval.runner import init_carry, make_step
from live_ekf_slam_tpu_torch.hw import apriltag
from live_ekf_slam_tpu_torch.ops.philox import philox_noise
from live_ekf_slam_tpu_torch.utils import checkpoint as ckpt
from live_ekf_slam_tpu_torch.viz.artists import (
    cov_to_ellipse,
    landmark_sigma_points_xy,
    sigma_points_xy,
)
from port_harness import few_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_threads")


def test_recorder_and_bar_charts(tmp_path):
    run = tmp_path / "ekf_high_noise_iter"
    errs = {"ekf": [1.0, 1.2, 1.4], "pose_graph_result": [0.6, 0.7, 0.8]}
    recorder.write_run_csvs(str(run), errs)
    pgs_m, filt_m, ftype = recorder.bar_chart(str(run), str(tmp_path / "plots"))
    assert ftype == "EKF-SLAM"
    assert abs(pgs_m - 0.7) < 1e-9 and abs(filt_m - 1.2) < 1e-9
    assert (tmp_path / "plots" / "ekf_high_noise_iter.png").exists()
    # the same files as JAX's recorder writes, and the same charts' means
    jrun = tmp_path / "jax" / "ekf_high_noise_iter"
    jrecorder.write_run_csvs(str(jrun), errs)
    for name in ("ekf.csv", "pose_graph_result.csv"):
        assert (run / name).read_text() == (jrun / name).read_text()
    assert jrecorder.bar_chart(str(jrun), str(tmp_path / "jplots")) == (pgs_m, filt_m, ftype)
    assert recorder.read_errs(str(run / "ekf.csv")) == errs["ekf"]


def test_cli_runs_dir_and_bar_graphs(tmp_path, capsys):
    run = tmp_path / "data" / "naive_low_noise_one"
    common = ["--batch", "2", "--steps", "6", "--device", "cpu", "--params",
              str(_params(tmp_path)), "--runs-dir", str(run)]
    # the pose graph with its naive secondary, then a naive run appending to
    # the same naive CSVs (the bulk solve's schedule makes the first ~25 s)
    assert cli.main(["monte_carlo", "--filter", "pose_graph", *common]) == 0
    assert cli.main(["monte_carlo", "--filter", "naive", "--impl", "per_tick",
                     *common]) == 0
    names = sorted(os.listdir(run))
    assert names == ["diverged_naive.csv", "diverged_pose_graph.csv", "naive.csv",
                     "pose_graph.csv", "pose_graph_initial.csv",
                     "pose_graph_result.csv"]
    assert len(recorder.read_errs(str(run / "naive.csv"))) == 4
    assert len(recorder.read_errs(str(run / "pose_graph_result.csv"))) == 2
    capsys.readouterr()
    plots = tmp_path / "plots"
    assert cli.main(["bar_graphs", "--data-dir", str(tmp_path / "data"),
                     "--plots-dir", str(plots)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("naive_low_noise_one:\n\tPGS: ") and "\tNaive: " in out
    assert (plots / "naive_low_noise_one.png").exists()
    # JAX's sweep over the same directory gives the same means
    res = recorder.make_all_bar_charts(str(tmp_path / "data"), str(plots))
    assert res == jrecorder.make_all_bar_charts(str(tmp_path / "data"),
                                                str(tmp_path / "jplots"))


def _params(tmp_path):
    p = tmp_path / "params.yaml"
    p.write_text("pose_graph: {bulk_gn_iters: 2, bulk_cg_iters: 2}\n"
                 "map: {num_landmarks: 4}\n")
    return p


def test_cov_ellipse_and_sigma_points():
    ell = cov_to_ellipse(np.diag([4.0, 1.0]), n_std=1.0)
    assert ell.shape == (2, 100)
    # semi-axes ~ 2*sqrt(vals): x extent 4, y extent 2
    assert abs(ell[0].max() - 4.0) < 0.05 and abs(ell[1].max() - 2.0) < 0.05
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 2))
    np.testing.assert_array_equal(cov_to_ellipse(a @ a.T, 2.0),
                                  jartists.cov_to_ellipse(a @ a.T, 2.0))
    sig = rng.normal(size=(8, 17))
    for got, want in zip(sigma_points_xy(sig) + landmark_sigma_points_xy(sig),
                         jartists.sigma_points_xy(sig)
                         + jartists.landmark_sigma_points_xy(sig)):
        np.testing.assert_array_equal(got, want)


def test_apriltag_bridge():
    dets = [apriltag.TagDetection(tag_id=3, translation=(1.0, 1.0, 0.5)),
            apriltag.TagDetection(tag_id=7, translation=(2.0, 0.0, 0.5))]
    flat = apriltag.detections_to_measurements(dets)
    assert flat[0] == 3.0 and abs(flat[1] - np.sqrt(2.0)) < 1e-9
    assert abs(flat[2] - np.pi / 4) < 1e-9
    jdets = [japriltag.TagDetection(d.tag_id, d.translation) for d in dets]
    assert flat == japriltag.detections_to_measurements(jdets)
    assert (apriltag.detections_to_measurements(dets, compat_tan_bearing=True)
            == japriltag.detections_to_measurements(jdets, compat_tan_bearing=True))
    meas = apriltag.flat_to_measurement_slots(flat, 4)
    jmeas = japriltag.flat_to_measurement_slots(flat, 4)
    for f in ("ids", "r", "b", "valid", "overflow"):
        got = getattr(meas, f)
        assert got.shape[0] == 1  # one world
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(getattr(jmeas, f)))
    assert int(meas.ids[0, 0]) == 3 and int(meas.ids[0, 1]) == 7
    assert bool(meas.valid[0, 1]) and not bool(meas.valid[0, 2])
    # more detections than slots: the overflow flag
    assert bool(apriltag.flat_to_measurement_slots(flat, 1).overflow[0])
    q = (0.9, 0.1, -0.2, 0.3)
    np.testing.assert_array_equal(apriltag.quat_to_mat(*q), japriltag.quat_to_mat(*q))
    np.testing.assert_array_equal(apriltag.se3((1, 2, 3), q), japriltag.se3((1, 2, 3), q))


def _replay_log(cfg, lms):
    """A noiseless straight drive's camera-frame detection log."""
    pose = np.zeros(3)
    cmds, log = [], []
    for _ in range(cfg.num_iterations):
        pose[0] += 0.1
        cmds.append((0.1, 0.0))
        dets = []
        for j, lm in enumerate(lms):
            dx, dy = lm - pose[:2]
            r = math.hypot(dx, dy)
            if r <= cfg.constraints.vision.range_max:
                b = math.atan2(dy, dx) - pose[2]
                dets.append((j, (r * math.cos(b), r * math.sin(b), 0.5)))
        log.append(dets)
    return np.asarray(cmds, np.float32), log, pose


@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_slam", "naive"])
def test_apriltag_recorded_replay_matches_jax(filt):
    """A recorded camera-frame detection log, TF'd from the camera mount
    frame, drives the filter through the bridge; its poses are JAX's."""
    cfg = Config(num_iterations=40).replace(num_landmark_slots=3, num_meas_slots=3)
    jcfg = JConfig(num_iterations=40).replace(num_landmark_slots=3, num_meas_slots=3)
    lms = np.array([[2.0, 0.5], [3.0, -0.8], [4.0, 1.2]])
    cmds, raw, pose = _replay_log(cfg, lms)
    tf = apriltag.FrameTransforms()
    tf.register("base_link", "camera", apriltag.se3((0.0, 0.0, 0.0)))
    T = tf.get_transform("base_link", "camera")
    assert T is not None and np.allclose(T, np.eye(4))
    assert tf.get_transform("camera", "base_link") is not None
    assert tf.get_transform("camera", "laser") is None
    log = [[apriltag.TagDetection(j, t) for j, t in dets] for dets in raw]
    jlog = [[japriltag.TagDetection(j, t) for j, t in dets] for dets in raw]
    state, poses = apriltag.replay_detection_log(cfg, log, cmds, filt, T_base_cam=T,
                                                 device="cpu")
    jstate, jposes = japriltag.replay_detection_log(jcfg, jlog, cmds, filt, T_base_cam=T)
    assert poses.shape == (40, 3)
    np.testing.assert_allclose(poses, np.asarray(jposes), rtol=0, atol=1e-4)
    if filt != "naive":
        assert int(state.M[0]) == int(jstate.M) >= 2  # saw and inserted landmarks
        # noiseless measurements + exact odometry -> tight tracking
        assert np.linalg.norm(poses[-1][:2] - pose[:2]) < 0.05


def test_apriltag_detector_config_schema(tmp_path):
    settings_yaml = textwrap.dedent("""\
        tag_family:        'tag36h11'
        tag_threads:       2
        tag_decimate:      1.0
        tag_blur:          0.0
        tag_refine_edges:  1
        tag_debug:         0
        max_hamming_dist:  2
        publish_tf:        true
        transport_hint:    "raw"
    """)
    tags_yaml = textwrap.dedent("""\
        standalone_tags:
          [
            {id: 0, size: 0.054},
            {id: 1, size: 0.054},
            {id: 8, size: 0.02635},
          ]
        tag_bundles:
          [
          ]
    """)
    sp, tp = tmp_path / "settings.yaml", tmp_path / "tags.yaml"
    sp.write_text(settings_yaml)
    tp.write_text(tags_yaml)
    settings, registry = apriltag.load_detector_config(str(sp), str(tp))
    jsettings, jregistry = japriltag.load_detector_config(str(sp), str(tp))
    assert settings.tag_family == "tag36h11" and settings.max_hamming_dist == 2
    assert vars(settings) == vars(jsettings)
    assert registry.ids == jregistry.ids == {0, 1, 8}
    assert registry.size_of(8) == 0.02635 and registry.size_of(5) is None
    dets = [apriltag.TagDetection(i, (1.0, 0.0, 0.5)) for i in (0, 5, 8)]
    assert [d.tag_id for d in registry.filter_detections(dets)] == [0, 8]
    with pytest.raises(ValueError, match="unknown tag_family"):
        apriltag.DetectorSettings(tag_family="tag99h1")
    with pytest.raises(ValueError, match="duplicate tag ids"):
        apriltag.TagRegistry(standalone_tags=[{"id": 1, "size": 0.1}] * 2)


def _run(cfg, n_ticks, t0=0, carry=None):
    lms = torch.as_tensor(np.random.default_rng(0).uniform(-5, 5, (2, 4, 2)),
                          dtype=torch.float32)
    carry = carry if carry is not None else init_carry(cfg, lms)
    step = make_step(cfg)
    noise = philox_noise(5, 10, 4, 2)
    cmd = torch.tensor([[0.05, 0.01]] * 2)
    for t in range(t0, t0 + n_ticks):
        carry, _ = step(carry, cmd, noise[t].T, t)
    return carry


def _cfg(filt="ekf_slam"):
    cfg = Config(num_iterations=10).replace(filter=filt, num_landmark_slots=4,
                                            num_meas_slots=4)
    return cfg.replace(map=cfg.map.__class__(num_landmarks=4))


@pytest.mark.parametrize("filt", ["ekf_slam", "ukf_slam", "pose_graph"])
def test_checkpoint_roundtrip_and_resume(filt, tmp_path):
    cfg = _cfg(filt)
    carry = _run(cfg, 3)
    path = str(tmp_path / "sub" / "ck.npz")
    ckpt.save(path, carry)
    restored = ckpt.restore(path, carry)
    leaves = ckpt.leaves(carry)
    assert len(leaves) == len(np.load(path).files) > 10
    for a, b in zip(leaves, ckpt.leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # the resumed run continues bit for bit
    c1, c2 = _run(cfg, 4, 3, carry), _run(cfg, 4, 3, restored)
    for a, b in zip(ckpt.leaves(c1), ckpt.leaves(c2)):
        assert torch.equal(a, b)
    # a template of another shape is refused
    other = _run(_cfg(filt).replace(num_landmark_slots=5, num_meas_slots=5), 0)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        ckpt.restore(path, other)


def test_checkpoint_restores_onto_the_templates_device_and_dtype(tmp_path):
    carry = _run(_cfg(), 2)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, carry)
    # a template elsewhere (the meta device stands in for another device
    # here; tests/test_torch_cuda.py restores a card's state on the CPU) and
    # in float64: each leaf follows its template
    like = ckpt.tree_map(carry, lambda t: t.to("meta"))
    like = like.replace(primary=ckpt.tree_map(
        like.primary, lambda t: t.double() if t.is_floating_point() else t))
    got = ckpt.restore(path, like)
    for a, b in zip(ckpt.leaves(got), ckpt.leaves(like)):
        assert a.device == b.device and a.dtype == b.dtype and a.shape == b.shape
    back = ckpt.restore(path, carry.replace(primary=ckpt.tree_map(
        carry.primary, lambda t: t.double() if t.is_floating_point() else t)))
    torch.testing.assert_close(back.primary.P, carry.primary.P.double(), rtol=0, atol=0)
