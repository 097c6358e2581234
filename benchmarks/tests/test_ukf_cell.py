"""The UKF-SLAM cell on the CPU at small sizes: its check's control and
faults, its wiring in ``BENCHMARK.json`` and the readers of its per-layer
metrics on synthetic traces whose answers are known. The frozen copies are
held against the port in ``tests/test_bench_ukf_slam.py``."""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import pytest

from benchmarks import scenario, spec
from benchmarks.counts import ukf_rollout_work
from benchmarks.params import namespace
from benchmarks.run import run_cell
from benchmarks.tests.test_control import rollout_altered, rollout_half, rollout_unchanged
from benchmarks.tests.test_spans import CUDA, Event
from benchmarks.trace import WINDOW_SPAN, Trace, Tracer

BENCH = spec.benchmark()
CELL = spec.cell("ukf_slam_n20.tour_ids_4096", BENCH)
METRICS = ("ukf_kernel_ms", "ukf_kernel_roofline", "ukf_launch_host_ms",
           "ukf_update_rejects_per_rollout")
TICKS, WORLDS = 40, 8


def small():
    """The cell's configuration and traffic cut to a CPU test's size, its
    check sampling every world."""
    conf = copy.deepcopy(spec.config(CELL["config"]))
    traffic = copy.deepcopy(spec.traffic(CELL["traffic"]))
    conf["params"]["num_iterations"] = 30
    traffic.update(worlds=8, maps=2)
    conf["check"] = {"rollouts": 2, "worlds_per_rollout": 8}
    return conf, traffic


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


def test_the_control_is_not_correct():
    conf, traffic = small()
    run = spec.driver(conf["driver"]).Cell(conf, traffic, 3, "cpu")
    run.window(0.05, Tracer(False))
    sound = run.check()
    assert sound["worlds_calm"] > 0 and not fails(sound, conf["limits"])
    assert fails(run.check(control=True), conf["limits"])


@pytest.fixture(scope="module")
def sound_run():
    conf, traffic = small()
    return run_cell(BENCH, CELL, 3, 0.05, False, "cpu", conf=conf, traffic=traffic,
                    t_start=time.perf_counter())


@pytest.mark.parametrize("program", [rollout_unchanged, rollout_half, rollout_altered],
                         ids=lambda p: p.__name__)
def test_a_broken_timed_path_is_not_correct(program, sound_run):
    assert sound_run["correct"]
    conf, traffic = small()
    bad = run_cell(BENCH, CELL, 3, 0.05, False, "cpu", program=program, conf=conf,
                   traffic=traffic, t_start=time.perf_counter())
    assert not bad["correct"]


def ref_config():
    conf = copy.deepcopy(spec.config("ukf_slam_n20"))
    conf["params"]["num_iterations"] = TICKS
    return namespace(conf["params"])


def test_the_cell_and_its_metrics_are_wired():
    assert CELL["chips"] == 1 and CELL["traffic"] == "tour_ids_4096"
    conf = spec.config(CELL["config"])
    assert conf["reduced"] == [] and conf["params"]["filter"] == "ukf_slam"
    assert hasattr(spec.driver(conf["driver"]), "Cell")
    e2e = {m["name"] for m in spec.metrics_of(CELL["name"], BENCH, "end_to_end")}
    assert e2e == {"setup_s", "rollout_world_steps_per_s", "rollout_p95_ms"}
    per_layer = {m["name"]: m for m in spec.metrics_of(CELL["name"], BENCH, "per_layer")}
    # its own four, and the device's idle share, which every rollout cell reports
    assert set(per_layer) == set(METRICS) | {"device_idle_pct.rollout"}
    for name, m in per_layer.items():
        assert m["moves"] == "rollout_world_steps_per_s" and CELL["name"] in m["workloads"]
        assert callable(spec.metric_reader(name))
    for name in METRICS:
        assert per_layer[name]["workloads"] == [CELL["name"]]
    assert per_layer["ukf_kernel_roofline"]["unit"] == "%"


def window(device=True):
    """A window of 300 ms holding two rollouts' launch spans (one begun
    before the window) and K4's two launches, with the EKF kernel's beside
    them."""
    ev = [Event(WINDOW_SPAN, 1_000_000, 301_000_000),
          Event("les.fused_ukf_rollout", 0, 2_000_000),
          Event("les.fused_ukf_rollout", 100_000_000, 100_500_000)]
    if device:
        kernel = "void (anonymous namespace)::fused_ukf_rollout_kernel<true>(UkfParams, float const*)"
        ev += [Event(kernel, 2_000_000, 88_000_000, CUDA),
               Event(kernel, 101_000_000, 189_000_000, CUDA),
               Event("void fused_ekf_rollout_kernel<false>()", 200_000_000, 210_000_000, CUDA),
               Event("les.fused_ukf_rollout", 100_000_000, 100_500_000, CUDA, annotation=True)]
    return ev


def ctx(trace, run=None, peaks=None, seeds=()):
    return SimpleNamespace(trace=trace, records={"seeds": list(seeds)}, run=run, peaks=peaks)


def test_the_kernel_and_launch_readers_give_the_known_answers():
    trace = Trace(window())
    # K4's two launches, 86 and 88 ms; the launch spans 1 ms (clipped) and 0.5 ms
    assert spec.metric_reader("ukf_kernel_ms")(ctx(trace)) == pytest.approx(87.0)
    assert spec.metric_reader("ukf_launch_host_ms")(ctx(trace)) == pytest.approx(0.75)


def test_the_roofline_is_the_counted_bound_over_the_kernels_time():
    ref = ref_config()
    lms, cmds = scenario.inputs(ref, WORLDS, 2, True, 5, "cpu")
    run = SimpleNamespace(lms=lms, cmds=cmds, ticks=TICKS, ref_cfg=ref)
    peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    got = spec.metric_reader("ukf_kernel_roofline")(
        ctx(Trace(window()), run, peaks, seeds=[21, 22, 23]))
    bounds = []
    for seed in (21, 22):
        g = ukf_rollout_work.gate_counts(ref, lms, cmds, [seed] * WORLDS, range(WORLDS))
        flops, nbytes = ukf_rollout_work.work(g, WORLDS, TICKS, 20)
        bounds.append(max(flops / 67e12, nbytes / 3.35e12))
    assert got == pytest.approx(100.0 * (sum(bounds) / 2) / 0.087, rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_gives_nothing_where_there_is_nothing_to_read(name, monkeypatch):
    from live_ekf_slam_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: {})
    read = spec.metric_reader(name)
    assert read(ctx(None)) is None
    bare = [e for e in window() if not e.name().startswith(("les.", "void"))]
    assert read(ctx(Trace(bare), peaks={"fp32_flops_per_s": 1.0, "hbm_bytes_per_s": 1.0})) is None


def test_the_refusals_read_the_programs_counters(monkeypatch):
    from live_ekf_slam_tpu_torch.utils import profiling

    read = spec.metric_reader("ukf_update_rejects_per_rollout")
    trace = Trace(window())
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"ukf.rollouts": 4, "ukf.update_rejects": 10})
    assert read(ctx(trace)) == pytest.approx(2.5)
    monkeypatch.setattr(profiling, "counters", lambda: {"ukf.rollouts": 4})
    assert read(ctx(trace)) == 0.0
    monkeypatch.setattr(profiling, "counters", lambda: {"pg.gn_world_steps": 8})
    assert read(ctx(trace)) is None
    # an earlier version of the program keeps no counters: nothing, no raise
    monkeypatch.delattr(profiling, "counters")
    assert read(ctx(trace)) is None

