"""The readers of the program's spans and counters, on a synthetic trace
whose answers are known, and, on the card, that the program's spans add no
device activity to a traced run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmarks import spec
from benchmarks.trace import WINDOW_SPAN, Trace, Tracer

BENCH = spec.benchmark()
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN_METRICS = ("rollout_launch_host_ms", "pg_trajectory_s", "pg_gn_system_s", "pg_cg_s",
                "pg_line_search_s", "pg_solve_busy_pct", "pg_device_ops_per_gn_step")
DEVICE_METRICS = ("pg_solve_busy_pct", "pg_device_ops_per_gn_step")


class Event:
    def __init__(self, name, start, end, device=CPU, annotation=False):
        self._n, self._s, self._e, self._d, self._a = name, start, end, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def gn_step(t0):
    """A 10 us GN step at t0 ns with its three parts."""
    return [Event("les.pg.gn", t0, t0 + 10_000), Event("les.pg.gn.system", t0, t0 + 2_000),
            Event("les.pg.gn.cg", t0 + 2_000, t0 + 9_000),
            Event("les.pg.gn.line_search", t0 + 9_000, t0 + 10_000)]


def events(device=True):
    """A window of 100 us (1 us to 101 us) holding two rollout launches (one
    begun before the window), two studies' trajectory spans and solves of two
    GN steps each, and device activity in and out of the solves."""
    ev = [Event(WINDOW_SPAN, 1_000, 101_000),
          Event("les.fused_rollout", 0, 3_000), Event("les.fused_rollout", 10_000, 14_000),
          Event("aten::empty", 10_500, 10_600),
          Event("les.inputs.trajectory", 2_000, 6_000),
          Event("les.inputs.trajectory", 50_000, 52_000),
          Event("les.pg.solve", 20_000, 40_000), Event("les.pg.solve", 60_000, 80_000)]
    for t0 in (20_000, 30_000, 60_000, 70_000):
        ev += gn_step(t0)
    if device:
        ev += [Event("kernel_a", 21_000, 25_000, CUDA), Event("kernel_b", 24_000, 29_000, CUDA),
               Event("kernel_c", 35_000, 36_000, CUDA), Event("kernel_d", 39_500, 41_000, CUDA),
               Event("kernel_e", 65_000, 79_000, CUDA), Event("Memcpy DtoH", 90_000, 95_000, CUDA),
               # the profiler's mirror of a host span on the device: no device work
               Event("les.pg.solve", 20_000, 40_000, CUDA, annotation=True)]
    return ev


def ctx(trace, studies=2):
    return SimpleNamespace(trace=trace, records={"studies": studies}, run=None, peaks=None)


EXPECTED = {
    # (2000 ns clipped to the window + 4000) / 2
    "rollout_launch_host_ms": 3e-3,
    # (4000 + 2000) ns over 2 studies
    "pg_trajectory_s": 3e-6,
    "pg_gn_system_s": 4 * 2_000 * 1e-9 / 2,
    "pg_cg_s": 4 * 7_000 * 1e-9 / 2,
    "pg_line_search_s": 4 * 1_000 * 1e-9 / 2,
    # busy inside the solves: 21-29 us, 35-36, 39.5-40, 65-79 = 23.5 of 40 us
    "pg_solve_busy_pct": 100.0 * 23_500 / 40_000,
    # kernels a to e start inside a solve; the copy does not
    "pg_device_ops_per_gn_step": 5 / 4,
}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_span_reader_gives_the_known_answer(name):
    read = spec.metric_reader(name)
    assert read(ctx(Trace(events()))) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_span_reader_gives_nothing_where_there_is_nothing_to_read(name):
    read = spec.metric_reader(name)
    assert read(ctx(None)) is None
    bare = [e for e in events() if not e.name().startswith("les.")]
    assert read(ctx(Trace(bare))) is None
    got = read(ctx(Trace(events(device=False))))
    if name in DEVICE_METRICS:
        assert got is None
    else:
        assert got == pytest.approx(EXPECTED[name], rel=1e-12)


def test_the_acceptance_share_reads_the_programs_counters(monkeypatch):
    from live_ekf_slam_tpu_torch.utils import profiling

    read = spec.metric_reader("pg_gn_accept_pct")
    trace = Trace(events())
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"pg.gn_world_steps": 8192, "pg.gn_accepted": 6144})
    assert read(ctx(trace)) == pytest.approx(75.0)
    assert read(ctx(None)) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(ctx(trace)) is None
    # an earlier version of the program keeps no counters: the reader
    # gives nothing and does not raise
    monkeypatch.delattr(profiling, "counters")
    assert read(ctx(trace)) is None


def test_every_new_metric_lists_its_cells_and_the_metric_it_moves():
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    rollout = ["ekf_slam_n20.tour_ids_4096", "ekf_slam_n20.perworld_4096"]
    for name in SPAN_METRICS + ("pg_gn_accept_pct",):
        m = by_name[name]
        want = rollout if name.startswith("rollout") else ["pose_graph_ekf_n20.bulk_1024"]
        assert m["workloads"] == want, name
        assert m["source"] == ("program_counter" if name == "pg_gn_accept_pct" else "program_span")
        assert m["moves"] == ("rollout_world_steps_per_s" if name.startswith("rollout")
                              else "pg_study_s")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_on_the_card_has_no_span_among_its_device_activity(cell):
    """The program's spans are mirrored on the device's timeline by the
    profiler; the trace keeps them out of the device activity, so they add
    nothing to the busy time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = spec.cell(cell, BENCH)
    conf, traffic = spec.config(w["config"]), dict(spec.traffic(w["traffic"]))
    if "trace_studies" in traffic:
        traffic["trace_studies"] = 1
    run = spec.driver(conf["driver"]).Cell(conf, traffic, 2147483999, "cuda")
    tracer = Tracer(True)
    run.window(1.0, tracer)
    tr = tracer.trace
    assert len(tr.dev_names) and any(n.startswith("les.") for n in tr.cpu_names)
    assert not [n for n in tr.dev_names if n.startswith("les.")]
