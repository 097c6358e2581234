"""The port's ``utils/profiling.py``: ``trace`` writing a Chrome trace on the
CPU, and the ``les.*`` spans and counters of the benchmarked paths, present
under a profiler and absent, at no work, without one."""

import dataclasses
import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.eval.runner import (
    fused_rollout,
    mc_inputs,
    run_monte_carlo_pg_streams,
)
from live_ekf_slam_tpu_torch.utils import profiling as prof

WORLDS, TICKS, GN_ITERS = 4, 30, 8
# bulk_gn_iters = 8 gives the graduated schedule 8 + 8 + 8 GN steps
# (runner._pg_bulk_solve: each stage at least 8)
GN_STEPS = 24
PG_PHASES = ("inputs", "streams", "secondary", "assemble", "replay", "solve")
GN_PARTS = ("les.pg.gn.system", "les.pg.gn.cg", "les.pg.gn.line_search")
# a phase's span holds both of its clock's readings; the profiler's clock is
# not the host's perf_counter, so they may disagree by a little
SPAN_SLACK_S = 2e-3


def pg_cfg():
    cfg = Config(num_iterations=TICKS).replace(filter="pose_graph")
    return cfg.replace(pose_graph=dataclasses.replace(
        cfg.pose_graph, filter_to_compare="ekf_slam", bulk_gn_iters=GN_ITERS,
        bulk_cg_iters=4, solve_graph_every_iteration=False))


def study():
    return run_monte_carlo_pg_streams(pg_cfg(), WORLDS, seed=3, device="cpu")


def spans(p) -> list:
    """(name, start ns, end ns) of every ``les.*`` span in the profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in p.profiler.kineto_results.events() if e.name().startswith("les.")]


def named(sp, name) -> list:
    return [s for s in sp if s[0] == name]


@pytest.fixture(scope="module")
def traced_study():
    """(spans, info, counters) of one study under the CPU profiler."""
    prof._COUNTERS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _, info, _ = study()
    counts = prof.counters()
    prof._COUNTERS.clear()
    return spans(p), info, counts


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "traces"
    for n in range(2):
        with prof.trace(str(log_dir)) as p:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert p is not None
        path = log_dir / f"trace_{n}.json"
        assert path.exists() and os.path.getsize(path) > 0
        events = json.loads(path.read_text())["traceEvents"]
        assert any("mm" in str(e.get("name", "")) for e in events)


def test_the_chrome_trace_holds_the_ports_spans(tmp_path):
    cfg = Config(num_iterations=TICKS)
    with prof.trace(str(tmp_path)):
        lms, cmds = mc_inputs(cfg, 8, 5, "cpu")
        fused_rollout(cfg, lms, cmds, 5)
    names = {e.get("name") for e in
             json.loads((tmp_path / "trace_0.json").read_text())["traceEvents"]}
    assert {"les.inputs.maps", "les.inputs.trajectory", "les.fused_rollout"} <= names


def test_profiling_module_loads_no_jax_and_no_torch_at_import():
    # like the JAX module, it imports its framework inside trace() only; off
    # a profiler, span and count do not load it either
    import subprocess
    import sys

    code = ("import sys\n"
            "import live_ekf_slam_tpu_torch.utils.profiling as p\n"
            "with p.span('les.x'):\n"
            "    p.count('x', 1)\n"
            "assert not p.tracing() and p.counters() == {}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'live_ekf_slam_tpu', 'torch'))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_without_a_profiler_no_span_is_made_and_nothing_is_counted(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    prof._COUNTERS.clear()
    assert prof.span("les.a") is prof.span("les.b")
    _, info, _ = study()
    assert set(info["seconds"]) == set(PG_PHASES)
    assert prof._COUNTERS == {} and prof.counters() == {}


def test_count_sums_ints_and_device_tensors_only_while_tracing():
    prof._COUNTERS.clear()
    prof.count("n", 5)
    assert prof.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert prof.tracing()
        prof.count("n", 3)
        prof.count("n", torch.tensor(4))
        prof.count("m", torch.tensor([True, False, True]).sum())
        assert isinstance(prof._COUNTERS["n"], torch.Tensor)
    assert not prof.tracing()
    assert prof.counters() == {"n": 7, "m": 2}
    prof._COUNTERS.clear()


def test_a_traced_study_has_a_span_for_each_phase(traced_study):
    sp, _, _ = traced_study
    names = {s[0] for s in sp}
    want = {f"les.pg.{k}" for k in PG_PHASES} | {
        "les.inputs.maps", "les.inputs.trajectory", "les.fused_rollout", "les.pg.gn"}
    assert want | set(GN_PARTS) <= names
    for k in PG_PHASES:
        assert len(named(sp, f"les.pg.{k}")) == 1, k
    (inputs,) = named(sp, "les.pg.inputs")
    for part in ("les.inputs.maps", "les.inputs.trajectory"):
        (s,) = named(sp, part)
        assert inputs[1] <= s[1] <= s[2] <= inputs[2]
    (solve,) = named(sp, "les.pg.solve")
    assert all(solve[1] <= s[1] <= s[2] <= solve[2] for s in named(sp, "les.pg.gn"))


def test_each_gn_step_is_a_span_holding_its_three_parts_in_order(traced_study):
    sp, _, _ = traced_study
    steps = sorted(named(sp, "les.pg.gn"), key=lambda s: s[1])
    assert len(steps) == GN_STEPS
    for part in GN_PARTS:
        assert len(named(sp, part)) == GN_STEPS, part
    for _, g0, g1 in steps:
        inside = [sorted(s for s in named(sp, part) if g0 <= s[1] and s[2] <= g1)
                  for part in GN_PARTS]
        assert [len(x) for x in inside] == [1, 1, 1]
        (sys_,), (cg,), (ls,) = inside
        assert sys_[2] <= cg[1] and cg[2] <= ls[1]


def test_each_phase_span_covers_its_phase_clock(traced_study):
    sp, info, _ = traced_study
    for k in PG_PHASES:
        (s,) = named(sp, f"les.pg.{k}")
        assert (s[2] - s[1]) * 1e-9 >= info["seconds"][k] - SPAN_SLACK_S, k


def test_the_counters_count_every_worlds_gn_steps(traced_study):
    _, _, counts = traced_study
    assert counts["pg.gn_world_steps"] == WORLDS * GN_STEPS
    assert 0 <= counts["pg.gn_accepted"] <= counts["pg.gn_world_steps"]


def test_a_fused_rollout_is_one_span_a_call():
    cfg = Config(num_iterations=TICKS)
    lms, cmds = mc_inputs(cfg, 8, 11, "cpu")
    fused_rollout(cfg, lms, cmds, 11)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for seed in (1, 2):
            fused_rollout(cfg, lms, cmds, seed)
    assert [s[0] for s in spans(p)] == ["les.fused_rollout"] * 2


def test_a_ukf_rollout_is_one_span_a_call_and_counts_its_refusals():
    # a noisy simulator: the sanity gate refuses updates
    cfg = Config(num_iterations=TICKS, sim_noise_scale=800.0).replace(filter="ukf_slam")
    lms, cmds = mc_inputs(cfg, 8, 11, "cpu")
    prof._COUNTERS.clear()
    fused_rollout(cfg, lms, cmds, 11)
    assert prof.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as p:
        outs = [fused_rollout(cfg, lms, cmds, seed) for seed in (1, 2)]
    counts = prof.counters()
    prof._COUNTERS.clear()
    assert [s[0] for s in spans(p)] == ["les.fused_ukf_rollout"] * 2
    rejects = sum(int(o["update_rejects"].sum()) for o in outs)
    assert rejects > 0
    assert counts == {"ukf.rollouts": 2, "ukf.update_rejects": rejects}


def test_a_sharded_ukf_rollout_counts_once_with_a_span_a_shard():
    from live_ekf_slam_tpu_torch.ops.fused_ukf import fused_ukf_rollout_sharded
    from live_ekf_slam_tpu_torch.parallel.mesh import make_mesh

    cfg = Config(num_iterations=TICKS, sim_noise_scale=800.0).replace(filter="ukf_slam")
    lms, cmds = mc_inputs(cfg, 8, 11, "cpu")
    prof._COUNTERS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fused_ukf_rollout_sharded(cfg, lms, cmds, 5, make_mesh(4, "cpu"))
    counts = prof.counters()
    prof._COUNTERS.clear()
    assert [s[0] for s in spans(p)] == ["les.fused_ukf_rollout"] * 4
    assert counts == {"ukf.rollouts": 1, "ukf.update_rejects": int(out["update_rejects"].sum())}


def test_counts_from_threads_are_all_kept():
    """Eight threads count at once, switching every microsecond; no
    addition is lost."""
    prof._COUNTERS.clear()

    def work():
        for _ in range(1000):
            prof.count("n", 1)
            prof.count("t", torch.tensor(2))

    old = sys.getswitchinterval()
    with profile(activities=[ProfilerActivity.CPU]):
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert prof.counters() == {"n": 8000, "t": 16000}
    prof._COUNTERS.clear()
