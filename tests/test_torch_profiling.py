"""The port's ``utils/profiling.py``: ``Throughput`` tick for tick against
the JAX package's class, and ``trace`` writing a Chrome trace on the CPU."""

import json
import os
import time

import pytest
import torch

from live_ekf_slam_tpu.utils import profiling as jprof
from live_ekf_slam_tpu_torch.utils import profiling as prof


@pytest.mark.parametrize("n_worlds,alpha", [(1, 0.2), (4096, 0.5)])
def test_throughput_matches_the_jax_class_tick_for_tick(monkeypatch, n_worlds, alpha):
    # both classes read time.perf_counter; each tick sees the same instant
    # (0.75 twice: a tick with no time passed)
    a, b = jprof.Throughput(n_worlds, alpha), prof.Throughput(n_worlds, alpha)
    assert b.steps_per_sec_per_world is None and b.aggregate_steps_per_sec is None
    ticks = zip((1, 10, 5, 1, 100, 3), (0.0, 0.5, 0.75, 0.75, 2.0, 2.25))
    for steps, now in ticks:
        monkeypatch.setattr(time, "perf_counter", lambda now=now: now)
        assert a.tick(steps) == b.tick(steps)
        assert a.steps_per_sec_per_world == b.steps_per_sec_per_world
        assert a.aggregate_steps_per_sec == b.aggregate_steps_per_sec
    assert b.rate is not None and b.aggregate_steps_per_sec == b.rate * n_worlds
    assert b._steps == a._steps == 120


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


def test_profiling_module_loads_no_jax_and_no_torch_at_import():
    # like the JAX module, it imports its framework inside trace() only
    import subprocess
    import sys

    code = ("import sys\n"
            "import live_ekf_slam_tpu_torch.utils.profiling as p\n"
            "p.Throughput(2).tick()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'live_ekf_slam_tpu', 'torch'))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
