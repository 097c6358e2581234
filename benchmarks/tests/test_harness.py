"""The harness's rules, on the CPU: names, discovery by name, the metrics'
wiring, and that nothing it runs loads JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import spec
from benchmarks.run import FORBIDDEN

BENCH = spec.benchmark()
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for kind in ("end_to_end", "per_layer") for m in BENCH[kind]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME.match(name), name
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert spec.UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert m["source"] in (E2E_SOURCES if kind == "end_to_end" else SOURCES), m
    for kind in ("end_to_end", "per_layer", "configs", "workloads"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got)), kind
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_bounds_and_window():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    conf = spec.config(cell["config"])
    assert conf["name"] == cell["config"]
    assert any(c["name"] == cell["config"] and c["file"] == f"benchmarks/configs/{cell['config']}.json"
               for c in BENCH["configs"])
    spec.traffic(cell["traffic"])
    assert hasattr(spec.driver(conf["driver"]), "Cell")
    assert cell["chips"] in (1, 4)
    for kind in ("end_to_end", "per_layer"):
        metrics = spec.metrics_of(cell["name"], BENCH, kind)
        assert metrics, (cell["name"], kind)
        for m in metrics:
            if m["name"] != "setup_s":
                assert callable(spec.metric_reader(m["name"]))
    reported = {m["name"] for m in spec.metrics_of(cell["name"], BENCH, "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2


def test_each_per_layer_metric_moves_a_metric_that_its_cells_report():
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for c in cells:
            reported = {e["name"] for e in spec.metrics_of(c, BENCH, "end_to_end")}
            assert m["moves"] in reported, (m["name"], c)


def test_roofline_metrics_are_named_and_in_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        assert not (_imports(path) & set(FORBIDDEN)), path


def test_the_references_import_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "live_ekf_slam_tpu_torch" not in _imports(path), path
    for path in (spec.HERE / "counts").rglob("*.py"):
        assert "live_ekf_slam_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax_module():
    """A dry run of a rollout cell in a fresh process; then sys.modules is
    searched by whole top-level names."""
    code = ("import sys; from benchmarks import dryrun; from benchmarks.run import forbidden_modules; "
            "dryrun.main(['--workload', 'ekf_slam_n20.tour_ids_4096']); "
            "print('FORBIDDEN', forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert "FORBIDDEN []" in out


def test_the_command_refuses_without_a_card(tmp_path):
    """Without CUDA devices the command prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                        "ekf_slam_n20.tour_ids_4096", "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and not p.stdout.strip()


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder (no program), the command fails and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload",
                        "ekf_slam_n20.tour_ids_4096", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_cell_added_as_new_files_is_found_without_editing(tmp_path):
    """A copy of the benchmark gains a traffic mix, a per-layer metric and a
    cell as new files and new entries only; the dry run finds and runs it."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmarks").rglob("*") if p.is_file()}
    (tmp_path / "benchmarks" / "traffic" / "shared_1024.json").write_text(json.dumps(
        {"worlds": 1024, "maps": 4, "relabel": True, "scenario_seed": None}))
    (tmp_path / "benchmarks" / "metrics" / "rollouts_attempted.py").write_text(
        "def read(ctx):\n    return ctx.records['attempted']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ekf_slam_n20.shared_1024", "config": "ekf_slam_n20",
                               "traffic": "shared_1024", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ekf_slam_n20.tour_ids_4096" in m["workloads"]:
            m["workloads"].append("ekf_slam_n20.shared_1024")
    bench["per_layer"].append({"name": "rollouts_attempted", "unit": "rollouts", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "rollout_world_steps_per_s",
                               "workloads": ["ekf_slam_n20.shared_1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmarks import dryrun; dryrun.main(['--workload', 'ekf_slam_n20.shared_1024'])")
    root = str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, check=True,
                         env=dict(os.environ, PYTHONPATH=f"{tmp_path}:{root}")).stdout
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [x["trace"] for x in lines] == [False, True]
    assert "rollout_world_steps_per_s" in lines[0]["not_device_metrics"]
    assert lines[1]["not_device_metrics"]["rollouts_attempted"]["value"] >= 1
    assert all(x["correct"] for x in lines)
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", cell, "--seed",
                        "2147483999", "--seconds", "2"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
