"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; a cell names
its configuration and its traffic mix, the configuration names its driver,
and every metric listed for the cell has a reader of its own name. Each of
these is a file of this folder found by that name, so a later cell, mix,
configuration or metric is added as new files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{_name('configuration', name)}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{_name('traffic', name)}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"benchmarks.drivers.{_name('driver', name)}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (a name may hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{_name('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell_name: str, bench: dict, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it under ``workloads``, and those without the key."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
