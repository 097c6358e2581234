"""The check's control and its faults, on the CPU at small sizes.

The control, the reference computed in bfloat16 in the program's place,
must come out not correct; so must a run whose timed path is broken
underneath: a rollout or solve that returns its state unchanged, half of
the batch left out with the mean of the rest in its place, and an answer
altered where it is produced. (Every cell runs on one chip, so no exchange
between chips can be left out.) The runs drive ``run.run_cell`` past its
look for a card, with the port's plain versions on the CPU.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from benchmarks import spec
from benchmarks.run import run_cell
from benchmarks.trace import Tracer

BENCH = spec.benchmark()
ROLLOUT_CELL = spec.cell("ekf_slam_n20.tour_ids_4096", BENCH)
PG_CELL = spec.cell("pose_graph_ekf_n20.bulk_1024", BENCH)


def small(cell):
    """The cell's configuration and traffic cut to a CPU test's size, its
    check sampling every world."""
    conf = copy.deepcopy(spec.config(cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    if conf["driver"] == "fused_rollout":
        conf["params"]["num_iterations"] = 30
        traffic.update(worlds=8, maps=2)
        conf["check"] = {"rollouts": 2, "worlds_per_rollout": 8}
    else:
        conf["params"]["num_iterations"] = 60
        conf["params"]["pose_graph"]["bulk_gn_iters"] = 8
        traffic.update(worlds=4, world_chunk=4, trace_studies=1)
        conf["check"] = {"studies": 1, "worlds_per_study": 4}
    return conf, traffic


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", [ROLLOUT_CELL, PG_CELL], ids=lambda c: c["name"])
def test_the_control_is_not_correct(cell):
    conf, traffic = small(cell)
    run = spec.driver(conf["driver"]).Cell(conf, traffic, 3, "cpu")
    run.window(0.05, Tracer(False))
    assert not fails(run.check(), conf["limits"])
    assert fails(run.check(control=True), conf["limits"])


def _rollout(cfg, lms, cmds, seed):
    from live_ekf_slam_tpu_torch.eval.runner import fused_rollout

    return fused_rollout(cfg, lms, cmds, seed)


def rollout_unchanged(cfg, lms, cmds, seed):
    out = _rollout(cfg, lms, cmds, seed)
    return {**out, "err_sum": torch.zeros_like(out["err_sum"]),
            "err_max": torch.zeros_like(out["err_max"])}


def rollout_half(cfg, lms, cmds, seed):
    h = lms.shape[0] // 2
    out = _rollout(cfg, lms[:h].contiguous(), cmds[:h].contiguous(), seed)
    return {k: torch.cat([out[k], out[k].mean().expand(h)]) for k in ("err_sum", "err_max")}


def rollout_altered(cfg, lms, cmds, seed):
    out = _rollout(cfg, lms, cmds, seed)
    out["err_sum"] = out["err_sum"].clone()
    out["err_sum"][3] *= 1.25
    return out


def _study(cfg, worlds, **kw):
    from live_ekf_slam_tpu_torch.eval.runner import run_monte_carlo_pg_streams

    return run_monte_carlo_pg_streams(cfg, worlds, **kw)


def study_unchanged(cfg, worlds, **kw):
    res, info, x = _study(cfg, worlds, **kw)
    return {**res, "err_pose_graph_result": res["err_pose_graph_initial"]}, info, x


def study_half(cfg, worlds, **kw):
    res, info, x = _study(cfg, worlds, **kw)
    h = worlds // 2
    out = {}
    for k, v in res.items():
        v = np.array(v)
        v[h:] = v[:h].mean() if v.dtype != bool else v[:h].any()
        out[k] = v
    return out, info, x


def study_altered(cfg, worlds, **kw):
    res, info, x = _study(cfg, worlds, **kw)
    err = np.array(res["err_pose_graph_result"])
    err[1] += 0.1
    return {**res, "err_pose_graph_result": err}, info, x


@pytest.fixture(scope="module")
def sound_runs():
    """Each cell's run with the program as it is: correct."""
    out = {}
    for cell in (ROLLOUT_CELL, PG_CELL):
        conf, traffic = small(cell)
        out[cell["name"]] = run_cell(BENCH, cell, 3, 0.05, False, "cpu", conf=conf,
                                     traffic=traffic, t_start=time.perf_counter())
    return out


@pytest.mark.parametrize("cell,program", [
    (ROLLOUT_CELL, rollout_unchanged), (ROLLOUT_CELL, rollout_half), (ROLLOUT_CELL, rollout_altered),
    (PG_CELL, study_unchanged), (PG_CELL, study_half), (PG_CELL, study_altered),
], ids=lambda x: x["name"] if isinstance(x, dict) else x.__name__)
def test_a_broken_timed_path_is_not_correct(cell, program, sound_runs):
    assert sound_runs[cell["name"]]["correct"]
    conf, traffic = small(cell)
    bad = run_cell(BENCH, cell, 3, 0.05, False, "cpu", program=program, conf=conf,
                   traffic=traffic, t_start=time.perf_counter())
    assert not bad["correct"]
