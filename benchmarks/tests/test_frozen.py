"""The benchmark's frozen copies against the port's code they were copied
from, on the CPU at small sizes: the scenario generator, the Philox
stream, the plain EKF rollout, the streams and the roofline counts."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmarks import scenario, spec
from benchmarks.counts import rollout_work
from benchmarks.params import namespace, port_config
from benchmarks.reference import ekf_rollout, philox, streams

TICKS, WORLDS = 40, 8


def configs(ticks=TICKS):
    conf = copy.deepcopy(spec.config("ekf_slam_n20"))
    conf["params"]["num_iterations"] = ticks
    return port_config(conf["params"]), namespace(conf["params"])


@pytest.mark.parametrize("shared", [True, False])
def test_the_generator_gives_the_ports_inputs(shared):
    from live_ekf_slam_tpu_torch.eval.runner import mc_inputs

    cfg, ref = configs()
    worlds = 512 if shared else WORLDS  # the runner's shared block is 256 worlds a map
    lms, cmds = mc_inputs(cfg, worlds, 7, "cpu", shared=shared, relabel=shared)
    maps = worlds // 256 if shared else worlds
    lms_b, cmds_b = scenario.inputs(ref, worlds, maps, shared, 7, "cpu")
    assert torch.equal(lms, lms_b) and torch.equal(cmds, cmds_b)


def test_philox_gives_the_ports_stream():
    from live_ekf_slam_tpu_torch.ops.philox import philox_noise_reference

    want = philox_noise_reference(2 ** 31 + 5, 70, 20, 6, "cpu", world0=3)
    got = philox.noise([2 ** 31 + 5] * 6, list(range(3, 9)), 70, 20, "cpu")
    assert torch.equal(want, got)


def test_the_reference_rollout_is_the_ports_plain_version():
    from live_ekf_slam_tpu_torch.ops.fused_rollout import fused_ekf_rollout_reference

    cfg, ref = configs()
    lms, cmds = scenario.inputs(ref, WORLDS, 2, True, 3, "cpu")
    noise = philox.noise([11] * WORLDS, range(WORLDS), TICKS, 20, "cpu")
    want = fused_ekf_rollout_reference(cfg, lms, cmds, 11, emit_traj=True)
    got = ekf_rollout.rollout(ref, lms, cmds, noise, emit_traj=True)
    for key in ("err_sum", "err_max", "est_traj", "true_traj"):
        assert torch.equal(want[key], got[key]), key


def test_the_reference_streams_are_the_ports():
    from live_ekf_slam_tpu_torch.models import posegraph as pg
    from live_ekf_slam_tpu_torch.sim.streams import sim_streams

    cfg, ref = configs()
    lms, cmds = scenario.inputs(ref, WORLDS, WORLDS, False, 5, "cpu")
    noise = philox.noise([5] * WORLDS, range(WORLDS), TICKS, 20, "cpu")
    want = sim_streams(cfg, lms, 20, cmds, noise)
    got = streams.sim_streams(ref, lms, cmds, noise)
    for key in want:
        assert torch.equal(want[key], got[key]), key
    est = want["poses_true"] + 0.01
    g = pg.assemble_streams(cfg, est, want["r"], want["b"], want["vis"], cmds)
    a = streams.assemble(ref, est, want["r"], want["b"], want["vis"], cmds)
    for key in ("poses_init", "lms_init", "odom", "odom_valid", "meas_rb", "meas_valid", "M"):
        assert torch.equal(getattr(g, key), a[key].to(getattr(g, key).dtype)), key
    slots = pg.LmSlots(g)
    valid = g.meas_valid.any(dim=1)
    assert torch.equal(slots.col[valid], a["col"][valid])


def test_the_counts_are_chip_smokes():
    import chip_smoke

    cfg, ref = configs()
    lms, cmds = scenario.inputs(ref, WORLDS, 2, True, 9, "cpu")
    want = chip_smoke.gate_counts(cfg, lms, cmds, 13)
    got = rollout_work.gate_counts(ref, lms, cmds, [13] * WORLDS, range(WORLDS))
    for key in rollout_work.KEYS + ("ticks",):
        assert want[key] == got[key], key
    assert chip_smoke.work("ekf_slam", want, WORLDS, TICKS, 20) == rollout_work.work(got, WORLDS, TICKS, 20)


def test_the_byte_counts_are_the_ports():
    from live_ekf_slam_tpu_torch.tools.kernel_ab import schur_mv_bytes

    from benchmarks.counts import posegraph_bytes

    b, t, k, n = 3, 50, 20, 20
    d, u = torch.zeros(b, t + 1, 3, 3), torch.zeros(b, t, 3, 3)
    coeffs = tuple(torch.zeros(b, t, k) for _ in range(5))

    class Slots:
        index32 = torch.zeros(b, k, dtype=torch.int32)

    assert schur_mv_bytes(d, u, torch.zeros(b, n, 3), coeffs, Slots, torch.zeros(b, t + 1, 3)) \
        == posegraph_bytes.schur_mv(b, t, k, n)
    assert 4.0 * (d.numel() * 2 + u.numel() * 3 + b * (t + 1) * 3) == posegraph_bytes.block_thomas_factor(b, t)
    assert 4.0 * (d.numel() + u.numel() * 2 + b * (t + 1) * 9) == posegraph_bytes.block_thomas_solve(b, t)
