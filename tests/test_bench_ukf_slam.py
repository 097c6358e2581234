"""The UKF-SLAM cell's pieces of the benchmark against the port, on the CPU
at small sizes: the frozen plain rollout (``benchmarks/reference/
ukf_rollout``) against the port's plain version and its runner, the
roofline count against ``chip_smoke``'s, and the chaos split and
compared numbers of ``drivers/fused_ukf_rollout`` on hand-made records."""

import copy

import numpy as np
import pytest
import torch

from benchmarks import scenario, spec
from benchmarks.counts import ukf_rollout_work
from benchmarks.drivers.fused_ukf_rollout import GAP_INF, chaotic, compare
from benchmarks.params import namespace, port_config
from benchmarks.reference import philox, ukf_rollout
from live_ekf_slam_tpu_torch.eval.runner import fused_rollout
from live_ekf_slam_tpu_torch.ops.fused_ukf import fused_ukf_rollout_reference
from port_harness import few_threads  # noqa: F401  (fixture)

# torch on 2 threads: six pytest-xdist workers share the host's cores
pytestmark = pytest.mark.usefixtures("few_threads")

WORLDS, TICKS = 8, 40
# landmarks in a +/-2.5 m box: within 40 ticks a world sees 2-13 of them,
# so insertions grow the active block, updates share a tick's sigma points,
# and the sanity gate refuses updates in some worlds
BOX = 2.5


def configs(n_lm: int, ticks: int = TICKS):
    """The port's Config and the benchmark's namespace of the cell's
    configuration with ``n_lm`` landmarks and ``ticks`` ticks."""
    params = copy.deepcopy(spec.config("ukf_slam_n20")["params"])
    params.update(num_iterations=ticks, num_landmark_slots=n_lm, num_meas_slots=n_lm)
    params["map"]["num_landmarks"] = n_lm
    return port_config(params), namespace(params)


def random_inputs(n_lm: int, seed: int):
    """(landmarks (B, N, 2), commands (B, T, 2)) from numpy's seeded
    generator, the commands within the configuration's limits."""
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-BOX, BOX, (WORLDS, n_lm, 2))
    cmds = np.stack([rng.uniform(0.0, 0.1, (WORLDS, TICKS)),
                     rng.uniform(-0.05, 0.05, (WORLDS, TICKS))], axis=-1)
    return (torch.as_tensor(lms.astype(np.float32)), torch.as_tensor(cmds.astype(np.float32)),
            rng)


@pytest.mark.parametrize("n_lm", [20, 6])
@pytest.mark.parametrize("injected", [False, True], ids=["philox", "injected"])
def test_the_benchmark_reference_is_the_ports_plain_version(n_lm, injected):
    cfg, ref = configs(n_lm)
    lms, cmds, rng = random_inputs(n_lm, n_lm)
    if injected:
        seed = 0
        noise = torch.as_tensor(rng.uniform(-1, 1, (TICKS, 2 * n_lm + 8, WORLDS))
                                .astype(np.float32))
        stream = noise
    else:
        seed, noise = 2 ** 31 + 7, None
        stream = philox.noise([seed] * WORLDS, range(WORLDS), TICKS, n_lm, "cpu")
    want = fused_ukf_rollout_reference(cfg, lms, cmds, seed, noise=noise)
    runner = fused_rollout(cfg, lms, cmds, seed, noise=noise)
    got = ukf_rollout.rollout(ref, lms, cmds, stream)
    assert want["seen"].sum() > 2 * WORLDS  # insertions happened
    for key in want:
        assert torch.equal(want[key], got[key]), key
        assert torch.equal(want[key], runner[key]), key


def test_the_roofline_count_is_chip_smokes():
    import chip_smoke

    cfg, ref = configs(20)
    lms, cmds = scenario.inputs(ref, WORLDS, 2, True, 9, "cpu")
    want = chip_smoke.gate_counts(cfg, lms, cmds, 13)
    got = ukf_rollout_work.gate_counts(ref, lms, cmds, [13] * WORLDS, range(WORLDS))
    for key in ukf_rollout_work.KEYS + ("ticks",):
        assert want[key] == got[key], key
    assert got["updates"] > 0 and got["act3"] > 64 * got["ticks"]


def test_the_chaos_split_follows_the_nudged_runs_and_the_refusals():
    # a nudge may move an average error of 1 m by 0.1 (1e-6 + 1e-3) m
    err = np.ones(6)
    rejects = np.array([0, 0, 0, 0, 0, 3.0])
    plus = (np.array([1.0 + 5e-5, 1.0 + 2e-4, np.nan, 1.0, 1.0, 1.0]), np.array([0, 0, 0, 2.0, 0, 0]))
    minus = (np.array([1.0 - 5e-5, 1.0, 1.0, 1.0, 1.0 - 2e-4, 1.0]), np.zeros(6))
    assert chaotic(err, rejects, [plus, minus]).tolist() == [False, True, True, True, True, True]
    assert chaotic(err, rejects, [plus]).tolist() == [False, True, True, True, False, True]


TICKS_HAND, RADIUS = 10, 50.0


def test_the_compared_numbers_of_hand_made_records():
    """Five worlds: three calm, one chaotic by a nudge, one by a refusal;
    calm world 2 is 20% off on average, calm world 1 10% off at its
    maximum; the chaotic world 3 is far off and counts in no calm gap."""
    ref = (np.array([10.0, 20.0, 30.0, 10.0, 40.0]), np.array([2.0, 3.0, 4.0, 2.0, 5.0]))
    got = (np.array([10.1, 20.0, 36.0, 30.0, 40.0]), np.array([2.0, 3.3, 4.0, 2.0, 5.0]))
    calm = np.array([True, True, True, False, False])
    out = compare(got, ref, calm, TICKS_HAND, RADIUS)
    assert out["calm_err_rel_gap"] == pytest.approx(0.2)
    assert out["calm_err_max_rel_gap"] == pytest.approx(0.1)
    assert out["calm_diverged_mismatch"] == 0
    assert (out["worlds_calm"], out["worlds_compared"]) == (3, 5)
    # average errors: the reference's median 2.0, the program's 3.0
    assert out["median_err_rel_gap"] == pytest.approx(0.5)
    # means over every world: 2.722 against 2.2
    assert out["mean_err_rel_gap"] == pytest.approx(0.522 / 2.2)
    assert out["diverged_share_gap"] == 0.0
    # the same records with every world calm: world 3's 200% is the widest
    out = compare(got, ref, np.ones(5, dtype=bool), TICKS_HAND, RADIUS)
    assert out["calm_err_rel_gap"] == pytest.approx(2.0)


def test_the_compared_numbers_where_worlds_diverge():
    """World 0 diverged in the reference alone, world 1 in the program alone
    (not finite), world 2 in both; worlds 3 and 4 agree."""
    ref = (np.array([100.0, 10.0, 900.0, 10.0, 20.0]), np.array([60.0, 2.0, 90.0, 2.0, 3.0]))
    got = (np.array([100.0, np.nan, 800.0, 10.0, 20.0]), np.array([10.0, np.nan, 80.0, 2.0, 3.0]))
    calm = np.ones(5, dtype=bool)
    out = compare(got, ref, calm, TICKS_HAND, RADIUS)
    # worlds 0 and 1: the latches differ
    assert out["calm_diverged_mismatch"] == 2
    # world 1, kept by the reference, is not finite in the program
    assert out["calm_err_rel_gap"] == GAP_INF and out["calm_err_max_rel_gap"] == GAP_INF
    # the kept worlds 1, 3, 4: the program's (inf, 1, 2), median 2, against
    # (1, 1, 2), median 1
    assert out["median_err_rel_gap"] == pytest.approx(1.0)
    assert out["mean_err_rel_gap"] == GAP_INF
    assert out["diverged_share_gap"] == 0.0
    # a latch that differs in a chaotic world is no calm mismatch
    chaos = np.array([False, False, True, True, True])
    assert compare(got, ref, chaos, TICKS_HAND, RADIUS)["calm_diverged_mismatch"] == 0
    assert compare(got, ref, ~chaos, TICKS_HAND, RADIUS)["calm_diverged_mismatch"] == 2
    # a not-finite answer in every kept world moves the median to infinity
    nan = np.full(5, np.nan)
    assert compare((nan, nan), ref, calm, TICKS_HAND, RADIUS)["median_err_rel_gap"] == GAP_INF
    got = (np.array([100.0, 10.0, 10.0, 10.0, 20.0]), np.array([10.0, 2.0, 2.0, 2.0, 3.0]))
    assert compare(got, ref, calm, TICKS_HAND, RADIUS)["diverged_share_gap"] == pytest.approx(0.4)
