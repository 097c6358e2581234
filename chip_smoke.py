"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, run.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``live_ekf_slam_tpu_torch/csrc`` with
nvcc and holds each rollout kernel (EKF-SLAM, RI-EKF-SLAM, UKF-SLAM,
UKF-Loc) against its plain torch version: on three configs with injected
noise, predicated against unpredicated, in-kernel Philox against the
replayed stream, and a build with FMA contraction off against the plain
version bit for bit; the same for the EKF kernels' pose stream, for the
block-Thomas factor and solve kernels on the blocks of real graphs (the
solve, a segment scan, also within tolerance of the sequential loop it
replaced) and for the Schur matvec of the bulk solve (P2, also within
tolerance of the torch spelling it replaced, with both forms of the slot
map, and two launches equal bit for bit; both also on chordal_init's
fixed-heading systems). The per-tick pose graph
(``run_monte_carlo(impl="per_tick", collect="poses")`` with
``filter="pose_graph"``) runs the study's default pose-graph config at 1024
worlds x 1000 ticks and the EKF-SLAM secondary in bulk mode at 256 worlds,
each with its launches counted, timed by phase and one tick under the
profiler, its graphs held to ``assemble_streams`` on its own streams, and
its results world by world to ``run_monte_carlo_pg_streams`` on the same
seed (the iterative solved graph to the streams replay on its own streams,
and by its mean to the streams path); ``posegraph.solve`` with
``init="chordal"`` and with ``solver="dense"`` runs on the card at 64 x 200
against the CPU and against the Schur solve. The closed loop
(``eval/closed_loop.run_closed_loop``) runs the JAX bench's igvc1
configuration at 1024 worlds x 1000 ticks through its entry point, its
launches counted (Philox once), its blocks timed as replan and ticks and one
block under the profiler; JAX's scale test (64 x 200) runs on the card and
on the CPU from the same Philox noise, each world held until its first
replan or pare that differs between the two (F15), the test's bounds on the
card; one batched replan is held against its CPU run, and the igvc1 grid is
read from its PNG without Pillow. The host side (``host_side``) runs the
single-world demo presets through ``cli.run_demo`` and ``cli.run_sim_base``
on the card, each timed with its launches counted (Philox once a run, the
pose graph's final solve P1 and P2): filter_demo_results_only for every
filter (EKF-SLAM and the pose graph at the preset's 1000 ticks, EKF-SLAM on
the CPU too), filter_demo_live with the async frame feed, sim_base in both
trajectory modes, goal pursuit with async replans on building1, the
EKF-SLAM and pose-graph demos card against CPU (the pose graph's final
solve at one world; the clicked-goal run under F15) and P1 and P2 against
their plain versions at one world (these two in ``host_side_vs_cpu``, a
process of their own), Philox bit for bit at one world, the AprilTag
replay, a checkpoint saved on the card
and resumed on the CPU, and a pose-graph study's CSVs with the bar charts
(PNGs and CSVs under ``chiprun_out/host_side``). The multi-device layer
(``parallel/mesh``) shards K1 and K4 (SLAM and Loc) at the main path's
inputs over a mesh of every card present (the side check
``multi_device``: each sharded call's launches counted, every shard bit
for bit its single launch at its shard seed, injected noise sharded
against unsharded bit for bit; ``mean_over_worlds``, the per-tick
EKF-SLAM step through ``sharded_step`` against the unsharded step at 4096
x 20, a sharded checkpoint round trip, the igvc1 closed loop sharded over
8 virtual shards against the unsharded run, every leaf equal, the
weak-scaling rows of ``tools/weak_scaling``) and, after the main path, over a virtual mesh of
4 shards on cuda:0, a stream each (the same checks, shard 1 also against
the plain version and bit for bit under -fmad=false, and each sharded
call timed against its one-device launch). Those checks feed nothing
later and wait mostly for the host, so they run in processes side by side (``python3 chip_smoke.py --side-checks NAME ...`` is
one of them). Then it drives the main paths, alone on the card.
``run_monte_carlo`` at 4096 worlds, T = 1000, N = 20
under the bench's shared protocol, once per filter, each through its own
kernel, timed, the kernel compared with the plain version on the first 256
worlds of that run. ``run_monte_carlo_pg_streams``, the pose-graph study, at
1024 worlds with the EKF-SLAM secondary (twice: the results must repeat),
and at 256 worlds with the naive and RI-EKF secondaries and in iterative
mode, with the launch counts each run implies, and the block-Thomas
kernels and the Schur matvec on that study's first system: each as a
wrapper call (the record's ``ms``) and alone (launches back to back,
``kernel_ms``), and the factor's and the solve's cycles by phase. Last the
kernel-attribution path at the bench's size: the EKF and RI-EKF rollouts
in their ``sim``, ``nolm`` and ``full`` profile modes (the split of a rollout into simulator,
predict and landmark loop), the three microbenchmark tools, which time each
primitive of a tick alone (every kernel and variant of ``ops/micro_ops``
held against its plain version), and the sum of the passes a tick executes
against the EKF and UKF-SLAM kernels' measured times. Beside these, right
after the build, every rollout kernel's occupancy (registers, spills,
shared memory, resident worlds an SM; K1, K2 and K4 SLAM must keep 16
without spilling) and the block-Thomas solve's and the Schur matvec's (no
spills), the register micro kernels' (rank_update, joseph, chol, matvec:
no spills, no local memory, 8 or 16 worlds an SM) and the float32 instructions of
their pass loops in the SASS (``micro_sass``: no fewer than the expression
needs, and the shared loads the design counts), and after
the main paths the UKF, EKF and RI-EKF kernels' cycles by phase of the
tick (``ukf_phase_clocks``, ``ekf_phase_clocks``), from a third build
compiled with -DLES_PHASE_CLOCKS. Every phase prints one JSON line; any failure raises and the exit code is nonzero. The last three
lines are the kernels' record, the card's name and power limit as
nvidia-smi reports them, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repository beside it, it fails
before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from live_ekf_slam_tpu_torch.bench import (
    card,
    chain_blocks,
    closed_loop_config,
    pg_config,
    pg_graphs,
    pg_summary,
    plan_once_ms,
    schur_system,
    time_rollouts,
)
from live_ekf_slam_tpu_torch.config import CompatConfig, Config, preset
from live_ekf_slam_tpu_torch.convert import kernel_params
from live_ekf_slam_tpu_torch.eval import closed_loop as cl
from live_ekf_slam_tpu_torch.eval.runner import (
    _pg_bulk_solve,
    fused_rollout,
    init_carry,
    make_step,
    mc_inputs,
    replay_chunk,
    rollout,
    run_monte_carlo,
    run_monte_carlo_pg_streams,
    sync_clock,
)
from live_ekf_slam_tpu_torch.models import posegraph as pg
from live_ekf_slam_tpu_torch.ops import _build, philox
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr
from live_ekf_slam_tpu_torch.ops import fused_ukf as fu
from live_ekf_slam_tpu_torch.ops import micro_ops as mo
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap
from live_ekf_slam_tpu_torch.ops.precision import pin_fp32
from live_ekf_slam_tpu_torch.parallel import mesh as pmesh
from live_ekf_slam_tpu_torch.planning import astar as p_astar
from live_ekf_slam_tpu_torch.sim.streams import naive_deadreckon, sim_streams
from live_ekf_slam_tpu_torch.sim.world import init_world, propagate_truth, sense
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle
from live_ekf_slam_tpu_torch.utils import checkpoint as ckpt
from live_ekf_slam_tpu_torch.viz.live import FrameRecorder
from live_ekf_slam_tpu_torch.tools import micro_downdate, micro_ukf, micro_ukf_probe, weak_scaling
from live_ekf_slam_tpu_torch.tools._common import DIM as MICRO_DIM
from live_ekf_slam_tpu_torch.tools.kernel_ab import (
    factor_kernel_ms,
    schur_mv_bytes,
    schur_mv_kernel_ms,
    solve_kernel_ms,
)

# Kernel vs plain version (injected noise), as |kernel - plain| <= atol +
# rtol * scale, where scale is the plain value for the per-world scalars and,
# for a vector or matrix output, its largest magnitude in that world
# (covariance entries near zero are differences of large terms; their error
# follows the matrix's scale, not their own). The plain versions run the
# kernels' float32 algebra in the kernels' order: a build with nvcc's FMA
# contraction off (-fmad=false) must give their bits exactly, in every world.
# The default build, which the port runs, contracts a*b + c into one FMA (one
# rounding instead of two); ticks of sequential updates carry those last-bit
# differences along, hence these tolerances. `seen` must match exactly, and
# the UKFs' `update_rejects` wherever the world is checked.
TOL = {
    "true_pose": (1e-5, 1e-5),
    "err_sum": (1e-3, 1e-3),
    "err_max": (1e-3, 1e-4),
    "x": (1e-4, 1e-4),
    "P": (1e-3, 1e-6),
}
# The same at the main path's shape, T = 1000: more ticks of feedback carry
# the differences further.
TOL_MAIN = {
    "true_pose": (1e-4, 1e-4),
    "err_sum": (3e-2, 1e-2),
    "err_max": (3e-2, 1e-3),
    "x": (1e-3, 1e-3),
    "P": (1e-2, 1e-5),
}
# Some UKF worlds are chaotic: once their covariance goes indefinite, the
# clamped Cholesky pivots turn on the last bits, and from then on two
# roundings of the same algebra follow different estimates (ROADMAP F6); so
# does a world whose sanity gate refused an update. Which worlds are chaotic
# is read off the plain version alone: it runs again with its injected noise
# scaled by NUDGE, which moves the measurements by ~1e-7 m, the size of a
# float32 rounding of a metre-scale state. A world is chaotic when that nudge
# alone moves the plain version by more than CHAOS_RATIO of the tolerance, or
# when either plain run refused an update or left an eigenvalue of P below
# UKF_INDEFINITE max|P|. Chaotic worlds are counted and left out of the
# per-world check of the default build; their share is reported, not capped:
# the -fmad=false build is held to every world bit for bit, compat branches
# included. The compat config's signed process noise (fused_ukf.py:318-335)
# makes P indefinite in most worlds by design, and calibrated motion's small
# process noise leaves a few worlds chaotic within SHORT ticks; at T = 200
# the mean error sum over all worlds must agree within AGG_RTOL besides.
NUDGE = 1.0 + 2.0 ** -16
CHAOS_RATIO = 0.1
UKF_INDEFINITE = -1e-3
AGG_RTOL = 1e-2
# The block-Thomas kernels against their plain loops, default build: |kernel
# - plain| <= P1_RTOL * max|plain| per output. The Schur blocks of weakly
# observed nodes have condition numbers in the hundreds, which multiply the
# FMA-rounding differences of a 1000-step recursion (measured: 1.6e-4).
P1_RTOL = 2e-3
# The Schur matvec (P2) against its plain versions, default build: |kernel -
# plain| <= SCHUR_RTOL * max|plain| in every world. FMA contraction rounds
# each product-sum once instead of twice; the landmark sums over a world's
# T K measurements and the K-term row sums carry those differences, and sp
# is the difference of the chain part and H_pl w, which nearly cancel in
# some worlds (measured on the 1024-world study's first system: 2.1e-4 in
# the worst world, 1.4e-5 of the whole array; 3e-6 at most on 8 worlds).
# The torch spelling, which sums in yet another order, is held to the same.
SCHUR_RTOL = 2e-3
# Two runs of the pose-graph main path must agree to this (metres): nothing
# on the path adds with atomics, so they are expected to be equal.
PG_REPEAT_ATOL = 1e-4
PG_MAIN = dict(batch=1024, steps=1000)    # the pose-graph study's size
PG_SIDE = 256                             # worlds of its other three runs
P1_WORLDS = 8                             # worlds of the block-Thomas checks
SMALL = dict(batch=250, steps=200)        # 250: not a multiple of 4 worlds
SHORT = 25                                # ticks, before most chaos sets in
MAIN = dict(batch=4096, steps=1000)       # the bench's size
PLAIN_WORLDS = 256                        # the main-shape comparison's worlds
K3_PLAIN_WORLDS = 64                      # the same for the pose stream: with a
                                          # map per world the plain version rarely
                                          # skips a landmark, ~45 ms a tick
# The standalone primitives against their plain versions, default build:
# |kernel - plain| <= MICRO_RTOL * max|plain| over the output, in a launch of
# at most MICRO_CHECK_PASSES passes. A pass differs from the plain version by
# FMA contraction alone: the product is not rounded before its sum. Where
# the rounded product lands the sum on a tie and the exact one beside it, the
# two round apart by one unit in the last place of the accumulated value, and
# since every pass adds the same term they do so in every pass: the
# difference grows by up to one ulp of the output's scale a pass (measured:
# 1.0e-4 of the scale after 2000 one-term Joseph passes, 5.2e-5 after 4096
# rank-2 passes), so a tolerance that held for a tool's thousands of passes
# would be too wide to catch a fault. MICRO_CHECK_PASSES ulps are 3.1e-5 of
# the scale, a third of MICRO_RTOL. The launch of the tool's own count of passes
# is timed, its drift is reported, and its -fmad=false build must equal the
# plain version bit for bit, as the short launch's must.
MICRO_RTOL = 1e-4
MICRO_CHECK_PASSES = 256
# shared memory: 128 bytes a clock on each of the 132 SMs at 1.98 GHz
PEAK_SMEM_BYTES = 128 * 132 * 1.98e9
REPS = 5
# H100 SXM peaks (NVIDIA data sheet, dense): fp32 without tensor cores, HBM
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the least time of a serial chain: dependent float32 operations at 4 cycles
# each on the card's highest SM clock (1.98 GHz)
DEP_OP_S = 4 / 1.98e9

SRC = "live_ekf_slam_tpu_torch/csrc/"
# kernel name -> (filter, launch counter, source, TPU kernel it replaces)
KERNELS = {
    "fused_ekf_rollout": (
        "ekf_slam", (fr.launches, "ekf"), SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:625"),
    "fused_iekf_rollout": (
        "iekf_slam", (fr.launches, "iekf"), SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:788"),
    "fused_ukf_rollout[slam]": (
        "ukf_slam", (fu.launches, "slam"), SRC + "fused_ukf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_ukf.py:619"),
    "fused_ukf_rollout[loc]": (
        "ukf_loc", (fu.launches, "loc"), SRC + "fused_ukf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_ukf.py:619"),
}


LINES = []  # every phase's line of this run, the side processes' included


def emit(phase: str, **kw):
    LINES.append({"phase": phase, **kw})
    print(json.dumps(LINES[-1]), flush=True)


def configs(steps: int):
    base = Config(num_iterations=steps)
    return {
        "default": base,
        "compat": base.replace(compat=CompatConfig.all_on()),
        "calibrated": base.replace(calibrated_motion=True),
    }


# the kernels of the pose-graph path: name -> (launch counter, key, source,
# what it replaces)
PG_KERNELS = {
    "fused_ekf_rollout[emit_traj]": (
        fr.launches, "ekf_traj", SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:604"),
    "fused_iekf_rollout[emit_traj]": (
        fr.launches, "iekf_traj", SRC + "fused_ekf_rollout.cu",
        "live_ekf_slam_tpu/ops/fused_rollout.py:604"),
    "block_thomas_factor": (
        pg.launches, "factor", SRC + "block_thomas.cu",
        "live_ekf_slam_tpu/models/posegraph.py:1071"),
    "block_thomas_solve": (
        pg.launches, "solve", SRC + "block_thomas.cu",
        "live_ekf_slam_tpu/models/posegraph.py:1092"),
    "schur_mv": (
        pg.launches, "schur_mv", SRC + "schur_mv.cu",
        "live_ekf_slam_tpu/models/posegraph.py:1267"),
}


# the kernels of the attribution path. K1p: name -> (filter, profile mode,
# key of fr.launches, the branch of the TPU kernel it replaces)
K1P_KERNELS = {
    f"fused_{kind}_rollout[{mode}]": (
        kind + "_slam", mode, f"{kind}_{mode}",
        "live_ekf_slam_tpu/ops/fused_rollout.py:" + line)
    for kind in fr.FILTER_KINDS for mode, line in (("sim", "188"), ("nolm", "268"))
}
# the standalone primitives: name -> (key of mo.launches, the first of the
# TPU kernel factories it replaces, the variant whose time heads the record)
MICRO_KERNELS = {
    "micro_rank_update": ("rank_update", "scripts/micro_downdate.py:40", "R=2"),
    "micro_column_gather": ("column_gather", "scripts/micro_downdate.py:71", "take"),
    "micro_chol": ("chol", "scripts/micro_ukf.py:53", "lower"),
    "micro_matvec": ("matvec", "scripts/micro_ukf.py:104", "row x4"),
    "micro_joseph": ("joseph", "scripts/micro_ukf.py:132", "prod9"),
    "micro_zstats": ("zstats", "scripts/micro_ukf.py:191", "zstats"),
}
# the families redesigned since their port, and in which change of the
# port's record (PERF.md)
MICRO_REDESIGNED = {"micro_rank_update": "PR 15", "micro_joseph": "PR 15",
                    "micro_chol": "PR 16", "micro_matvec": "PR 16",
                    "micro_column_gather": "PR 17", "micro_zstats": "PR 17"}


MICRO_TILE_ENTRIES = 12 * 6  # a lane's tile of the 48 x 48 matrix
MICRO_TILE = 48
# rank_update keeps k and h in registers up to this R (csrc/micro_ops.cu
# kRankInRegisters) and reads them from shared memory above it
RANK_IN_REGISTERS = 4
# chol's pivot loop: the loop over row groups, 12 pivots of the tile's rows
# unrolled in it
CHOL_BLOCK = 12
# a chol pivot's 16-byte loads of its column: the lane's 12 rows, 6 columns
CHOL_PIVOT_LOADS = 5
# the float32 instructions of one chol pivot besides its 72 FFMA of the
# trailing update and its 12 FMUL of the column's scaling, as ptxas spells
# them for sm_90a: the IEEE square root's two FMUL and two FFMA after its
# MUFU.RSQ, the IEEE division's five FFMA after its MUFU.RCP, and the sum
# that max_nan returns for a NaN pivot
CHOL_PIVOT_OPS = {"FFMA": 7, "FMUL": 2, "FADD": 1}
# matvec: a lane's two lines of the matrix padded to MICRO_TILE, and the
# butterfly's tree over the 32 lanes' partial sums in the column order
MATVEC_LINE_PRODUCTS = 2 * MICRO_TILE
MATVEC_TREE_ADDS = 2 * 31
# take: a lane's rows of the D = MICRO_DIM matrix (lane + 32 k), one 4-byte
# load and one FADD each a pass
TAKE_ROWS = -(-MICRO_DIM // 32)
# zstats: a lane's sigma points a pass (16 columns a round, the + half on
# lanes 0-15, the - half on 16-31), each read as x, y, yaw and its column's
# weight in four 4-byte loads
ZSTATS_ROUNDS = -(-MICRO_DIM // 16)
ZSTATS_POINT_LOADS = 4


def tile_ops(per_entry: dict) -> dict:
    """A tiled register pass's float32 instructions a lane: ``per_entry``
    for each of the lane's MICRO_TILE_ENTRIES entries."""
    return {k_: MICRO_TILE_ENTRIES * v for k_, v in per_entry.items()}


def chol_ops() -> dict:
    """The float32 instructions of chol's pivot loop a lane: CHOL_BLOCK
    pivots of 72 FFMA (the tile's trailing update), 12 FMUL (its rows of the
    pivot column scaled) and the pivot's own square root and division."""
    per = {"FFMA": MICRO_TILE_ENTRIES, "FMUL": 12}
    for k_, v in CHOL_PIVOT_OPS.items():
        per[k_] = per.get(k_, 0) + v
    return {k_: CHOL_BLOCK * v for k_, v in per.items()}


# the micro kernels (template arguments as mangled_args takes them) and the
# instructions of their pass loop a lane, as the plain version spells them
# with FMA contraction: a rank-R entry R FFMA; prod9 a and b (a
# product and an FFMA each), -a - b, s00 (k0 k0) (FMUL, FFMA), s01 (k0 k1 +
# k1 k0) (FMUL, FFMA, FFMA), s11 (k1 k1) (FMUL, FFMA) and P + v; hoist g00,
# g11, g01, s00 g00 and the two sums of the other terms, two subtractions and
# P + v; the first n of the seven terms 1, 1, 1, 1, 2, 2, 3. chol: its pivot
# loop (chol_ops), one code for every variant. matvec: a vector of a pass,
# a product of the lane's two lines an FFMA (the first from zero), then the
# row order's two sums added onto out, or the column order's two trees and
# two sums added onto out. column_gather: select is the matvec's row order
# with one vector, take one FADD a row. zstats: one IEEE square root
# (MUFU.RSQ) a sigma point a pass, the parent's four a column pair; its
# sines, cosines and atan2 are polynomials whose instruction counts are
# ptxas's, so its entry names the MUFU.RSQ count alone (an entry that names
# an instruction outside SASS_FP is held to its own instructions only)
MICRO_SASS = {
    **{f"rank_update[R={r}]": (str(r), tile_ops({"FFMA": r})) for r in mo.RANKS},
    "joseph[prod9]": ("0, 0", tile_ops({"FFMA": 6, "FMUL": 5, "FADD": 2})),
    "joseph[hoist]": ("1, 0", tile_ops({"FFMA": 5, "FMUL": 6, "FADD": 3})),
    **{f"joseph[terms={n}]": (f"2, {n}", tile_ops(want)) for n, want in (
        (1, {"FFMA": 1}), (2, {"FFMA": 2}), (3, {"FFMA": 3}), (4, {"FFMA": 4}),
        (5, {"FFMA": 5, "FMUL": 1}), (6, {"FFMA": 6, "FMUL": 2}),
        (7, {"FFMA": 8, "FMUL": 3}))},
    # full and trail launch one instantiation, kLower false
    "chol[full]": ("false", chol_ops()),
    "chol[lower]": ("true", chol_ops()),
    "matvec[row]": ("0", {"FFMA": MATVEC_LINE_PRODUCTS, "FADD": 2}),
    "matvec[col]": ("1", {"FFMA": MATVEC_LINE_PRODUCTS, "FADD": MATVEC_TREE_ADDS + 2}),
    "matvec[unrolled]": ("2", {"FFMA": MATVEC_LINE_PRODUCTS}),
    "column_gather[select]": ("3", {"FFMA": MATVEC_LINE_PRODUCTS, "FADD": 2}),
    "column_gather[take]": (str(TAKE_ROWS), {"FADD": TAKE_ROWS}),
    "zstats[zstats]": (str(ZSTATS_ROUNDS), {"MUFU.RSQ": ZSTATS_ROUNDS}),
}
# the worlds an SM a micro kernel must hold at D = MICRO_DIM (default 8 or
# 16: 4096 worlds in whole waves of at most 32 worlds an SM): take, 24, as
# many as its 9.4 KB of P a world leave in shared memory (three blocks of
# eight); zstats at least 32, so that 4096 worlds take one wave
MICRO_RESIDENT = {"column_gather[take]": (24,), "zstats[zstats]": tuple(range(32, 65, 8))}
# the kernel of a MICRO_SASS entry where it is not its family's own
MICRO_SASS_KERNEL = {"column_gather[select]": "matvec"}
# the entries whose pass loop must hold their expression exactly, not only
# at least (more would be work that their design does not do)
MICRO_SASS_EXACT = ("column_gather[select]", "column_gather[take]", "zstats[zstats]")


def sass_stem(name: str) -> str:
    """The mangled stem (kernel name and template arguments) of a
    MICRO_SASS entry's kernel."""
    kernel = MICRO_SASS_KERNEL.get(name, name.split("[")[0])
    return kernel + "_kernel" + mangled_args(MICRO_SASS[name][0])


def tile_lds(op: str, variant: str) -> int:
    """Shared loads a lane makes in the pass loop of a micro kernel
    (``variant`` as MICRO_SASS names it: "R=8", "prod9", "terms=3",
    "lower", "row", "take", "zstats"), 16-byte loads but where named: a
    term of rank_update read from shared memory is three words of k (the
    lane's 12 rows) and two of h (its 6 columns at a two-word stride);
    joseph reads five such words for the vectors of each of its first four
    terms, and one for s from the fifth on; a chol pivot reads five such
    words of the pivot column, CHOL_BLOCK pivots a loop; a matvec vector,
    and the select gather's one-hot, is 12 words, every lane reading all of
    them; take reads its TAKE_ROWS entries, zstats its sigma points'
    ZSTATS_POINT_LOADS words, 4-byte loads each."""
    if op == "column_gather":
        return MICRO_TILE // 4 if variant == "select" else TAKE_ROWS
    if op == "zstats":
        return ZSTATS_POINT_LOADS * ZSTATS_ROUNDS
    if op == "rank_update":
        r = int(variant.split("=")[1])
        return 0 if r <= RANK_IN_REGISTERS else 5 * r
    if op == "chol":
        return CHOL_PIVOT_LOADS * CHOL_BLOCK
    if op == "matvec":
        return MICRO_TILE // 4
    n = int(variant.split("=")[1]) if "=" in variant else mo.JOSEPH_TERMS
    return 5 * min(n, 4) + (n >= 5)


# The shared pipe serves a warp's access in 128-byte wavefronts, one at the
# least. A warp-wide 16-byte load of the register kernels' pass loops reads
# at most 8 distinct words (a broadcast 1, a row group's 4, a column group's
# 8), so it takes one wavefront, not the 512 bytes of its 32 lanes; so does
# a store by the four lanes of chol's pivot column. Accesses to distinct
# words (P staged, the lanes' copies) take their bytes.
WAVEFRONT = 128.0
# the stores of chol's pivot column a pivot, by its four lanes: three
# 16-byte words in row order, two 16- and two 8-byte words in column groups
CHOL_PIVOT_STORES = 7


def tile_smem_bytes(c: dict, b: int, d: int) -> float:
    """Shared-pipe bytes a launch of a register case takes: WAVEFRONT for
    each warp-wide 16-byte load of a pass (``tile_lds``), the bytes of each
    access to distinct words. rank_update and joseph: each pass's loads, and
    once a world P staged in and out (each entry stored and loaded on the
    way in and on the way out) and the rank vectors written in padded
    layout (rows and column groups: 48 + 64 floats a vector; joseph's four
    and s). chol: P staged in and out, the lanes' copies of their tiles
    written once and read by every factorisation, and at each of its du
    pivots the column's CHOL_PIVOT_STORES and, but after the last pivot,
    which updates nothing, five loads. matvec: L staged in and read into the
    lanes once, the A vectors written padded, and every matvec (a vector of
    a pass) read as 12 broadcasts."""
    if c["op"] == "chol":
        copies = 32 * 4.0 * MICRO_TILE_ENTRIES
        per_pass = (copies + c["du"] * CHOL_PIVOT_STORES * WAVEFRONT
                    + (c["du"] - 1) * CHOL_PIVOT_LOADS * WAVEFRONT)
        return b * (4 * 4.0 * d * d + copies + c["passes"] * per_pass)
    if c["op"] == "matvec":
        a = c["args"][1].shape[1]
        once = 2 * 4.0 * d * d + 4.0 * a * MICRO_TILE
        return b * (once + c["passes"] * WAVEFRONT * tile_lds("matvec", c["order"]))
    if c["op"] == "rank_update":
        variant, vectors = f"R={c['rank']}", (c["rank"] if c["rank"] > RANK_IN_REGISTERS else 0)
    else:
        variant = c["spelling"] + (f"={c['n_terms']}" if c["spelling"] == "terms" else "")
        vectors = 4
    per_pass = WAVEFRONT * tile_lds(c["op"], variant)
    once = 4 * 4.0 * d * d + 4.0 * vectors * (MICRO_TILE + 64) + (16.0 if c["op"] == "joseph" else 0)
    return b * (c["passes"] * per_pass + once)


def counts() -> dict:
    out = {name: c[key] for name, (_, (c, key), _, _) in KERNELS.items()}
    out.update({name: c[key] for name, (c, key, _, _) in PG_KERNELS.items()})
    out.update({name: fr.launches[key] for name, (_, _, key, _) in K1P_KERNELS.items()})
    out.update({name: mo.launches[key] for name, (key, _, _) in MICRO_KERNELS.items()})
    out["philox_noise"] = philox.launches
    return out


def zero_counts():
    for c in (fr.launches, fu.launches, pg.launches, mo.launches):
        for key in c:
            c[key] = 0
    philox.launches = 0


def scale(ref: torch.Tensor) -> torch.Tensor:
    """Per-world magnitude an output's error is measured against."""
    if ref.dim() == 1:
        return ref.abs()
    return ref.abs().amax(dim=tuple(range(1, ref.dim())), keepdim=True)


def tol_ratio(a: dict, ref: dict, tol: dict) -> dict:
    """Per output, each world's largest |a - ref| / (atol + rtol * scale)."""
    b = ref["seen"].shape[0]
    return {name: ((a[name] - ref[name]).abs()
                   / (atol + rtol * scale(ref[name]))).reshape(b, -1).amax(dim=1)
            for name, (rtol, atol) in tol.items()}


def plain_run(cfg, lms, cmds, noise, tol: dict
              ) -> tuple[dict, torch.Tensor | None]:
    """The plain version's run on these inputs and, for the UKFs, the worlds
    it flags as chaotic (see NUDGE); None for the EKFs, which have none. The
    UKFs' run and the nudged one go in one batch of twice the worlds (the
    plain version's time is launch-bound)."""
    if not cfg.filter.startswith("ukf"):
        return fused_rollout(cfg, lms, cmds, 0, noise=noise, plain=True), None
    nudged = noise * NUDGE
    b = lms.shape[0]
    both = fused_rollout(cfg, torch.cat([lms, lms]), torch.cat([cmds, cmds]),
                         0, noise=torch.cat([noise, nudged], dim=2).contiguous(),
                         plain=True)
    p = {k: v[:b] for k, v in both.items()}
    p_nudged = {k: v[b:] for k, v in both.items()}
    flags = torch.stack(list(tol_ratio(p_nudged, p, tol).values())).amax(
        dim=0) > CHAOS_RATIO
    for r in (p, p_nudged):
        P = r["P"].double()
        min_eig = torch.linalg.eigvalsh(P).min(dim=1).values
        flags |= min_eig < UKF_INDEFINITE * P.abs().amax(dim=(1, 2))
        flags |= r["update_rejects"] > 0
    return p, flags


def compare(k: dict, p: dict, tol: dict, exempt: torch.Tensor | None = None,
            agg_rtol: float | None = None) -> dict:
    """Max abs error and worst tolerance ratio of each output; raises if
    `seen` differs, or in a world not ``exempt`` an output is out of
    tolerance or `update_rejects` differ, or (with ``agg_rtol``) the mean
    error sums differ by more than that."""
    if not torch.equal(k["seen"], p["seen"]):
        raise AssertionError("seen differs between kernel and plain version")
    b = k["seen"].shape[0]
    if exempt is None:
        exempt = torch.zeros(b, dtype=torch.bool, device=k["seen"].device)
    out, bad_world = {}, torch.zeros_like(exempt)
    checked = bool((~exempt).any())
    for name, r_w in tol_ratio(k, p, tol).items():
        bad_world |= ~(r_w <= 1.0)
        d_w = (k[name] - p[name]).abs().reshape(b, -1).amax(dim=1)
        out[name] = {"max_abs_err": float(d_w.max()),
                     "max_abs_err_checked": float(d_w[~exempt].max())
                     if checked else None,
                     "tol_ratio": float(r_w.max()),
                     "tol_ratio_checked": float(r_w[~exempt].max())
                     if checked else None}
    if "update_rejects" in k:
        bad_world |= k["update_rejects"] != p["update_rejects"]
    mean_k = float(k["err_sum"].mean())
    mean_p = float(p["err_sum"].mean())
    out["mean_err_sum_rel_diff"] = abs(mean_k - mean_p) / abs(mean_p)
    out["worlds_exempt"] = int(exempt.sum())
    out["worlds_out_of_tol"] = int(bad_world.sum())
    out["worlds_out_of_tol_exempt"] = int((bad_world & exempt).sum())
    if bool((bad_world & ~exempt).any()):
        raise AssertionError(f"out of tolerance: {out}")
    if agg_rtol is not None and not out["mean_err_sum_rel_diff"] <= agg_rtol:
        raise AssertionError(f"mean error differs: {out}")
    return out


def bitwise(k: dict, p: dict, what: str) -> dict:
    """Which outputs are equal bit for bit; raises unless all are."""
    same = {key: bool(torch.equal(k[key], p[key])) for key in k}
    if not all(same.values()):
        raise AssertionError(f"{what}: not bitwise equal: {same}")
    return same


def gate_counts(cfg, lms, cmds, seed) -> dict:
    """Counts, summed over worlds and ticks, of the filters' work on these
    inputs: the plain versions' gates (vis * seen updates, vis * (1 - seen)
    insertions, the UKF's active dimension n_act = 4 + 2 * seen and its
    powers, the EKF's seen block D_act = 3 + 2 (1 + the highest id seen or
    visible) and its square, a tick and an update), replayed from the
    simulator and the kernels' Philox stream."""
    b, n, _ = lms.shape
    t_total = cmds.shape[1]
    noise = philox.philox_noise_reference(seed, t_total, n, b, lms.device)
    kp = kernel_params(cfg)  # the plain versions' float32 constants
    tx = torch.full((b,), kp.x0, dtype=torch.float32, device=lms.device)
    ty = torch.full_like(tx, kp.y0)
    tth = torch.full_like(tx, kp.yaw0)
    seen = torch.zeros((b, n), dtype=torch.bool, device=lms.device)
    tot = {k: 0.0 for k in ("updates", "insertions", "visible", "act1",
                            "act2", "act3", "act1u", "act2u", "dact1", "dact2",
                            "dact1u", "dact2u")}
    ids = torch.arange(1, n + 1, device=lms.device)
    for t in range(t_total):
        u = noise[t]
        d_n = torch.clamp(cmds[:, t, 0] + kp.v00s * u[0], 0.0, kp.d_max)
        h_n = torch.clamp(cmds[:, t, 1] + kp.v11s * u[1], -kp.th_max, kp.th_max)
        tx = tx + d_n * torch.cos(tth)
        ty = ty + d_n * torch.sin(tth)
        tth = tth + h_n
        dx = lms[:, :, 0] - tx[:, None]
        dy = lms[:, :, 1] - ty[:, None]
        r = torch.sqrt(dx * dx + dy * dy)
        beta = wrap(atan2(dy, dx) - tth[:, None])
        vis = (r <= kp.r_max) & (beta > kp.fov_min) & (beta < kp.fov_max)
        # n_act: the UKF's active dimensions, 4 + 2 per landmark seen
        n_act = (4 + 2 * seen.sum(dim=1)).to(torch.float64)
        n_upd = (vis & seen).sum(dim=1).to(torch.float64)
        # D_act: the EKF kernels' seen block, rows past it hold +0
        dact = (3 + 2 * torch.where(vis | seen, ids, 0).amax(dim=1)).to(torch.float64)
        for key, v in (("updates", n_upd), ("insertions", (vis & ~seen).sum(dim=1)),
                       ("visible", vis.sum(dim=1)), ("act1", n_act),
                       ("act2", n_act ** 2), ("act3", n_act ** 3),
                       ("act1u", n_upd * n_act), ("act2u", n_upd * n_act ** 2),
                       ("dact1", dact), ("dact2", dact ** 2),
                       ("dact1u", n_upd * dact), ("dact2u", n_upd * dact ** 2)):
            tot[key] += float(v.sum())
        seen |= vis
    tot["ticks"] = float(b * t_total)
    return tot


def work(filt: str, g: dict, b: int, t_total: int, n: int,
         mode: str = "full") -> tuple[float, float]:
    """(flops, bytes) the rollout of ``filt`` must do on these inputs: ops
    per event read off the algebra (the kernels' source notes), times the
    events the plain versions' gates count; bytes are each input read once
    and each output written once (noise is drawn in-kernel). ``mode`` "nolm"
    counts no update or insertion, "sim" the simulator alone."""
    d = 3 + 2 * n
    ticks = g["ticks"]
    sense = 40.0 * n * ticks + 20.0 * ticks  # per landmark and tick; truth, error
    if mode != "full":  # and seen stays empty: the vehicle block alone
        g = {**g, "updates": 0.0, "insertions": 0.0, "dact1": 3.0 * ticks,
             "dact2": 9.0 * ticks, "dact1u": 0.0, "dact2u": 0.0}
    if mode == "sim":
        flops = sense
    elif filt == "ekf_slam":
        # over the seen block D_act (the rest of P is +0 and stays so):
        # predict: two rank-1 row and two column passes; update: gain and
        # H P (~34 D) and the rank-2 downdate (4 D^2); insertion: two rows
        flops = sense + 8.0 * g["dact1"] + 4.0 * g["dact2u"] + 34.0 * g["dact1u"] \
            + g["insertions"] * (4.0 * d + 30.0)
    elif filt == "iekf_slam":
        # over the seen block: predict: one rank-1 pass (2 D^2); update:
        # ~19 D of gain, retraction and H P, the rank-2 downdate (4 D^2);
        # insertion: ~30
        flops = sense + 2.0 * g["dact2"] + 3.0 * g["dact1"] + 4.0 * g["dact2u"] \
            + 19.0 * g["dact1u"] + 60.0 * g["updates"] + g["insertions"] * 30.0
    elif filt == "ukf_slam":
        # per tick over the n_act active dimensions: Cholesky n^3/3, four
        # triangular matvecs (4 n^2), sigma rows and sums (~130 n); per
        # update: two triangular matvecs (2 n^2), half a Joseph pass of ~15
        # flops an entry (7.5 n^2), z-stats and sums (~200 n)
        flops = sense + g["act3"] / 3.0 + 4.0 * g["act2"] + 130.0 * g["act1"] \
            + 9.5 * g["act2u"] + 200.0 * g["act1u"] + g["insertions"] * 30.0
    else:  # ukf_loc: n_act = 4 throughout, every visible landmark updates
        flops = sense + ticks * (64 / 3.0 + 4.0 * 16 + 130.0 * 4) \
            + g["visible"] * (9.5 * 16 + 200.0 * 4)
    du = {"ekf_slam": d, "iekf_slam": d, "ukf_slam": 4 + 2 * n, "ukf_loc": 4}[filt]
    nbytes = 4.0 * (b * t_total * 2 + b * n * 2) \
        + 4.0 * b * (du * du + du + 8) + b * n
    return flops, nbytes


def timed_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls, after
    one warm-up call."""
    fn()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return float(np.median(ms))


def stream_of(r: dict) -> dict:
    """A rollout's pose streams under the names whose tolerances they take:
    est_traj is x[0:3] and true_traj the true pose, tick by tick."""
    return {"x": r["est_traj"], "true_pose": r["true_traj"], "seen": r["seen"],
            "err_sum": r["err_sum"]}


def pose_stream_checks(dev, n_lm: int):
    """K3 against the plain version: EKF and RI-EKF on three configs at
    SMALL. The default build's streams within the tolerances of x and
    true_pose; the -fmad=false build bit for bit; everything else of the
    result bit for bit what emit_traj=False gives; sum_t |est - true| equal
    to err_sum."""
    rng = np.random.default_rng(3)
    for kind in fr.FILTER_KINDS:
        for cname, cfg in configs(SMALL["steps"]).items():
            lms, cmds = mc_inputs(cfg, SMALL["batch"], 3, dev)
            noise = torch.as_tensor(
                rng.uniform(-1, 1, (SMALL["steps"], 2 * n_lm + 8,
                                    SMALL["batch"])).astype(np.float32),
                device=dev)
            kw = dict(noise=noise, filter_kind=kind)
            before = fr.launches[kind + "_traj"]
            k = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
            torch.cuda.synchronize()
            if fr.launches[kind + "_traj"] != before + 1:
                raise AssertionError(f"{kind}: the pose-stream kernel was not launched")
            k0 = fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw)
            p = fr.fused_ekf_rollout_reference(cfg, lms, cmds, 0, emit_traj=True, **kw)
            with _build.without_fma():
                k_nofma = fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw)
            same = bitwise(k_nofma, p, f"{kind} {cname} pose stream -fmad=false")
            unchanged = bitwise(k0, k, f"{kind} {cname} emit_traj=True against False")
            errs = compare(stream_of(k), stream_of(p),
                           {o: TOL[o] for o in ("x", "true_pose")})
            d = (k["est_traj"][..., :2] - k["true_traj"][..., :2]).norm(dim=-1).sum(dim=1)
            sum_rel = float(((d - k["err_sum"]).abs() / k["err_sum"]).max())
            last = (torch.equal(k["est_traj"][:, -1], k["x"][:, :3])
                    and torch.equal(k["true_traj"][:, -1], k["true_pose"]))
            emit("pose_stream_vs_plain", kernel=f"fused_{kind}_rollout[emit_traj]",
                 config=cname, **SMALL, est_traj=errs["x"], true_traj=errs["true_pose"],
                 no_fma_bitwise_equal=same, rest_bitwise_equal_to_emit_false=unchanged,
                 last_tick_is_final_state=last, err_sum_rel_diff=sum_rel)
            if not last or sum_rel > 1e-5:
                raise AssertionError(f"{kind} {cname}: the pose stream does not "
                                     f"fit the final state or err_sum ({sum_rel})")


# worlds of the pose-graph runs that launch each pose-stream kernel
K3_WORLDS = {"ekf": PG_MAIN["batch"], "iekf": PG_SIDE}


def pose_stream_inputs(kind: str, dev, n_lm: int):
    """What the pose-graph run with this secondary hands its rollout kernel:
    (cfg, lms, cmds, noise)."""
    cfg = pg_config(PG_MAIN["steps"], kind + "_slam", False)
    lms, cmds = mc_inputs(cfg, K3_WORLDS[kind], 0, dev)
    noise = philox.philox_noise(0, PG_MAIN["steps"], n_lm, K3_WORLDS[kind], dev)
    return cfg, lms, cmds, noise


def pose_stream_main_check(kind: str, dev, n_lm: int):
    """K3 at the pose-graph path's shape against the plain version, on the
    first K3_PLAIN_WORLDS worlds over all its ticks: the default build's
    streams within TOL_MAIN, the -fmad=false build bit for bit."""
    name = f"fused_{kind}_rollout[emit_traj]"
    cfg, lms, cmds, noise = pose_stream_inputs(kind, dev, n_lm)
    w = K3_PLAIN_WORLDS
    lw, cw = lms[:w].contiguous(), cmds[:w].contiguous()
    kw_w = dict(emit_traj=True, noise=noise[:, :, :w].contiguous(), filter_kind=kind)
    k = fr.fused_ekf_rollout(cfg, lw, cw, 0, **kw_w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = fr.fused_ekf_rollout_reference(cfg, lw, cw, 0, **kw_w)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    errs = compare(stream_of(k), stream_of(p),
                   {o: TOL_MAIN[o] for o in ("x", "true_pose")})
    with _build.without_fma():
        same = bitwise(fr.fused_ekf_rollout(cfg, lw, cw, 0, **kw_w),
                       p, f"{name} main shape -fmad=false")
    emit("pose_stream_main_vs_plain", kernel=name, steps=PG_MAIN["steps"],
         plain_ms=p_ms, plain_worlds=w, est_traj=errs["x"],
         true_traj=errs["true_pose"], no_fma_bitwise_equal=same)


def block_thomas_compare(d, u, rhs, what: str) -> dict:
    """P1 against its plain versions on one system: the default build within
    P1_RTOL of each output's scale, and the solve's also of the sequential
    loop it replaced; the -fmad=false build bit for bit. Returns the errors
    and the plain versions' milliseconds."""
    before = dict(pg.launches)
    fac = pg._tridiag_factor(d, u)
    x = pg._tridiag_solve(fac, rhs)
    torch.cuda.synchronize()
    if pg.launches != {**before, "factor": before["factor"] + 1,
                       "solve": before["solve"] + 1}:
        raise AssertionError("the block-Thomas wrappers did not launch their kernels")
    t0 = time.perf_counter()
    pfac = pg._tridiag_factor_reference(d, u)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    px = pg._tridiag_solve_reference(pfac, rhs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sx = pg._tridiag_solve_sequential(pfac, rhs)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with _build.without_fma():
        nfac = pg._tridiag_factor(d, u)
        nx = pg._tridiag_solve(nfac, rhs)
    same = bitwise({**nfac, "x": nx}, {**pfac, "x": px}, f"{what} -fmad=false")
    out = {"no_fma_bitwise_equal": same, "factor_plain_ms": 1e3 * (t1 - t0),
           "solve_plain_ms": 1e3 * (t2 - t1),
           "solve_sequential_plain_ms": 1e3 * (t3 - t2),
           "segments": pg.SOLVE_SEGMENTS}
    pairs = [(k_, fac[k_], pfac[k_]) for k_ in fac]
    for name, a, b in pairs + [("x", x, px), ("x_vs_sequential", x, sx)]:
        err, top = float((a - b).abs().max()), float(b.abs().max())
        out[name] = {"max_abs_err": err, "scale": top, "rel_to_scale": err / top}
        if not err <= P1_RTOL * top:
            raise AssertionError(f"{what}: {name} out of tolerance: {out[name]}")
    return out


def block_thomas_checks(dev):
    """P1 on the blocks of real graphs: a few worlds at T = 37 (a ragged
    last segment), 200 and 1000, at the first and the last measurement
    scale of the schedule, and on chordal_init's fixed-heading system."""
    for steps in (37, SMALL["steps"], PG_MAIN["steps"]):
        cfg = pg_config(steps, "ekf_slam", False)
        graphs = pg_graphs(cfg, P1_WORLDS, dev, seed=1)[0]
        for sc, chordal in ((16.0, False), (1.0, False), (1.0, True)):
            res = block_thomas_compare(*chain_blocks(cfg, graphs, sc, chordal),
                                       f"block-Thomas T={steps} scale={sc} chordal={chordal}")
            emit("block_thomas_vs_plain", worlds=P1_WORLDS, steps=steps,
                 meas_scale=sc, chordal=chordal, rtol_of_scale=P1_RTOL, **res)


def world_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest over worlds of max|a - ref| / max|ref| in the world."""
    return float(((a - ref).abs().amax(dim=(1, 2))
                  / ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)).max())


def schur_mv_compare(sy: dict, vp, what: str) -> dict:
    """P2 against its plain versions on one system (``bench.schur_system``)
    and direction vp: the default build within SCHUR_RTOL of the kernel's
    order (``_schur_mv_reference``) and of the torch spelling in every
    world, a second launch equal bit for bit, the -fmad=false build equal to
    the reference bit for bit. Returns the errors and the plain versions'
    milliseconds."""
    args = (sy["d"], sy["u"], sy["hll_inv"], sy["coeffs"], sy["slots"], vp)
    before = pg.launches["schur_mv"]
    sp = pg._schur_mv(*args)
    again = pg._schur_mv(*args)
    torch.cuda.synchronize()
    if pg.launches["schur_mv"] != before + 2:
        raise AssertionError("the Schur matvec wrapper did not launch its kernel")
    t0 = time.perf_counter()
    ref = pg._schur_mv_reference(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tor = pg._schur_mv_torch(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with _build.without_fma():
        same = bitwise({"sp": pg._schur_mv(*args)}, {"sp": ref}, f"{what} -fmad=false")
    if not torch.equal(sp, again):
        raise AssertionError(f"{what}: two launches differ")
    out = {"no_fma_bitwise_equal": same, "repeat_bitwise_equal": True,
           "by_column": sy["slots"].by_column, "plain_ms": 1e3 * (t1 - t0),
           "torch_ms": 1e3 * (t2 - t1)}
    for name, want in (("vs_reference", ref), ("vs_torch", tor)):
        out[name] = {"max_abs_err": float((sp - want).abs().max()),
                     "scale": float(want.abs().max()),
                     "max_world_rel_to_scale": world_rel(sp, want)}
        if not out[name]["max_world_rel_to_scale"] <= SCHUR_RTOL:
            raise AssertionError(f"{what}: sp {name} out of tolerance: {out[name]}")
    out["reference_vs_torch_world_rel"] = world_rel(ref, tor)
    return out


def cg_direction(sy: dict) -> torch.Tensor:
    """The first CG direction of the system: the preconditioned gradient."""
    return pg._tridiag_solve(pg._tridiag_factor(sy["d"], sy["u"]), sy["rhs"])


def schur_mv_checks(dev):
    """P2 on real graphs: a few worlds at T = 37, 200 and 1000, at the first
    and the last measurement scale, with the by-column slot map and the
    general one, and on chordal_init's fixed-heading system."""
    for steps in (37, SMALL["steps"], PG_MAIN["steps"]):
        cfg = pg_config(steps, "ekf_slam", False)
        graphs = pg_graphs(cfg, P1_WORLDS, dev, seed=1)[0]
        for sc, chordal in ((16.0, False), (1.0, False), (1.0, True)):
            for slots in (pg.LmSlots(graphs), pg.LmSlots(graphs, detect=False)):
                sy = schur_system(cfg, graphs, sc, slots, chordal)
                res = schur_mv_compare(sy, cg_direction(sy),
                                       f"Schur matvec T={steps} scale={sc} chordal={chordal}")
                emit("schur_mv_vs_plain", worlds=P1_WORLDS, steps=steps,
                     meas_scale=sc, chordal=chordal, rtol_of_scale=SCHUR_RTOL, **res)


def pg_bulk_launches(cfg) -> dict:
    """The P1 and P2 launches of one bulk solve of a world chunk: the
    graduated schedule, 16 + 16 + 50 Gauss-Newton steps from the seeds, in
    iterative mode 50 more from the replayed or per-tick solution; each
    factors once, solves once per CG step and once before them, and applies
    the Schur matvec once per CG step."""
    pgc = cfg.pose_graph
    n_gn = (max(8, pgc.bulk_gn_iters // 3) * 2 + pgc.bulk_gn_iters
            + (pgc.bulk_gn_iters if pgc.solve_graph_every_iteration else 0))
    return dict(block_thomas_factor=n_gn,
                block_thomas_solve=n_gn * (pgc.bulk_cg_iters + 1),
                schur_mv=n_gn * pgc.bulk_cg_iters)


def pg_run(secondary: str, iterative: bool, batch: int, dev) -> tuple[dict, dict]:
    """One pose-graph study through ``run_monte_carlo_pg_streams``, in one
    world chunk, with the checks on its launch counts and results. Returns
    (results, launch counts)."""
    cfg = pg_config(PG_MAIN["steps"], secondary, iterative)
    zero_counts()
    t0 = time.perf_counter()
    res, info, _ = run_monte_carlo_pg_streams(cfg, batch, seed=0,
                                              world_chunk=batch, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = dict.fromkeys(launches, 0)
    want.update(philox_noise=1, **pg_bulk_launches(cfg))
    if secondary != "naive":
        kind = "iekf" if secondary == "iekf_slam" else "ekf"
        want[f"fused_{kind}_rollout[emit_traj]"] = 1
    if launches != want:
        raise AssertionError(f"pose graph, {secondary}: launched {launches}, "
                             f"expected {want}")
    summary = pg_summary(res, info, PG_MAIN["steps"], secondary)
    emit("pose_graph_path", secondary=secondary, iterative=iterative,
         batch=batch, steps=PG_MAIN["steps"], noise="high", wall_s=wall,
         **summary, launches={k_: v for k_, v in launches.items() if v})
    for key, v in res.items():
        if not key.startswith("diverged") and not np.isfinite(v).all():
            raise AssertionError(f"pose graph, {secondary}: non-finite {key}")
    if summary["diverged"]:
        raise AssertionError(f"pose graph, {secondary}: {summary['diverged']} worlds diverged")
    if not (summary["mean_err_pose_graph_result"]
            < summary["mean_err_pose_graph_initial"]):
        raise AssertionError(f"pose graph, {secondary}: the solve did not "
                             f"improve on the seeds: {summary}")
    return res, launches


SPLIT_GN = 4  # Gauss-Newton steps of each timed solve of solve_split


def solve_split(cfg, s, cuda: bool = True) -> dict:
    """Where a bulk solve's time goes: ``solve_schur_pcg`` from the seeds of
    graphs ``s`` for SPLIT_GN steps with no CG step (the Gauss-Newton
    step's own work: Jacobians, blocks, the factor, the reduced rhs, the
    back-substitution, the line search) and with the study's CG steps; the
    difference a CG step (the matvec, the block-Thomas solve, the vector
    ops). Host-clock milliseconds, the fastest of two runs."""
    def run(n_cg: int) -> float:
        best = float("inf")
        for _ in range(2):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            pg.solve_schur_pcg(cfg, s, s.poses_init, s.lms_init, n_gn=SPLIT_GN, n_cg=n_cg)
            if cuda:
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return 1e3 * best
    n_cg = cfg.pose_graph.bulk_cg_iters
    gn_ms, full_ms = run(0), run(n_cg)
    return {"gn_steps": SPLIT_GN, "cg_steps_per_gn": n_cg,
            "gn_step_ms": gn_ms / SPLIT_GN,
            "cg_step_ms": (full_ms - gn_ms) / (SPLIT_GN * n_cg)}


def pose_graph_paths(dev, n_lm: int) -> tuple[list, int]:
    """The pose-graph main path and its three side runs; returns the records
    of its kernels for the ``kernels`` line and the main run's count of
    philox_noise launches."""
    res, launches = pg_run("ekf_slam", False, PG_MAIN["batch"], dev)
    again, _ = pg_run("ekf_slam", False, PG_MAIN["batch"], dev)
    spread = {k_: float(np.abs(res[k_].astype(np.float64) - again[k_]).max())
              for k_ in res}
    emit("pose_graph_repeat", equal={k_: bool(np.array_equal(res[k_], again[k_]))
                                     for k_ in res}, max_abs_diff=spread)
    if max(spread.values()) > PG_REPEAT_ATOL:
        raise AssertionError(f"the pose-graph path does not repeat: {spread}")
    pg_run("naive", False, PG_SIDE, dev)
    _, launches_iekf = pg_run("iekf_slam", False, PG_SIDE, dev)
    pg_run("naive", True, PG_SIDE, dev)

    record = []
    # ---- K3 at the shapes those runs gave it: its time with and without
    # the pose stream; its streams were held against the plain version's by
    # pose_stream_main_check, among the side checks
    for kind, ls in (("ekf", launches), ("iekf", launches_iekf)):
        name = f"fused_{kind}_rollout[emit_traj]"
        filt, batch = kind + "_slam", K3_WORLDS[kind]
        cfg, lms, cmds, noise = pose_stream_inputs(kind, dev, n_lm)
        kw = dict(noise=noise, filter_kind=kind)
        ms = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, emit_traj=True, **kw))
        ms_off = timed_ms(lambda: fr.fused_ekf_rollout(cfg, lms, cmds, 0, **kw))
        chk = next(d for d in LINES if d["phase"] == "pose_stream_main_vs_plain"
                   and d["kernel"] == name)
        gates = gate_counts(cfg, lms, cmds, 0)
        flops, nbytes = work(filt, gates, batch, PG_MAIN["steps"], n_lm)
        # beside the rollout's own traffic: the injected noise read once,
        # the two pose streams written once
        nbytes += 4.0 * noise.numel() + 2 * 4.0 * batch * PG_MAIN["steps"] * 3
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        emit("pose_stream_main_shape", kernel=name, batch=batch,
             steps=PG_MAIN["steps"], ms=ms, ms_without_stream=ms_off)
        record.append({
            "name": name, "route": "cuda", "source": PG_KERNELS[name][2],
            "replaces": PG_KERNELS[name][3], "launches": ls[name],
            "max_abs_err": max(chk[o]["max_abs_err"] for o in ("est_traj", "true_traj")),
            "ms": ms, "ms_without_stream": ms_off, "plain_ms": chk["plain_ms"],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "batch": batch, "plain_worlds": chk["plain_worlds"],
            "plain_steps": chk["steps"], "plain_timed": "beside the other side checks",
        })

    # ---- P1 and P2 on the main path's own graphs
    cfg = pg_config(PG_MAIN["steps"], "ekf_slam", False)
    graphs = pg_graphs(cfg, PG_MAIN["batch"], dev)[0]
    sy = schur_system(cfg, graphs, 1.0)
    d, u, rhs = sy["d"], sy["u"], sy["rhs"]
    res = block_thomas_compare(d, u, rhs, "block-Thomas main shape")
    fac = pg._tridiag_factor(d, u)
    # one wrapper call each (``ms``, as every kernel's), and the kernels
    # alone: launches back to back, without the wrapper's host time
    ms_f = timed_ms(lambda: pg._tridiag_factor(d, u))
    ms_s = timed_ms(lambda: pg._tridiag_solve(fac, rhs))
    alone_f, alone_s = factor_kernel_ms(d, u), solve_kernel_ms(fac, rhs)
    cycles, _ = pg.solve_phase_clocks(fac, rhs)
    fcycles, _ = pg.factor_phase_clocks(d, u)
    # the factor's longest dependent chain of a step: ~20 operations
    # (cofactor, determinant, reciprocal, the two products' 3-term sums), T
    # of them in a row
    emit("block_thomas_main_shape", **PG_MAIN, factor_ms=ms_f, solve_ms=ms_s,
         factor_kernel_ms=alone_f, solve_kernel_ms=alone_s,
         factor_latency_floor_ms=1e3 * (d.shape[1] - 1) * 20 * DEP_OP_S, **res)
    emit("block_thomas_phase_clocks", **PG_MAIN, segments=pg.SOLVE_SEGMENTS,
         cycles=cycles, shares={k_: v / sum(cycles.values()) for k_, v in cycles.items()})
    emit("block_thomas_factor_phase_clocks", **PG_MAIN, cycles=fcycles,
         cycles_per_step_per_world=sum(fcycles.values()) / d.shape[0] / (d.shape[1] - 1),
         shares={k_: v / sum(fcycles.values()) for k_, v in fcycles.items()})
    vp = pg._tridiag_solve(fac, rhs)
    mv = (d, u, sy["hll_inv"], sy["coeffs"], sy["slots"], vp)
    res_m = schur_mv_compare(sy, vp, "Schur matvec main shape")
    ms_m = timed_ms(lambda: pg._schur_mv(*mv))
    alone_m = schur_mv_kernel_ms(*mv)
    emit("schur_mv_main_shape", **PG_MAIN, ms=ms_m, kernel_ms=alone_m,
         torch_spelling_ms=timed_ms(lambda: pg._schur_mv_torch(*mv)),
         occupancy=pg.schur_mv_occupancy(sy["slots"].shape[2], sy["slots"].n),
         bytes_per_s=schur_mv_bytes(*mv) / (alone_m * 1e-3),
         bound_with_coefficients_read_twice_ms=1e3 * (
             schur_mv_bytes(*mv) + 4.0 * sum(c.numel() for c in sy["coeffs"])) / PEAK_BYTES,
         l2_hit_rate="not measured", **res_m)
    # the study's solve by part: 82 Gauss-Newton steps, 40 CG steps each
    split = solve_split(cfg, graphs)
    n_gn = launches["block_thomas_factor"]
    n_cg = launches["schur_mv"]
    emit("pose_graph_solve_split", **PG_MAIN, **split, schur_mv_ms=ms_m,
         cg_vector_ops_and_solve_ms=split["cg_step_ms"] - ms_m,
         study_gn_s=1e-3 * n_gn * split["gn_step_ms"],
         study_schur_mv_s=1e-3 * n_cg * ms_m,
         study_cg_rest_s=1e-3 * n_cg * (split["cg_step_ms"] - ms_m),
         solve_s=next(d["solve_s"] for d in LINES if d["phase"] == "pose_graph_path"))
    b, t1 = d.shape[:2]
    steps = t1 - 1
    k_cap = sy["slots"].shape[2]
    # factor: an adjugate inverse (~41 flop) and two 3x3 products (45 each)
    # and a subtraction (9) a step, the scaling (36); solve: three 3x3
    # matvecs (15 each) and two subtractions a step, the two scalings (the
    # work of the function: the segment scan's composed maps are the
    # kernel's own, beyond it). The Schur matvec: 18
    # flops a measurement each way (H_pl^T v and H_pl w) and the chain's
    # three 3x3 matvecs and sums (54) a pose.
    work_p1 = {
        "block_thomas_factor": (
            b * steps * 176.0, 4.0 * (d.numel() * 2 + u.numel() * 3 + b * t1 * 3),
            ms_f, res["factor_plain_ms"], ("sinv", "l", "u", "dsc"), res,
            {"kernel_ms": alone_f}),
        "block_thomas_solve": (
            b * t1 * 57.0, 4.0 * (d.numel() + u.numel() * 2 + b * t1 * 9),
            ms_s, res["solve_plain_ms"], ("x",), res,
            {"segments": res["segments"],
             "steps_per_segment": -(-steps // res["segments"]),
             "max_rel_to_scale_vs_sequential": res["x_vs_sequential"]["rel_to_scale"],
             "sequential_plain_ms": res["solve_sequential_plain_ms"],
             "kernel_ms": alone_s}),
        "schur_mv": (
            b * (steps * k_cap * 36.0 + t1 * 54.0), schur_mv_bytes(*mv),
            ms_m, res_m["plain_ms"], ("vs_reference",),
            {"vs_reference": {"max_abs_err": res_m["vs_reference"]["max_abs_err"],
                              "rel_to_scale": res_m["vs_reference"]["max_world_rel_to_scale"]}},
            {"kernel_ms": alone_m, "torch_spelling_plain_ms": res_m["torch_ms"]}),
    }
    # the per-tick pose graph's launches (its side process's counted run) and
    # the chordal systems' checks (the side checks' lines)
    ptpg = {d["run"]: d["launches"] for d in LINES if d["phase"] == "per_tick_pose_graph"}
    # the host side's demos (their side process's counted runs) and its
    # one-world checks of P1 and P2
    hs = next(d for d in LINES if d["phase"] == "host_side")
    hs_one = next(d for d in LINES if d["phase"] == "host_side_solve_vs_plain")
    chordal = {"block_thomas_factor": ("block_thomas_vs_plain", ("sinv", "l", "u", "dsc")),
               "block_thomas_solve": ("block_thomas_vs_plain", ("x",)),
               "schur_mv": ("schur_mv_vs_plain", ("vs_reference",))}
    for name, (flops, nbytes, ms, p_ms, outs, errs, extra) in work_p1.items():
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        phase, keys = chordal[name]
        extra = dict(extra, launches_by_path={
            "pose_graph_streams": launches[name],
            **{f"per_tick_pose_graph[{run}]": ls.get(name, 0) for run, ls in ptpg.items()},
            "host_side": hs["solve_launches"][name]},
            single_world_max_rel_to_scale=hs_one["max_rel_to_scale"][name],
            chordal_max_rel_to_scale=max(
                d[k]["rel_to_scale" if phase == "block_thomas_vs_plain"
                     else "max_world_rel_to_scale"]
                for d in LINES if d["phase"] == phase and d.get("chordal") for k in keys))
        record.append({
            "name": name, "route": "cuda", "source": PG_KERNELS[name][2],
            "replaces": PG_KERNELS[name][3], "launches": launches[name],
            "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
            "max_rel_to_scale": max(errs[o]["rel_to_scale"] for o in outs),
            "ms": ms, "plain_ms": p_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "batch": b, "steps": steps, **extra,
        })
    return record, launches["philox_noise"]


def phase_attribution(dev, n_lm: int, base, lms, cmds, gates: dict):
    """K1p: the EKF and RI-EKF rollouts at MAIN in their sim, nolm and full
    modes, each launched once through the runner's routing with the counts
    zeroed before and read after, then timed; each cut mode's kernel against
    its plain version on the first PLAIN_WORLDS worlds (default build within
    TOL_MAIN, -fmad=false bit for bit), nolm predicated against unpredicated
    and against the replayed Philox stream bit for bit, sim with the estimate
    where it started. Returns the kernels' records and each filter's times
    by mode."""
    modes = ("sim", "nolm", "full")
    b, t_total = MAIN["batch"], MAIN["steps"]
    lw, cw = lms[:PLAIN_WORLDS].contiguous(), cmds[:PLAIN_WORLDS].contiguous()
    noise_w = philox.philox_noise_reference(0, t_total, n_lm, PLAIN_WORLDS, dev)
    noise_card = philox.philox_noise(0, t_total, n_lm, PLAIN_WORLDS, dev)
    record, times = [], {}
    for kind in fr.FILTER_KINDS:
        filt = kind + "_slam"
        cfg = base.replace(filter=filt)
        names = {m: f"fused_{kind}_rollout" + ("" if m == "full" else f"[{m}]")
                 for m in modes}
        zero_counts()
        outs = {m: fused_rollout(cfg, lms, cmds, 0, profile_mode=m) for m in modes}
        torch.cuda.synchronize()
        launches = counts()
        want = {k_: int(k_ in names.values()) for k_ in launches}
        if launches != want:
            raise AssertionError(f"{filt}: the attribution path launched "
                                 f"{launches}, not once each of {list(names.values())}")
        ms = {m: timed_ms(lambda m=m: fused_rollout(cfg, lms, cmds, 1, profile_mode=m))
              for m in modes}
        times[filt] = ms
        d = 3 + 2 * n_lm
        x0 = torch.zeros((b, d), device=dev)
        x0[:, :3] = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev)
        p0 = torch.diag_embed(torch.tensor(
            list(fr.P0) + [0.0] * (d - 3), dtype=torch.float32, device=dev)).expand(b, d, d)
        sim = outs["sim"]
        if not (torch.equal(sim["x"], x0) and torch.equal(sim["P"], p0)
                and not bool(sim["seen"].any())):
            raise AssertionError(f"{filt}: sim mode moved the estimate")
        if bool(outs["nolm"]["seen"].any()):
            raise AssertionError(f"{filt}: nolm mode marked a landmark seen")
        for m in ("sim", "nolm"):
            name = names[m]
            k = {k_: v[:PLAIN_WORLDS] for k_, v in outs[m].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = fused_rollout(cfg, lw, cw, 0, noise=noise_w, plain=True, profile_mode=m)
            torch.cuda.synchronize()
            p_ms = 1e3 * (time.perf_counter() - t0)
            errs = compare(k, p, TOL_MAIN)
            with _build.without_fma():
                same = bitwise(fused_rollout(cfg, lw, cw, 0, profile_mode=m), p,
                               f"{name} main shape -fmad=false")
            checks = {"no_fma_bitwise_equal": same}
            if m == "nolm":
                checks["unpredicated_bitwise_equal"] = bitwise(
                    fused_rollout(cfg, lw, cw, 0, profile_mode=m, predicated=False),
                    k, f"{name} predicated against unpredicated")
                checks["philox_replay_bitwise_equal"] = bitwise(
                    fused_rollout(cfg, lw, cw, 5, noise=noise_card, profile_mode=m),
                    k, f"{name} in-kernel Philox against the replay")
            worst = max(TOL_MAIN, key=lambda o: errs[o]["max_abs_err"])
            flops, nbytes = work(filt, gates, b, t_total, n_lm, mode=m)
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            emit("profile_mode_vs_plain", kernel=name, worlds=PLAIN_WORLDS,
                 steps=t_total, plain_ms=p_ms, errors=errs, **checks)
            record.append({
                "name": name, "route": "cuda", "source": SRC + "fused_ekf_rollout.cu",
                "replaces": K1P_KERNELS[name][3], "launches": launches[name],
                "max_abs_err": errs[worst]["max_abs_err"],
                "ms": ms[m], "plain_ms": p_ms,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "flops": flops, "bytes": nbytes,
                "plain_worlds": PLAIN_WORLDS, "plain_steps": t_total,
            })
        split = {"sim": ms["sim"], "predict": ms["nolm"] - ms["sim"],
                 "landmark_loop": ms["full"] - ms["nolm"]}
        emit("phase_attribution", filter=filt, **MAIN, n_lm=n_lm, protocol="shared",
             ms=ms, split_ms=split,
             shares={k_: v / ms["full"] for k_, v in split.items()},
             launches={k_: v for k_, v in launches.items() if v})
    return record, times


# flops an entry of one Joseph pass: the products, sums and the final add
JOSEPH_FLOPS = {"prod9": 20.0, "hoist": 20.0}
JOSEPH_TERM_FLOPS = (2.0, 2.0, 2.0, 2.0, 3.0, 3.0, 5.0)
# flops a sigma column of one z-stats pass: a range-and-bearing evaluation of
# each sigma half (a square root, a division, the atan2 polynomial and a
# wrap: ~40 each), four sines and cosines (~20 each), the deviations and
# sums (~35). The kernel evaluates each sigma point once, on its own lane,
# and both lanes of a column compute the column's six terms w (a_p + a_m)
# and add them onto their partial sums (3 flops each, ZSTATS_TERM_FLOPS).
ZSTATS_FLOPS = 2 * 40.0 + 4 * 20.0 + 35.0
ZSTATS_TERM_FLOPS = 6 * 3.0
ZSTATS_FLOPS_KERNEL = ZSTATS_FLOPS + ZSTATS_TERM_FLOPS


def micro_work(c: dict, b: int, d: int) -> tuple[float, float, float, float]:
    """(flops, device-memory bytes, shared-memory bytes, flops executed) of
    one launch of a tool's case on b worlds of a (d, d) matrix. The flops
    are what the function needs, whichever variant computes it: the
    Cholesky's trailing updates over the lower triangle, one add an entry of
    the gathered column. The bound comes from them and from the bytes, each
    input read and each output written once in device memory. Beside the
    bound: the shared pipe's bytes (the register kernels' by
    ``tile_smem_bytes``; every kernel's in WAVEFRONTs of its pass loop's
    loads, and once a world the bytes of its inputs staged), and the flops
    this variant's loops execute, read off the kernel (the register
    Cholesky updates the whole padded tile at every pivot but the last and
    scales 12 rows a lane; the matvec's lanes multiply two padded lines
    each, and its column order adds their trees; the select-and-sum gather
    is the matvec's row order by a one-hot; take adds its lane's rows, 32
    a round; zstats evaluates each sigma point once and each column's terms
    on both its lanes)."""
    op, n = c["op"], float(c["passes"])
    mat = 4.0 * b * d * d
    if op == "rank_update":
        r = c["rank"]
        flops = n * b * 2.0 * r * d * d
        return flops, 2 * mat + 2 * 4.0 * b * r * d, tile_smem_bytes(c, b, d), flops
    if op == "column_gather":
        nbytes = mat + 4.0 * b + 4.0 * b * d
        if c["spelling"] == "select":
            # matvec_kernel's row order with one vector: L staged in and
            # read once, the one-hot written padded, 12 broadcasts a pass
            once = 2 * 4.0 * d * d + 4.0 * MICRO_TILE
            return (n * b * d, nbytes,
                    b * (once + n * WAVEFRONT * tile_lds("column_gather", "select")),
                    n * b * 32 * 2.0 * MATVEC_LINE_PRODUCTS)
        # P staged once; a round of the lanes' rows, one wavefront a pass
        rows = -(-d // 32)
        return (n * b * d, nbytes, b * (4.0 * d * d + n * WAVEFRONT * rows),
                n * b * 32.0 * rows)
    if op == "chol":
        du = c["du"]
        e_low = micro_ukf.chol_elems("lower", d, du)
        scal = sum(d - j - 1 for j in range(du))
        tile = MICRO_TILE * MICRO_TILE
        return (n * b * (2.0 * e_low + scal + 2.0 * du), 2 * mat,
                tile_smem_bytes(c, b, d),
                n * b * (2.0 * tile * (du - 1) + 32 * 12.0 * du + 2.0 * du))
    if op == "matvec":
        flops = n * b * 2.0 * d * d
        adds = MATVEC_TREE_ADDS if c["order"] == "col" else 0
        return (flops, mat + 4.0 * b * d * (1 + c["args"][1].shape[1]),
                tile_smem_bytes(c, b, d),
                n * b * 32 * (2.0 * MATVEC_LINE_PRODUCTS + adds))
    if op == "joseph":
        per = (sum(JOSEPH_TERM_FLOPS[:c["n_terms"]]) if c["spelling"] == "terms"
               else JOSEPH_FLOPS[c["spelling"]])
        flops = n * b * per * d * d
        return flops, 2 * mat + 4.0 * b * (4 * d + 3), tile_smem_bytes(c, b, d), flops
    if op == "zstats":
        # the inputs staged once (7 floats a column, padded to whole rounds
        # of 16), each round's four 4-byte loads a wavefront each a pass
        rounds = -(-d // 16)
        return (n * b * ZSTATS_FLOPS * d, 4.0 * b * (7 * d + 3),
                b * (4.0 * 7 * 16 * rounds + n * WAVEFRONT * ZSTATS_POINT_LOADS * rounds),
                n * b * ZSTATS_FLOPS_KERNEL * 16 * rounds)
    raise ValueError(op)


def library_ms(c: dict) -> float | None:
    """Milliseconds of the PyTorch calls that compute a case's function on
    its inputs, one call a pass (``baddbmm`` for the rank update and the
    matvec, ``linalg.cholesky`` of the pivoted block, ``gather``), or None
    where no one call does. A yardstick: nothing in the port calls these."""
    op, args = c["op"], c["args"]
    if op == "rank_update":
        p, k, h, n = args
        kt = k.transpose(1, 2).contiguous()
        step, state = (lambda v: torch.baddbmm(v, kt, h, alpha=-1.0)), p
    elif op == "column_gather":
        p, idx, n, _ = args
        index = idx.long()[:, None, None].expand(-1, p.shape[1], 1)
        step, state = (lambda v: v + torch.gather(p, 2, index)[..., 0]), \
            torch.zeros_like(p[:, :, 0])
    elif op == "chol":
        p, n, _, du = args
        block = p[:, :du, :du].contiguous()
        step, state = (lambda v: torch.linalg.cholesky(block)), None
    elif op == "matvec":
        l, g, n, order = args
        m = l.transpose(1, 2).contiguous() if order == "col" else l
        n = n * g.shape[1]
        ga = g[:, 0, :, None].contiguous()
        step, state = (lambda v: torch.baddbmm(v, m, ga)), torch.zeros_like(ga)
    else:
        return None
    state = step(state)  # warm-up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        state = step(state)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


# zstats' sine and cosine (csrc/micro_ops.cu sincos_reduced, the CUDA
# library's sinf and cosf without their path for |x| >= 105615) against
# torch.sin and torch.cos: every float32 of [-SINCOS_RANGE, SINCOS_RANGE]
# (the wrapped bearing lies in [-pi, pi]), SINCOS_CHUNK floats a launch
SINCOS_RANGE = 4.0
SINCOS_CHUNK = 1 << 26


def zstats_sincos_check(dev) -> dict:
    """Every float32 x with |x| <= SINCOS_RANGE, and NaN, through zstats'
    sine and cosine and through torch.sin and torch.cos on the card: the
    floats checked and the count whose sine or cosine differs in any bit."""
    top = int(np.float32(SINCOS_RANGE).view(np.int32))
    differ = checked = 0
    for lo in range(0, top + 1, SINCOS_CHUNK):
        pos = torch.arange(lo, min(lo + SINCOS_CHUNK, top + 1), dtype=torch.int32,
                           device=dev).view(torch.float32)
        for x in (pos, -pos):
            sc = mo.zstats_sincos(x)
            same = ((sc[:, 0].view(torch.int32) == torch.sin(x).view(torch.int32))
                    & (sc[:, 1].view(torch.int32) == torch.cos(x).view(torch.int32)))
            differ += int((~same).sum())
            checked += x.numel()
    nan = mo.zstats_sincos(torch.full((1,), float("nan"), device=dev))
    return {"floats": checked, "range": SINCOS_RANGE, "differ": differ,
            "nan_gives_nan": bool(torch.isnan(nan).all())}


def micro_compare(c: dict, worlds: int, short: dict | None = None) -> dict:
    """One case's kernel against its plain version on the first ``worlds``
    worlds. ``short`` is the same case at no more than MICRO_CHECK_PASSES
    passes (default: ``c`` itself): there the default build must lie within
    MICRO_RTOL of the output's scale. At ``c``'s own passes the default
    build's drift is reported. At both, the -fmad=false build must equal the
    plain version bit for bit. Returns the errors and the milliseconds of
    the plain version of ``c``."""
    fn, ref = getattr(mo, c["op"]), getattr(mo, c["op"] + "_reference")

    def run(case):
        args = tuple(a[:worlds].contiguous() if torch.is_tensor(a) else a
                     for a in case["args"])
        before = mo.launches[case["op"]]
        k = fn(*args)
        torch.cuda.synchronize()
        if mo.launches[case["op"]] != before + 1:
            raise AssertionError(f"{case['name']}: the wrapper did not launch the kernel")
        t0 = time.perf_counter()
        p = ref(*args)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        with _build.without_fma():
            k_nofma = fn(*args)
        if not torch.equal(k_nofma, p):
            raise AssertionError(
                f"{case['name']}, {case['passes']} passes: the -fmad=false build differs "
                f"from the plain version by {float((k_nofma - p).abs().max())}")
        return k, k_nofma, p, p_ms

    k, k_nofma, p, p_ms = run(c)
    k_s, _, p_s, _ = (k, k_nofma, p, p_ms) if short is None else run(short)
    err, top = float((k_s - p_s).abs().max()), float(p_s.abs().max())
    out = {"max_abs_err": err, "scale": top, "rel_to_scale": err / top,
           "rtol_of_scale": MICRO_RTOL,
           "checked_passes": (c if short is None else short)["passes"],
           "drift_rel_to_scale": float((k - p).abs().max()) / float(p.abs().max()),
           "plain_ms": p_ms, "plain_worlds": worlds, "no_fma_bitwise_equal": True}
    if not err <= MICRO_RTOL * top:
        raise AssertionError(f"{c['name']}: out of tolerance: {out}")
    if c["op"] == "joseph" and c["spelling"] != "terms":
        # both triangles from their own expressions: what FMA contraction
        # does to the symmetry the plain version keeps exactly
        out["asymmetry"] = float((k - k.transpose(1, 2)).abs().max())
        out["asymmetry_no_fma"] = float((k_nofma - k_nofma.transpose(1, 2)).abs().max())
    return out


def phase_micro_ops(dev) -> list:
    """The three tools at MAIN's batch and D = 48, through their ``run`` (the
    counts zeroed before, read after); then every case of theirs against its
    plain version and beside its bounds and library call: a case faster
    than its bound raises. Returns the six families' records."""
    b, d = MAIN["batch"], MICRO_DIM
    tools = {"micro_downdate": micro_downdate, "micro_ukf": micro_ukf,
             "micro_ukf_probe": micro_ukf_probe}
    zero_counts()
    rows = {name: tool.run(b, dev, REPS) for name, tool in tools.items()}
    torch.cuda.synchronize()
    launches = counts()
    want = {k_: 0 for k_ in launches}
    n_cases = {}
    for tool in tools.values():
        for c in tool.cases(8, dev, passes=1):
            n_cases[c["op"]] = n_cases.get(c["op"], 0) + 1
    for name, (key, _, _) in MICRO_KERNELS.items():
        want[name] = n_cases[key] * (REPS + 1)  # a warm-up and REPS timed launches
    if launches != want:
        raise AssertionError(f"the tools launched {launches}, expected {want}")
    families = {name: [] for name in MICRO_KERNELS}
    for tname, tool in tools.items():
        for c, c_short, r in zip(tool.cases(b, dev),
                                 tool.cases(b, dev, passes=MICRO_CHECK_PASSES),
                                 rows[tname]):
            if c_short["passes"] >= c["passes"]:
                c_short = None  # the tool's own launch is short enough
            flops, nbytes, smem, executed = micro_work(c, b, d)
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            v = {**r, "tool": tname, **micro_compare(c, PLAIN_WORLDS, c_short),
                 "bound_ms": 1e3 * max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "flops": flops, "bytes": nbytes, "flops_executed": executed,
                 "smem_bytes": smem, "smem_ms": 1e3 * smem / PEAK_SMEM_BYTES,
                 "library_ms": library_ms(c)}
            emit("micro_ops", worlds=b, dim=d, **v)
            if v["ms"] < v["bound_ms"]:
                raise AssertionError(
                    f"{c['name']}: {v['ms']} ms is under its bound of {v['bound_ms']} ms: "
                    f"passes were folded or part of a pass hoisted out of the loop")
            families["micro_" + c["op"]].append(v)
    # linearity in the passes: a launch of the tool's passes takes twice the
    # time of one of half as many (within 5%), or the compiler folded passes
    # together
    lin = {}
    for tool, op, variant in ((micro_ukf_probe, "rank_update", "R=2 (probe)"),
                              (micro_downdate, "column_gather", "take"),
                              (micro_ukf, "chol", "lower"),
                              (micro_ukf_probe, "matvec", "row"),
                              (micro_ukf, "joseph", "prod9"),
                              (micro_ukf, "zstats", "zstats")):
        def pick(passes=None):
            return next(c for c in tool.cases(b, dev, passes=passes)
                        if (c["op"], c["variant"]) == (op, variant))
        full = pick()
        t = [timed_ms(lambda: getattr(mo, op)(*c["args"]))
             for c in (pick(full["passes"] // 2), full)]
        lin[f"{op}[{variant}]"] = t[1] / t[0]
    emit("micro_ops_linearity", time_ratio_for_twice_the_passes=lin)
    if not all(1.9 <= r <= 2.1 for r in lin.values()):
        raise AssertionError(f"time is not linear in the passes: {lin}")
    sincos = zstats_sincos_check(dev)
    emit("zstats_sincos", **sincos)
    if sincos["differ"] or not sincos["nan_gives_nan"]:
        raise AssertionError(f"zstats' sine and cosine are not torch's: {sincos}")
    record = []
    for name, (key, replaces, head) in MICRO_KERNELS.items():
        vs = families[name]
        h = next(v for v in vs if v["variant"] == head)
        record.append({
            "name": name, "route": "cuda", "source": SRC + "micro_ops.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in vs),
            "max_rel_to_scale": max(v["rel_to_scale"] for v in vs),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "variant": head, "passes": h["passes"], "us_per_pass": h["us_per_pass"],
            "smem_ms": h["smem_ms"], "batch": b, "dim": d,
            "plain_worlds": PLAIN_WORLDS,
            "variants": [{k_: v[k_] for k_ in (
                "variant", "tool", "passes", "ms", "us_per_pass", "max_abs_err",
                "checked_passes", "drift_rel_to_scale", "plain_ms", "bound_ms",
                "bound_by", "flops", "flops_executed", "smem_ms", "library_ms")}
                for v in vs],
        })
        if name in MICRO_REDESIGNED:
            record[-1]["redesigned_in"] = MICRO_REDESIGNED[name]
    return record


def phase_op_sum(dev, n_lm: int, gates: dict, times: dict, kernel_ms: dict):
    """The passes a tick executes, from the gates' counts, times each
    primitive's measured time per pass at the kernel's own dimension, against
    the kernel's measured time: for K1 (D = 43) and K4 SLAM (Du = 44). A pass
    is timed over the whole batch, so a count per world-tick times the
    batch's time per pass is the batch's time. The rank-2 update, the
    Cholesky, the matvec and the Joseph update are register kernels, and the
    z-stats block evaluates each sigma point once: their parts read what
    those designs cost on this card, not a copy of the rollout's loop, so
    the sum is a floor of those designs, not the kernel's
    own split nor the primitives' least cost (the register Cholesky updates
    the whole padded tile at every pivot, 5.7x the lower triangle's flops at
    D = 48)."""
    b, t_total = MAIN["batch"], MAIN["steps"]
    upd = gates["updates"] / gates["ticks"]  # updates per world and tick

    def us_per_pass(c):
        return 1e3 * timed_ms(lambda: getattr(mo, c["op"])(*c["args"])) / c["passes"]

    d = 3 + 2 * n_lm
    dd = us_per_pass(micro_ukf_probe.cases(b, dev, dim=d)[0])
    parts = {
        "sim_and_predict (the nolm kernel)": times["ekf_slam"]["nolm"],
        "rank2_downdates": upd * t_total * dd / 1e3,
    }
    total = sum(parts.values())
    emit("op_sum", kernel="fused_ekf_rollout", **MAIN, dim=d,
         updates_per_world_tick=upd, rank2_downdate_us_per_pass=dd,
         parts_ms=parts, op_sum_ms=total, kernel_ms=kernel_ms["ekf_slam"],
         explained_share=total / kernel_ms["ekf_slam"],
         not_timed_alone="gain and H P vectors, state update, insertions",
         note="rank2_downdates reads the register-tiled rank-2 update, the "
              "primitive's floor on this card, not K1's own loop; K1's own "
              "split: ekf_phase_clocks")

    du = fu.state_dim(n_lm, True)
    per = {c["variant"]: us_per_pass(c)
           for c in micro_ukf.cases(b, dev, dim=du, du=du)}
    # The micro kernels are the TPU scripts' functions at K4's counts, no
    # longer K4's own loops (K4 factors four pivots a pass and walks lines of
    # two rows; its split by phase is the ukf_phase_clocks line): the sum
    # says what a tick would cost with its Cholesky, matvecs and Joseph
    # update as the register kernels (the floors of these designs on this
    # card: the Cholesky's tiles walk the whole padded width at every pivot,
    # whatever the variant) and its z-stats as the kernel that evaluates
    # each sigma point once, every lane busy (the floor of this block's
    # atan2, sine and cosine spelling on this card). The
    # rollout factors the active dimensions only (pivots past the highest
    # seen slot are skipped): the mean of n_act^3 over Du^3; matvecs over the
    # lower triangle (half of the rows' products); Joseph over one triangle,
    # timed here as the both-triangles spelling; z-stats by rotation algebra
    # in place of this block's atan2, sin and cos
    f_chol = gates["act3"] / gates["ticks"] / du ** 3
    parts = {
        "sim (the EKF kernel in sim mode)": times["ekf_slam"]["sim"],
        "chol_lower": t_total * f_chol * per["lower"] / 1e3,
        "predict_matvecs (4 a tick, triangular)": t_total * 4 * 0.5 * per["row x4"] / 1e3,
        "update_matvecs (2 an update, triangular)": upd * t_total * 2 * 0.5 * per["row x4"] / 1e3,
        "update_joseph": upd * t_total * per["prod9"] / 1e3,
        "update_zstats": upd * t_total * per["zstats"] / 1e3,
    }
    total = sum(parts.values())
    emit("op_sum", kernel="fused_ukf_rollout[slam]", **MAIN, dim=du,
         updates_per_world_tick=upd, chol_active_share=f_chol,
         us_per_pass=per, parts_ms=parts, op_sum_ms=total,
         kernel_ms=kernel_ms["ukf_slam"],
         explained_share=total / kernel_ms["ukf_slam"],
         not_timed_alone="sigma propagation, the 4x4 block, gain and gate, insertions",
         note="the TPU scripts' functions at K4's counts; chol_lower, the "
              "matvecs and update_joseph read the register kernels, the "
              "floors of these designs on this card (the Cholesky updates "
              "the whole padded 48 x 48 tile at every pivot), not K4's own "
              "loops; update_zstats the z-stats kernel that evaluates each "
              "sigma point once (the floor of the block's atan2, sine and "
              "cosine spelling, not K4's rotation algebra); K4's own split: "
              "ukf_phase_clocks")


# the EKF kernels' instantiations: name -> (filter kind, profile mode,
# emit_traj, template arguments <kInvariant, kEmitTraj, kMode>)
EKF_INSTANCES = {
    "fused_ekf_rollout": ("ekf", "full", False, "false, false, 0"),
    "fused_iekf_rollout": ("iekf", "full", False, "true, false, 0"),
    "fused_ekf_rollout[emit_traj]": ("ekf", "full", True, "false, true, 0"),
    "fused_iekf_rollout[emit_traj]": ("iekf", "full", True, "true, true, 0"),
    "fused_ekf_rollout[nolm]": ("ekf", "nolm", False, "false, false, 1"),
    "fused_iekf_rollout[nolm]": ("iekf", "nolm", False, "true, false, 1"),
    "fused_ekf_rollout[sim]": ("ekf", "sim", False, "false, false, 2"),
    "fused_iekf_rollout[sim]": ("iekf", "sim", False, "true, false, 2"),
}
# worlds an SM that K1 and K2 (EKF_INSTANCES' first two) and K4 SLAM must
# keep without spilling at N = 20: the register file's limit at 128 a thread
EKF_RESIDENT, UKF_SLAM_RESIDENT = 16, 16


def ptxas_report(src: str) -> dict:
    """What ptxas reports of every kernel of one source, compiled with the
    default build's flags: mangled name -> registers, stack frame and spill
    store and load bytes a thread."""
    cmd = [_build.find_nvcc(), *(f for f in _build.NVCC_FLAGS if f != "-shared"),
           "-Xptxas", "-v", "-c", "-o", "/dev/null", str(_build.CSRC / src)]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["ptxas_registers"] = int(line.split("Used")[1].split()[0])
    return out


SASS_FP = ("FFMA", "FMUL", "FADD")


def sass_pass_loops(sass: str, keep: tuple[str, ...] = ("",)) -> dict:
    """Per function of ``cuobjdump -sass`` output (mangled name) whose name
    holds one of ``keep``, the counts of each mnemonic in the body of its
    loop with the most float32 arithmetic (FFMA, FMUL, FADD): the
    instructions from a backward branch's target address to the branch, the
    pass loop of a kernel whose inner loops are unrolled. MUFU counts by its
    function (MUFU.RSQ, MUFU.RCP, ...), every other mnemonic without its
    suffix. Counts {} where no loop holds float32 arithmetic."""
    out, name, code = {}, None, []

    def close():
        best = {}
        for i, (addr, op, target) in enumerate(code):
            if op != "BRA" or target is None or target > addr:
                continue
            body = {}
            for a, o, _ in code[:i + 1]:
                if a >= target:
                    body[o] = body.get(o, 0) + 1
            if sum(body.get(k_, 0) for k_ in SASS_FP) > sum(best.get(k_, 0) for k_ in SASS_FP):
                best = body
        out[name] = best

    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            if name is not None:
                close()
            name = m.group(1) if any(k_ in m.group(1) for k_ in keep) else None
            code = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.\S+)?\s*(.*)", line)
        if not m or name is None:
            continue
        addr, op, rest = int(m.group(1), 16), m.group(2), m.group(4).split(";")[0]
        if op == "MUFU":
            op += m.group(3) or ""
        t = re.search(r"0x[0-9a-f]+", rest) if op == "BRA" else None
        code.append((addr, op, int(t.group(0), 16) if t else None))
    if name is not None:
        close()
    return out


def micro_sass(lib: Path) -> dict:
    """The micro kernels of the default build's library ``lib``
    disassembled (``cuobjdump -sass``): for each kernel of MICRO_SASS the
    float32 arithmetic (zstats: its square roots) and shared loads of its
    pass loop a lane (chol's: the loop over its pivots), beside what the
    expression needs for the lane's entries and the loads the design makes
    (``tile_lds``, which ``micro_work``'s shared-memory bytes count). Less
    arithmetic would mean part of a pass was hoisted out of the loop, other
    counts or loads that the work and the bytes are not the kernel's:
    raises. One ``micro_sass`` line."""
    cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    loops = sass_pass_loops(sass, keep=("rank_update_kernel", "joseph_kernel",
                                        "chol_kernel", "matvec_kernel",
                                        "column_gather_kernel", "zstats_kernel"))
    rows = {}
    for name, (targs, expression) in MICRO_SASS.items():
        op, variant = name[:-1].split("[")
        stem = sass_stem(name)
        body = next(v for k_, v in loops.items() if stem in k_)
        keys = SASS_FP if set(expression) <= set(SASS_FP) else tuple(expression)
        found = {k_: body.get(k_, 0) for k_ in keys}
        want = {k_: expression.get(k_, 0) for k_ in keys}
        rows[name] = {"per_pass": found, "expression": want,
                      "lds": sum(v for k_, v in body.items() if k_.startswith("LDS")),
                      "design_lds": tile_lds(op, variant),
                      "matches_expression": found == want,
                      "fp_share_of_expression": sum(found.values()) / sum(want.values())}
    emit("micro_sass", tile_entries=MICRO_TILE_ENTRIES, kernels=rows)
    short = {k_: r for k_, r in rows.items() if r["fp_share_of_expression"] < 1.0}
    if short:
        raise AssertionError(f"a pass loop holds less float32 arithmetic than its "
                             f"expression needs (hoisted): {short}")
    # e.g. zstats: one square root a sigma point, not the parent's second
    # evaluation of z
    inexact = {k_: r for k_, r in rows.items()
               if k_ in MICRO_SASS_EXACT and not r["matches_expression"]}
    if inexact:
        raise AssertionError(f"a pass loop holds other operations than its design: {inexact}")
    other = {k_: r for k_, r in rows.items() if r["lds"] != r["design_lds"]}
    if other:
        raise AssertionError(f"a pass loop makes other shared loads than its design: {other}")
    return rows


def mangled_args(args: str) -> str:
    """Template arguments as they are mangled: "true, false, 0" -> ILb1ELb0ELi0EE."""
    parts = {"true": "Lb1E", "false": "Lb0E"}
    return "I" + "".join(parts.get(a, f"Li{a}E") for a in args.split(", ")) + "E"


def solve_ptxas(ptxas: dict) -> dict:
    """ptxas's report of the block-Thomas solve that the port launches at
    the study's T (template <segments, round, y in shared memory>)."""
    stem = f"block_thomas_solve_kernelILi{pg.SOLVE_SEGMENTS}ELi"
    return next(v for k_, v in ptxas.items() if stem in k_ and "ELb1EE" in k_)


def phase_occupancy(n_lm: int, ptxas: dict) -> list:
    """Every rollout kernel's launch at N = n_lm as the card takes it:
    registers and local bytes a thread, shared bytes a block, worlds a
    block, and resident blocks and worlds an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); beside them the stack
    and spill bytes ptxas reports (``ptxas``: ptxas_report of the rollout
    sources, block_thomas.cu, schur_mv.cu and micro_ops.cu). K1 and K2
    must keep EKF_RESIDENT worlds on an SM, K4 SLAM UKF_SLAM_RESIDENT,
    without spilling; beside them P1's solve and P2, which must not spill
    either, and the register micro kernels at D = 48, which must use no
    local memory at all and hold 8 or 16 worlds an SM."""
    rows, args = [], {}
    for name, (kind, mode, traj, targs) in EKF_INSTANCES.items():
        rows.append({"kernel": name, **fr.occupancy(n_lm, kind, mode, traj)})
        args[name] = targs
    for slam in (True, False):
        name = f"fused_ukf_rollout[{'slam' if slam else 'loc'}]"
        rows.append({"kernel": name, **fu.occupancy(n_lm, slam)})
        args[name] = "true" if slam else "false"
    for r in rows:
        kind = "ukf" if r["kernel"].startswith("fused_ukf") else "ekf"
        stem = f"fused_{kind}_rollout_kernel" + mangled_args(args[r["kernel"]])
        r.update(next(v for k_, v in ptxas.items() if stem in k_))
        emit("occupancy", n_lm=n_lm, **r)
    # P1's solve at the pose-graph study's T, y in shared memory, and P2 at
    # its K and N
    cfg = pg_config(PG_MAIN["steps"], "ekf_slam", False)
    for r in ({"kernel": "block_thomas_solve", "steps": PG_MAIN["steps"],
               "segments": pg.SOLVE_SEGMENTS, **pg.solve_occupancy(PG_MAIN["steps"]),
               **solve_ptxas(ptxas)},
              {"kernel": "schur_mv", "k": cfg.num_meas_slots, "n_lm": n_lm,
               "threads": pg.SCHUR_THREADS,
               **pg.schur_mv_occupancy(cfg.num_meas_slots, n_lm),
               **next(v for k_, v in ptxas.items() if "schur_mv_kernel" in k_)}):
        emit("occupancy", **r)
        rows.append(r)
    need = {"fused_ekf_rollout": EKF_RESIDENT, "fused_iekf_rollout": EKF_RESIDENT,
            "fused_ukf_rollout[slam]": UKF_SLAM_RESIDENT, "block_thomas_solve": 1,
            "schur_mv": 1}
    for r in rows:
        if r["kernel"] in need and (r["worlds_per_sm"] < need[r["kernel"]]
                                    or r["spill_store_bytes"] or r["spill_load_bytes"]):
            raise AssertionError(f"{r['kernel']}: fewer than {need[r['kernel']]} "
                                 f"worlds an SM, or spills: {r}")
    # the micro kernels at D = 48 and 4096 worlds: no spills and no local
    # memory (a register kernel's matrix stays in registers); the worlds an
    # SM of MICRO_RESIDENT
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name in MICRO_SASS:
        op, variant = name[:-1].split("[")
        kw = mo.occupancy_kwargs(op, variant, micro_ukf.MATVEC_A)
        r = {"kernel": "micro_" + name, "dim": MICRO_DIM, **mo.occupancy(op, MICRO_DIM, **kw),
             **next(v for k_, v in ptxas.items() if sass_stem(name) in k_)}
        r["waves_at_4096_worlds"] = MAIN["batch"] / (r["worlds_per_sm"] * n_sm)
        emit("occupancy", **r)
        rows.append(r)
        resident = MICRO_RESIDENT.get(name, (8, 16))
        if (r["local_bytes"] or r["spill_store_bytes"] or r["spill_load_bytes"]
                or r["worlds_per_sm"] not in resident):
            raise AssertionError(f"{r['kernel']}: local memory, spills, or not "
                                 f"{resident} worlds an SM: {r}")
    return rows


def phase_tick_clocks(lms, cmds, n_lm: int, kernel_ms: dict) -> dict:
    """K4 SLAM and Loc, K1 and K2 at MAIN once each in the build that counts
    cycles by phase of the tick (the ``ukf_phase_clocks`` and
    ``ekf_phase_clocks`` lines): each phase's share of the cycles and that
    share of the default build's measured time."""
    runs = {
        "ukf_slam": lambda cfg: fu.phase_clocks(cfg, lms, cmds, 0, slam=True),
        "ukf_loc": lambda cfg: fu.phase_clocks(cfg, lms, cmds, 0, slam=False),
        **{kind + "_slam": (lambda cfg, kind=kind: fr.phase_clocks(
            cfg, lms, cmds, 0, filter_kind=kind)) for kind in fr.FILTER_KINDS},
    }
    out = {}
    for filt, run in runs.items():
        cycles, res = run(Config(num_iterations=MAIN["steps"]).replace(filter=filt))
        if not bool(torch.isfinite(res["err_sum"]).all()):
            raise AssertionError(f"{filt}: the phase-clock build's errors are not finite")
        total = sum(cycles.values())
        shares = {k_: v / total for k_, v in cycles.items()}
        out[filt] = shares
        emit(("ukf" if filt.startswith("ukf") else "ekf") + "_phase_clocks",
             filter=filt, **MAIN, n_lm=n_lm, cycles=cycles, shares=shares,
             kernel_ms=kernel_ms[filt],
             ms_by_share={k_: v * kernel_ms[filt] for k_, v in shares.items()})
    return out


def rollout_checks(kname: str, dev, n_lm: int):
    """One rollout kernel against its plain version on three configs at
    SMALL, then predicated against unpredicated and in-kernel Philox against
    the replayed stream."""
    filt, (ctr, key), _, _ = KERNELS[kname]
    # ---- 3. kernel vs plain version, injected noise, three configs:
    # the default build per world within TOL, over SMALL and over its
    # first SHORT ticks, on the worlds the plain version does not flag as
    # chaotic; the -fmad=false build bit for bit
    rng = np.random.default_rng(3)
    for cname, cfg in configs(SMALL["steps"]).items():
        t_phase = time.perf_counter()
        cfg = cfg.replace(filter=filt)
        lms, cmds = mc_inputs(cfg, SMALL["batch"], 3, dev)
        noise = torch.as_tensor(
            rng.uniform(-1, 1, (SMALL["steps"], 2 * n_lm + 8,
                                SMALL["batch"])).astype(np.float32),
            device=dev)
        before = ctr[key]
        k = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        torch.cuda.synchronize()
        if ctr[key] != before + 1:
            raise AssertionError(f"{kname}: the wrapper did not launch the kernel")
        p, exempt = plain_run(cfg, lms, cmds, noise, TOL)
        errs = compare(k, p, TOL, exempt, AGG_RTOL)
        with _build.without_fma():
            k_nofma = fused_rollout(cfg, lms, cmds, 0, noise=noise)
        same = bitwise(k_nofma, p, f"{kname} {cname} -fmad=false")
        cs, ns = cmds[:, :SHORT].contiguous(), noise[:SHORT].contiguous()
        p_short, exempt_short = plain_run(cfg, lms, cs, ns, TOL)
        errs_short = compare(fused_rollout(cfg, lms, cs, 0, noise=ns),
                             p_short, TOL, exempt_short)
        emit("kernel_vs_plain", kernel=kname, config=cname, **SMALL,
             seconds=time.perf_counter() - t_phase,
             n_lm=n_lm, worlds_with_2plus_landmarks=int(
                 (k["seen"].sum(1) >= 2).sum()), errors=errs,
             short_steps=SHORT, errors_short=errs_short,
             no_fma_bitwise_equal=same)

    # ---- 4. predicated == unpredicated, bit for bit (in-kernel noise),
    # ---- 5. in-kernel Philox == the replayed philox_noise stream
    cfg = configs(SMALL["steps"])["default"].replace(filter=filt)
    lms, cmds = mc_inputs(cfg, SMALL["batch"], 4, dev)
    a = fused_rollout(cfg, lms, cmds, 11)
    b = fused_rollout(cfg, lms, cmds, 11, predicated=False)
    nz = philox.philox_noise(11, SMALL["steps"], n_lm, SMALL["batch"], dev)
    c = fused_rollout(cfg, lms, cmds, 0, noise=nz)
    torch.cuda.synchronize()
    same = {k_: bool(torch.equal(a[k_], b[k_])) for k_ in a}
    replay = {k_: bool(torch.equal(a[k_], c[k_])) for k_ in a}
    emit("predicated_vs_unpredicated", kernel=kname, bitwise_equal=same)
    emit("philox_replay", kernel=kname, inkernel_equals_replay=replay)
    if not all(same.values()):
        raise AssertionError(f"{kname}: predication changed the result: {same}")
    if not all(replay.values()):
        raise AssertionError(f"{kname}: in-kernel Philox differs from the replay")


def philox_check(dev, n_lm: int):
    """The standalone Philox kernel against its torch version."""
    nz = philox.philox_noise(11, SMALL["steps"], n_lm, SMALL["batch"], dev)
    nz_ref = philox.philox_noise_reference(11, SMALL["steps"], n_lm,
                                           SMALL["batch"], dev)
    emit("philox", kernel_equals_torch=bool(torch.equal(nz, nz_ref)),
         mean=float(nz.mean()), var=float(nz.var()), min=float(nz.min()),
         max=float(nz.max()))
    if not torch.equal(nz, nz_ref):
        raise AssertionError("Philox stream differs between kernel and torch")
    if abs(float(nz.mean())) > 0.01 or abs(float(nz.var()) - 1 / 3) > 0.01:
        raise AssertionError("Philox noise moments are off")


# ---- the per-tick path (eval/runner.make_step through run_monte_carlo's
# impl="per_tick"): every online filter at the main path's size, on the
# main path's inputs and Philox noise, so that each world is the world the
# fused kernel saw. Its modes: name -> (filter, what differs from the
# default config).
PT_MODES = {
    "naive": ("naive", {}),
    "ekf_slam": ("ekf_slam", {}),
    "ekf_slam[unknown_ids]": ("ekf_slam", {"unknown_ids": True}),
    "iekf_slam": ("iekf_slam", {}),
    "ukf_loc": ("ukf_loc", {}),
    "ukf_loc[chol]": ("ukf_loc", {"sigma_sqrt": "chol"}),
    "ukf_slam[chol]": ("ukf_slam", {"sigma_sqrt": "chol"}),
    "ukf_slam[eigh]": ("ukf_slam", {}),
}
# UKF-SLAM's default square root is a batched 44 x 44 torch.linalg.eigh a
# tick, which takes ~1 s at 4096 worlds on the card (the `eigh_timing` line:
# cuSOLVER's batched Jacobi path serves n <= 32 only, and eigh syncs with
# the host): its run at the main path's width is cut to this many ticks, and
# it and its card-against-CPU check run alone in the main process, where
# its host syncs wait on no other process's time slices on the card.
PT_EIGH = "ukf_slam[eigh]"
PT_EIGH_TICKS = 20
# A per-tick tick is bound by the host (~4000 small launches; the device
# busy ~17-18% of it): each mode's tick time is taken alone on a window of
# its first ticks (a tick runs the same launches whatever the state), and
# the other modes' full-size runs are side checks, in processes beside the
# others, whose per-world results the main process holds against the fused
# kernels once those have run (their seconds are not a mode's own).
PT_WINDOW = {PT_EIGH: 4}
PT_WINDOW_TICKS = 20
PT_RUN_GROUPS = (
    ("ekf_slam", "naive"), ("ekf_slam[unknown_ids]",), ("iekf_slam",),
    ("ukf_slam[chol]",), ("ukf_loc[chol]", "ukf_loc"),
)
PT_RUNS = {}  # mode -> the line of its full-size run, from its side process
# The card against the CPU: every mode on these worlds and ticks, the same
# inputs on both devices; all but PT_EIGH in two side processes, whose
# host-bound runs (the CPU's plain version on two threads) set the side
# checks' pace at 200 ticks.
PT_SMALL = dict(batch=64, steps=100)
PT_CPU_GROUPS = (
    ("naive", "ekf_slam", "ekf_slam[unknown_ids]", "ukf_loc", "ukf_loc[chol]"),
    ("iekf_slam", "ukf_slam[chol]"),
)
# Per-tick against the fused kernel on the same worlds, per world: |per-tick
# - fused| <= atol + rtol * fused, on the average error (metres), and the
# relative gap of the mean errors. Both run the same filter in float32 but
# not the same arithmetic: the per-tick filters are the JAX model's algebra
# (P symmetrised once a tick, one-hot slot reads, torch.atan2), the kernels
# their own (the two-sided downdate, FMA, K5's atan2); over 1000 ticks of
# feedback those roundings part by up to ~1e-3 m (measured on an H100 at
# the main shape: EKF 0.98 mm in the worst of 4096 worlds, median 12 um). A landmark on the
# field-of-view edge may be seen by one and not the other (ROADMAP F9), and
# a UKF-Loc world whose kernel run refused an update is chaotic (F6, and
# NUDGE above): both kinds are counted and left out. UKF-SLAM is held by
# its mean error over all worlds and its diverged count only: by T = 1000
# about half its worlds are chaotic (F6), the two paths part by up to
# metres in a few (5.8 m in one of 4096), and their mean errors by ~1%
# (1.04%, measured on an H100); a fault moves the mean by far more. Its mean
# is taken over the worlds that PT_CHAOS calls calm: at 64 worlds x 200
# ticks one chaotic world (0.74 m apart on the card; the JAX package's own
# model and kernel part there too, by 0.06 m) moves the all-world mean by
# 18%.
# mode -> (fused counterpart, per-world (atol, rtol) or None, mean rtol)
PT_AGAINST = {
    "naive": ("naive_deadreckon", (1e-4, 1e-3), 0.01),
    "ekf_slam": ("ekf_slam", (1e-4, 1e-2), 0.01),
    "iekf_slam": ("iekf_slam", (1e-4, 1e-2), 0.01),
    "ukf_loc[chol]": ("ukf_loc", (1e-4, 1e-2), 0.01),
    "ukf_slam[chol]": ("ukf_slam", None, 0.03),
}
# the largest share of the held worlds outside the per-world tolerance, and
# of all worlds by which the diverged counts may differ
PT_OUTSIDE_SHARE = 0.01
# The modes whose mean is held over calm worlds alone. A world is chaotic,
# and left out of the mean, when the fused kernel refused an update in it
# (the UKF-Loc criterion) or when the fused kernel run again with its noise
# scaled by NUDGE moves the world's average error by more than CHAOS_RATIO
# of PT_CARD_TOL (the per-tick path's card-against-CPU criterion, read off
# the kernel, whose run is cheap)
PT_CHAOS = ("ukf_slam[chol]",)
# card against CPU, per world: |card - cpu| <= atol + rtol * cpu on the
# average error, the alive masks equal, in every world that is not chaotic:
# for the UKFs, a world whose CPU run moves by more than CHAOS_RATIO of the
# tolerance when its noise is scaled by NUDGE (measured on an H100: 23 of 64
# UKF-SLAM chol worlds chaotic, 6 of them parting by up to 0.62 m; every
# other world of every mode within 2.4e-5 m)
PT_CARD_TOL = (1e-6, 1e-3)


def per_tick_config(base, mode: str):
    """The config of a per-tick mode of PT_MODES."""
    filt, kw = PT_MODES[mode]
    cfg = base.replace(filter=filt)
    if kw.get("unknown_ids"):
        cons = cfg.constraints
        cfg = cfg.replace(constraints=dataclasses.replace(
            cons, measurements=dataclasses.replace(
                cons.measurements, landmark_id_is_known=False)))
    if "sigma_sqrt" in kw:
        cfg = cfg.replace(ukf=dataclasses.replace(cfg.ukf,
                                                  sigma_sqrt=kw["sigma_sqrt"]))
    return cfg


def pt_steps(mode: str) -> int:
    return PT_EIGH_TICKS if mode == PT_EIGH else MAIN["steps"]


def fov_edge_worlds(cfg, lms, cmds, noise) -> np.ndarray:
    """(B,) bool: the worlds in which, at some tick, torch.atan2 and K5's
    atan2 disagree on whether a landmark is visible, on the per-tick path's
    own truth (ROADMAP F9)."""
    vision = cfg.constraints.vision
    pose = torch.tensor(cfg.init_pose, dtype=torch.float32,
                        device=lms.device).expand(lms.shape[0], 3)
    edge = torch.zeros(lms.shape[0], dtype=torch.bool, device=lms.device)
    for t in range(cmds.shape[1]):
        pose = propagate_truth(cfg, pose, cmds[:, t], noise[t, 0:2].T)
        dx = lms[:, :, 0] - pose[:, 0:1]
        dy = lms[:, :, 1] - pose[:, 1:2]
        r_ok = torch.sqrt(dx * dx + dy * dy) <= vision.range_max
        vis = []
        for b in (wrap_angle(torch.atan2(dy, dx) - pose[:, 2:3]),
                  wrap(atan2(dy, dx) - pose[:, 2:3])):
            vis.append(r_ok & (b > vision.fov_min) & (b < vision.fov_max))
        edge |= (vis[0] != vis[1]).any(dim=1)
    return edge.cpu().numpy()


def fused_chaotic(ref_err, ref_rej, ref_err_nudged) -> np.ndarray:
    """(B,) bool: the worlds PT_CHAOS calls chaotic, from the fused run's
    average errors, its refusals and its average errors with the noise
    scaled by NUDGE."""
    atol, rtol = PT_CARD_TOL
    moved = np.abs(ref_err_nudged - ref_err) > CHAOS_RATIO * (atol + rtol * np.abs(ref_err))
    return moved | (ref_rej > 0)


def held_against_fused(mode, cfg, err, diverged, ref, lms, cmds, noise,
                       ref_nudged=None) -> dict:
    """The per-tick average errors of ``mode`` against its fused counterpart
    on the same worlds (PT_AGAINST); ``ref`` is (average errors, diverged
    mask, update refusals or None) of the fused run, ``ref_nudged`` its
    average errors with the noise scaled by NUDGE, which a mode of PT_CHAOS
    needs. Raises when out of tolerance."""
    against, tol, mean_rtol = PT_AGAINST[mode]
    ref_err, ref_div, ref_rej = ref
    b = len(err)
    held = ~diverged & ~ref_div
    out = {"against": against, "tolerance": tol, "mean_rtol": mean_rtol}
    if mode in PT_CHAOS:
        if ref_nudged is None:
            raise ValueError(f"{mode}: its mean is held over calm worlds, which "
                             "the fused run's nudged errors name")
        chaotic = fused_chaotic(ref_err, ref_rej, ref_nudged)
        held &= ~chaotic
        out.update(chaos="PT_CHAOS", worlds_chaotic=int(chaotic.sum()))
    if tol is not None:
        chaotic = np.zeros(b, bool) if ref_rej is None else ref_rej > 0
        edge = fov_edge_worlds(cfg, lms, cmds, noise)
        held &= ~chaotic & ~edge
        out.update(worlds_refusing_in_kernel=int(chaotic.sum()),
                   fov_edge_worlds=int(edge.sum()))
    d = np.abs(err - ref_err)
    mean_ref = float(ref_err[held].mean())
    out.update(
        worlds_held=int(held.sum()), mean_err_fused_m=mean_ref,
        mean_err_gap_rel=abs(float(err[held].mean()) - mean_ref) / mean_ref,
        mean_err_gap_rel_all_worlds=(abs(float(err.mean()) - float(ref_err.mean()))
                                     / float(ref_err.mean())),
        diverged_fused=int(ref_div.sum()),
        max_abs_diff_m=float(d[held].max()),
        max_abs_diff_all_worlds_m=float(d.max()),
        median_abs_diff_m=float(np.median(d[held])))
    if tol is not None:
        atol, rtol = tol
        outside = ~(d <= atol + rtol * np.abs(ref_err))
        out.update(worlds_outside=int((outside & held).sum()),
                   worlds_outside_all=int(outside.sum()))
        if out["worlds_outside"] > PT_OUTSIDE_SHARE * b:
            raise AssertionError(f"{mode}: per-tick against {against}: {out}")
    if not out["mean_err_gap_rel"] <= mean_rtol:
        raise AssertionError(f"{mode}: mean error against {against}: {out}")
    if abs(int(diverged.sum()) - out["diverged_fused"]) > PT_OUTSIDE_SHARE * b:
        raise AssertionError(f"{mode}: diverged worlds against {against}: {out}")
    return out


def tick_launches(cfg, carry, cmd, u, t=None) -> dict:
    """One tick (tick t) of the per-tick step under torch.profiler
    (``profiled``). A pose graph's tick writes its rows into the carry's
    graph: the same rows twice."""
    step = make_step(cfg)
    return profiled(lambda: step(carry, cmd, u, t))


def profiled(fn) -> dict:
    """``fn()`` once untimed, then once under torch.profiler: the CUDA
    kernels it runs (and memory copies / sets), their summed device time,
    the runtime's launch calls, and its host time (profiled)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = memops = launch_calls = 0
    device_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                memops += 1
            else:
                kernels += 1
            device_us += e.device_time_total
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launch_calls += 1
    return {"kernels": kernels, "memops": memops, "launch_calls": launch_calls,
            "device_ms": device_us / 1e3, "host_ms_profiled": 1e3 * host_s,
            "device_busy_share": device_us / 1e6 / host_s if host_s else None}


def eigh_timing(dev, b: int):
    """One torch.linalg.eigh of b random symmetric positive definite n x n
    float32 matrices (seeded) for n = 4 (UKF-Loc), 32 (the largest n of
    cuSOLVER's batched Jacobi path) and 44 (UKF-SLAM at N = 20), after a
    warm-up call each."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for n in (4, 32, 44):
        a = torch.randn((b, n, n), generator=gen, device=dev)
        a = a @ a.transpose(1, 2) + 0.1 * torch.eye(n, device=dev)
        torch.linalg.eigh(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.eigh(a)
        torch.cuda.synchronize()
        ms[f"n={n}"] = 1e3 * (time.perf_counter() - t0)
    emit("eigh_timing", worlds=b, ms=ms)


def per_tick_alone(dev, n_lm: int, lms, cmds, noise) -> dict:
    """Each mode's tick time alone on the card: the first PT_WINDOW ticks on
    the main path's inputs, after two ticks of warm-up; and one tick of
    ekf_slam and of ukf_slam[chol] under the profiler. mode -> dict."""
    out = {}
    for mode in PT_MODES:
        cfg = per_tick_config(Config(num_iterations=MAIN["steps"]), mode)
        w = PT_WINDOW.get(mode, PT_WINDOW_TICKS)
        step = make_step(cfg)
        carry, _ = rollout(cfg, init_carry(cfg, lms, n_lm), cmds[:, :2],
                           noise[:2], step=step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = rollout(cfg, carry, cmds[:, 2:2 + w], noise[2:2 + w],
                           step=step)
        torch.cuda.synchronize()
        tick_s = (time.perf_counter() - t0) / w
        out[mode] = {"window_ticks": w, "ms_per_tick": 1e3 * tick_s,
                     "steps_per_s_per_world": 1.0 / tick_s}
        if mode in ("ekf_slam", "ukf_slam[chol]"):
            out[mode]["one_tick"] = tick_launches(
                cfg, carry, cmds[:, 2 + w], noise[2 + w].T)
    return out


def per_tick_run(mode: str, dev) -> dict:
    """``mode`` through run_monte_carlo(impl="per_tick") at 4096 worlds, the
    counts zeroed before and read after: its seconds, launches, final state
    shape and per-world results."""
    cfg = per_tick_config(Config(num_iterations=pt_steps(mode)), mode)
    filt = cfg.filter
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, final, _ = run_monte_carlo(cfg, MAIN["batch"], seed=0,
                                    impl="per_tick", device=dev,
                                    protocol="shared")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    state = final.primary.pose if filt == "naive" else final.primary.x
    return {"per_tick_run": mode, "seconds": run_s, "launches": counts(),
            "state_shape": list(state.shape),
            "err": res["err_" + filt].tolist(),
            "diverged": res["diverged_" + filt].tolist()}


def per_tick_runs(dev, n_lm: int, modes: tuple):
    """A side check: the full-size runs of ``modes``, one line each, which
    ``side_checks`` keeps in PT_RUNS for ``per_tick_path``."""
    for mode in modes:
        print(json.dumps(per_tick_run(mode, dev)), flush=True)


def per_tick_path(dev, n_lm: int, fused: dict, smi: str) -> int:
    """Every mode of PT_MODES at the main path's size (PT_EIGH at
    PT_EIGH_TICKS ticks): timed alone on a window (``per_tick_alone``), run
    whole through run_monte_carlo(impl="per_tick") (PT_EIGH here, alone, the
    others in the side processes), each run's launches only the Philox
    kernel's; the modes with a fused counterpart held against it world by
    world (``fused``: filter -> (average errors, diverged mask, refusals) of
    the main path's run); PT_EIGH's card-against-CPU check. Returns the
    Philox kernel's launches on the path."""
    base = Config(num_iterations=MAIN["steps"])
    b = MAIN["batch"]
    eigh_timing(dev, b)
    lms, cmds = mc_inputs(base, b, 0, dev, shared=True, relabel=True)
    noise = philox.philox_noise(0, MAIN["steps"], n_lm, b, dev)
    alone = per_tick_alone(dev, n_lm, lms, cmds, noise)
    PT_RUNS[PT_EIGH] = per_tick_run(PT_EIGH, dev)
    per_tick_card_vs_cpu(dev, n_lm, (PT_EIGH,))

    philox_total = 0
    for mode in PT_MODES:
        r = PT_RUNS[mode]
        filt = PT_MODES[mode][0]
        want = {k: int(k == "philox_noise") for k in r["launches"]}
        if r["launches"] != want:
            raise AssertionError(f"per-tick {mode}: launched {r['launches']}, "
                                 "not once philox_noise")
        philox_total += r["launches"]["philox_noise"]
        err = np.asarray(r["err"], np.float32)
        diverged = np.asarray(r["diverged"], bool)
        if not np.isfinite(err).all():
            raise AssertionError(f"per-tick {mode}: non-finite average errors")
        du = {"naive": 3, "ukf_loc": 4, "ukf_slam": 4 + 2 * n_lm}.get(filt, 3 + 2 * n_lm)
        if r["state_shape"] != [b, du]:
            raise AssertionError(f"per-tick {mode}: state shape {r['state_shape']}")
        line = dict(mode=mode, filter=filt, worlds=b, steps=pt_steps(mode),
                    run_monte_carlo_s=r["seconds"],
                    run_beside_other_processes=mode != PT_EIGH, **alone[mode],
                    mean_avg_pos_err_m=float(err.mean()),
                    diverged=int(diverged.sum()), launches=r["launches"], card=smi)
        if mode == PT_EIGH:
            line["cut"] = (f"{PT_EIGH_TICKS} of {MAIN['steps']} ticks: the "
                           "batched 44 x 44 eigh takes ~1 s a tick at 4096 "
                           "worlds (eigh_timing)")
        if mode in PT_AGAINST:
            if mode == "naive":
                st = sim_streams(base, lms, n_lm, cmds, noise)
                est = naive_deadreckon(base, cmds)
                ref_err = torch.linalg.vector_norm(
                    est[:, :, :2] - st["poses_true"][:, :, :2], dim=-1).mean(dim=1)
                ref = (ref_err.cpu().numpy(), np.zeros(b, dtype=bool), None)
            else:
                ref = fused[filt]
            nudged = None
            if mode in PT_CHAOS:
                # the fused kernel on the same worlds, its noise nudged
                nudged = run_monte_carlo(per_tick_config(base, mode), b, seed=0,
                                         device=dev, protocol="shared",
                                         noise=noise * NUDGE)[0]["err_" + filt]
            line["held_against_fused"] = held_against_fused(
                mode, per_tick_config(base, mode), err, diverged, ref, lms,
                cmds, noise, nudged)
        emit("per_tick_path", **line)
    return philox_total


def per_tick_card_vs_cpu(dev, n_lm: int, modes: tuple):
    """The ``modes`` of PT_MODES at PT_SMALL on the card and on the CPU,
    from the same inputs (made on the CPU) and noise: the average errors and
    alive masks against PT_CARD_TOL, the UKFs' chaotic worlds left out."""
    cpu = torch.device("cpu")
    base = Config(num_iterations=PT_SMALL["steps"])
    b, t_total = PT_SMALL["batch"], PT_SMALL["steps"]
    lms, cmds = mc_inputs(base, b, 0, cpu)
    noise = philox.philox_noise_reference(0, t_total, n_lm, b, cpu)
    atol, rtol = PT_CARD_TOL

    def run(cfg, d, nz):
        t0 = time.perf_counter()
        final, _ = rollout(cfg, init_carry(cfg, lms.to(d), n_lm), cmds.to(d),
                           nz.to(d))
        ticks = torch.clamp_min(final.ticks_primary, 1).to(torch.float32)
        return ((final.err_sum_primary / ticks).cpu().numpy(),
                final.alive_primary.cpu().numpy(), time.perf_counter() - t0)

    for mode in modes:
        cfg = per_tick_config(base, mode)
        (e_c, a_c, s_c), (e_h, a_h, s_h) = run(cfg, dev, noise), run(cfg, cpu, noise)
        scale = atol + rtol * np.abs(e_h)
        chaotic = np.zeros(b, bool)
        if cfg.filter.startswith("ukf"):
            e_n, _, _ = run(cfg, cpu, noise * NUDGE)
            chaotic = np.abs(e_n - e_h) > CHAOS_RATIO * scale
        d_err = np.abs(e_c - e_h)
        outside = ~(d_err <= scale) | (a_c != a_h)
        line = dict(mode=mode, worlds=b, steps=t_total, tolerance=PT_CARD_TOL,
                    worlds_chaotic=int(chaotic.sum()),
                    worlds_outside=int((outside & ~chaotic).sum()),
                    worlds_outside_chaotic=int((outside & chaotic).sum()),
                    max_abs_diff_m=float(d_err[~chaotic].max()),
                    max_abs_diff_all_worlds_m=float(d_err.max()),
                    mean_err_card_m=float(e_c.mean()),
                    mean_err_cpu_m=float(e_h.mean()),
                    alive_differs=int((a_c != a_h).sum()),
                    card_s=s_c, cpu_s=s_h)
        emit("per_tick_card_vs_cpu", **line)
        if line["worlds_outside"]:
            raise AssertionError(f"per-tick {mode}: card against CPU: {line}")


# ---- the per-tick pose graph (run_monte_carlo(impl="per_tick") with
# filter="pose_graph"): the study's default pose-graph config (naive
# secondary, a PCG solve every tick, the Schur bulk solve) at PG_MAIN on the
# study's inputs and Philox noise, so that its worlds are those of
# run_monte_carlo_pg_streams on the same seed; and the EKF-SLAM secondary in
# bulk mode at PG_SIDE worlds. (secondary, iterative, worlds)
PTPG_RUNS = {"naive": ("naive", True, PG_MAIN["batch"]),
             "ekf_slam": ("ekf_slam", False, PG_SIDE)}
# Per-tick against streams, per world, |per-tick - streams| <= atol + rtol
# |streams|: JAX's own scan-against-streams tolerances
# (tests/test_posegraph.py test_streams_path_matches_scan_path_naive, _ekf,
# at T = 80). The naive secondary's graph is the same graph built two ways,
# a sequential sum over the ticks and a cumsum, whose rounding grows with
# T: at T = 1000 one world of 1024 parts by 1.1e-4 m (measured on an H100),
# so the seeds carry the per-tick path's own naive tolerance against the
# closed form (PT_AGAINST["naive"], 1e-4 m + 0.1%). The EKF-SLAM streams'
# secondary is the fused kernel (its polynomial atan2, FMA), the per-tick
# one the JAX model's algebra: the secondary and the seeds to 1.5e-3 m
# (5.3e-4 m the most, measured on an H100 at 256 x 1000), the result to
# JAX's 5e-3 m. Worlds on the field-of-view edge (F9) are left out.
PTPG_AGAINST = {"naive": dict(secondary=(1e-4, 1e-3), initial=(1e-4, 1e-3),
                              result=(2e-3, 0.0)),
                "ekf_slam": dict(secondary=(1.5e-3, 0.0), initial=(1.5e-3, 0.0),
                                 result=(5e-3, 0.0))}
# In iterative mode two twins of the streams path run on the per-tick
# path's own streams (``same_streams_results``: its truth and secondary
# stepped tick by tick, its simulator's measurements): the replay in one
# window, the per-tick path's shapes, on the first PTPG_SAME_WORLDS worlds,
# which must give the per-tick result to PTPG_SAME_ATOL in every world
# (the same float operations in the same order); and the replay in its
# default windows on every world, which parts from the per-tick result by
# the windows' float order alone and from run_monte_carlo_pg_streams by the
# two simulators' alone (a sequential sum against a cumsum, 1e-5-1e-4 m on
# the truth and the seeds by T = 1000), both carried by 999 warm-started,
# truncated PCG solves. Measured on an H100 at 1024 x 1000: 57 worlds'
# results part from run_monte_carlo_pg_streams by more than 2e-3 m, 53
# worlds' windowed twin (2.2 cm the most), 12 worlds' per-tick result
# from its windowed twin (8.1 mm; 824 worlds equal bit for bit). So these
# three are held by their means over all worlds, to PTPG_MEAN_RTOL (0.16%,
# 0.20% and 0.05% apart there)
PTPG_SAME_WORLDS = 256
PTPG_SAME_ATOL = 1e-6
PTPG_MEAN_RTOL = 0.004
# The per-tick graph against assemble_streams on the per-tick path's own
# secondary poses and measurements, world by world: the landmark slots, the
# factors' slots and validity equal, the values within this (the same
# float32 operations in another order of the slot loop)
PTPG_GRAPH_ATOL = 1e-6
PTPG_WINDOW = 20        # ticks timed in the process, after 3 of warm-up
PTPG = {}               # the side processes' per-world lines, by kind and run
# chordal_init and the dense LM on the card against the CPU and against the
# Schur solve, at these worlds and ticks (the CPU on the first cpu_worlds):
# tests/test_posegraph.py test_schur_solver_matches_dense's tolerance, a
# graph error within 2% (+ 1e-3) of the reference's and the active nodes'
# positions within 2 cm
PG_SOLVERS = dict(batch=64, steps=200, cpu_worlds=8)
PG_SOLVE_RTOL, PG_SOLVE_ATOL, PG_POSE_ATOL = 0.02, 1e-3, 2e-2


PTPG_KEYS = ("err_{}", "err_pose_graph_initial", "err_pose_graph_result",
             "diverged_pose_graph")


def per_world(res: dict, secondary: str) -> dict:
    return {k.format(secondary): res[k.format(secondary)].tolist() for k in PTPG_KEYS}


def per_tick_measurements(cfg, lms, true_poses, noise):
    """(r, b, vis), each (B, T, N): the measurements the per-tick simulator
    takes on its true poses (B, T, 3) and draws, every tick at once."""
    b, t_total, n = true_poses.shape[0], true_poses.shape[1], lms.shape[1]
    world = init_world(cfg, lms.repeat_interleave(t_total, dim=0))
    u = noise.permute(2, 0, 1)[..., 2:2 + 2 * n].reshape(b * t_total, 2, n)
    meas = sense(cfg, world, true_poses.reshape(b * t_total, 3), u)
    return tuple(a.reshape(b, t_total, n) for a in (meas.r, meas.b, meas.valid))


def graph_against_streams(cfg, s, outs, lms, cmds, noise) -> dict:
    """The per-tick path's graphs ``s`` against ``assemble_streams`` on the
    same run's streams: its secondary poses and the measurements its
    simulator took (``sim.world.sense`` on its true poses and the same
    draws, every tick at once), field by field (PTPG_GRAPH_ATOL)."""
    true_poses, est = outs
    b = true_poses.shape[0]
    g = pg.assemble_streams(cfg, est, *per_tick_measurements(cfg, lms, true_poses, noise),
                            cmds)
    out = {}
    for f in ("ids", "M", "timestep", "odom_valid", "meas_valid", "meas_lm"):
        a, b_ = getattr(s, f), getattr(g, f)
        out[f] = {"worlds_differ": int((a != b_).reshape(b, -1).any(dim=1).sum())}
    for f in ("poses_init", "lms_init", "odom", "meas_rb"):
        d = (getattr(s, f) - getattr(g, f)).abs().reshape(b, -1).amax(dim=1)
        out[f] = {"max_abs_diff": float(d.max()),
                  "worlds_outside": int((d > PTPG_GRAPH_ATOL).sum())}
    if any(v.get("worlds_differ", 0) or v.get("worlds_outside", 0) for v in out.values()):
        raise AssertionError(f"per-tick graph against assemble_streams: {out}")
    return out


def per_tick_pose_graph(name: str, dev):
    """One study of PTPG_RUNS on the per-tick path: a window of ticks timed
    in this process and one tick under the profiler; then the counted run
    through run_monte_carlo(impl="per_tick", collect="poses"): its phases'
    seconds, the launches it implies and no other; its graphs against
    assemble_streams (``graph_against_streams``); its per-world results and
    F9 edge worlds, one line for ``per_tick_pose_graph_check``."""
    secondary, iterative, batch = PTPG_RUNS[name]
    cfg = pg_config(PG_MAIN["steps"], secondary, iterative)
    t_total, n_lm = PG_MAIN["steps"], cfg.map.num_landmarks
    lms, cmds = mc_inputs(cfg, batch, 0, dev)
    noise = philox.philox_noise(0, t_total, n_lm, batch, dev)
    step = make_step(cfg, "poses")
    carry, _ = rollout(cfg, init_carry(cfg, lms, n_lm), cmds[:, :3], noise[:3],
                       "poses", step=step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = 3 + PTPG_WINDOW
    carry, _ = rollout(cfg, carry, cmds[:, 3:w], noise[3:w], "poses", step=step, t0=3)
    torch.cuda.synchronize()
    window_ms = 1e3 * (time.perf_counter() - t0) / PTPG_WINDOW
    one = tick_launches(cfg, carry, cmds[:, w], noise[w].T, w)

    zero_counts()
    sec = {}
    t0 = time.perf_counter()
    res, final, outs = run_monte_carlo(cfg, batch, seed=0, impl="per_tick",
                                       device=dev, collect="poses", seconds=sec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = dict.fromkeys(launches, 0)
    want.update(philox_noise=1, **pg_bulk_launches(cfg))
    if launches != want:
        raise AssertionError(f"per-tick pose graph {name}: launched {launches}, "
                             f"expected {want}")
    for key, v in res.items():
        if not key.startswith("diverged") and not np.isfinite(v).all():
            raise AssertionError(f"per-tick pose graph {name}: non-finite {key}")
    edge = fov_edge_worlds(cfg, lms, cmds, noise)
    graph = graph_against_streams(cfg, final.primary, outs, lms, cmds, noise)
    print(json.dumps({"per_tick_pose_graph_run": name, "wall_s": wall, "seconds": sec,
                      "window_ms_per_tick": window_ms, "one_tick": one,
                      "launches": {k_: v for k_, v in launches.items() if v},
                      "graph_against_streams": graph, "fov_edge": edge.tolist(),
                      **per_world(res, secondary)}), flush=True)


def pg_streams_of(name: str, dev):
    """The streams path on the config and seed of ``per_tick_pose_graph``'s
    run ``name``, and in iterative mode ``same_streams_results``: their
    per-world results, one line."""
    secondary, iterative, batch = PTPG_RUNS[name]
    cfg = pg_config(PG_MAIN["steps"], secondary, iterative)
    t0 = time.perf_counter()
    res, info, _ = run_monte_carlo_pg_streams(cfg, batch, seed=0,
                                              world_chunk=batch, device=dev)
    torch.cuda.synchronize()
    out = {"per_tick_pose_graph_streams": name, "wall_s": time.perf_counter() - t0,
           "seconds": info["seconds"], **per_world(res, secondary)}
    if iterative:
        lms, cmds = mc_inputs(cfg, batch, 0, dev)
        noise = philox.philox_noise(0, PG_MAIN["steps"], cfg.map.num_landmarks, batch, dev)
        out.update(same_streams_results(cfg, lms, cmds, noise))
    print(json.dumps(out), flush=True)


def same_streams_results(cfg, lms, cmds, noise) -> dict:
    """err_pose_graph_result of the streams path's replay and bulk solve on
    the graphs of the per-tick path's own streams: the truth and the naive
    secondary stepped tick by tick by ``rollout``, the measurements its
    simulator takes (``sim.world.sense``), assembled by
    ``assemble_streams``. ``windowed``: the replay in its default windows,
    every world; ``one_window``: in one window, the first PTPG_SAME_WORLDS
    worlds. Each with its seconds."""
    t_total = cmds.shape[1]
    naive_cfg = cfg.replace(filter="naive")
    _, (true_poses, est) = rollout(naive_cfg, init_carry(naive_cfg, lms, lms.shape[1]),
                                   cmds, noise, "poses")
    r, b, vis = per_tick_measurements(cfg, lms, true_poses, noise)
    graphs = pg.assemble_streams(cfg, est, r, b, vis, cmds)
    tidx = torch.arange(t_total, device=lms.device)
    vis_live = vis & (tidx < t_total - 1)[None, :, None]
    first_t = torch.where(vis_live, tidx[None, :, None], t_total).amin(dim=1)
    m_at = (first_t[:, None, :] <= tidx[None, :, None]).sum(dim=2, dtype=torch.int32)
    w = PTPG_SAME_WORLDS
    out = {}
    for kind, g, m, tr, window in (
            ("windowed", graphs, m_at, true_poses, None),
            ("one_window", graphs.map(lambda a: a[:w]), m_at[:w], true_poses[:w], t_total)):
        t0 = time.perf_counter()
        g = replay_chunk(cfg, g, m, window)
        out["same_streams_" + kind] = _pg_bulk_solve(cfg, g, tr, tr.shape[0])[0].tolist()
        out[f"same_streams_{kind}_s"] = time.perf_counter() - t0
    return out


def per_tick_pose_graph_check(name: str, smi: str, dev):
    """The per-tick run ``name`` against its streams twin, world by world
    (PTPG_AGAINST) but for the F9 edge worlds; in iterative mode the solved
    graph by its mean (PTPG_MEAN_RTOL) against the streams path, and world
    by world against ``same_streams_results``' one-window twin
    (PTPG_SAME_ATOL); its windowed twin beside both, reported. One
    ``per_tick_pose_graph`` line. Raises when out of tolerance."""
    secondary, iterative, batch = PTPG_RUNS[name]
    run, st = PTPG["run"][name], PTPG["streams"][name]
    edge = np.asarray(run["fov_edge"], bool)
    res = "err_pose_graph_result"
    # (part, per-tick or twin, reference, tolerance, worlds held)
    parts = [(part, run[key], st[key], PTPG_AGAINST[name][part], ~edge)
             for part, key in (("secondary", "err_" + secondary),
                               ("initial", "err_pose_graph_initial"), ("result", res))]
    if iterative:
        w = PTPG_SAME_WORLDS
        win = st["same_streams_windowed"]
        parts += [("result_one_window", run[res][:w], st["same_streams_one_window"],
                   (PTPG_SAME_ATOL, 0.0), np.ones(w, bool)),
                  ("result_windowed", run[res], win, PTPG_AGAINST[name]["result"], ~edge),
                  ("windowed_vs_streams", win, st[res], PTPG_AGAINST[name]["result"], ~edge)]
    against = {}
    for part, a, ref, (atol, rtol), held in parts:
        a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
        d = np.abs(a - ref)
        outside = ~(d <= atol + rtol * np.abs(ref))
        against[part] = {"tolerance": [atol, rtol], "worlds_held": int(held.sum()),
                         "max_abs_diff_m": float(d[held].max()),
                         "median_abs_diff_m": float(np.median(d[held])),
                         "max_abs_diff_all_worlds_m": float(d.max()),
                         "worlds_outside": int((outside & held).sum()),
                         "worlds_outside_all": int(outside.sum()),
                         "mean_m": float(a.mean()), "mean_ref_m": float(ref.mean()),
                         "mean_gap_rel": float(abs(a.mean() - ref.mean()) / ref.mean())}
    # the parts held by their mean only (PTPG_MEAN_RTOL), reported world by world
    held_by_mean = {"result", "result_windowed", "windowed_vs_streams"} if iterative else set()
    sec = run["seconds"]
    line = dict(run=name, secondary=secondary, iterative=iterative, batch=batch,
                steps=PG_MAIN["steps"], noise="high", wall_s=run["wall_s"], seconds=sec,
                ms_per_tick=1e3 * sec["rollout"] / PG_MAIN["steps"],
                window_ms_per_tick=run["window_ms_per_tick"], one_tick=run["one_tick"],
                streams_wall_s=st["wall_s"], streams_seconds=st["seconds"],
                per_tick_over_streams_wall=run["wall_s"] / st["wall_s"],
                mean_err_pose_graph_result=against["result"]["mean_m"],
                mean_err_pose_graph_initial=against["initial"]["mean_m"],
                mean_err_secondary=against["secondary"]["mean_m"],
                diverged=int(np.sum(run["diverged_pose_graph"])),
                diverged_streams=int(np.sum(st["diverged_pose_graph"])),
                fov_edge_worlds=int(edge.sum()),
                held_by_mean_only=sorted(held_by_mean),
                graph_against_streams=run["graph_against_streams"],
                against_streams=against, launches=run["launches"], card=smi,
                run_beside_other_processes=True)
    if iterative:
        line["same_streams_s"] = {k: st[f"same_streams_{k}_s"]
                                  for k in ("windowed", "one_window")}
    emit("per_tick_pose_graph", **line)
    if line["diverged"] or line["diverged_streams"]:
        raise AssertionError(f"per-tick pose graph {name}: diverged worlds: {line}")
    if any(a["worlds_outside"] for k, a in against.items() if k not in held_by_mean):
        raise AssertionError(f"per-tick pose graph {name}: against streams: {against}")
    if any(against[k]["mean_gap_rel"] > PTPG_MEAN_RTOL for k in held_by_mean):
        raise AssertionError(f"per-tick pose graph {name}: mean result: {against}")
    if not line["mean_err_pose_graph_result"] < line["mean_err_pose_graph_initial"]:
        raise AssertionError(f"per-tick pose graph {name}: the solve did not "
                             f"improve on the seeds: {line}")


def pose_graph_solvers(dev):
    """posegraph.solve with init="chordal" and with solver="dense" on the
    card against the same solve on the CPU (its first cpu_worlds worlds:
    worlds are independent) and against the Schur solve (init="secondary")
    on the card, at PG_SOLVERS on the EKF-SLAM study's graphs: graph errors
    within PG_SOLVE_RTOL (+ PG_SOLVE_ATOL) of the reference's and the active
    nodes' positions within PG_POSE_ATOL."""
    torch.set_num_threads(2)
    base = pg_config(PG_SOLVERS["steps"], "ekf_slam", False)
    graphs = pg_graphs(base, PG_SOLVERS["batch"], dev)[0]
    w = PG_SOLVERS["cpu_worlds"]
    on_cpu = graphs.map(lambda a: a[:w].cpu())
    pgc = base.pose_graph
    cfgs = {"schur": base,
            "chordal": base.replace(pose_graph=dataclasses.replace(pgc, init="chordal")),
            "dense": base.replace(pose_graph=dataclasses.replace(pgc, solver="dense"))}
    out = {}

    def timed(cfg, g, cuda):
        t0 = time.perf_counter()
        r = pg.solve(cfg, g)
        if cuda:
            torch.cuda.synchronize()
        return [a.cpu() for a in r], time.perf_counter() - t0

    def held(a, ref, what):
        (pa, _, ea), (pr, _, er) = a, ref
        t_act = PG_SOLVERS["steps"]
        d_err = float(((ea - er) / (er.abs() * PG_SOLVE_RTOL + PG_SOLVE_ATOL)).max())
        d_pose = float((pa[:, :t_act, :2] - pr[:, :t_act, :2]).abs().max())
        if not (d_err <= 1.0 and d_pose <= PG_POSE_ATOL):
            raise AssertionError(f"pose-graph solvers: {what}: err ratio {d_err}, "
                                 f"pose {d_pose}")
        return {"err_excess_ratio": d_err, "max_pose_diff_m": d_pose}

    card = {}
    for name, cfg in cfgs.items():
        card[name], card_s = timed(cfg, graphs, True)
        out[name] = {"card_s": card_s, "mean_err": float(card[name][2].mean()),
                     "finite": bool(torch.isfinite(card[name][0]).all())}
        if name != "schur":
            cpu, cpu_s = timed(cfg, on_cpu, False)
            first = [a[:w] for a in card[name]]
            out[name].update(cpu_s=cpu_s, card_vs_cpu=held(first, cpu, f"{name} card vs cpu"),
                             cpu_vs_card=held(cpu, first, f"{name} cpu vs card"))
    out["schur"]["vs_dense"] = held(card["schur"], card["dense"], "schur vs dense")
    out["chordal"]["vs_dense"] = held(card["chordal"], card["dense"], "chordal vs dense")
    emit("pose_graph_solvers", **PG_SOLVERS, tolerance=[PG_SOLVE_RTOL, PG_SOLVE_ATOL,
                                                        PG_POSE_ATOL], **out)


# ---- the closed loop (eval/closed_loop): the JAX bench's configuration at
# CL_MAIN through run_closed_loop, its launches counted; JAX's scale test
# (tests/test_closed_loop.py:41-89) at CL_SCALE on the card against the
# port's CPU run on the same Philox noise; one batched replan against its
# CPU run; and the igvc1 grid read without Pillow
CL_MAIN = dict(batch=1024, steps=1000)
CL_SCALE = dict(batch=64, steps=200, seed=3)
CL_REPLAN_WORLDS = 64
# card against CPU (F15): a world is held until the first replan whose plan
# differs between the two runs, or the first tick whose pursuit head or
# length differ (a waypoint pared on one side of the 0.15 m edge only);
# before that its true and estimated poses must agree to CL_PART_ATOL (m,
# rad), float order alone: ten times the largest gap measured at CL_SCALE
# on an H100 (6.1e-6, true and estimated poses alike). A world that parts
# with no such event fails.
CL_PART_ATOL = 6e-5
# the scale test's bounds (tests/test_closed_loop.py:80-89), on the card
CL_BOUNDS = dict(median_err=0.2, max_err=0.6, median_progress=1.0, min_progress=0.3)


def cl_traced(cfg, batch: int, dev, noise):
    """A closed-loop run through its block step on ``dev`` that records,
    per tick, the true and estimated poses and the pursuit head and length
    after the tick, and per replan the pursuit path, head and length after
    it. Returns (final carry, the record on the CPU)."""
    block = cl.BlockStep(cfg, cl.occupancy(cfg, dev))
    carry = cl.init_closed_loop(cfg, batch, dev)
    noise = noise.to(dev)
    period = cfg.path_planning.replan_period
    rec = {k: [] for k in ("true", "est", "head", "length", "plan")}
    for i in range(noise.shape[0] // period):
        if i:
            carry = block.replan(carry)
            p = carry.pursuit
            rec["plan"].append(torch.cat([p.path.flatten(1), p.head[:, None].float(),
                                          p.length[:, None].float()], 1))
        for k in range(period):
            carry, (tp, est) = block.tick(carry, noise[i * period + k].T)
            rec["true"].append(tp)
            rec["est"].append(est)
            rec["head"].append(carry.pursuit.head)
            rec["length"].append(carry.pursuit.length)
    return carry, {k: torch.stack(v, 1).cpu() for k, v in rec.items()}


def cl_first_events(a: dict, b: dict, period: int) -> np.ndarray:
    """Each world's first tick from which two runs' poses may part: the
    tick after the first pursuit head or length that differs, or the first
    tick of the block whose replan differs; the run's length if none."""
    t_total = a["true"].shape[1]
    first = np.full(a["true"].shape[0], t_total)
    pare = ((a["head"] != b["head"]) | (a["length"] != b["length"])).numpy()
    plan = (a["plan"] != b["plan"]).any(dim=2).numpy()
    for w in range(first.size):
        hits = [t + 1 for t in np.flatnonzero(pare[w])[:1]]
        hits += [period * (i + 1) for i in np.flatnonzero(plan[w])[:1]]
        first[w] = min(hits + [t_total])
    return first


def cl_card_vs_cpu(dev, batch: int, steps: int, seed: int) -> dict:
    """JAX's scale-test configuration on the card and on the CPU (the
    port's plain run) from the same Philox noise, held world by world under
    the F15 rule; the card run's errors and progress against CL_BOUNDS'
    quantities (reported; ``cl_scale_card_vs_cpu`` holds them)."""
    cfg = closed_loop_config(steps, meas_slots=12, sweeps=(96, 48))
    period = cfg.path_planning.replan_period
    n_lm = len(cl.landmarks(cfg)[0])
    # each side draws as run_closed_loop does: the kernel on the card, its
    # plain version on the CPU (2N+8 = 82 rows, a partial last 4-row block)
    noise_c = philox.philox_noise(seed, steps, n_lm, batch, dev)
    noise_h = philox.philox_noise_reference(seed, steps, n_lm, batch)
    if not torch.equal(noise_c.cpu(), noise_h):
        raise AssertionError(f"closed loop: the Philox kernel differs from its plain "
                             f"version at ({steps}, {2 * n_lm + 8}, {batch})")
    t0 = time.perf_counter()
    fin_c, card = cl_traced(cfg, batch, dev, noise_c)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fin_h, cpu = cl_traced(cfg, batch, torch.device("cpu"), noise_h)
    cpu_s = time.perf_counter() - t0
    first = cl_first_events(card, cpu, period)
    parted, failed = {}, []
    gaps = {"true": 0.0, "est": 0.0}  # the largest gap before each world's event
    for w in range(batch):
        t1 = int(first[w])
        for k in gaps:
            gap = float((card[k][w, :t1] - cpu[k][w, :t1]).abs().max()) if t1 else 0.0
            gaps[k] = max(gaps[k], gap)
            if gap > CL_PART_ATOL and w not in failed:
                failed.append(w)
        if t1 < steps:
            parted[w] = t1
    err = fin_c.err_sum.cpu().numpy() / steps
    dist = np.linalg.norm(fin_c.world.pose[:, :2].cpu().numpy()
                          - np.asarray(cfg.init_pose[:2]), axis=1)
    line = dict(batch=batch, steps=steps, seed=seed, tolerance_m=CL_PART_ATOL,
                max_gap_before_event=gaps, noise_kernel_equals_plain=True,
                worlds_with_an_event=len(parted), event_ticks=parted,
                worlds_failed=failed, card_s=card_s, cpu_s=cpu_s,
                card=dict(median_err=float(np.median(err)), max_err=float(err.max()),
                          median_progress=float(np.median(dist)),
                          min_progress=float(dist.min())),
                mean_err_card_m=float(err.mean()),
                mean_err_cpu_m=float(fin_h.err_sum.mean()) / steps,
                nan_worlds=int((~np.isfinite(err)).sum()))
    emit("closed_loop_card_vs_cpu", **line)
    if failed or line["nan_worlds"]:
        raise AssertionError(f"closed loop: card against CPU: {line}")
    return line


def cl_scale_card_vs_cpu(dev) -> dict:
    """``cl_card_vs_cpu`` at JAX's scale test's size, its bounds on the card."""
    line = cl_card_vs_cpu(dev, **CL_SCALE)
    got = line["card"]
    if not (got["median_err"] < CL_BOUNDS["median_err"]
            and got["max_err"] < CL_BOUNDS["max_err"]
            and got["median_progress"] > CL_BOUNDS["median_progress"]
            and got["min_progress"] > CL_BOUNDS["min_progress"]):
        raise AssertionError(f"closed loop: the scale test's bounds {CL_BOUNDS}: {line}")
    return line


def cl_replan_card_vs_cpu(dev) -> dict:
    """One batched replan of CL_REPLAN_WORLDS seeded poses on the igvc1 grid
    (the bench configuration) on the card and on the CPU: the goals, flags
    and paths must be equal."""
    cfg = closed_loop_config(CL_MAIN["steps"])
    rng = np.random.default_rng(5)
    b = CL_REPLAN_WORLDS
    poses = torch.from_numpy(np.concatenate(
        [rng.uniform(-9.0, 9.0, (b, 2)), rng.uniform(-np.pi, np.pi, (b, 1))],
        1).astype(np.float32))
    out = []
    for d in (dev, torch.device("cpu")):
        occ = cl.occupancy(cfg, d)
        goal, ok = p_astar.local_planner(cfg, occ, poses.to(d))
        path, valid, reached = p_astar.astar(cfg, occ, poses[:, :2].to(d), goal)
        out.append([x.cpu() for x in (goal, ok, path, valid, reached)])
    equal = all(torch.equal(x, y) for x, y in zip(*out))
    line = dict(worlds=b, equal=equal, ok=int(out[1][1].sum()),
                reached=int(out[1][4].sum()))
    emit("closed_loop_replan_card_vs_cpu", **line)
    if not equal or not line["reached"]:
        raise AssertionError(f"closed loop: the replan, card against CPU: {line}")
    return line


def closed_loop_checks(dev):
    """The closed-loop phase (a side check): the map, the full run, the
    replan's times and its card-against-CPU check, the scale test."""
    import importlib.util
    import zlib

    # the igvc1 grid read without Pillow
    cfg = closed_loop_config(CL_MAIN["steps"])
    occ, color = cl.sim_maps.load_occ_map(cfg)
    emit("closed_loop_map", image=cfg.occ_map_img, shape=list(occ.shape),
         free_cells=int(occ.sum()), crc32=zlib.crc32(occ.tobytes()),
         color_crc32=zlib.crc32(color.tobytes()),
         pillow_installed=importlib.util.find_spec("PIL") is not None)

    # the full run, through the entry point, its launches counted
    b, t_total = CL_MAIN["batch"], CL_MAIN["steps"]
    period = cfg.path_planning.replan_period
    cl.run_closed_loop(cfg.replace(num_iterations=2 * period), b, 0, device=dev)
    zero_counts()
    sec = {}
    t0 = time.perf_counter()
    m, fin, _ = cl.run_closed_loop(cfg, b, 0, device=dev, seconds=sec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    want = {k: int(k == "philox_noise") for k in launches}
    if launches != want:
        raise AssertionError(f"closed loop: the main path launched {launches}, "
                             "not once philox_noise")
    err = m["err_" + cfg.filter]
    dist = np.linalg.norm(m["final_true_pose"][:, :2] - np.asarray(cfg.init_pose[:2]),
                          axis=1)
    n_lm = fin.world.landmarks.shape[1]
    # the run's Philox draw, (1000, 82, 1024): 82 rows end in a partial
    # 4-row block, which the main Monte-Carlo shape (48 rows) never has
    shape = (0, t_total, n_lm, b, dev)
    nz, nz_ref = philox.philox_noise(*shape), philox.philox_noise_reference(*shape)
    emit("closed_loop_philox", shape=[t_total, 2 * n_lm + 8, b],
         bitwise_equal=bool(torch.equal(nz, nz_ref)),
         max_abs_err=float((nz - nz_ref).abs().max()))
    if not torch.equal(nz, nz_ref):
        raise AssertionError("closed loop: the Philox kernel differs from its plain "
                             "version at the run's shape")
    del nz, nz_ref
    noise = philox.philox_noise(1, period, n_lm, b, dev)
    block = cl.BlockStep(cfg, cl.occupancy(cfg, dev))
    one_block = profiled(lambda: block(fin, noise))
    plan_ms = plan_once_ms(cfg, b, dev)
    line = dict(**CL_MAIN, n_lm=n_lm, meas_slots=cfg.num_meas_slots, wall_s=wall,
                steps_per_s_per_world=t_total / wall,
                block_ms=1e3 * (float(np.median(sec["replan"][1:]))
                                + float(np.median(sec["ticks"]))),
                replan_ms_median=1e3 * float(np.median(sec["replan"][1:])),
                ticks_ms_median=1e3 * float(np.median(sec["ticks"])),
                tick_ms=1e3 * float(np.median(sec["ticks"])) / period,
                plan_once_ms=plan_ms, one_block=one_block,
                mean_err_m=float(np.nanmean(err)), median_err_m=float(np.nanmedian(err)),
                max_err_m=float(np.nanmax(err)), nan_worlds=int(np.isnan(err).sum()),
                progress_median_m=float(np.median(dist)), progress_min_m=float(dist.min()),
                launches=launches)
    emit("closed_loop_path", **line)
    if not np.isfinite(err).all():
        raise AssertionError(f"closed loop: non-finite errors: {line}")
    cl_replan_card_vs_cpu(dev)
    torch.set_num_threads(2)  # beside the other side processes
    cl_scale_card_vs_cpu(dev)


# ---- the host side (cli's single-world presets, clicked-goal pursuit, the
# recorder, checkpoints, the AprilTag replay): a side check of its own, one
# world through the entry points a user calls. filter -> ticks of its
# filter_demo_results_only run: 300 for EKF-SLAM and the pose graph (naive
# secondary), whose preset runs HS_PRESET_T (a tick is one world's
# host-bound step, 0.05-0.25 s beside the other side processes, so the
# preset's length set the side checks' pace), 200 for the others. Philox at
# one world and P1 and P2 on a one-world graph keep the preset's T.
HS_PRESET_T = 1000
HS_RESULTS = {"ekf_slam": 300, "pose_graph": 300, "naive": 200,
              "iekf_slam": 200, "ukf_slam": 200, "ukf_loc": 200}
HS_LIVE = ("ekf_slam", "ukf_slam", "pose_graph")  # filter_demo_live, async_viz
HS_LIVE_T = 100
HS_SHORT_T = 200  # sim_base, goal pursuit, card against CPU, the recorder's study
# the pose-graph demo card against CPU: on the CPU its final solve's plain
# P1 and P2 loops take ~30 s at any T (2 threads), each tick ~0.2 s more
HS_PG_T = 50
HS_OUT = Path(__file__).resolve().parent / "chiprun_out" / "host_side"
# The EKF-SLAM demo card against CPU. Its precomputed-trajectory run: every
# tick's true and estimated poses agree to HS_PART_ATOL (m, rad), the closed
# loop's CL_PART_ATOL (measured on an H100: 6.7e-6). Its clicked-goal run
# (F15): the discrete decisions are the pursuit queue (the replans and the
# pared waypoints) and pure pursuit's lookahead point (which segment, which
# radius), which shows as a jump in the command; the first tick whose queue
# differs between the two runs, or whose commands differ by more than
# HS_CMD_JUMP (m, rad a tick), is the world's event. Before it the poses
# agree to HS_PURSUIT_ATOL, ten times the largest gap measured on an H100
# (1.0e-3): the pursuit's PID (its derivative term 0.4 / dt = 8 on the
# bearing) carries float-order differences of ~1e-6 to ~1e-3 in ~30 ticks,
# as the CPU run against itself with its noise scaled by HS_NUDGE shows
# (6.2e-4 before the same events), which the line reports.
HS_PART_ATOL = CL_PART_ATOL
# the kernels of the pose-graph demo's final solve (``posegraph.finalize``)
HS_SOLVE = ("block_thomas_factor", "block_thomas_solve", "schur_mv")
HS_PURSUIT_ATOL = 1e-2
HS_CMD_JUMP = 1e-3
HS_NUDGE = 1.0 + 2.0 ** -20


def hs_viewer():
    """The viewer class of the host-side runs: the live viewer under Agg
    where matplotlib imports, else the frame recorder; and its name."""
    from live_ekf_slam_tpu_torch.viz.live import LiveViewer

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot  # noqa: F401  (it imports Pillow)
    except ImportError:
        return FrameRecorder, "frames"
    return LiveViewer, "agg"


def hs_config(preset_name: str, filt: str, steps: int, **kw) -> Config:
    """A preset at ``steps`` ticks whose viewer saves its final map and
    appends its average error under HS_OUT (``--base-dir``)."""
    cfg = preset(preset_name, Config(num_iterations=steps)).replace(
        filter=filt, num_iterations=steps, **kw)
    return cfg.replace(
        plotter=dataclasses.replace(cfg.plotter, save_final_map=True),
        pose_graph=dataclasses.replace(cfg.pose_graph, save_average_error_at_end=True))


def hs_demo(cfg, dev, live: bool, viewer, tag: str) -> dict:
    """``cli.run_demo`` once on ``dev``, its launches counted: the line of
    that run (ms a tick, wall seconds, the printed average, the frames the
    async feed dropped, as the printed line gives them). Each run launches
    Philox once; the pose graph's final solve P1 and P2; nothing else."""
    from live_ekf_slam_tpu_torch import cli

    zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        avg = cli.run_demo(cfg, seed=0, live=live, base_dir=str(HS_OUT / tag),
                           device=dev, viewer=viewer)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counts().items() if v}
    printed = out.getvalue().strip().splitlines()[-1]
    dropped = re.search(r"async viz: (\d+) frames skipped", printed)
    line = dict(filter=cfg.filter, steps=cfg.num_iterations, live=live,
                async_viz=bool(live and cfg.plotter.async_viz), device=str(dev),
                wall_s=wall, ms_per_tick=1e3 * wall / cfg.num_iterations,
                avg_err_m=avg, printed=printed,
                frames_dropped=int(dropped.group(1)) if dropped else None,
                launches=launches)
    if dev.type == "cuda":
        want = {"philox_noise"} | (set(HS_SOLVE) if cfg.filter == "pose_graph" else set())
        if set(launches) != want or launches["philox_noise"] != 1:
            raise AssertionError(f"host side: the {cfg.filter} demo launched "
                                 f"{launches}, not once philox_noise"
                                 + (" and the final solve's P1, P2"
                                    if cfg.filter == "pose_graph" else ""))
    if not np.isfinite(avg):
        raise AssertionError(f"host side: the {cfg.filter} demo's average is {avg}")
    return line


class PursuitRecorder(FrameRecorder):
    """The frame recorder that also keeps, each tick, the clicked-goal
    pursuit's command and its queue after the tick: the pursuit whose
    ``set_goal`` ``cli.run_demo`` hands its viewer as ``on_goal``."""

    def __post_init__(self):
        super().__post_init__()
        self.cmds, self.queues = [], []

    def update(self, frame):
        super().update(frame)
        gp = self.on_goal.__self__
        self.cmds.append(gp.cmd)
        self.queues.append([tuple(p) for p in gp.pp.goal_queue])


def hs_run(cfg, dev, noise, viewer=FrameRecorder):
    """``cli.run_demo`` with live frames on ``dev`` from the given noise:
    (its recorder, the average, seconds)."""
    from live_ekf_slam_tpu_torch import cli

    views = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        avg = cli.run_demo(cfg, live=True, device=dev, viewer=viewer.into(views),
                           noise=noise)
    return views[0], avg, time.perf_counter() - t0


def hs_pursuit(cfg, dev, noise) -> dict:
    """The clicked-goal demo on ``dev``: per tick the true and estimated
    poses, the command and the pursuit queue after the tick, and the run's
    seconds."""
    v, _, sec = hs_run(cfg, dev, noise, PursuitRecorder)
    return {"true": np.asarray([f.true_pose for f in v.frames]),
            "est": np.asarray([f.est_pose for f in v.frames]),
            "cmd": np.asarray(v.cmds), "queue": v.queues, "s": sec}


def hs_card_vs_cpu(dev) -> dict:
    """The demos on the card and on the CPU from the same Philox noise,
    through ``cli.run_demo``: EKF-SLAM and the pose graph (HS_PG_T ticks) on
    the preset's precomputed trajectory (live frames: every tick's poses, the average;
    the pose graph's final frame, whose solve runs P1 and P2 at one world,
    to the per-tick pose graph's tolerances) and EKF-SLAM's clicked-goal
    pursuit on building1 (the local planner, a native A* replan every 5
    ticks), held under F15: each tick before the run's first event to
    HS_PURSUIT_ATOL; the CPU run against its nudged twin, for the pursuit's
    own amplification."""
    cpu = torch.device("cpu")
    cfg = hs_config("filter_demo_live", "ekf_slam", HS_SHORT_T)
    n_lm = cfg.map.num_landmarks
    noise_c = philox.philox_noise(1, HS_SHORT_T, n_lm, 1, dev)
    noise_h = philox.philox_noise_reference(1, HS_SHORT_T, n_lm, 1)
    if not torch.equal(noise_c.cpu(), noise_h):
        raise AssertionError("host side: the Philox kernel differs from its plain "
                             f"version at ({HS_SHORT_T}, {2 * n_lm + 8}, 1)")
    atol, rtol = PT_CARD_TOL
    tsp, bad = {}, []
    for filt, steps in (("ekf_slam", HS_SHORT_T), ("pose_graph", HS_PG_T)):
        (vc, avg_c, card_s), (vh, avg_h, cpu_s) = (
            hs_run(cfg.replace(filter=filt, num_iterations=steps), d, noise_h)
            for d in (dev, cpu))
        pairs = list(zip(vc.frames, vh.frames))
        d_avg = abs(avg_c - avg_h)
        one = dict(steps=steps, avg_err_card_m=avg_c, avg_err_cpu_m=avg_h,
                   avg_err_abs_diff_m=d_avg, tolerance=PT_CARD_TOL,
                   max_est_gap=max(float(np.abs(a.est_pose - b.est_pose).max())
                                   for a, b in pairs),
                   max_true_gap=max(float(np.abs(a.true_pose - b.true_pose).max())
                                    for a, b in pairs),
                   card_s=card_s, cpu_s=cpu_s)
        if (d_avg > atol + rtol * abs(avg_h)
                or max(one["max_est_gap"], one["max_true_gap"]) > HS_PART_ATOL):
            bad.append(filt)
        if filt == "pose_graph":
            fc, fh = vc.frames[-1], vh.frames[-1]
            tol = PTPG_AGAINST[cfg.pose_graph.filter_to_compare]
            final = {}
            for key, (a_tol, r_tol) in (("pg_initial", tol["initial"]),
                                        ("pg_result", tol["result"]),
                                        ("pg_landmarks", tol["result"])):
                a, b = np.asarray(getattr(fc, key)), np.asarray(getattr(fh, key))
                final[key] = dict(shape=list(a.shape), tolerance=[a_tol, r_tol],
                                  max_abs_diff=float(np.abs(a - b).max()))
                if a.shape != b.shape or not np.all(np.abs(a - b) <= a_tol + r_tol * np.abs(b)):
                    bad.append(f"{filt} {key}")
            one["final_frame"] = final
        tsp[filt] = one

    pcfg = cfg.replace(occ_map_img="building1.png", precompute_trajectory=False,
                       use_local_planner=True)
    card = hs_pursuit(pcfg, dev, noise_h)
    host = hs_pursuit(pcfg, cpu, noise_h)
    nudged = hs_pursuit(pcfg, cpu, noise_h * HS_NUDGE)

    def parting(a, b):
        """(first event tick, first queue difference, first command jump,
        the largest pose gaps up to the event)."""
        differs = [t for t in range(HS_SHORT_T) if a["queue"][t] != b["queue"][t]]
        jumps = np.flatnonzero(np.abs(a["cmd"] - b["cmd"]).max(axis=1) > HS_CMD_JUMP)
        first = min(differs[:1] + [int(t) for t in jumps[:1]] + [HS_SHORT_T])
        gaps = {k: float(np.abs(a[k][: first + 1] - b[k][: first + 1]).max())
                for k in ("true", "est")}
        return dict(first_event_tick=first,
                    first_queue_difference=differs[0] if differs else None,
                    first_command_jump=int(jumps[0]) if len(jumps) else None,
                    max_gap_before_event=gaps)

    progress = float(np.linalg.norm(card["true"][-1, :2] - np.asarray(pcfg.init_pose[:2])))
    pursuit = dict(steps=HS_SHORT_T, image=pcfg.occ_map_img, **parting(card, host),
                   cpu_against_nudged_cpu=dict(nudge=HS_NUDGE, **parting(host, nudged)),
                   command_jump=HS_CMD_JUMP, tolerance_m=HS_PURSUIT_ATOL,
                   progress_card_m=progress, card_s=card["s"], cpu_s=host["s"])
    if max(pursuit["max_gap_before_event"].values()) > HS_PURSUIT_ATOL:
        bad.append("clicked_goal")
    line = dict(precomputed=tsp, clicked_goal=pursuit, noise_kernel_equals_plain=True)
    emit("host_side_card_vs_cpu", **line)
    if bad:
        raise AssertionError(f"host side: the demos, card against CPU ({bad}): {line}")
    return line


def hs_solve_single_world(dev) -> dict:
    """P1 and P2 at one world, a new edge of their layouts (half a warp a
    world for P1's factor, 256 threads a world for P2), at the pose-graph
    preset's T (HS_PRESET_T): on a one-world graph's systems, at the first
    and the last measurement scale and on chordal_init's, with both slot
    maps for P2, against their plain versions as the side checks hold them
    at P1_WORLDS worlds (``block_thomas_compare``, ``schur_mv_compare``).
    Returns the largest error relative to scale of each kernel."""
    steps = HS_PRESET_T
    cfg = pg_config(steps, "ekf_slam", False)
    graphs = pg_graphs(cfg, 1, dev, seed=1)[0]
    worst = dict.fromkeys(HS_SOLVE, 0.0)
    for sc, chordal in ((16.0, False), (1.0, False), (1.0, True)):
        what = f"one world T={steps} scale={sc} chordal={chordal}"
        res = block_thomas_compare(*chain_blocks(cfg, graphs, sc, chordal),
                                   "block-Thomas " + what)
        worst["block_thomas_factor"] = max(worst["block_thomas_factor"], *(
            res[k]["rel_to_scale"] for k in ("sinv", "l", "u", "dsc")))
        worst["block_thomas_solve"] = max(worst["block_thomas_solve"],
                                          res["x"]["rel_to_scale"])
        for slots in (pg.LmSlots(graphs), pg.LmSlots(graphs, detect=False)):
            sy = schur_system(cfg, graphs, sc, slots, chordal)
            res_m = schur_mv_compare(sy, cg_direction(sy), "Schur matvec " + what)
            worst["schur_mv"] = max(worst["schur_mv"],
                                    res_m["vs_reference"]["max_world_rel_to_scale"])
    line = dict(worlds=1, steps=steps, rtol_of_scale={"block_thomas": P1_RTOL,
                                                      "schur_mv": SCHUR_RTOL},
                max_rel_to_scale=worst)
    emit("host_side_solve_vs_plain", **line)
    return line


def hs_replay_log(cfg, lms):
    """A noiseless straight drive's camera-frame AprilTag log (the JAX
    package's recorded-replay test's)."""
    from live_ekf_slam_tpu_torch.hw.apriltag import TagDetection

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
                dets.append(TagDetection(j, (r * math.cos(b), r * math.sin(b), 0.5)))
        log.append(dets)
    return np.asarray(cmds, np.float32), log, pose


def hs_tools(dev, viewer_name: str) -> dict:
    """The AprilTag replay on the card, a checkpoint saved on the card and
    resumed on the CPU, and the recorder: a pose-graph study's CSVs
    (``cli monte_carlo --runs-dir``) and ``cli bar_graphs`` over them."""
    from live_ekf_slam_tpu_torch import cli
    from live_ekf_slam_tpu_torch.eval import recorder
    from live_ekf_slam_tpu_torch.hw import apriltag

    out = {}
    # the AprilTag replay, EKF-SLAM on the card
    cfg = Config(num_iterations=40).replace(num_landmark_slots=3, num_meas_slots=3)
    lms = np.array([[2.0, 0.5], [3.0, -0.8], [4.0, 1.2]])
    cmds, log, pose = hs_replay_log(cfg, lms)
    state, poses = apriltag.replay_detection_log(
        cfg, log, cmds, "ekf_slam", T_base_cam=apriltag.se3((0.0, 0.0, 0.0)), device=dev)
    err = float(np.linalg.norm(poses[-1][:2] - pose[:2]))
    out["apriltag_replay"] = dict(ticks=len(log), landmarks=int(state.M[0]),
                                  final_err_m=err)
    if err > 0.05 or int(state.M[0]) < 2:
        raise AssertionError(f"host side: the AprilTag replay: {out['apriltag_replay']}")

    # a checkpoint of 4 worlds' per-tick EKF-SLAM run at 20 ticks, saved on
    # the card, restored into a template on the CPU, both resumed 20 ticks
    cfg = Config(num_iterations=40)
    lms4, cmds4 = mc_inputs(cfg, 4, 3, torch.device("cpu"))
    noise = philox.philox_noise_reference(3, 40, lms4.shape[1], 4)
    step = make_step(cfg)
    carry = init_carry(cfg, lms4.to(dev), lms4.shape[1])
    for t in range(20):
        carry, _ = step(carry, cmds4[:, t].to(dev), noise[t].T.to(dev), t)
    path = HS_OUT / "checkpoint.npz"
    ckpt.save(str(path), carry)
    like = ckpt.tree_map(carry, lambda x: x.cpu())
    back = ckpt.restore(str(path), like)
    same = all(torch.equal(a, b) for a, b in zip(ckpt.leaves(back), ckpt.leaves(like)))
    on_cpu = all(x.device.type == "cpu" for x in ckpt.leaves(back))
    step_h = make_step(cfg)
    for t in range(20, 40):
        carry, _ = step(carry, cmds4[:, t].to(dev), noise[t].T.to(dev), t)
        back, _ = step_h(back, cmds4[:, t], noise[t].T, t)
    d = float((carry.primary.x.cpu() - back.primary.x).abs().max())
    out["checkpoint"] = dict(worlds=4, saved_at_tick=20, resumed_ticks=20,
                             restored_equal=same, restored_on_cpu=on_cpu,
                             leaves=len(ckpt.leaves(back)),
                             resumed_max_abs_diff_x=d, tolerance=PT_CARD_TOL[1])
    if not (same and on_cpu) or d > PT_CARD_TOL[1]:
        raise AssertionError(f"host side: the checkpoint: {out['checkpoint']}")

    # the recorder: a small pose-graph study's CSVs on the card, then the
    # bar charts (``cli bar_graphs``, matplotlib); where matplotlib is
    # absent, the charts' means as ``bar_chart`` computes them, from the CSVs
    data, plots = HS_OUT / "data", HS_OUT / "plots" / "err_comparisons"
    run = data / "naive_low_noise_iter"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["monte_carlo", "--filter", "pose_graph", "--batch", "4", "--steps",
                  str(HS_SHORT_T), "--runs-dir", str(run)])
        if viewer_name == "agg":
            cli.main(["bar_graphs", "--data-dir", str(data), "--plots-dir", str(plots)])
    pgs = recorder.read_errs(str(run / "pose_graph_result.csv"))
    naive = recorder.read_errs(str(run / "naive.csv"))
    chart = plots / "naive_low_noise_iter.png"
    out["recorder"] = dict(study_s=time.perf_counter() - t0, worlds=len(pgs),
                           pgs_mean_m=float(np.mean(pgs)), naive_mean_m=float(np.mean(naive)),
                           bar_charts="png" if viewer_name == "agg" else "means",
                           chart_bytes=chart.stat().st_size if chart.exists() else 0)
    if len(pgs) != 4 or not np.isfinite(pgs + naive).all() or (
            out["recorder"]["bar_charts"] == "png" and not chart.exists()):
        raise AssertionError(f"host side: the recorder: {out['recorder']}")
    return out


def host_side_checks(dev):
    """The host-side phase (a side check, 2 CPU threads): the native
    library's build, the demos through ``cli.run_demo`` and
    ``cli.run_sim_base`` on the card, each timed with its launches counted
    (Philox once a run); the EKF-SLAM demo on the CPU; goal pursuit with
    async replans; Philox at a single world; the tools. The card against
    the CPU runs beside it (``host_side_vs_cpu_checks``)."""
    from live_ekf_slam_tpu_torch import cli, native

    import shutil

    torch.set_num_threads(2)
    shutil.rmtree(HS_OUT, ignore_errors=True)  # the CSVs append: start empty
    HS_OUT.mkdir(parents=True)
    viewer, viewer_name = hs_viewer()
    native.load()
    build_s = native.build_seconds

    # Philox at a demo's shape, one world: (1000, 48, 1)
    shape = (1, HS_PRESET_T, Config().map.num_landmarks, 1, dev)
    nz, nz_ref = philox.philox_noise(*shape), philox.philox_noise_reference(*shape)
    ph = dict(shape=list(nz.shape), bitwise_equal=bool(torch.equal(nz, nz_ref)),
              max_abs_err=float((nz - nz_ref).abs().max()))
    emit("host_side_philox", **ph)
    if not ph["bitwise_equal"]:
        raise AssertionError(f"host side: Philox at one world: {ph}")

    demos = []
    for filt, steps in HS_RESULTS.items():
        cfg = hs_config("filter_demo_results_only", filt, steps)
        demos.append(hs_demo(cfg, dev, False, viewer, "results_only"))
        emit("host_side_demo", **demos[-1])
    # the same EKF-SLAM demo on the CPU, the plain versions
    cfg = hs_config("filter_demo_results_only", "ekf_slam", HS_RESULTS["ekf_slam"])
    cpu_line = hs_demo(cfg, torch.device("cpu"), False, FrameRecorder, "cpu")
    emit("host_side_demo", **cpu_line)
    for filt in HS_LIVE:
        cfg = hs_config("filter_demo_live", filt, HS_LIVE_T)
        cfg = cfg.replace(plotter=dataclasses.replace(cfg.plotter, async_viz=True))
        demos.append(hs_demo(cfg, dev, True, viewer, "live_async"))
        emit("host_side_demo", **demos[-1])

    # one EKF-SLAM demo tick under the profiler: kernels, device busy share
    cfg = hs_config("filter_demo_results_only", "ekf_slam", 10)
    cfg, _, _, lms, lms_t, cmds, noise = cli._one_world(cfg, 0, dev, None, None)
    carry = init_carry(cfg, lms_t, lms.shape[0])
    step = make_step(cfg, collect="poses")
    for t in range(5):
        carry, _ = step(carry, cmds[:, t], noise[t].T, t)
    one_tick = profiled(lambda: step(carry, cmds[:, 5], noise[5].T, 5))

    # sim_base in both trajectory modes
    sims = {}
    for pre in (True, False):
        cfg = hs_config("sim_base", "ekf_slam", HS_SHORT_T, precompute_trajectory=pre)
        t0 = time.perf_counter()
        view = cli.run_sim_base(cfg, base_dir=str(HS_OUT / f"sim_base_{pre}"),
                                device=dev, viewer=viewer)
        torch.cuda.synchronize()
        sims["tsp" if pre else "goal_pursuit"] = dict(
            steps=HS_SHORT_T, wall_s=time.perf_counter() - t0,
            true_pose=[float(v) for v in view.true_hist[-1]]
            if hasattr(view, "true_hist") else [float(v) for v in view.frames[-1].true_pose])

    # clicked-goal pursuit on building1, the local planner's replans on the
    # native scheduler's threads
    cfg = hs_config("filter_demo_live", "ekf_slam", HS_SHORT_T, occ_map_img="building1.png",
                    precompute_trajectory=False, use_local_planner=True)
    cfg = cfg.replace(path_planning=dataclasses.replace(cfg.path_planning,
                                                        async_replan=True))
    views = []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        avg = cli.run_demo(cfg, device=dev, viewer=FrameRecorder.into(views))
    gp = views[0].on_goal.__self__  # run_demo closed its scheduler
    frames = views[0].frames
    pursuit = dict(steps=HS_SHORT_T, image=cfg.occ_map_img, wall_s=time.perf_counter() - t0,
                   avg_err_m=avg, async_replans=gp.async_replans,
                   async_replans_blocked=gp.async_replans_blocked,
                   progress_m=float(np.linalg.norm(frames[-1].true_pose[:2]
                                                   - np.asarray(cfg.init_pose[:2]))))
    if not gp.async_replans or pursuit["progress_m"] < 0.5:
        raise AssertionError(f"host side: goal pursuit with async replans: {pursuit}")

    tools = hs_tools(dev, viewer_name)
    ekf = demos[0]
    line = dict(nvidia_smi=card(), viewer=viewer_name, native_build_s=build_s,
                demos=len(demos),
                ekf_slam_results_only=dict(card_s=ekf["wall_s"], cpu_s=cpu_line["wall_s"],
                                           card_ms_per_tick=ekf["ms_per_tick"],
                                           cpu_ms_per_tick=cpu_line["ms_per_tick"],
                                           avg_err_card_m=ekf["avg_err_m"],
                                           avg_err_cpu_m=cpu_line["avg_err_m"]),
                one_tick_ekf_slam=one_tick, sim_base=sims, goal_pursuit=pursuit,
                frames_dropped={d["filter"]: d["frames_dropped"] for d in demos
                                if d["async_viz"]},
                philox_launches=sum(d["launches"].get("philox_noise", 0) for d in demos),
                solve_launches={k: sum(d["launches"].get(k, 0) for d in demos)
                                for k in HS_SOLVE},
                outputs=str(HS_OUT.relative_to(HS_OUT.parent.parent)), **tools)
    emit("host_side", **line)


def host_side_vs_cpu_checks(dev):
    """The host side's checks against the CPU and the plain versions (a side
    check of its own, 2 CPU threads, beside ``host_side``, which would
    otherwise bound the side checks' time): the demos card against CPU and
    P1 and P2 at one world."""
    torch.set_num_threads(2)
    hs_card_vs_cpu(dev)
    hs_solve_single_world(dev)


# ---- the multi-device layer (parallel/mesh): the sharded rollouts, the
# reduction, the sharded per-tick step, weak scaling and sharded checkpoints,
# on a mesh of every card present and on a virtual mesh of MD_SHARDS shards
# on cuda:0 (a stream each), at the main path's inputs
MD_SHARDS = 4
MD_PER_TICK_STEPS = 20                  # ticks of the sharded per-tick step
MD_WEAK = dict(worlds_per_device=64, steps=100)  # JAX's weak-scaling defaults
MD_WEAK_VIRTUAL = (1, 2, 4)
MD_OUT = Path(__file__).resolve().parent / "chiprun_out" / "multi_device"
# kernel -> (filter, sharded wrapper, single rollout, keywords)
MD_KERNELS = {
    "fused_ekf_rollout": ("ekf_slam", fr.fused_ekf_rollout_sharded,
                          fr.fused_ekf_rollout, {}),
    "fused_ukf_rollout[slam]": ("ukf_slam", fu.fused_ukf_rollout_sharded,
                                fu.fused_ukf_rollout, {"slam": True}),
    "fused_ukf_rollout[loc]": ("ukf_loc", fu.fused_ukf_rollout_sharded,
                               fu.fused_ukf_rollout, {"slam": False}),
}


def md_rollout_checks(kname: str, mesh, cfg, lms, cmds, seed: int,
                      plain_worlds: int) -> dict:
    """One rollout kernel sharded over ``mesh``: its launches counted (one a
    shard, no other kernel), every shard bit for bit its slice's single
    launch at ``shard_seed(seed, d)`` on the inputs' device, with injected
    noise the sharded run bit for bit the unsharded one and, unless
    ``plain_worlds`` is 0, shard 1 (shard 0 on a one-shard mesh) on its
    first ``plain_worlds`` worlds within TOL_MAIN of the plain version and
    bit for bit the -fmad=false build."""
    filt, sharded, single, kw = MD_KERNELS[kname]
    cfg = cfg.replace(filter=filt)
    b, t_total, n_lm = lms.shape[0], cmds.shape[1], lms.shape[1]
    k = b // mesh.size
    zero_counts()
    out = sharded(cfg, lms, cmds, seed, mesh, **kw)
    torch.cuda.synchronize()
    launches = counts()
    want = {name: mesh.size * int(name == kname) for name in launches}
    if launches != want:
        raise AssertionError(f"{kname} sharded: launched {launches}, not "
                             f"{mesh.size} x {kname}")
    for d in range(mesh.size):
        one = single(cfg, lms[d * k:(d + 1) * k].contiguous(),
                     cmds[d * k:(d + 1) * k].contiguous(),
                     pmesh.shard_seed(seed, d), **kw)
        bitwise({n: v[d * k:(d + 1) * k] for n, v in out.items()}, one,
                f"{kname} shard {d} against its single launch")
    nz = philox.philox_noise(seed, t_total, n_lm, b, lms.device)
    bitwise(sharded(cfg, lms, cmds, seed, mesh, noise=nz, **kw),
            single(cfg, lms, cmds, seed, noise=nz, **kw),
            f"{kname} sharded against unsharded with injected noise")
    line = dict(kernel=kname, shards=mesh.size, launches=launches[kname],
                shards_bitwise_single=True, injected_noise_bitwise_unsharded=True,
                max_abs_err=None, no_fma_bitwise_equal=None)
    if not plain_worlds:
        return line
    d = min(1, mesh.size - 1)
    lw = lms[d * k:d * k + plain_worlds].contiguous()
    cw = cmds[d * k:d * k + plain_worlds].contiguous()
    seed_d = pmesh.shard_seed(seed, d)
    noise = philox.philox_noise_reference(seed_d, t_total, n_lm, plain_worlds,
                                          lms.device)
    p, exempt = plain_run(cfg, lw, cw, noise, TOL_MAIN)
    kd = {n: v[d * k:d * k + plain_worlds] for n, v in out.items()}
    errs = compare(kd, p, TOL_MAIN, exempt)
    with _build.without_fma():
        same = bitwise(single(cfg, lw, cw, seed_d, **kw), p,
                       f"{kname} shard {d} -fmad=false")
    worst = max(TOL_MAIN, key=lambda o: errs[o]["max_abs_err"])
    line.update(plain_shard=d, plain_seed=seed_d, plain_worlds=plain_worlds,
                errors=errs, max_abs_err=errs[worst]["max_abs_err"],
                max_abs_err_output=worst, no_fma_bitwise_equal=all(same.values()))
    return line


def md_per_tick(dev, mesh, lms, cmds, steps: int) -> dict:
    """The per-tick EKF-SLAM step (``make_step``) through ``sharded_step``
    on ``mesh`` against the unsharded step on the same worlds and Philox
    draws, ``steps`` ticks each, host-clock timed from the second tick on
    (the first warms both up): the largest gaps, the
    average error held to PT_CARD_TOL per world and the alive masks equal
    (batched products may take another cuBLAS algorithm at another batch
    size)."""
    n_lm = lms.shape[1]
    cfg = Config(num_iterations=steps).replace(filter="ekf_slam")
    cmds = cmds[:, :steps].contiguous()
    noise = philox.philox_noise(0, steps, n_lm, lms.shape[0], dev)
    step = make_step(cfg)
    sstep = pmesh.sharded_step(step, mesh)
    c_sh = pmesh.shard_batch(cmds, mesh)
    n_sh = pmesh.shard_batch(noise, pmesh.world_sharding(mesh, 2))
    carry, _ = step(init_carry(cfg, lms, n_lm), cmds[:, 0], noise[0].T, 0)
    sh, _ = sstep(pmesh.shard_batch(init_carry(cfg, lms, n_lm), mesh),
                  c_sh.map(lambda x: x[:, 0]), n_sh.map(lambda x: x[0].T), 0)
    t0 = sync_clock(dev)  # each timed from its second tick on
    for t in range(1, steps):
        carry, _ = step(carry, cmds[:, t], noise[t].T, t)
    t1 = sync_clock(dev)
    for t in range(1, steps):
        sh, _ = sstep(sh, c_sh.map(lambda x: x[:, t]),
                      n_sh.map(lambda x: x[t].T), t)
    fin = pmesh.gather(sh)
    t3 = sync_clock(dev)
    avg = lambda c: c.err_sum_primary / c.ticks_primary.clamp_min(1).float()
    a, r = avg(fin), avg(carry)
    atol, rtol = PT_CARD_TOL
    bad = ~((a - r).abs() <= atol + rtol * r.abs())
    same_alive = bool(torch.equal(fin.alive_primary, carry.alive_primary))
    line = dict(shards=mesh.size, worlds=lms.shape[0], steps=steps,
                bitwise_equal=all(torch.equal(x, y) for x, y in
                                  zip(ckpt.leaves(fin), ckpt.leaves(carry))),
                max_abs_diff_avg_err=float((a - r).abs().max()),
                max_abs_diff_x=float((fin.primary.x - carry.primary.x).abs().max()),
                max_abs_diff_P=float((fin.primary.P - carry.primary.P).abs().max()),
                worlds_out_of_tol=int(bad.sum()), alive_equal=same_alive,
                tolerance=list(PT_CARD_TOL),
                unsharded_ms_a_tick=1e3 * (t1 - t0) / (steps - 1),
                sharded_ms_a_tick=1e3 * (t3 - t1) / (steps - 1),
                mean_err_m=float(pmesh.mean_over_worlds(
                    pmesh.Shards([c.err_sum_primary for c in sh.parts],
                                 sh.placement), mesh)) / steps)
    if bad.any() or not same_alive or not np.isfinite(line["mean_err_m"]):
        raise AssertionError(f"sharded per-tick step: {line}")
    return line


def md_checkpoint(mesh, carry, path: Path) -> dict:
    """A sharded carry saved and restored (``save_sharded`` /
    ``restore_sharded``), bit for bit and on its shards' devices."""
    path.parent.mkdir(parents=True, exist_ok=True)
    ckpt.save_sharded(str(path), carry)
    back = ckpt.restore_sharded(str(path), carry)
    same = all(torch.equal(x, y) and x.device == y.device
               for p, q in zip(carry.join().parts, back.parts)
               for x, y in zip(ckpt.leaves(p), ckpt.leaves(q)))
    line = dict(shards=mesh.size, leaves=len(ckpt.leaves(back.parts[0])),
                bytes=path.stat().st_size, bitwise_equal=same)
    path.unlink()
    if not same:
        raise AssertionError(f"sharded checkpoint: {line}")
    return line


# the sharded closed loop against the unsharded one, as the card test holds
# it: igvc1 with its 37 barrels, 16 worlds, 40 ticks, the planners cut to
# 96 / 48 sweeps, on a virtual mesh of MD_CL_SHARDS shards (two worlds a
# shard)
MD_CL = dict(batch=16, steps=40, seed=11)
MD_CL_SHARDS = 8


def md_closed_loop(dev) -> dict:
    """``run_closed_loop_sharded`` on the virtual mesh of MD_CL_SHARDS
    shards on ``dev`` against ``run_closed_loop`` on the same worlds and
    Philox draws: every leaf of the final carry equal (``torch.equal``);
    raises on any difference."""
    cfg = preset("igvc1", num_iterations=MD_CL["steps"]).replace(
        num_landmark_slots=37, num_meas_slots=12)
    cfg = cfg.replace(path_planning=dataclasses.replace(
        cfg.path_planning, astar_max_iters=96, local_astar_max_iters=48,
        path_capacity=128))
    t0 = time.perf_counter()
    _, one, _ = cl.run_closed_loop(cfg, MD_CL["batch"], MD_CL["seed"], device=dev)
    t1 = time.perf_counter()
    _, sharded = cl.run_closed_loop_sharded(cfg, pmesh.virtual_mesh(MD_CL_SHARDS, dev),
                                            MD_CL["batch"], MD_CL["seed"])
    t2 = time.perf_counter()
    pairs = list(zip(ckpt.leaves(one), ckpt.leaves(sharded)))
    unequal = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    line = dict(shards=MD_CL_SHARDS, **MD_CL, leaves=len(pairs),
                unequal_leaves=unequal, bitwise_equal=not unequal,
                unsharded_s=t1 - t0, sharded_s=t2 - t1)
    if unequal or not pairs:
        raise AssertionError(f"sharded closed loop differs from the unsharded one: {line}")
    return line


def md_timing(dev, base, lms, cmds) -> dict:
    """Each sharded rollout on the virtual mesh against its one-device
    launch at the main path's inputs, in turns: CUDA-event and host-clock
    milliseconds (median of REPS after a warm-up; the sharded call includes
    placing the inputs and gathering the outputs)."""
    mesh = pmesh.virtual_mesh(MD_SHARDS, dev)
    out = {}
    for kname, (filt, sharded, single, kw) in MD_KERNELS.items():
        cfg = base.replace(filter=filt)
        calls = {"sharded": lambda: sharded(cfg, lms, cmds, 0, mesh, **kw),
                 "single": lambda: single(cfg, lms, cmds, 0, **kw)}
        ev, host = {}, {}
        for name in ("single", "sharded", "sharded", "single"):
            ev.setdefault(name, []).append(timed_ms(calls[name]))
            hs = []
            for _ in range(REPS):
                t0 = sync_clock(dev)
                calls[name]()
                hs.append(1e3 * (sync_clock(dev) - t0))
            host.setdefault(name, []).append(float(np.median(hs)))
        out[kname] = {f"{name}_ms": ev[name] for name in ev}
        out[kname].update({f"{name}_host_ms": host[name] for name in host})
    return out


def multi_device_checks(dev, n_lm: int):
    """The multi-device phase's side check: K1 and K4 (SLAM and Loc)
    sharded over the real mesh of every card at the main path's inputs,
    the reduction on it and on the virtual mesh of MD_SHARDS shards on
    cuda:0, the sharded per-tick step, a sharded checkpoint, the sharded
    closed loop against the unsharded one (``md_closed_loop``) and the
    weak-scaling rows (beside the other side processes); a
    ``multi_device_side`` line that ``multi_device_path`` completes."""
    t_start = time.perf_counter()
    base = Config(num_iterations=MAIN["steps"])
    lms, cmds = mc_inputs(base, MAIN["batch"], 0, dev, shared=True, relabel=True)
    count = torch.cuda.device_count()
    real = pmesh.make_mesh()
    if count > 1 and real.virtual:
        raise AssertionError(f"{count} cards but a virtual mesh: {real}")
    virtual = pmesh.virtual_mesh(MD_SHARDS, dev)
    seconds, t0 = {}, time.perf_counter()
    lines = {}
    for kname in MD_KERNELS:
        line = md_rollout_checks(kname, real, base, lms, cmds, 0, 0)
        emit("multi_device_rollout", mesh="real",
             devices=[str(x) for x in real.devices], **line)
        lines[kname] = line
    seconds["real_mesh_rollouts"], t0 = time.perf_counter() - t0, time.perf_counter()
    # the reduction: the EKF's per-world error sums on both meshes
    err = fr.fused_ekf_rollout(base, lms, cmds, 0)["err_sum"]
    mean_rel = {}
    for mesh_name, mesh in (("real", real), ("virtual", virtual)):
        m = pmesh.mean_over_worlds(pmesh.shard_batch(err, mesh), mesh)
        mean_rel[mesh_name] = float(((m.to(dev) - err.mean()) / err.mean()).abs())
        if not mean_rel[mesh_name] <= 1e-6:
            raise AssertionError(f"mean_over_worlds on the {mesh_name} mesh: "
                                 f"relative gap {mean_rel[mesh_name]}")
    per_tick = md_per_tick(dev, virtual, lms, cmds, MD_PER_TICK_STEPS)
    emit("multi_device_per_tick", **per_tick)
    cfg = Config(num_iterations=2)
    carry = pmesh.shard_batch(init_carry(cfg, lms, n_lm), virtual)
    checkpoint = md_checkpoint(virtual, carry, MD_OUT / "sharded.npz")
    seconds["reduction_per_tick_checkpoint"], t0 = (time.perf_counter() - t0,
                                                    time.perf_counter())
    closed_loop = md_closed_loop(dev)
    seconds["closed_loop"], t0 = time.perf_counter() - t0, time.perf_counter()
    rows = []
    for n in MD_WEAK_VIRTUAL:
        rows.append(weak_scaling.run_row(n, MD_WEAK["worlds_per_device"],
                                         MD_WEAK["steps"], device=dev))
    rows.append(weak_scaling.run_row(count, MD_WEAK["worlds_per_device"],
                                     MD_WEAK["steps"], real=True))
    for row in rows:
        emit("weak_scaling", beside_other_processes=True, **row)
        if not np.isfinite(row["mean_err"]):
            raise AssertionError(f"weak scaling: {row}")
    seconds["weak_scaling"] = time.perf_counter() - t0
    emit("multi_device_side", device_count=count,
         cross_device=len(real.distinct_devices) > 1,
         real_devices=[str(x) for x in real.devices],
         launches={f"real:{k}": v["launches"] for k, v in lines.items()},
         shards_bitwise_single=all(v["shards_bitwise_single"] for v in lines.values()),
         injected_noise_bitwise_unsharded=all(
             v["injected_noise_bitwise_unsharded"] for v in lines.values()),
         mean_over_worlds_rel_gap=mean_rel,
         per_tick_max_abs_diff_avg_err=per_tick["max_abs_diff_avg_err"],
         per_tick_max_abs_diff_x=per_tick["max_abs_diff_x"],
         per_tick_bitwise_equal=per_tick["bitwise_equal"],
         per_tick_ms_a_tick={"sharded": per_tick["sharded_ms_a_tick"],
                             "unsharded": per_tick["unsharded_ms_a_tick"]},
         checkpoint_bitwise_equal=checkpoint["bitwise_equal"],
         closed_loop_sharded=closed_loop,
         weak_scaling_wall_s={f"{r['mode']}:{r['devices']}": r["wall_s"] for r in rows},
         part_seconds=seconds, seconds=time.perf_counter() - t_start)


def multi_device_path(dev, base, lms, cmds, smi: str) -> dict:
    """The multi-device phase in the main process, alone on the card: K1
    and K4 (SLAM and Loc) sharded over the virtual mesh of MD_SHARDS
    shards, each with its launches counted, every shard against its single
    launch, shard 1 against the plain version (host-bound: ~10x slower
    beside the side processes, so here) and under -fmad=false, injected
    noise; then the sharded calls timed (``md_timing``). Emits the
    ``multi_device`` line with the side check's results; returns, by
    kernel, the path's launches and largest error against the plain
    version."""
    side = next(line for line in LINES if line["phase"] == "multi_device_side")
    virtual = pmesh.virtual_mesh(MD_SHARDS, dev)
    lines = {}
    for kname in MD_KERNELS:
        line = md_rollout_checks(kname, virtual, base, lms, cmds, 0, PLAIN_WORLDS)
        emit("multi_device_rollout", mesh="virtual",
             devices=[str(x) for x in virtual.devices], **line)
        lines[kname] = line
    timing = md_timing(dev, base, lms, cmds)
    emit("multi_device_timing", shards=MD_SHARDS, **MAIN, nvidia_smi=smi,
         kernels=timing)
    launches = dict(side["launches"])
    launches.update({f"virtual:{k}": v["launches"] for k, v in lines.items()})
    summary = {k: v for k, v in side.items() if k not in ("phase", "launches", "seconds")}
    summary.update(
        virtual_shards=MD_SHARDS, worlds=MAIN["batch"], steps=MAIN["steps"],
        launches=launches,
        max_abs_err={f"virtual:{k}": v["max_abs_err"] for k, v in lines.items()},
        shards_bitwise_single=side["shards_bitwise_single"] and all(
            v["shards_bitwise_single"] for v in lines.values()),
        injected_noise_bitwise_unsharded=side["injected_noise_bitwise_unsharded"]
        and all(v["injected_noise_bitwise_unsharded"] for v in lines.values()),
        no_fma_bitwise_equal=all(v["no_fma_bitwise_equal"] for v in lines.values()),
        sharded_ms={k: t["sharded_ms"] for k, t in timing.items()},
        single_ms={k: t["single_ms"] for k, t in timing.items()},
        side_seconds=side["seconds"])
    emit("multi_device", **summary)
    return {k: (launches[f"real:{k}"] + v["launches"], v["max_abs_err"])
            for k, v in lines.items()}


# The checks whose results nothing later reads, by name, and the processes
# they run in: the plain versions they wait for are bound by the host (one
# Python thread issuing small launches), so processes side by side shorten
# the run to what the longest group takes; the card is shared among them.
# No kernel is timed meanwhile (the plain versions' host times are, and say
# so). The last group runs in the calling process.
SIDE_CHECKS = {
    **{kname: (lambda dev, n_lm, kname=kname: rollout_checks(kname, dev, n_lm))
       for kname in KERNELS},
    "philox": philox_check,
    "pose_stream": pose_stream_checks,
    **{f"pose_stream_main[{kind}]":
       (lambda dev, n_lm, kind=kind: pose_stream_main_check(kind, dev, n_lm))
       for kind in fr.FILTER_KINDS},
    "block_thomas": lambda dev, n_lm: block_thomas_checks(dev),
    "schur_mv": lambda dev, n_lm: schur_mv_checks(dev),
    **{f"per_tick_pose_graph[{name}]":
       (lambda dev, n_lm, name=name: per_tick_pose_graph(name, dev))
       for name in PTPG_RUNS},
    **{f"pg_streams_of[{name}]":
       (lambda dev, n_lm, name=name: pg_streams_of(name, dev))
       for name in PTPG_RUNS},
    "pose_graph_solvers": lambda dev, n_lm: pose_graph_solvers(dev),
    "closed_loop": lambda dev, n_lm: closed_loop_checks(dev),
    "host_side": lambda dev, n_lm: host_side_checks(dev),
    "host_side_vs_cpu": lambda dev, n_lm: host_side_vs_cpu_checks(dev),
    "multi_device": multi_device_checks,
    # beside the other side processes: two CPU threads
    **{f"per_tick_card_vs_cpu[{i}]":
       (lambda dev, n_lm, modes=modes: (torch.set_num_threads(2),
                                        per_tick_card_vs_cpu(dev, n_lm, modes)))
       for i, modes in enumerate(PT_CPU_GROUPS)},
    **{f"per_tick_run[{i}]":
       (lambda dev, n_lm, modes=modes: per_tick_runs(dev, n_lm, modes))
       for i, modes in enumerate(PT_RUN_GROUPS)},
}
SIDE_GROUPS = (
    *((f"per_tick_run[{i}]",) for i in range(len(PT_RUN_GROUPS))),
    ("per_tick_pose_graph[naive]",),
    ("per_tick_pose_graph[ekf_slam]", "pg_streams_of[ekf_slam]"),
    ("pg_streams_of[naive]",),
    ("pose_graph_solvers",),
    ("closed_loop",),
    ("host_side",),
    ("host_side_vs_cpu",),
    ("multi_device",),
    ("fused_ukf_rollout[slam]",),
    ("fused_ukf_rollout[loc]",),
    ("fused_ekf_rollout", "pose_stream_main[ekf]"),
    ("fused_iekf_rollout", "pose_stream_main[iekf]"),
    ("per_tick_card_vs_cpu[0]",),
    ("per_tick_card_vs_cpu[1]",),
    ("philox", "pose_stream", "block_thomas", "schur_mv"),
)
SIDE_FLAG = "--side-checks"


def side_checks(dev, n_lm: int):
    """Every group of SIDE_GROUPS at once: all but the last as ``python3
    chip_smoke.py --side-checks NAME ...``, whose lines are printed when it
    has ended and whose failure fails the run; no process is left behind."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               SIDE_FLAG, *group], stdout=subprocess.PIPE, text=True)
             for group in SIDE_GROUPS[:-1]]
    pool = ThreadPoolExecutor(len(procs))
    try:
        outs = [pool.submit(p.communicate) for p in procs]
        for name in SIDE_GROUPS[-1]:
            SIDE_CHECKS[name](dev, n_lm)
        for group, p, out in zip(SIDE_GROUPS, procs, outs):
            for line in out.result()[0].splitlines(keepends=True):
                if line.startswith('{"per_tick_run"'):  # per-world arrays
                    run = json.loads(line)
                    PT_RUNS[run["per_tick_run"]] = run
                    continue
                if line.startswith('{"per_tick_pose_graph_'):  # the same
                    run = json.loads(line)
                    kind = "run" if "per_tick_pose_graph_run" in run else "streams"
                    PTPG.setdefault(kind, {})[run["per_tick_pose_graph_" + kind]] = run
                    continue
                sys.stdout.write(line)
                if line.startswith("{"):
                    LINES.append(json.loads(line))
            sys.stdout.flush()
            if p.returncode != 0:
                raise AssertionError(f"the side checks {group} ended with "
                                     f"code {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        pool.shutdown()  # every communicate() has returned: no process is left
    emit("side_checks", seconds=time.perf_counter() - t0, groups=SIDE_GROUPS)


def side_main(names: list):
    """The process of one group: the named checks on the libraries the
    caller built, their lines on the standard output."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    pin_fp32()
    _build.load()
    n_lm = Config().map.num_landmarks
    for name in names:
        t0 = time.perf_counter()
        SIDE_CHECKS[name](torch.device("cuda"), n_lm)
        emit("side_check", name=name, seconds=time.perf_counter() - t0)


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    pin_fp32()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card()
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    t_start = time.perf_counter()

    # ---- 2. build every kernel from the checkout's sources: the default
    # build the port runs, the -fmad=false build of the bitwise checks and
    # the phase-clocks build, one nvcc a source each, beside ptxas's reports
    # and the micro kernels' SASS, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(9) as pool:
        builds = [pool.submit(_build.build, extra)
                  for extra in ((), _build.NO_FMA, _build.PHASE_CLOCKS)]
        sass = pool.submit(lambda: micro_sass(builds[0].result()))
        reports = [pool.submit(ptxas_report, src) for src in (
            "fused_ekf_rollout.cu", "fused_ukf_rollout.cu", "block_thomas.cu",
            "schur_mv.cu", "micro_ops.cu")]
        libs = [f.result() for f in builds]
        ptxas = {}
        for f in reports:
            ptxas.update(f.result())
        sass.result()
    _build.load()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(lib.relative_to(_build.CSRC.parent.parent)) for lib in libs])
    n_lm = Config().map.num_landmarks
    phase_occupancy(n_lm, ptxas)

    # ---- 3-5. the checks that feed nothing later, in processes side by side
    side_checks(dev, n_lm)
    # the per-tick pose graph's runs, made in the side processes, against
    # the streams path on the same worlds
    for run in PTPG_RUNS:
        per_tick_pose_graph_check(run, smi, dev)

    # ---- 6. the main path, once per filter, through its kernel; the counts
    # read right after run_monte_carlo are that path's own
    base = Config(num_iterations=MAIN["steps"])
    lms, cmds = mc_inputs(base, MAIN["batch"], 0, dev, shared=True, relabel=True)
    gates = gate_counts(base, lms, cmds, 0)
    record = []
    fused = {}  # filter -> (average errors, diverged mask), for the per-tick path
    for kname, (filt, (ctr, key), src, replaces) in KERNELS.items():
        cfg = base.replace(filter=filt)
        zero_counts()
        t0 = time.perf_counter()
        res, out, _ = run_monte_carlo(cfg, MAIN["batch"], seed=0, device=dev,
                                      protocol="shared")
        torch.cuda.synchronize()
        mc_s = time.perf_counter() - t0
        launches = counts()
        want = {k_: int(k_ == kname) for k_ in launches}
        if launches != want:
            raise AssertionError(
                f"{filt}: the main path launched {launches}, not once {kname}")
        err = res["err_" + filt]
        if not np.isfinite(err).all():
            raise AssertionError(f"{filt}: non-finite average errors")
        fused[filt] = (err, res["diverged_" + filt],
                       out["update_rejects"].cpu().numpy()
                       if filt.startswith("ukf") else None)
        du = fu.state_dim(n_lm, filt == "ukf_slam") if filt.startswith("ukf") \
            else 3 + 2 * n_lm
        if tuple(out["x"].shape) != (MAIN["batch"], du):
            raise AssertionError(f"{filt}: state shape {tuple(out['x'].shape)}")
        extra = {}
        if filt.startswith("ukf"):
            P = out["P"]
            extra["P_exactly_symmetric"] = bool(torch.equal(P, P.transpose(1, 2)))
            if not extra["P_exactly_symmetric"]:
                raise AssertionError(f"{filt}: P is not exactly symmetric")
            rej = out["update_rejects"]
            extra["worlds_with_rejects_share"] = float((rej > 0).float().mean())
            extra["update_rejects_total"] = float(rej.sum())
            # world -> refusals, for the few worlds that refuse
            extra["rejecting_worlds"] = {
                int(i): float(rej[i]) for i in torch.nonzero(rej > 0).flatten()[:16]}
        host_s, ms, _ = time_rollouts(cfg, lms, cmds, "cuda", REPS)
        emit("main_path", filter=filt, kernel=kname, **MAIN, n_lm=n_lm,
             protocol="shared", run_monte_carlo_s=mc_s,
             steps_per_s_per_world=MAIN["steps"] / float(np.median(host_s)),
             rep_s=host_s, kernel_ms=ms,
             mean_avg_pos_err_m=float(err.mean()),
             std_avg_pos_err_m=float(err.std()),
             diverged=int(res["diverged_" + filt].sum()), launches=launches,
             **extra)

        # kernel vs plain at the main path's shape: the first 256 worlds of
        # that run, the plain version replaying their slice of the kernel's
        # Philox stream (worlds are independent); and the -fmad=false build
        # on those worlds, bit for bit
        lw = lms[:PLAIN_WORLDS].contiguous()
        cw = cmds[:PLAIN_WORLDS].contiguous()
        k = {k_: v[:PLAIN_WORLDS] for k_, v in out.items()}
        noise = philox.philox_noise_reference(0, MAIN["steps"], n_lm,
                                              PLAIN_WORLDS, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, exempt = plain_run(cfg, lw, cw, noise, TOL_MAIN)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        # the UKFs' plain time is that of the run and its nudged twin in one
        # batch, with the chaos flags' eigenvalues
        plain_worlds = PLAIN_WORLDS * (2 if filt.startswith("ukf") else 1)
        errs = compare(k, p, TOL_MAIN, exempt)
        with _build.without_fma():
            same = bitwise(fused_rollout(cfg, lw, cw, 0), p,
                           f"{kname} main shape -fmad=false")
        outputs = [o for o in TOL_MAIN]
        worst = max(outputs, key=lambda o: errs[o]["max_abs_err"])
        d_avg = (k["err_sum"] - p["err_sum"]).abs() / MAIN["steps"]
        emit("kernel_vs_plain_main_shape", kernel=kname, worlds=PLAIN_WORLDS,
             steps=MAIN["steps"], plain_ms=p_ms, plain_worlds=plain_worlds,
             errors=errs,
             exempt_share=errs["worlds_exempt"] / PLAIN_WORLDS,
             max_abs_err_output=worst, no_fma_bitwise_equal=same,
             avg_err_max_abs_diff_m=float(d_avg.max()),
             avg_err_median_abs_diff_m=float(d_avg.median()))

        flops, nbytes = work(filt, gates, MAIN["batch"], MAIN["steps"], n_lm)
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        record.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[worst]["max_abs_err"],
            "max_abs_err_checked": max(errs[o]["max_abs_err_checked"] or 0.0
                                       for o in outputs),
            "worlds_exempt": errs["worlds_exempt"],
            "ms": float(np.median(ms)), "plain_ms": p_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "plain_worlds": plain_worlds, "plain_steps": MAIN["steps"],
        })
    emit("gate_counts", **MAIN, **gates)
    # the multi-device path: the real mesh checked in its side process,
    # the virtual mesh here; its launches and errors join K1's and K4's
    # records
    md = multi_device_path(dev, base, lms, cmds, smi)
    for r in record:
        if r["name"] in md:
            r["launches_multi_device"], r["max_abs_err_multi_device"] = md[r["name"]]
            r["max_abs_err"] = max(r["max_abs_err"], r["max_abs_err_multi_device"])
    kernel_ms = {KERNELS[r["name"]][0]: r["ms"] for r in record}
    phase_tick_clocks(lms, cmds, n_lm, kernel_ms)

    # ---- 6b. the kernel-attribution path: the profile modes of K1 and K2,
    # the standalone primitives, and the sum of a tick's passes
    k1p_record, times = phase_attribution(dev, n_lm, base, lms, cmds, gates)
    record += k1p_record + phase_micro_ops(dev)
    phase_op_sum(dev, n_lm, gates, times, kernel_ms)

    # ---- 7. the pose-graph main path and its kernels
    pg_record, philox_launches = pose_graph_paths(dev, n_lm)
    record += pg_record

    # ---- 8. the per-tick path of every online filter
    philox_launches += per_tick_path(dev, n_lm, fused, smi)

    # ---- 9. the per-tick pose graph, run in its side processes: each
    # counted run launched Philox once and P1 and P2 in its bulk solve
    # (per_tick_pose_graph raises otherwise)
    philox_launches += sum(r["launches"]["philox_noise"] for r in PTPG["run"].values())
    # ---- 10. the closed loop, run in its side process: once per run
    philox_launches += next(line["launches"]["philox_noise"] for line in LINES
                            if line["phase"] == "closed_loop_path")
    # ---- 11. the host side's demos, run in their side process: once a run
    philox_launches += next(line["philox_launches"] for line in LINES
                            if line["phase"] == "host_side")

    # the standalone Philox kernel: the rollouts draw in-kernel, the
    # pose-graph path launches it once per world chunk, the per-tick path
    # and the closed loop once per run
    args = (0, MAIN["steps"], n_lm, MAIN["batch"], dev)
    philox.philox_noise(*args)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    nz = philox.philox_noise(*args)
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nz_ref = philox.philox_noise_reference(*args)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = 4.0 * nz.numel()
    # and at the closed loop's shape (its side process held it bit for bit)
    cl_nz = next(line for line in LINES if line["phase"] == "closed_loop_philox")
    # and at a single world's demo shape (its side process, bit for bit)
    hs_nz = next(line for line in LINES if line["phase"] == "host_side_philox")
    err = float((nz - nz_ref).abs().max())
    record.append({
        "name": "philox_noise", "route": "cuda",
        "source": SRC + "philox_noise.cu",
        "replaces": "live_ekf_slam_tpu/ops/fused_rollout.py:160",
        "launches": philox_launches,
        "max_abs_err": max(err, cl_nz["max_abs_err"], hs_nz["max_abs_err"]),
        "max_abs_err_main_shape": err,
        "max_abs_err_closed_loop_shape": cl_nz["max_abs_err"],
        "closed_loop_shape": cl_nz["shape"],
        "max_abs_err_host_side_shape": hs_nz["max_abs_err"],
        "host_side_shape": hs_nz["shape"],
        "ms": e0.elapsed_time(e1), "plain_ms": p_ms,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
        "library_ms": None, "bytes": nbytes,
    })
    emit("wall", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == [SIDE_FLAG]:
        side_main(sys.argv[2:])
    else:
        main()
