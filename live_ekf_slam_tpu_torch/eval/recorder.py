"""Benchmark artifacts: per-filter avg-error CSVs + comparison bar charts.

Reproduces the reference's offline analysis pipeline: per-run CSV appends
(plotting_node.py:126-129 into base_pkg/data/<run>/*.csv, one float per line)
and the PGS-vs-filter bar charts (make_bar_graphs.py) written to
plots/err_comparisons/<run>.png. The port's copy of
``live_ekf_slam_tpu/eval/recorder.py``.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np


def write_run_csvs(run_dir: str, errors: dict):
    """Append per-filter average errors. errors: {"ekf": array-of-runs, ...}.

    File layout matches base_pkg/data/<run>/{ekf,naive,pose_graph_init,
    pose_graph_result}.csv — one float per line per run.
    """
    os.makedirs(run_dir, exist_ok=True)
    for name, vals in errors.items():
        with open(os.path.join(run_dir, f"{name}.csv"), "a") as f:
            for v in np.atleast_1d(vals):
                f.write(f"{float(v)}\n")


def read_errs(fname: str):
    with open(fname) as f:
        return [float(line.split(",")[0]) for line in f if line.strip()]


def bar_chart(run_dir: str, out_dir: str):
    """One run-dir -> one PGS-vs-filter bar chart (make_bar_graphs.py:20-55).

    Returns (pgs_mean, filter_mean, filter_type) and writes <run>.png.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pgs = read_errs(os.path.join(run_dir, "pose_graph_result.csv"))
    ekf_path = os.path.join(run_dir, "ekf.csv")
    naive_path = os.path.join(run_dir, "naive.csv")
    if os.path.exists(ekf_path):
        filt, ftype = read_errs(ekf_path), "EKF-SLAM"
    else:
        filt, ftype = read_errs(naive_path), "Naive"

    bar_w = 0.25
    fig, ax = plt.subplots()
    xs = np.arange(len(pgs))
    ax.bar(xs, pgs, color="purple", width=bar_w, edgecolor="grey",
           label="Pose-Graph SLAM")
    ax.bar(xs + bar_w, filt[: len(pgs)], color="green", width=bar_w,
           edgecolor="grey", label=ftype)
    ax.set_xlabel("Run number", fontsize=15)
    ax.set_ylabel("Average position error (m)", fontsize=15)
    ax.set_xticks(xs + bar_w / 2, [i + 1 for i in range(len(pgs))])
    ax.legend(loc="upper left")
    run_name = os.path.basename(os.path.normpath(run_dir))
    title = ("High" if "high" in run_name else "Low") + f" Noise, {ftype} vs "
    title += ("One-Time-" if "one" in run_name else "Iterative-") + "PGS"
    ax.set_title(title)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{run_name}.png")
    fig.savefig(out, format="png")
    plt.close(fig)
    return float(np.mean(pgs)), float(np.mean(filt)), ftype


def make_all_bar_charts(data_dir: str, plots_dir: str):
    """Sweep every run dir like make_bar_graphs.main (make_bar_graphs.py:57-79)."""
    results = {}
    for run_dir in sorted(glob(os.path.join(data_dir, "*", ""))):
        try:
            pgs_m, filt_m, ftype = bar_chart(run_dir, plots_dir)
        except (FileNotFoundError, OSError):
            continue
        name = os.path.basename(os.path.normpath(run_dir))
        results[name] = {"pgs": pgs_m, ftype.lower(): filt_m}
        print(f"{name}:\n\tPGS: {pgs_m:.4f}\n\t{ftype}: {filt_m:.4f}")
    return results
