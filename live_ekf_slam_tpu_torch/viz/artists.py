"""Matplotlib artist helpers for the live viewer (rebuild of the drawing
primitives in plotting_node.py: covariance ellipses 146-170, pose arrows
278-299, sigma points 337-372, legend symbols 183-193); the port's copy of
``live_ekf_slam_tpu/viz/artists.py``."""

from __future__ import annotations

import numpy as np


def cov_to_ellipse(p2, n_std=1.0, n_pts=100):
    """2x2 covariance -> (2, n_pts) ellipse polyline (plotting_node.py:146-170).

    Negative eigenvalues are abs()'d like the reference so landmark ellipses
    survive slightly indefinite covariances.
    """
    cov = np.asarray(p2, dtype=np.float64)[:2, :2]
    vals, vecs = np.linalg.eigh(cov)
    order = np.argsort(vals)[::-1]
    vals = np.abs(vals[order])
    vecs = vecs[:, order]
    theta = np.arctan2(vecs[1, 0], vecs[0, 0])
    w, h = n_std * 2.0 * np.sqrt(vals)
    t = np.linspace(0, 2 * np.pi, n_pts)
    ell = np.stack([w * np.cos(t), h * np.sin(t)])
    rot = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    return rot @ ell


def pose_arrow_components(yaw, arrow_len=0.1):
    return arrow_len * np.cos(yaw), arrow_len * np.sin(yaw)


def sigma_points_xy(x_sig, veh_len=4):
    """Extract vehicle (x, y, yaw) for each sigma column of a (Du, 2Du+1)
    sigma matrix with (x, y, cos, sin) vehicle block (plotting_node.py:344-360)."""
    xs = x_sig[0, :]
    ys = x_sig[1, :]
    if veh_len == 4:
        yaws = np.arctan2(x_sig[3, :], x_sig[2, :])
    else:
        yaws = x_sig[2, :]
    return xs, ys, yaws


def landmark_sigma_points_xy(x_sig, veh_len=4):
    """All landmark (x, y) coords across sigma columns
    (plotting_node.py:362-372)."""
    lm = x_sig[veh_len:, :]
    xs = lm[0::2, :].ravel()
    ys = lm[1::2, :].ravel()
    return xs, ys
