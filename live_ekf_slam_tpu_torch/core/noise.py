"""Noise-moment helpers, in torch (counterpart of ``live_ekf_slam_tpu/core/
noise.py``).

The simulator draws U(-V, V) on commands and clips the result, and draws
unclipped U(-W, W) on measurements. ``Config.calibrated_motion`` routes the
filter through the true moments instead of the reference's half-width-as-
variance convention. The centred form is kept: it is what keeps fp32 from
cancelling mean^2/var digits (see ``clip_uniform_moments``).
"""

from __future__ import annotations

import torch

S3 = 3.0 ** 0.5


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s in true IEEE division. Dividing a CUDA tensor by a Python number
    multiplies by its reciprocal instead, which rounds differently."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def clip_uniform_moments(c, v: float, lo: float, hi: float):
    """Mean and std of clip(c + u, lo, hi) with u ~ U(-v, v), elementwise.

    Computed on the centred variable g = clip(u, l, h), l = clip(lo - c, -v,
    v), h = clip(hi - c, -v, v), so clip(c + u, lo, hi) = c + g:
      P(u<l) = (l+v)/2v,  P(u>h) = (v-h)/2v
      E[g]   = P(u<l) l + P(u>h) h + (h^2 - l^2) / 4v
      E[g^2] = P(u<l) l^2 + P(u>h) h^2 + (h^3 - l^3) / 6v.
    ``v``, ``lo`` and ``hi`` are Python floats; products of them such as 2v
    are taken in double and rounded once, as the JAX version does.
    """
    c = torch.as_tensor(c, dtype=torch.float32)
    l = torch.clamp(lo - c, -v, v)
    h = torch.clamp(hi - c, -v, v)
    p_lo = _div(l + v, 2.0 * v)
    p_hi = _div(v - h, 2.0 * v)
    mean_g = p_lo * l + p_hi * h + _div(h * h - l * l, 4.0 * v)
    m2_g = p_lo * l * l + p_hi * h * h + _div(h * (h * h) - l * (l * l), 6.0 * v)
    var = torch.clamp_min(m2_g - mean_g * mean_g, 0.0)
    return c + mean_g, torch.sqrt(var)


def motion_moments(cfg, d_cmd, th_cmd):
    """Clip-aware per-tick executed-motion moments for the EKF predict.

    Returns (eff_d, eff_th, var_d, var_th): the expected executed forward and
    heading command under the simulator's clip, and the true residual
    variances, std floored at 10% of the unclipped std.
    """
    v_fwd = cfg.process_noise.V_00
    v_hdg = cfg.process_noise.V_11
    c_d = torch.as_tensor(d_cmd, dtype=torch.float32) + cfg.process_noise.v_d
    c_th = torch.as_tensor(th_cmd, dtype=torch.float32) + cfg.process_noise.v_th
    if v_fwd > 0.0:
        eff_d, sig_d = clip_uniform_moments(
            c_d, v_fwd, 0.0, cfg.constraints.commands.d_max
        )
        sig_d = torch.clamp_min(sig_d, 0.1 * v_fwd / S3)
    else:
        eff_d, sig_d = c_d, torch.full_like(c_d, 1e-6)
    th_max = cfg.constraints.commands.th_max
    if v_hdg > 0.0:
        eff_th, sig_th = clip_uniform_moments(c_th, v_hdg, -th_max, th_max)
        sig_th = torch.clamp_min(sig_th, 0.1 * v_hdg / S3)
    else:
        eff_th, sig_th = c_th, torch.full_like(c_th, 1e-6)
    return eff_d, eff_th, sig_d * sig_d, sig_th * sig_th


def calibrated_meas_vars(cfg) -> tuple[float, float]:
    """True (range, bearing) measurement variances of U(-W, W): W^2/3."""
    return (
        cfg.sensing_noise.W_00 ** 2 / 3.0,
        cfg.sensing_noise.W_11 ** 2 / 3.0,
    )


def use_calibrated(cfg) -> bool:
    """Calibrated motion applies only in honest mode: the compat V/W swap
    reproduces the reference bug for bug and takes precedence."""
    return cfg.calibrated_motion and not cfg.compat.noise_vw_swap
