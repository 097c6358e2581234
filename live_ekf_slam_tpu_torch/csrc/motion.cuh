// Calibrated-motion moments of the rollout kernels (core/noise.py): the
// clip-aware expected executed command and its true residual variance, for
// Config.calibrated_motion. Shared by fused_ekf_rollout.cu and
// fused_ukf_rollout.cu.
#pragma once

#include "kernel_math.cuh"

namespace les {

// Clip-aware moments of clip(c + u, lo, hi), u ~ U(-v, v), centred form
// (core/noise.clip_uniform_moments).
__device__ __forceinline__ void clip_uniform_moments(
    float c, float v, float two_v, float four_v, float six_v, float lo,
    float hi, float& mean, float& sd) {
  const float l = clip(lo - c, -v, v);
  const float h = clip(hi - c, -v, v);
  const float p_lo = (l + v) / two_v;
  const float p_hi = (v - h) / two_v;
  const float mean_g = p_lo * l + p_hi * h + (h * h - l * l) / four_v;
  const float m2_g =
      p_lo * l * l + p_hi * h * h + (h * (h * h) - l * (l * l)) / six_v;
  const float var = max_nan(m2_g - mean_g * mean_g, 0.0f);
  mean = c + mean_g;
  sd = sqrtf(var);
}

// core/noise.motion_moments for one world's command; Params is the
// kernel's parameter struct (EkfParams or UkfParams: the same field names).
template <class Params>
__device__ __forceinline__ void motion_moments(const Params& p, float fwd,
                                               float ang, float& eff_d,
                                               float& eff_th, float& var_d,
                                               float& var_th) {
  const float c_d = fwd + p.v_d;
  const float c_th = ang + p.v_th;
  float sig_d, sig_th;
  if (p.cm_v_fwd > 0.0f) {
    clip_uniform_moments(c_d, p.cm_v_fwd, p.cm_2v_fwd, p.cm_4v_fwd,
                         p.cm_6v_fwd, 0.0f, p.d_max, eff_d, sig_d);
    sig_d = max_nan(sig_d, p.cm_floor_fwd);
  } else {
    eff_d = c_d;
    sig_d = 1e-6f;
  }
  if (p.cm_v_hdg > 0.0f) {
    clip_uniform_moments(c_th, p.cm_v_hdg, p.cm_2v_hdg, p.cm_4v_hdg,
                         p.cm_6v_hdg, -p.th_max, p.th_max, eff_th, sig_th);
    sig_th = max_nan(sig_th, p.cm_floor_hdg);
  } else {
    eff_th = c_th;
    sig_th = 1e-6f;
  }
  var_d = sig_d * sig_d;
  var_th = sig_th * sig_th;
}

}  // namespace les
