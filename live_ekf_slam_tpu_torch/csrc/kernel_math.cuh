// Scalar math of the rollout kernel: device counterparts of
// live_ekf_slam_tpu/ops/kernel_math.py (and of the torch functions in
// live_ekf_slam_tpu_torch/ops/kernel_math.py), formula for formula.
//
// * wrap: C remainder(t, 2*pi) as t - 2*pi*rint(t / 2*pi), with rintf
//   (round half to even), never roundf.
// * atan2: the same odd minimax polynomial as the JAX kernel (~1e-7 error),
//   not atan2f, so the port agrees with it to fp32 rounding.
// * min / max / clip propagate NaN, as jnp.maximum and torch.maximum do
//   (fmaxf would drop it, and the divergence latch reads non-finite errors).
#pragma once

#include <cstdint>

namespace les {

constexpr float TWO_PI = 6.283185307179586f;
constexpr float INV_TWO_PI = (float)(1.0 / 6.283185307179586);
constexpr float PI = 3.141592653589793f;
constexpr float HALF_PI = 1.5707963267948966f;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

__device__ __forceinline__ float wrap(float t) {
  return t - TWO_PI * rintf(t * INV_TWO_PI);
}

__device__ __forceinline__ float atan_01(float z) {
  const float w = z * z;
  float p = -0.0117212f;
  p = p * w + 0.05265332f;
  p = p * w + -0.11643287f;
  p = p * w + 0.19354346f;
  p = p * w + -0.33262347f;
  p = p * w + 0.99997726f;
  return z * p;
}

__device__ __forceinline__ float atan2p(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = max_nan(ax, ay);
  const float lo = min_nan(ax, ay);
  float a = atan_01(lo / max_nan(hi, 1e-30f));
  a = (ay > ax) ? HALF_PI - a : a;
  a = (x < 0.0f) ? PI - a : a;
  return (y < 0.0f) ? -a : a;
}

// a * b + c with the rounding pinned: one FMA in the default build, product
// and sum rounded apart in the build with contraction off (which defines
// LES_NO_FMA beside -fmad=false). nvcc contracts per basic block, so two
// instantiations of one kernel can round the same expression differently;
// this is for the places where they did.
__device__ __forceinline__ float mad_pinned(float a, float b, float c) {
#ifdef LES_NO_FMA
  return __fadd_rn(__fmul_rn(a, b), c);
#else
  return __fmaf_rn(a, b, c);
#endif
}

// signed 32-bit random word -> [-1, 1): the arithmetic shift keeps the sign
__device__ __forceinline__ float uniform_pm1(int32_t bits) {
  return (float)(bits >> 8) * (1.0f / 8388608.0f);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return ((x + m - 1) / m) * m;
}

}  // namespace les
