// Philox-4x32-10 (Salmon et al., SC'11; the Random123 generator), written
// out by hand. It takes the place of the TPU core's own generator
// (pltpu.prng_seed / prng_random_bits in live_ekf_slam_tpu/ops/
// fused_rollout.py), whose bits no other device reproduces.
//
// Stream: key = (seed, world), counter = (t, block, 0, 0); block k of tick t
// holds noise rows 4k..4k+3. live_ekf_slam_tpu_torch/ops/philox.py computes
// the same words in torch, so the plain version replays the kernel's draws.
#pragma once

#include <cstdint>

#include "kernel_math.cuh"

namespace les {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four noise values of rows 4*block .. 4*block+3 of tick t in [-1, 1).
__device__ __forceinline__ float4 philox_block(uint32_t seed, uint32_t world,
                                               uint32_t t, uint32_t block) {
  const uint4 w = philox4x32_10(make_uint4(t, block, 0u, 0u),
                                make_uint2(seed, world));
  return make_float4(uniform_pm1((int32_t)w.x), uniform_pm1((int32_t)w.y),
                     uniform_pm1((int32_t)w.z), uniform_pm1((int32_t)w.w));
}

}  // namespace les
