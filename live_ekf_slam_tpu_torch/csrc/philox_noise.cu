// philox_noise(seed, T, N, B) -> (T, 2N+8, B) float32: exactly the noise the
// rollout kernel draws in-kernel (philox.cuh). It exists so that a run with
// the in-kernel generator can be replayed with injected noise, and so the
// torch Philox can be held against the device one; the rollout does not
// launch it. One thread per (t, block, world), worlds fastest, so stores to
// the world-minor output are coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

__global__ void philox_noise_kernel(uint32_t seed, int T, int N, int B,
                                    float* __restrict__ out) {
  const int rows = 2 * N + 8;
  const int n_blk = (rows + 3) / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)T * n_blk * B) return;
  const int world = (int)(idx % B);
  const size_t rest = idx / B;
  const int blk = (int)(rest % n_blk);
  const int t = (int)(rest / n_blk);
  const float4 v = les::philox_block(seed, world, t, blk);
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * blk + q;
    if (r < rows) out[((size_t)t * rows + r) * B + world] = vals[q];
  }
}

}  // namespace

extern "C" int les_philox_noise(uint32_t seed, int T, int N, int B,
                                float* out, void* stream) {
  const size_t total = (size_t)T * ((2 * N + 8 + 3) / 4) * B;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  philox_noise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      seed, T, N, B, out);
  return (int)cudaGetLastError();
}
