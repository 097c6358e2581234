// philox_noise(seed, T, N, B, world0) -> (T, 2N+8, B) float32: exactly the
// noise the rollout kernel draws in-kernel (philox.cuh) for worlds world0 ..
// world0 + B - 1. A run with the in-kernel generator can be replayed from it
// with injected noise, the torch Philox is held against it, and the
// pose-graph streams path draws its world chunks' noise with it (the same
// tensor feeds the closed-form simulator and the rollout kernel). One thread per (t, block, world), worlds fastest, so stores to
// the world-minor output are coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

__global__ void philox_noise_kernel(uint32_t seed, int T, int N, int B,
                                    int world0, float* __restrict__ out) {
  const int rows = 2 * N + 8;
  const int n_blk = (rows + 3) / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)T * n_blk * B) return;
  const int world = (int)(idx % B);
  const size_t rest = idx / B;
  const int blk = (int)(rest % n_blk);
  const int t = (int)(rest / n_blk);
  const float4 v = les::philox_block(seed, world0 + world, t, blk);
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * blk + q;
    if (r < rows) out[((size_t)t * rows + r) * B + world] = vals[q];
  }
}

}  // namespace

extern "C" int les_philox_noise(uint32_t seed, int T, int N, int B,
                                int world0, float* out, void* stream) {
  const size_t total = (size_t)T * ((2 * N + 8 + 3) / 4) * B;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  philox_noise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      seed, T, N, B, world0, out);
  return (int)cudaGetLastError();
}
