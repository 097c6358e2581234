// P2: the Schur-complement matvec of the bulk pose-graph solve, one CG step's
// S vp for a batch of worlds (live_ekf_slam_tpu_torch/models/posegraph.py,
// _schur_mv; solve_schur_pcg calls it bulk_cg_iters times a Gauss-Newton
// step):
//
//   sp = (d vp + u vp[1:] + u^T vp[:-1]) - H_pl H_ll^-1 H_pl^T vp
//
// d (B, T+1, 3, 3), u (B, T, 3, 3): the pose chain's blocks; the five
// whitened bearing-range coefficient arrays ab, bb, cb, ar, br (B, T, K) of
// the measurements at row t (attached to pose t+1; bearing row [ab, bb, cb,
// -ab, -bb], range row [ar, br, 0, -ar, -br] over (px, py, pth, lx, ly));
// hll_inv (B, N, 3) the per-landmark 2x2 inverses [xx, xy, yy]; slot the
// measurement -> landmark map, by column (B, K) or per measurement (B, T K)
// (posegraph.LmSlots); vp, sp (B, T+1, 3). float32 throughout.
//
// It replaces no Pallas kernel: in the JAX package this is the schur_mv
// closure of solve_schur_pcg, which XLA fuses under lax.fori_loop
// (live_ekf_slam_tpu/models/posegraph.py:1267-1276). In torch it was ~35
// elementwise passes over the (B, T, K) arrays a call.
//
// One block a world, kThreads threads, in two halves split by barriers:
//  1. H_pl^T vp: thread p walks the measurements e = p, p + P, p + 2P, ..
//     (coalesced), forms u_b = ab vx + bb vy + cb vt and u_r = ar vx + br vy
//     at pose t+1 and adds -(ab u_b + ar u_r), -(bb u_b + br u_r) to its own
//     column of per-landmark partials in shared memory ([slot][thread]: a
//     warp's threads hit 32 banks). A halving tree over the threads, fixed in
//     order (a warp a landmark row: the upper levels in registers, the last
//     five by shuffles), gives each landmark's sums; w = H_ll^-1 sums.
//  2. H_pl w and the chain: per tile of P pose rows, the last tile first,
//     the threads form each measurement's three terms from w at its slot
//     (coalesced again) into shared memory; thread r sums row r's K terms in
//     index order, adds the chain part and stores sp.
// No atomics: the order of every sum is fixed, so two runs give the same
// bits (F7), and the -fmad=false build gives the plain version's bits
// (posegraph._schur_mv_reference spells this order, the threads as a
// dimension).
//
// What bounds it: device memory. At 1024 worlds x T = 1000, K = 20 it must
// read 0.51 GB once (the coefficients 410 MB, d and u 74 MB, vp and sp 25
// MB): 0.152 ms at 3.35 TB/s. It reads the coefficients twice, once a half;
// the second read comes from L2 only while a world's 400 KB is still there,
// and with every SM's blocks streaming at once it mostly is not (0.27 ms with
// both reads from device memory; PERF.md has the halves' times). A world's
// coefficients exceed one SM's shared memory, so keeping them on chip takes
// a cluster of blocks a world.
#include <cuda_runtime.h>

#include "smem_once.cuh"

namespace {

constexpr int kThreads = 256;  // a world's block (posegraph.SCHUR_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // measurements a thread loads at once

__device__ __forceinline__ void mv3(const float* __restrict__ m, const float* v,
                                    float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = __ldg(m + 3 * i) * v[0] + __ldg(m + 3 * i + 1) * v[1] +
           __ldg(m + 3 * i + 2) * v[2];
}

__device__ __forceinline__ void mtv3(const float* __restrict__ m, const float* v,
                                     float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = __ldg(m + i) * v[0] + __ldg(m + 3 + i) * v[1] + __ldg(m + 6 + i) * v[2];
}

__device__ __forceinline__ void load3(const float* __restrict__ p, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = __ldg(p + i);
}

// the chain part at pose t: d_t v_t, + u_t v_{t+1} (t < T), + u_{t-1}^T
// v_{t-1} (t > 0), in that order
__device__ __forceinline__ void chain(const float* __restrict__ d,
                                      const float* __restrict__ u,
                                      const float* __restrict__ vp, int t, int T,
                                      float* hv) {
  float v[3], o[3];
  load3(vp + 3 * t, v);
  mv3(d + 9 * t, v, hv);
  if (t < T) {
    load3(vp + 3 * (t + 1), v);
    mv3(u + 9 * t, v, o);
#pragma unroll
    for (int i = 0; i < 3; ++i) hv[i] = hv[i] + o[i];
  }
  if (t > 0) {
    load3(vp + 3 * (t - 1), v);
    mtv3(u + 9 * (t - 1), v, o);
#pragma unroll
    for (int i = 0; i < 3; ++i) hv[i] = hv[i] + o[i];
  }
}

struct Coeffs {
  const float* __restrict__ ab;
  const float* __restrict__ bb;
  const float* __restrict__ cb;
  const float* __restrict__ ar;
  const float* __restrict__ br;
};

__global__ void __launch_bounds__(kThreads)
schur_mv_kernel(const float* __restrict__ d, const float* __restrict__ u,
                Coeffs c, const float* __restrict__ hll_inv,
                const int* __restrict__ slot, int by_column,
                const float* __restrict__ vp, int T, int K, int N,
                float* __restrict__ sp) {
  extern __shared__ float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t world = blockIdx.x;
  const int TK = T * K, KP = K + 1;
  const size_t m0 = world * (size_t)TK;
  const Coeffs w_c{c.ab + m0, c.bb + m0, c.cb + m0, c.ar + m0, c.br + m0};
  const int* slotw = slot + world * (size_t)(by_column ? K : TK);
  const float* dw = d + world * (size_t)(T + 1) * 9;
  const float* uw = u + world * (size_t)T * 9;
  const float* vpw = vp + world * (size_t)(T + 1) * 3;
  float* spw = sp + world * (size_t)(T + 1) * 3;
  // part [2N][P] (half 1), then terms [3][P][K+1] (half 2); sums: 2N
  float* part = sm;
  float* sums = sm + max(2 * N * kThreads, 3 * kThreads * KP);
  int* cols = (int*)(sums + 2 * N);
  if (by_column)
    for (int k = t; k < K; k += kThreads) cols[k] = __ldg(slotw + k);
  for (int q = 0; q < 2 * N; ++q) part[q * kThreads + t] = 0.0f;
  __syncthreads();
  auto slot_of = [&](int e, int k) {
    return by_column ? cols[k] : __ldg(slotw + e);
  };

  // ---- half 1: each thread's partials of H_pl^T vp, landmark by landmark
  const int step_r = kThreads / K, step_k = kThreads - step_r * K;
  int r = t / K, k = t - r * K;  // row and column of measurement e
  for (int e0 = t; e0 < TK; e0 += kUnroll * kThreads) {
    float a[kUnroll], b[kUnroll], cc[kUnroll], ar[kUnroll], br[kUnroll];
    float v[kUnroll][3];
    int n[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int e = e0 + j * kThreads;
      n[j] = -1;
      if (e < TK) {
        a[j] = __ldg(w_c.ab + e);
        b[j] = __ldg(w_c.bb + e);
        cc[j] = __ldg(w_c.cb + e);
        ar[j] = __ldg(w_c.ar + e);
        br[j] = __ldg(w_c.br + e);
        load3(vpw + 3 * (r + 1), v[j]);
        n[j] = slot_of(e, k);
      }
      r += step_r;
      k += step_k;
      if (k >= K) {
        k -= K;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (n[j] < 0 || n[j] >= N) continue;  // past the end (or no slot)
      const float ub = a[j] * v[j][0] + b[j] * v[j][1] + cc[j] * v[j][2];
      const float ur = ar[j] * v[j][0] + br[j] * v[j][1];
      float* px = part + 2 * n[j] * kThreads + t;
      px[0] = px[0] + -(a[j] * ub + ar[j] * ur);
      px[kThreads] = px[kThreads] + -(b[j] * ub + br[j] * ur);
    }
  }
  __syncthreads();
  // the halving tree over the threads: level h adds thread p + h's partial
  // to thread p's (p < h), h = P/2 .. 1; the levels above 16 in registers
  for (int q = warp; q < 2 * N; q += kWarps) {
    float x[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) x[j] = part[q * kThreads + lane + 32 * j];
#pragma unroll
    for (int h = kWarps / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int j = 0; j < h; ++j) x[j] = x[j] + x[j + h];
#pragma unroll
    for (int dd = 16; dd >= 1; dd >>= 1)
      x[0] = x[0] + __shfl_down_sync(0xffffffffu, x[0], dd);
    if (lane == 0) sums[q] = x[0];
  }
  __syncthreads();
  for (int l = t; l < N; l += kThreads) {  // w = H_ll^-1 sums, in place
    const float* hi = hll_inv + (world * N + l) * 3;
    const float sx = sums[2 * l], sy = sums[2 * l + 1];
    sums[2 * l] = __ldg(hi) * sx + __ldg(hi + 1) * sy;
    sums[2 * l + 1] = __ldg(hi + 1) * sx + __ldg(hi + 2) * sy;
  }
  __syncthreads();

  // ---- half 2: H_pl w row by row, and the chain part, a tile of P rows at
  // a time, the last tile first: the rows half 1 read last are the likeliest
  // to be in L2 still
  float* terms = sm;
  for (int r0 = (T - 1) / kThreads * kThreads; r0 >= 0; r0 -= kThreads) {
    const int nr = min(kThreads, T - r0), nf = nr * K;
    int rr = t / K, kk = t - rr * K;  // of measurement r0 K + f in the tile
    for (int f0 = t; f0 < nf; f0 += kUnroll * kThreads) {
      float a[kUnroll], b[kUnroll], cc[kUnroll], ar[kUnroll], br[kUnroll];
      int n[kUnroll], at[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int f = f0 + j * kThreads, e = r0 * K + f;
        n[j] = -2;
        if (f < nf) {
          a[j] = __ldg(w_c.ab + e);
          b[j] = __ldg(w_c.bb + e);
          cc[j] = __ldg(w_c.cb + e);
          ar[j] = __ldg(w_c.ar + e);
          br[j] = __ldg(w_c.br + e);
          n[j] = slot_of(e, kk);
          at[j] = rr * KP + kk;
        }
        rr += step_r;
        kk += step_k;
        if (kk >= K) {
          kk -= K;
          ++rr;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (n[j] == -2) continue;  // past the tile
        float wx = 0.0f, wy = 0.0f;
        if (n[j] >= 0 && n[j] < N) {
          wx = sums[2 * n[j]];
          wy = sums[2 * n[j] + 1];
        }
        const float ub = -(a[j] * wx + b[j] * wy);
        const float ur = -(ar[j] * wx + br[j] * wy);
        terms[at[j]] = a[j] * ub + ar[j] * ur;
        terms[kThreads * KP + at[j]] = b[j] * ub + br[j] * ur;
        terms[2 * kThreads * KP + at[j]] = cc[j] * ub;
      }
    }
    __syncthreads();
    if (t < nr) {
      const int pose = r0 + t + 1;
      float y[3] = {0.0f, 0.0f, 0.0f}, hv[3];
      for (int q = 0; q < K; ++q) {
#pragma unroll
        for (int i = 0; i < 3; ++i) y[i] = y[i] + terms[i * kThreads * KP + t * KP + q];
      }
      chain(dw, uw, vpw, pose, T, hv);
#pragma unroll
      for (int i = 0; i < 3; ++i) spw[3 * pose + i] = hv[i] - y[i];
    }
    __syncthreads();
  }
  if (t == 0) {  // pose 0 has no measurements
    float hv[3];
    chain(dw, uw, vpw, 0, T, hv);
#pragma unroll
    for (int i = 0; i < 3; ++i) spw[i] = hv[i];
  }
}

// dynamic shared bytes a block: the larger half's buffer, the sums and the
// by-column slots
long schur_smem(int K, int N) {
  const long buf = (long)max(2 * N * kThreads, 3 * kThreads * (K + 1));
  return (buf + 2L * N + K) * (long)sizeof(float);
}

}  // namespace

extern "C" int les_kernel_occupancy(const void* fn, int threads, int smem,
                                    int* out);

extern "C" int les_schur_mv(const float* d, const float* u, const float* ab,
                            const float* bb, const float* cb, const float* ar,
                            const float* br, const float* hll_inv,
                            const int* slot, int by_column, const float* vp,
                            int B, int T, int K, int N, float* sp,
                            void* stream) {
  const long smem = schur_smem(K, N);
  if (B <= 0 || T < 0 || K <= 0 || N <= 0 || smem > les::kMaxSmem ||
      (long)T * K > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = les::allow_smem<schur_mv_kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  schur_mv_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      d, u, Coeffs{ab, bb, cb, ar, br}, hll_inv, slot, by_column, vp, T, K, N, sp);
  return (int)cudaGetLastError();
}

// The launch at K measurement slots and N landmarks as the card takes it
// (les_block_thomas_occupancy's out[6]; worlds a block 1).
extern "C" int les_schur_mv_occupancy(int K, int N, int* out) {
  const long smem = schur_smem(K, N);
  if (K <= 0 || N <= 0 || smem > les::kMaxSmem) return (int)cudaErrorInvalidValue;
  out[4] = 1;
  out[5] = (int)smem;
  const int rc =
      les_kernel_occupancy((const void*)schur_mv_kernel, kThreads, out[5], out);
  les::forget_smem<schur_mv_kernel>();
  return rc;
}
