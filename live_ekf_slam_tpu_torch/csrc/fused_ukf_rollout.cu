// Fused sim + UKF Monte-Carlo rollout, SLAM and localization: the whole
// T-tick rollout of every world in one launch.
//
// Replaces the Pallas TPU kernel live_ekf_slam_tpu/ops/fused_ukf.py, function
// fused_ukf_rollout (kernel body _make_kernel), with slam=True as
// fused_ukf_rollout_kernel<true> and slam=False as
// fused_ukf_rollout_kernel<false>. The scalar helpers of ops/kernel_math.py
// are inlined (kernel_math.cuh) and a Philox stream takes the place of the
// TPU's on-core PRNG, with the EKF kernel's stream layout.
//
// Per tick and world: truth propagation and sensing as in the EKF kernel; the
// UKF predict (a pivot-clamped Cholesky of P * n_act / (1 - W_0) over the
// active dimensions, propagation of the four vehicle rows of the sigma
// points, the vehicle 4x4 block and the vehicle-landmark cross rows of
// P_pred by L-matvecs); for each landmark in id order an update (z-stats over
// the sigma columns, cross-covariance by L-matvec, the sanity gate that
// counts update_rejects, the one-pass Joseph form); then (SLAM) every
// insertion; the running error sum and max.
//
// What bounds it on the card. A world is a serial chain of 1000 ticks. Each
// tick factors an up to Du x Du matrix (Du = 4+2N, 44 at N = 20: ~Du^3/6
// multiply-adds), and each update runs two L-matvecs and a Du(Du+1)/2-entry
// Joseph pass. Device memory is not the limit: at B = 4096, T = 1000, N = 20
// the kernel reads about 33 MB of commands and writes about 32 MB of
// covariance, once. The limit is the latency of the per-world chain (the
// pivot-by-pivot Cholesky, the sums over sigma columns that end in shuffles)
// and the instructions of the shared-memory passes; enough warps on each SM
// hide the first, lanes that share the passes evenly shorten the second.
//
// What the design does about it. One warp per world, kWorldsPerBlock worlds
// a block, at most 128 registers a thread, so that 16 worlds are resident on
// an SM (the register file's limit). P and the Cholesky factor L are kept as
// packed lower triangles (row i at i(i+1)/2): a world takes 11.1 KB of shared
// memory at N = 20 (19.5 KB with both full squares, which let only 8 worlds
// share an SM). The Cholesky factors kPanel = 4 pivots at a time: each
// column of the panel takes the earlier panel columns' products and is
// scaled, its pivot handed to all lanes by shuffle; then one rank-4 pass
// (trailing_update) updates the rest, one load and one store an entry for
// four pivots, the panel's four values of a row read as one float4 (8
// pivots a panel measured 7% slower). Every entry loses the same products
// in the same pivot order as pivot by pivot, so the bits are those of the
// one-pivot loop. That pass and the Joseph pass share a triangle out as
// lines, row l with row m-1-l, so every busy lane walks m+1 entries (whole
// rows gave the lanes with two rows twice the mean); a triangle of at most
// 32 entries (UKF-Loc's) goes an entry a lane. The row sums
// (the matvecs) keep their k order and hand the longest rows out first,
// the second round reversed. Exact zeros are not summed: the vehicle rows of
// L vanish past column 3, so every sigma column past 3 has the same vehicle
// rows and the predict's cross rows take 4 terms; the landmark rows li,
// li + 1 of L vanish past column li + 1, so the update's sigma columns past
// it all see the landmark alike (their z is evaluated once) and its matvecs
// stop there. Such a dropped term is +0 or -0, and a sum that starts at +0 is
// never -0, so the result is the same bits. The first sweep's z of each
// column stays in registers for the second. Pivots, rows and columns past a
// world's highest seen slot hold +0 and are skipped with warp-uniform
// branches (the TPU kernel skips per block of 128 worlds); skipped or not,
// the result is the same. The Joseph pass computes each entry of the one
// triangle it keeps, so P is exactly symmetric whatever nvcc contracts into
// FMA. Built with -DLES_PHASE_CLOCKS the kernel also counts its cycles by
// phase of the tick (LES_PHASE; a measurement build).
//
// Numerics. Operation order follows the JAX kernel wherever it is not a sum
// over sigma columns or a matvec; those sums run in another order here, which
// the plain torch version copies (fused_ukf.py: lane_sum, row_dot), so that
// built with -fmad=false the kernel equals it bit for bit. nvcc contracts
// a*b+c into FMA by default, which is why the comparison of the default build
// with the plain version carries a tolerance. Where predication changes
// which loop computes a value (the Joseph entry's two loops, the state
// update, the insertion), its products are pinned (les::mad_pinned), or the
// two paths could contract apart and predicated runs would part from
// unpredicated ones (ROADMAP F10). No fast-math: IEEE sqrtf and
// division, full-accuracy sinf and cosf; rsqrtf where the JAX kernel takes
// rsqrt.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_math.cuh"
#include "motion.cuh"
#include "philox.cuh"

// Mirror of live_ekf_slam_tpu_torch/convert.py:UkfParams (field order and
// types must match).
struct UkfParams {
  float v00f, v11f, w00f, w11f, det_gate;
  float v00s, v11s, w00s, w11s;
  float v_d, v_th, w_r, w_b, wbc, wbs;
  float d_max, th_max, r_max, fov_min, fov_max;
  float x0, y0, yaw0, cyaw0, syaw0;
  float w0, one_m_w0;
  float cm_v_fwd, cm_2v_fwd, cm_4v_fwd, cm_6v_fwd, cm_floor_fwd;
  float cm_v_hdg, cm_2v_hdg, cm_4v_hdg, cm_6v_hdg, cm_floor_hdg;
  int calibrated, zero_b_mean, committed_yaw, signed_q;
};

namespace {

// 4: measured 3-4% faster than 1 or 2 for UKF-SLAM, alike for UKF-Loc
constexpr int kWorldsPerBlock = 4;
// 16 resident warps an SM: 65536 registers / (16 * 32) = 128 a thread
constexpr int kMinBlocksPerSm = 16 / kWorldsPerBlock;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a Hopper block can use
constexpr int kErrSmem = 100000;     // les_error_string (fused_ekf_rollout.cu)
constexpr float kCholEps = 1e-8f;
// sigma columns kept: 0..3, and the one all columns past 3 share
constexpr int kSig = 5;
constexpr int kPanel = 4;  // Cholesky pivots factored together: a float4

// The tick's phases, as the -DLES_PHASE_CLOCKS build counts them.
enum Phase {
  kPhSim, kPhChol, kPhSigma, kPhCross, kPhZ1, kPhSweep2, kPhGain, kPhJoseph,
  kPhInsert, kPhError, kPhases
};

#ifdef LES_PHASE_CLOCKS
// Per phase, the clock64() cycles lane 0 of every warp spent in it, summed
// over warps and ticks. A measurement build: the default build compiles none
// of it.
__device__ unsigned long long g_phase_cycles[kPhases];
#define LES_PHASE(k)                                               \
  do {                                                             \
    __syncwarp();                                                  \
    const long long now_ = clock64();                              \
    if (lane == 0) clk[(k)] += (unsigned long long)(now_ - clk_t); \
    clk_t = now_;                                                  \
  } while (0)
constexpr int kClockFloats = 2 * kPhases;
#else
#define LES_PHASE(k) \
  do {               \
  } while (0)
constexpr int kClockFloats = 0;
#endif

__host__ __device__ inline int state_dim(int n, bool slam) {
  return slam ? 4 + 2 * n : 4;
}

// offset of row i in a packed lower triangle
__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// floats of shared memory per world: the gain and cross-covariance rows
// (float4 k0, k1, c_r, c_b per row), the Cholesky panel's scaled columns
// (a float4 per row), P and L (packed lower triangles), x, the predicted
// mean, the sigma weights and the update's two g vectors (Du each), the
// propagated vehicle rows of the kSig sigma columns (+ and - halves), the
// predict's g_a of columns 0..3, the tick's noise rows, landmark x and y,
// vis, rn, bn, seen (N each)
__host__ __device__ inline int world_floats(int n, bool slam) {
  const int du = state_dim(n, slam);
  return les::round_up(8 * du + 2 * tri(du) + 5 * du + 8 * kSig + 16 +
                           les::round_up(2 * n + 8, 4) + 6 * n,
                       4) +
         kClockFloats;
}

// Sum over the warp; the xor butterfly gives every lane the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Rank-R trailing update of the Cholesky: rows and columns j0..dm-1 of the
// packed L lose the products of the panel's R scaled columns (cb[i].x, .y,
// ... = L[i][j0 - R], L[i][j0 - R + 1], ...), in pivot order, as R rank-1
// steps would, one load and store an entry. A triangle of m rows is shared
// out as lines: row j0 + l, then row j0 + m-1-l (m+1 entries) on one lane,
// the middle row of an odd m alone.
template <int R>
__device__ __forceinline__ void trailing_update(float* L, const float4* cb,
                                                int j0, int dm, int lane) {
  const int m = dm - j0;
  for (int line = lane; 2 * line < m; line += 32) {
    const int rb = j0 + m - 1 - line;
    const int len = 2 * line + 1 == m ? line + 1 : m + 1;
    float4 b = cb[j0 + line];
    float* e = L + tri(j0 + line) + j0;
    for (int c = 0, k = 0; c < len; ++c, ++k) {
      if (c == line + 1) {  // on to the line's second row
        b = cb[rb];
        e = L + tri(rb) + j0;
        k = 0;
      }
      const float4 col = cb[j0 + k];
      float v = e[k];
      v = v - b.x * col.x;
      if (R > 1) v = v - b.y * col.y;
      if (R > 2) v = v - b.z * col.z;
      if (R > 3) v = v - b.w * col.w;
      e[k] = v;
    }
  }
}

// Sigma-point motion without per-element transcendentals (fused_ukf.py:
// 268-284): cos/sin(atan2(ps, pc)) is (pc, ps) normalised, and the new
// heading direction is that rotated by the heading increment (ca, sa).
__device__ __forceinline__ void propagate(float px, float py, float pc,
                                          float ps, float mv, float ca,
                                          float sa, float& ox, float& oy,
                                          float& oc, float& os) {
  const float nrm = pc * pc + ps * ps;
  const float inv = nrm > 0.0f ? rsqrtf(nrm) : 0.0f;
  const float cy = nrm > 0.0f ? pc * inv : 1.0f;
  const float sy = ps * inv;
  ox = px + mv * cy;
  oy = py + mv * sy;
  oc = cy * ca - sy * sa;
  os = sy * ca + cy * sa;
}

// Range and bearing direction (cos b, sin b) of a landmark seen from a sigma
// point, b = atan2(ddy, ddx) - yaw + w_b, by rotation algebra (:396-415).
__device__ __forceinline__ void z_of(const UkfParams& p, float lmx, float lmy,
                                     float sx, float sy, float cy, float sy2,
                                     float& r, float& cb, float& sb) {
  const float ddx = lmx - sx;
  const float ddy = lmy - sy;
  const float nrm = ddx * ddx + ddy * ddy;
  const float inv = nrm > 0.0f ? rsqrtf(nrm) : 0.0f;
  const float ux = ddx * inv;
  const float uy = ddy * inv;
  cb = ux * cy + uy * sy2;
  sb = uy * cy - ux * sy2;
  if (p.w_b != 0.0f) {
    const float c = cb * p.wbc - sb * p.wbs;
    sb = sb * p.wbc + cb * p.wbs;
    cb = c;
  }
  r = nrm * inv + p.w_r;
}

// wrap(b - z_b) as atan2 of the direction rotated by the (unnormalised)
// bearing mean (mcb, msb) (:449-454).
__device__ __forceinline__ float dev_b(float cb, float sb, float mcb,
                                       float msb) {
  return les::atan2p(sb * mcb - cb * msb, cb * mcb + sb * msb);
}

// z of one sigma column, both halves: (r, cos b, sin b) of + then -
struct ZCol {
  float rp, cbp, sbp, rm, cbm, sbm;
};

template <bool kSlam>
__global__ void __launch_bounds__(32 * kWorldsPerBlock, kMinBlocksPerSm)
fused_ukf_rollout_kernel(const UkfParams p, const float* __restrict__ lms,
                         const float* __restrict__ cmds,
                         const float* __restrict__ noise, uint32_t seed,
                         int B, int T, int N, int predicated,
                         float* __restrict__ err_sum,
                         float* __restrict__ err_max,
                         float* __restrict__ rejects_out,
                         float* __restrict__ true_pose,
                         float* __restrict__ x_out, float* __restrict__ P_out,
                         uint8_t* __restrict__ seen_out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int world = blockIdx.x * (blockDim.x >> 5) + wib;
  if (world >= B) return;  // ragged edge: whole warps leave; no block barrier

  const int Du = state_dim(N, kSlam);
  const int R = 2 * N + 8;
  float* base = reinterpret_cast<float*>(smem4) +
                (size_t)wib * world_floats(N, kSlam);
  float4* kc = reinterpret_cast<float4*>(base);  // (k0, k1, c_r, c_b) of row i
  float4* cb = kc + Du;  // Cholesky panel: cb[i] = scaled L[i][j..j+3]
  float* cbf = reinterpret_cast<float*>(cb);  // cbf[4 i + q] = L[i][j + q]
  float* P = base + 8 * Du;  // packed lower triangles
  float* L = P + tri(Du);
  float* x = L + tri(Du);
  float* xp0 = x + Du;  // predicted mean, before this tick's updates
  float* wm = xp0 + Du;  // weight of each +/- sigma column pair
  float* g0 = wm + Du;   // update: wm (d_p - d_m) of range and bearing
  float* g1 = g0 + Du;
  float* sg = g1 + Du;  // sg[a * kSig + c]: vehicle row a of sigma
                                 // column c (+ half); sg[(4 + a) * kSig + c]
                                 // (- half)
  float* ga = sg + 8 * kSig;  // predict's g_a of columns 0..3: ga[4 a + k]
  float* u = ga + 16;
  float* lmx = u + les::round_up(R, 4);
  float* lmy = lmx + N;
  float* vis = lmy + N;
  float* rn = vis + N;
  float* bn = rn + N;
  float* seen = bn + N;
  const float w0 = p.w0;
  const bool committed = p.committed_yaw != 0;
#ifdef LES_PHASE_CLOCKS
  unsigned long long* clk = reinterpret_cast<unsigned long long*>(
      base + world_floats(N, kSlam) - kClockFloats);
  if (lane == 0)
    for (int k = 0; k < kPhases; ++k) clk[k] = 0;
  long long clk_t = clock64();
#endif

  // ---- init (fused_ukf.py:120-134); P0 diag from ukf.cpp:9-18
  for (int i = lane; i < 2 * tri(Du); i += 32) P[i] = 0.0f;  // P and L
  for (int i = lane; i < Du; i += 32) x[i] = 0.0f;
  for (int j = lane; j < N; j += 32) {
    seen[j] = 0.0f;
    lmx[j] = lms[((size_t)world * N + j) * 2 + 0];
    lmy[j] = lms[((size_t)world * N + j) * 2 + 1];
  }
  __syncwarp();
  if (lane == 0) {
    x[0] = p.x0;
    x[1] = p.y0;
    x[2] = p.cyaw0;
    x[3] = p.syaw0;
    P[tri(0) + 0] = (float)(0.01 * 0.01);
    P[tri(1) + 1] = (float)(0.01 * 0.01);
    P[tri(2) + 2] = (float)(0.005 * 0.005);
    P[tri(3) + 3] = (float)(0.005 * 0.005);
  }
  float tx = p.x0, ty = p.y0, tth = p.yaw0;
  float esum = 0.0f, emax = 0.0f, rej = 0.0f;
  const float* cmd_w = cmds + (size_t)world * T * 2;
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    const float fwd = cmd_w[2 * t];
    const float ang = cmd_w[2 * t + 1];
    if (noise != nullptr) {
      for (int r = lane; r < R; r += 32)
        u[r] = noise[((size_t)t * R + r) * B + world];
    } else {
      for (int k = lane; k < (R + 3) / 4; k += 32) {
        const float4 v = les::philox_block(seed, world, t, k);
        u[4 * k] = v.x;
        u[4 * k + 1] = v.y;
        u[4 * k + 2] = v.z;
        u[4 * k + 3] = v.w;
      }
    }
    __syncwarp();

    // ---- truth propagation and sensing (:150-172)
    const float d_n = les::clip(fwd + p.v00s * u[0], 0.0f, p.d_max);
    const float h_n = les::clip(ang + p.v11s * u[1], -p.th_max, p.th_max);
    tx = tx + d_n * cosf(tth);
    ty = ty + d_n * sinf(tth);
    tth = tth + h_n;
    for (int j = lane; j < N; j += 32) {
      const float dxl = lmx[j] - tx;
      const float dyl = lmy[j] - ty;
      const float r = sqrtf(dxl * dxl + dyl * dyl);
      const float beta = les::wrap(les::atan2p(dyl, dxl) - tth);
      const bool v = (r <= p.r_max) && (beta > p.fov_min) && (beta < p.fov_max);
      vis[j] = v ? 1.0f : 0.0f;
      rn[j] = r + p.w00s * u[2 + j];
      bn[j] = beta + p.w11s * u[2 + N + j];
    }
    LES_PHASE(kPhSim);

    // ---- UKF predict (:174-358). Committed-yaw direction of the tick-start
    // state; weights from the tick-start seen
    const float xv0 = x[0], xv1 = x[1], xc = x[2], xs = x[3];
    const float nrm_c = xc * xc + xs * xs;
    const float inv_c = nrm_c > 0.0f ? rsqrtf(nrm_c) : 0.0f;
    const float cyawv = nrm_c > 0.0f ? xc * inv_c : 1.0f;
    const float syawv = xs * inv_c;
    float n_seen = 0.0f;
    int top = 0;  // highest seen slot + 1
    if (kSlam) {
      for (int j = lane; j < N; j += 32) {
        n_seen += seen[j];
        if (seen[j] > 0.0f) top = j + 1;
      }
      n_seen = warp_sum(n_seen);  // a count: exact in any order
      top = warp_max(top);
    }
    const float n_act = 4.0f + 2.0f * n_seen;
    const float scale = n_act / p.one_m_w0;
    const float wbar = p.one_m_w0 / (2.0f * n_act);
    // rows, columns and pivots past the highest seen slot hold +0 and stay
    // so; with predication they are skipped
    const int dm = kSlam && predicated ? 4 + 2 * top : Du;
    for (int k = lane; k < Du; k += 32)
      wm[k] = wbar * (k < 4 ? 1.0f : seen[(k - 4) >> 1]);
    // L = P * scale, lower triangle
    for (int e = lane; e < tri(dm); e += 32) L[e] = P[e] * scale;
    __syncwarp();

    // pivot-clamped Cholesky in place (:205-245), kPanel pivots at a time:
    // each column of the panel takes the earlier panel columns' updates and
    // is scaled; then one rank-kPanel pass updates the rest. Every entry
    // loses the same products in the same pivot order as pivot by pivot.
    // Lane l holds rows jq + l and jq + l + 32 of column jq in registers
    // (rows past them, Du > 64, go through its own shared memory), and
    // lane 0, which holds the pivot, hands it to all by shuffle.
    for (int j = 0; j < dm; j += kPanel) {
      const int R = min(kPanel, dm - j);
      for (int q = 0; q < R; ++q) {
        const int jq = j + q;
        auto updated = [&](int i) {  // L[i][jq] after the panel's pivots
          float v = L[tri(i) + jq];
          for (int p = 0; p < q; ++p) v = v - cbf[4 * i + p] * cbf[4 * jq + p];
          return v;
        };
        const int i0 = jq + lane, i1 = i0 + 32;
        const float u0 = i0 < dm ? updated(i0) : 0.0f;
        const float u1 = i1 < dm ? updated(i1) : 0.0f;
        for (int i = i1 + 32; i < dm; i += 32) L[tri(i) + jq] = updated(i);
        const float pivot = __shfl_sync(0xffffffffu, u0, 0);
        const float ok = pivot > kCholEps ? 1.0f : 0.0f;
        const float dval = sqrtf(les::max_nan(pivot, kCholEps));
        const float f = ok / dval;
        auto scaled = [&](int i, float v) {
          const float b = v * f;
          L[tri(i) + jq] = b;
          cbf[4 * i + q] = b;
        };
        if (lane == 0)
          L[tri(jq) + jq] = dval;
        else if (i0 < dm)
          scaled(i0, u0);
        if (i1 < dm) scaled(i1, u1);
        for (int i = i1 + 32; i < dm; i += 32) scaled(i, L[tri(i) + jq]);
        __syncwarp();
      }
      if (R == kPanel)  // dm is even: the last panel has 2 columns or kPanel
        trailing_update<kPanel>(L, cb, j + R, dm, lane);
      else
        trailing_update<2>(L, cb, j + R, dm, lane);
      __syncwarp();
    }
    LES_PHASE(kPhChol);

    float mv, ath, var_d, var_th;
    if (p.calibrated) {
      les::motion_moments(p, fwd, ang, mv, ath, var_d, var_th);
    } else {
      mv = fwd + p.v_d;
      ath = ang + p.v_th;
      var_d = p.v00f;
      var_th = p.v11f;
    }
    const float ca = cosf(ath), sa = sinf(ath);

    // sigma vehicle rows (:247-296): column k of L is sigma pair k; its
    // vehicle rows L[0..3][k] vanish past k = 3, so every column past 3 is
    // column kSig - 1
    if (lane < kSig) {
      float la[4];
      for (int a = 0; a < 4; ++a) la[a] = lane <= a ? L[tri(a) + lane] : 0.0f;
      propagate(xv0 + la[0], xv1 + la[1], xc + la[2], xs + la[3], mv, ca, sa,
                sg[0 * kSig + lane], sg[1 * kSig + lane], sg[2 * kSig + lane],
                sg[3 * kSig + lane]);
      propagate(xv0 - la[0], xv1 - la[1], xc - la[2], xs - la[3], mv, ca, sa,
                sg[4 * kSig + lane], sg[5 * kSig + lane], sg[6 * kSig + lane],
                sg[7 * kSig + lane]);
    }
    __syncwarp();
    const float* sig_p = sg;
    const float* sig_m = sg + 4 * kSig;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = lane; k < dm; k += 32) {
      const int c = min(k, kSig - 1);
      for (int a = 0; a < 4; ++a)
        acc[a] += wm[k] * (sig_p[a * kSig + c] + sig_m[a * kSig + c]);
    }
    float sc[4];
    propagate(xv0, xv1, xc, xs, mv, ca, sa, sc[0], sc[1], sc[2], sc[3]);
    float m[4];
    for (int a = 0; a < 4; ++a) m[a] = w0 * sc[a] + warp_sum(acc[a]);

    // P_pred: vehicle 4x4 block (:313-345)
    float dcs[4];
    for (int a = 0; a < 4; ++a) dcs[a] = sc[a] - m[a];
    float q[4][4] = {};
    bool has_q[4][4] = {};
    if (p.signed_q) {  // compat: the reference's signed diagonal
      q[0][0] = var_d * cyawv;
      q[1][1] = var_d * syawv;
      q[2][2] = var_th * cyawv;
      q[3][3] = var_th * syawv;
      has_q[0][0] = has_q[1][1] = has_q[2][2] = has_q[3][3] = true;
    } else {  // Q = G V G^T for the (x, y, cos, sin) state
      q[0][0] = var_d * cyawv * cyawv;
      q[0][1] = var_d * cyawv * syawv;
      q[1][1] = var_d * syawv * syawv;
      q[2][2] = var_th * syawv * syawv;
      q[2][3] = -var_th * cyawv * syawv;
      q[3][3] = var_th * cyawv * cyawv;
      has_q[0][0] = has_q[0][1] = has_q[1][1] = true;
      has_q[2][2] = has_q[2][3] = has_q[3][3] = true;
    }
    // the ten sums in one pass over the columns, then ten butterflies side
    // by side (each sum's own order is unchanged)
    float part[4][4] = {};
    for (int k = lane; k < dm; k += 32) {
      const int c = min(k, kSig - 1);
      float dp[4], dmn[4];
      for (int a = 0; a < 4; ++a) {
        dp[a] = sig_p[a * kSig + c] - m[a];
        dmn[a] = sig_m[a * kSig + c] - m[a];
      }
      for (int a = 0; a < 4; ++a)
        for (int b = a; b < 4; ++b)
          part[a][b] += wm[k] * (dp[a] * dp[b] + dmn[a] * dmn[b]);
    }
    float p44[4][4];
    for (int a = 0; a < 4; ++a) {
      for (int b = a; b < 4; ++b) {
        float s = w0 * dcs[a] * dcs[b] + warp_sum(part[a][b]);
        if (has_q[a][b]) s = s + q[a][b];
        p44[a][b] = s;
        p44[b][a] = s;
      }
    }
    // x_pred: vehicle rows only (the landmark rows' +/- L terms cancel)
    for (int i = lane; i < Du; i += 32) {
      const float v = i < 4 ? m[i] : x[i];
      x[i] = v;
      xp0[i] = v;
    }
    // g_a = wm (dps_a - dms_a) of columns 0..3; past them dps_a = dms_a
    if (lane < 4)
      for (int a = 0; a < 4; ++a)
        ga[4 * a + lane] = wm[lane] * ((sig_p[a * kSig + lane] - m[a]) -
                                       (sig_m[a * kSig + lane] - m[a]));
    __syncwarp();
    LES_PHASE(kPhSigma);

    // vehicle-landmark cross rows: L @ g_a, whose terms past column 3 are
    // +/-0 (g_a vanishes there)
    for (int i = 4 + lane; i < dm; i += 32) {
      const float* Li = L + tri(i);
      for (int a = 0; a < 4; ++a) {
        float c = 0.0f;
        for (int k = 0; k < 4; ++k) c += Li[k] * ga[4 * a + k];
        P[tri(i) + a] = c;
      }
    }
    if (lane == 0)
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b <= a; ++b) P[tri(a) + b] = p44[a][b];
    __syncwarp();
    LES_PHASE(kPhCross);

    // ---- pass 1: landmark updates in id order (:370-560)
    for (int j = 0; j < N; ++j) {
      const float m_u = kSlam ? vis[j] * seen[j] : vis[j];
      if (predicated && !(m_u > 0.0f)) continue;
      const float rnj = rn[j], bnj = bn[j];
      const int li = 4 + 2 * j;
      const float lmx_c = kSlam ? xp0[li] : lmx[j];
      const float lmy_c = kSlam ? xp0[li + 1] : lmy[j];
      // sigma columns k < kz see the landmark each their own way; past kz
      // the landmark rows of L vanish and every column is column kSig - 1
      // at the landmark's mean
      const int kz = kSlam ? li + 2 : Du;
      const float* Lx = L + tri(li);
      const float* Ly = L + tri(li + 1);

      // z of sigma column k (c: its vehicle rows' column)
      auto z_col = [&](int k, int c) {
        ZCol z;
        float lxp = lmx_c, lxm = lmx_c, lyp = lmy_c, lym = lmy_c;
        if (kSlam) {
          const float ll0 = k < kz && k <= li ? Lx[k] : 0.0f;
          const float ll1 = k < kz ? Ly[k] : 0.0f;
          lxp = lmx_c + ll0;
          lxm = lmx_c - ll0;
          lyp = lmy_c + ll1;
          lym = lmy_c - ll1;
        }
        z_of(p, lxp, lyp, sig_p[c], sig_p[kSig + c],
             committed ? cyawv : sig_p[2 * kSig + c],
             committed ? syawv : sig_p[3 * kSig + c], z.rp, z.cbp, z.sbp);
        z_of(p, lxm, lym, sig_m[c], sig_m[kSig + c],
             committed ? cyawv : sig_m[2 * kSig + c],
             committed ? syawv : sig_m[3 * kSig + c], z.rm, z.cbm, z.sbm);
        return z;
      };

      // first sweep: the z of every column, kept for the second (columns
      // lane and lane + 32 in registers; past them, Du > 64, recomputed:
      // bitwise the same)
      ZCol zc = {};
      if (kSlam && kz < dm) zc = z_col(Du, kSig - 1);
      auto z_at = [&](int k) {
        return k < kz ? z_col(k, min(k, kSig - 1)) : zc;
      };
      float a_r = 0.0f, a_s = 0.0f, a_c = 0.0f;
      auto first = [&](int k, const ZCol& z) {
        a_r += wm[k] * (z.rp + z.rm);
        a_s += wm[k] * (z.sbp + z.sbm);
        a_c += wm[k] * (z.cbp + z.cbm);
      };
      ZCol zk0 = {}, zk1 = {};
      if (lane < dm) {
        zk0 = z_at(lane);
        first(lane, zk0);
      }
      if (lane + 32 < dm) {
        zk1 = z_at(lane + 32);
        first(lane + 32, zk1);
      }
      for (int k = lane + 64; k < dm; k += 32) first(k, z_at(k));
      float r_c, cb_c, sb_c;
      z_of(p, lmx_c, lmy_c, sc[0], sc[1], committed ? cyawv : sc[2],
           committed ? syawv : sc[3], r_c, cb_c, sb_c);
      const float z_r = w0 * r_c + warp_sum(a_r);
      float z_b, mcb, msb;
      if (p.zero_b_mean) {  // compat: the bearing mean stays 0
        z_b = 0.0f;
        mcb = 1.0f;
        msb = 0.0f;
      } else {
        msb = w0 * sb_c + warp_sum(a_s);
        mcb = w0 * cb_c + warp_sum(a_c);
        z_b = les::atan2p(msb, mcb);
      }
      const float dr_c = r_c - z_r;
      const float db_c = dev_b(cb_c, sb_c, mcb, msb);
      float dev4c[4];
      for (int a = 0; a < 4; ++a) dev4c[a] = sc[a] - x[a];
      LES_PHASE(kPhZ1);

      // second sweep: S entries, sigma-weighted deviation sums, vehicle rows
      // of the cross-covariance, and g = wm (d_p - d_m) for the matvecs
      float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f, a_swr = 0.0f, a_swb = 0.0f;
      float a_hr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float a_hb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      auto second = [&](int k, const ZCol& z) {
        const int c = min(k, kSig - 1);
        const float dr_p = z.rp - z_r, dr_m = z.rm - z_r;
        const float db_p = dev_b(z.cbp, z.sbp, mcb, msb);
        const float db_m = dev_b(z.cbm, z.sbm, mcb, msb);
        const float wk = wm[k];
        a00 += wk * (dr_p * dr_p + dr_m * dr_m);
        a01 += wk * (dr_p * db_p + dr_m * db_m);
        a11 += wk * (db_p * db_p + db_m * db_m);
        a_swr += wk * (dr_p + dr_m);
        a_swb += wk * (db_p + db_m);
        for (int a = 0; a < 4; ++a) {
          const float dpa = sig_p[a * kSig + c] - x[a];
          const float dma = sig_m[a * kSig + c] - x[a];
          a_hr[a] += wk * (dpa * dr_p + dma * dr_m);
          a_hb[a] += wk * (dpa * db_p + dma * db_m);
        }
        if (k < kz) {
          g0[k] = wk * (dr_p - dr_m);
          g1[k] = wk * (db_p - db_m);
        }
      };
      if (lane < dm) second(lane, zk0);
      if (lane + 32 < dm) second(lane + 32, zk1);
      for (int k = lane + 64; k < dm; k += 32) second(k, z_at(k));
      const float s00 = w0 * (dr_c * dr_c) + warp_sum(a00) + p.w00f;
      const float s01 = w0 * (dr_c * db_c) + warp_sum(a01);
      const float s11 = w0 * (db_c * db_c) + warp_sum(a11) + p.w11f;
      const float sw_r = w0 * dr_c + warp_sum(a_swr);
      const float sw_b = w0 * db_c + warp_sum(a_swb);
      float h_r[4], h_b[4];
      for (int a = 0; a < 4; ++a) {
        h_r[a] = w0 * dev4c[a] * dr_c + warp_sum(a_hr[a]);
        h_b[a] = w0 * dev4c[a] * db_c + warp_sum(a_hb[a]);
      }
      __syncwarp();  // g0, g1 written; every lane has read x[0..3]
      LES_PHASE(kPhSweep2);

      const float det_raw = s00 * s11 - s01 * s01;
      const float det = fabsf(det_raw) > 0.0f ? det_raw : 1.0f;
      const float i00 = s11 / det, i01 = -s01 / det, i11 = s00 / det;
      const float nu_r = rnj - z_r;
      const float nu_b = les::wrap(bnj - z_b);
      // sanity gate (:514-526): a refused update coasts instead of going NaN
      const bool sane_b = (fabsf(nu_r) < 2.0f * p.r_max) &&
                          (det_raw > p.det_gate) && (s00 > 0.0f) &&
                          (s11 > 0.0f);
      const float sane = sane_b ? 1.0f : 0.0f;
      rej = rej + m_u * (1.0f - sane);
      const float m_g = m_u * sane;
      // cross-covariance rows (vehicle explicit, landmark delta + L-matvec
      // over k <= min(i, li + 1): g vanishes past kz), gain and state. Row i
      // sums in k order; rows go out longest first, the second round
      // reversed, so a lane with a long row gets a short one
      for (int rd = 0; dm - 1 - 32 * rd >= 0; ++rd) {
        const int i = dm - 1 - 32 * rd - ((rd & 1) ? 31 - lane : lane);
        if (i < 0) continue;
        float cri, cbi;
        if (i < 4) {
          cri = h_r[0];
          cbi = h_b[0];
          for (int a = 1; a < 4; ++a)
            if (i == a) {
              cri = h_r[a];
              cbi = h_b[a];
            }
        } else {
          const float* Li = L + tri(i);
          const int kend = min(i, kz - 1);
          float mr = 0.0f, mb = 0.0f;
          for (int k = 0; k <= kend; ++k) {
            mr += Li[k] * g0[k];
            mb += Li[k] * g1[k];
          }
          const float delta = xp0[i] - x[i];
          cri = delta * sw_r + mr;
          cbi = delta * sw_b + mb;
        }
        const float k0 = (cri * i00 + cbi * i01) * m_g;
        const float k1 = (cri * i01 + cbi * i11) * m_g;
        kc[i] = make_float4(k0, k1, cri, cbi);
        x[i] = les::mad_pinned(k1, nu_b, les::mad_pinned(k0, nu_r, x[i]));
      }
      __syncwarp();
      LES_PHASE(kPhGain);

      // one-pass Joseph form over the lower triangle: entry (r, c), c <= r,
      // from the expression of (i, j) = (c, r). Its products and sums are
      // pinned (mad_pinned), so the two loops below round it alike: which
      // one runs depends on dm, which predication changes
      auto joseph = [&](float* e, const float4& ki, const float4& kj) {
        const float k0i = ki.x, k1i = ki.y, cri = ki.z, cbi = ki.w;
        const float k0j = kj.x, k1j = kj.y;
        const float t_r = les::mad_pinned(k0i, kj.z, __fmul_rn(cri, k0j));
        const float t_b = les::mad_pinned(k1i, kj.w, __fmul_rn(cbi, k1j));
        const float t_x = les::mad_pinned(k0i, k1j, __fmul_rn(k1i, k0j));
        float v = __fsub_rn(-t_r, t_b);
        v = les::mad_pinned(s00, __fmul_rn(k0i, k0j), v);
        v = les::mad_pinned(s01, t_x, v);
        v = les::mad_pinned(s11, __fmul_rn(k1i, k1j), v);
        *e = __fadd_rn(*e, v);
      };
      if (tri(dm) <= 32) {  // localization, Du = 4: an entry a lane
        int r = 0, c = lane;
        while (c > r) c -= ++r;
        if (r < dm) joseph(P + tri(r) + c, kc[c], kc[r]);
      } else {  // lines of two rows (row l and row dm-1-l) a lane
        for (int line = lane; 2 * line < dm; line += 32) {
          const int ra = line, rb = dm - 1 - line;
          const int len = 2 * line + 1 == dm ? line + 1 : dm + 1;
          const float4 kja = kc[ra], kjb = kc[rb];
          for (int cc = 0; cc < len; ++cc) {
            const bool a = cc <= line;
            const int c = a ? cc : cc - line - 1;
            joseph(P + tri(a ? ra : rb) + c, kc[c], a ? kja : kjb);
          }
        }
      }
      __syncwarp();
      LES_PHASE(kPhJoseph);
    }
    __syncwarp();  // every lane is past the loop's reads of seen
    LES_PHASE(kPhJoseph);  // the loop over the landmarks not updated

    // ---- pass 2: insertions (SLAM only; :562-596): fresh W block, zero
    // cross terms; then seen |= vis. Each landmark reads the vehicle rows
    // only, so the lanes take one each
    if (kSlam) {
      const float yaw_now = les::atan2p(x[3], x[2]);
      const float xv = x[0], yv = x[1];
      for (int j = lane; j < N; j += 32) {
        const float m_i = vis[j] * (1.0f - seen[j]);
        if (!predicated || m_i > 0.0f) {
          const int li = 4 + 2 * j;
          const float tb = yaw_now + bn[j];
          const float sx = les::mad_pinned(rn[j], cosf(tb), xv);
          const float sy = les::mad_pinned(rn[j], sinf(tb), yv);
          if (m_i > 0.0f) {
            x[li] = sx;
            x[li + 1] = sy;
            P[tri(li) + li] = p.w00f;
            P[tri(li + 1) + li + 1] = p.w11f;
          }
        }
        seen[j] = les::max_nan(seen[j], vis[j]);
      }
    }
    __syncwarp();
    LES_PHASE(kPhInsert);

    // ---- error metric (:598-605)
    const float ex = x[0] - tx;
    const float ey = x[1] - ty;
    const float e = sqrtf(ex * ex + ey * ey);
    esum = esum + e;
    emax = les::max_nan(emax, e);
    __syncwarp();
    LES_PHASE(kPhError);
  }
#ifdef LES_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase_cycles[k], clk[k]);
#endif

  if (lane == 0) {
    err_sum[world] = esum;
    err_max[world] = emax;
    rejects_out[world] = rej;
    true_pose[(size_t)world * 3 + 0] = tx;
    true_pose[(size_t)world * 3 + 1] = ty;
    true_pose[(size_t)world * 3 + 2] = tth;
  }
  for (int i = lane; i < Du; i += 32) x_out[(size_t)world * Du + i] = x[i];
  for (int e = lane; e < Du * Du; e += 32) {
    const int r = e / Du, c = e % Du;
    P_out[(size_t)world * Du * Du + e] = r >= c ? P[tri(r) + c] : P[tri(c) + r];
  }
  for (int j = lane; j < N; j += 32)
    seen_out[(size_t)world * N + j] = seen[j] > 0.5f ? 1 : 0;
}

// worlds a block and dynamic shared bytes a block of the launch for N, or
// kErrSmem where a world does not fit
template <bool kSlam>
int launch_shape(int N, int& wpb, size_t& smem) {
  const size_t per_world = (size_t)world_floats(N, kSlam) * sizeof(float);
  if (per_world > kMaxSmem) return kErrSmem;
  wpb = kWorldsPerBlock;
  while (wpb > 1 && wpb * per_world > kMaxSmem) --wpb;
  smem = wpb * per_world;
  return 0;
}

template <bool kSlam>
int launch_ukf(const UkfParams* p, const float* lms, const float* cmds,
               const float* noise, uint32_t seed, int B, int T, int N,
               int predicated, float* err_sum, float* err_max, float* rejects,
               float* true_pose, float* x, float* P, uint8_t* seen,
               void* stream) {
  int wpb = 0;
  size_t smem = 0;
  const int rc = launch_shape<kSlam>(N, wpb, smem);
  if (rc != 0) return rc;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ukf_rollout_kernel<kSlam>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + wpb - 1) / wpb);
  fused_ukf_rollout_kernel<kSlam><<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
      *p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
      rejects, true_pose, x, P, seen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int les_kernel_occupancy(const void* fn, int threads, int smem,
                                    int* out);  // occupancy.cu

// The launch of N landmarks as the card takes it: out = registers a thread,
// local (spill) bytes a thread, static shared bytes a block, blocks an SM,
// worlds a block, dynamic shared bytes a block.
extern "C" int les_ukf_occupancy(int slam, int N, int* out) {
  int wpb = 0;
  size_t smem = 0;
  const int rc = slam ? launch_shape<true>(N, wpb, smem)
                      : launch_shape<false>(N, wpb, smem);
  if (rc != 0) return rc;
  out[4] = wpb;
  out[5] = (int)smem;
  const void* fn = slam ? (const void*)fused_ukf_rollout_kernel<true>
                        : (const void*)fused_ukf_rollout_kernel<false>;
  return les_kernel_occupancy(fn, 32 * wpb, (int)smem, out);
}

// Copies the phase counters of the -DLES_PHASE_CLOCKS build into out
// (n = kPhases entries) and, with reset, zeroes them. Any other build has no
// counters and returns cudaErrorNotSupported.
extern "C" int les_ukf_phase_clocks(unsigned long long* out, int n,
                                    int reset) {
#ifdef LES_PHASE_CLOCKS
  if (n != kPhases) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
#else
  (void)out;
  (void)n;
  (void)reset;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" int les_fused_ukf_rollout(
    const UkfParams* p, const float* lms, const float* cmds,
    const float* noise, uint32_t seed, int B, int T, int N, int slam,
    int predicated, float* err_sum, float* err_max, float* rejects,
    float* true_pose, float* x, float* P, uint8_t* seen, void* stream) {
  if (slam)
    return launch_ukf<true>(p, lms, cmds, noise, seed, B, T, N, predicated,
                            err_sum, err_max, rejects, true_pose, x, P, seen,
                            stream);
  return launch_ukf<false>(p, lms, cmds, noise, seed, B, T, N, predicated,
                           err_sum, err_max, rejects, true_pose, x, P, seen,
                           stream);
}
