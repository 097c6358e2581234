// Fused sim + EKF-SLAM and RI-EKF-SLAM Monte-Carlo rollouts: the whole T-tick
// rollout of every world in one launch.
//
// Replaces the Pallas TPU kernel live_ekf_slam_tpu/ops/fused_rollout.py,
// function fused_ekf_rollout (kernel body _make_kernel): with
// filter_kind="ekf" as fused_ekf_rollout_kernel<false, ., .>, and with
// filter_kind="iekf" (fused_iekf_rollout) as fused_ekf_rollout_kernel<true, ., .>.
// The scalar helpers of ops/kernel_math.py are inlined (kernel_math.cuh) and a
// Philox stream takes the place of the TPU's on-core PRNG.
//
// Per tick and world: truth propagation with clipped uniform command noise;
// FOV and range cull plus noisy range-bearing for all N landmarks; the
// predict; for each landmark in id order an update then a masked insertion;
// the running error sum and max. EKF: the predict as rank-1 row then column
// updates, the update with the gain from P columns, H P from P rows and one
// fused rank-2 downdate. RI-EKF: F = I and one full rank-1 yaw-noise pass,
// constant H = [-I | 0 | +I] with the exp retraction of every landmark pair,
// and an insertion that copies the vehicle rows; it ignores the EKF compat
// quirks (stale landmarks, unwrapped innovation), as the JAX kernel does.
//
// What bounds it on the card. A world is one long serial chain: 1000 ticks,
// each up to N sequential rank-2 downdates of a D x D covariance (D = 3+2N,
// 43 at N = 20), and for the RI-EKF one more full rank-1 pass per tick.
// Device memory is not the limit: at B = 4096, T = 1000, N = 20 the kernel
// reads about 33 MB of commands and writes about 30 MB of covariance, once.
// The limit is the latency and instruction throughput of that chain in
// shared memory.
//
// What the design does about it. One warp per world, four worlds per block.
// Each world's P stays in shared memory for the whole rollout (row stride D,
// odd, so a warp reading a column, lane i at row i, hits 32 distinct banks),
// with x, the gain and H P scratch vectors, the tick's noise and measurements
// beside it: about 8.9 KB a world at N = 20. A world with nothing to update
// or insert for a landmark skips it with a warp-uniform branch (the TPU
// kernel can only skip per block of 256 worlds). Lanes own covariance rows;
// __syncwarp() separates the read and write phases where the order of the
// JAX kernel matters. Registers hold the truth pose and the error stats.
//
// The pose stream (the JAX kernel's emit_traj=True output, _make_kernel lines
// 604-610) is a third template parameter: per tick the estimated pose x[0:3]
// and the true pose go to est_traj and true_traj, both (B, T, 3). A warp
// stages kTrajTicks ticks of its world in shared memory and then stores them
// as two contiguous runs of 3 * kTrajTicks floats, so the writes are
// coalesced and land in the layout the caller reads (the TPU's (T, 8, B)
// with two pad rows was its tile shape). With kEmitTraj = false nothing of
// it is compiled in: the instantiation is the kernel it was before.
//
// The phase-attribution modes (the JAX kernel's profile_mode, _make_kernel
// lines 188-194 and 268) are a fourth template parameter, not a run-time
// branch, so that the full kernels compile to what they compiled to without
// it. kModeSim ends every tick after the noise draw, truth propagation and
// sensing, with the error against the estimate that never moves: x, P and
// seen leave the kernel as they were initialised. kModeNoLm adds the predict
// and skips the landmark loop, so seen stays empty. Their times, taken from
// the full kernel's, split a rollout into simulator, predict and landmark
// loop. The JAX kernel's fourth name, "downdate", has no branch there and
// runs the full tick; the wrapper maps it to kModeFull.
//
// Numerics. Operation order follows the JAX kernel wherever results depend
// on it (see the comments below). nvcc contracts a*b+c into FMA by default,
// which the JAX and torch versions do not: that, not the algorithm, is why
// the card-side comparisons carry a tolerance. No fast-math: IEEE sqrtf and
// division, full-accuracy sinf and cosf.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_math.cuh"
#include "motion.cuh"
#include "philox.cuh"

// Mirror of live_ekf_slam_tpu_torch/convert.py:KernelParams (field order and
// types must match).
struct EkfParams {
  float v00f, v11f, w00f, w11f;
  float v00s, v11s, w00s, w11s;
  float v_d, v_th, w_r, w_b;
  float d_max, th_max, r_max, fov_min, fov_max;
  float x0, y0, yaw0;
  float cm_v_fwd, cm_2v_fwd, cm_4v_fwd, cm_6v_fwd, cm_floor_fwd;
  float cm_v_hdg, cm_2v_hdg, cm_4v_hdg, cm_6v_hdg, cm_floor_hdg;
  int calibrated, stale, wrap_innov;
};

namespace {

constexpr int kWorldsPerBlock = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a Hopper block can use
constexpr int kErrSmem = 100000;     // launcher's own code: see les_error_string
constexpr int kTrajTicks = 32;       // ticks of the pose stream staged per store
// where a tick ends: after the whole of it, after the predict, after sensing
constexpr int kModeFull = 0, kModeNoLm = 1, kModeSim = 2;

// floats of shared memory per world: P, then x, x snapshot, pr, pb, hp0,
// hp1 (D each), noise rows, landmark x and y, vis, rn, bn, seen (N each),
// and with the pose stream its staging buffer (estimated, then true poses)
__host__ __device__ inline int world_floats(int n, bool emit_traj) {
  const int d = 3 + 2 * n;
  return les::round_up(d * d + 6 * d + les::round_up(2 * n + 8, 4) + 6 * n, 4) +
         (emit_traj ? 6 * kTrajTicks : 0);
}

// Per-world working set in shared memory.
struct World {
  float* P;    // D x D, row stride D
  float* x;    // D
  float* xc;   // D: state snapshot after predict (stale-landmark compat);
               // the RI-EKF's correction xi
  float* pr;   // D: P h_r^T; the RI-EKF predict's yaw-noise column g
  float* pb;   // D: P h_b^T
  float* hp0;  // D: h_r P, and the first new row at insertion
  float* hp1;  // D: h_b P, and the second new row at insertion
  float* u;    // 2N+8 noise rows of the tick (padded to 4)
  float* lmx;  // N true landmark positions
  float* lmy;
  float* vis;  // N visibility of the tick
  float* rn;   // N noisy ranges
  float* bn;   // N noisy bearings
  float* seen; // N
  float* traj; // 6 kTrajTicks: staged pose stream (kEmitTraj only)
};

// EKF update with landmark j (fused_rollout.py:384-468). m_u is 0 or 1: a
// world with m_u = 0 gets K = 0, so x and P come out unchanged; the
// predicated kernel skips the call for it instead.
__device__ __forceinline__ void ekf_update(const EkfParams& p, const World& w, int D, int li,
                           float m_u, float rnj, float bnj, int lane) {
  float* P = w.P;
  const float xv = w.x[0], yv = w.x[1], thv = w.x[2];
  // compat: landmark from the snapshot taken after predict (:388-390)
  const float* xl = p.stale ? w.xc : w.x;
  const float ddx = xl[li] - xv;
  const float ddy = xl[li + 1] - yv;
  const float d2 = les::max_nan(ddx * ddx + ddy * ddy, 1e-12f);
  const float dist = sqrtf(d2);
  const float a_r = ddx / dist, b_r = ddy / dist;
  const float a_b = ddy / d2, b_b = ddx / d2;

  // P H^T from P's columns: lane i reads row i (:404-411)
  for (int i = lane; i < D; i += 32) {
    const float* Pi = P + i * D;
    const float c0 = Pi[0], c1 = Pi[1], c2 = Pi[2];
    const float cl0 = Pi[li], cl1 = Pi[li + 1];
    w.pr[i] = (cl0 - c0) * a_r + (cl1 - c1) * b_r;
    w.pb[i] = (c0 - cl0) * a_b + (cl1 - c1) * b_b - c2;
  }
  // H P from P's rows (:457-463): the one-sided spelling (P H^T)^T flips the
  // sign of P's antisymmetric fp32 residue and diverges over long runs
  for (int k = lane; k < D; k += 32) {
    const float r0 = P[k], r1 = P[D + k], r2 = P[2 * D + k];
    const float rl0 = P[li * D + k], rl1 = P[(li + 1) * D + k];
    w.hp0[k] = (rl0 - r0) * a_r + (rl1 - r1) * b_r;
    w.hp1[k] = (r0 - rl0) * a_b + (rl1 - r1) * b_b - r2;
  }
  __syncwarp();

  const float* pr = w.pr;
  const float* pb = w.pb;
  const float s00 = (-a_r * pr[0] - b_r * pr[1] + a_r * pr[li] +
                     b_r * pr[li + 1]) + p.w00f;
  const float s01 =
      -a_r * pb[0] - b_r * pb[1] + a_r * pb[li] + b_r * pb[li + 1];
  const float s10 = a_b * pr[0] - b_b * pr[1] - pr[2] - a_b * pr[li] +
                    b_b * pr[li + 1];
  const float s11 = (a_b * pb[0] - b_b * pb[1] - pb[2] - a_b * pb[li] +
                     b_b * pb[li + 1]) + p.w11f;
  float det = s00 * s11 - s01 * s10;
  det = fabsf(det) > 1e-20f ? det : 1.0f;
  const float i00 = s11 / det, i01 = -s01 / det;
  const float i10 = -s10 / det, i11 = s00 / det;

  const float ang_lm = les::wrap(les::atan2p(ddy, ddx) - thv);
  const float nu_r = rnj - dist - p.w_r;
  float nu_b = bnj - ang_lm - p.w_b;
  if (p.wrap_innov) nu_b = les::wrap(nu_b);  // compat leaves it unwrapped

  // x += K nu (heading re-wrapped, :447-449); P -= K (H P), lane i owns row i
  for (int i = lane; i < D; i += 32) {
    const float k0 = (pr[i] * i00 + pb[i] * i10) * m_u;
    const float k1 = (pr[i] * i01 + pb[i] * i11) * m_u;
    const float xn = w.x[i] + k0 * nu_r + k1 * nu_b;
    w.x[i] = (i == 2) ? les::wrap(xn) : xn;
    float* Pi = P + i * D;
    for (int k = 0; k < D; ++k) Pi[k] = Pi[k] - k0 * w.hp0[k] - k1 * w.hp1[k];
  }
  __syncwarp();
}

// Masked landmark insertion (fused_rollout.py:531-593): the new rows and the
// 2x2 block come from the OLD P, then rows, columns and block are written in
// that order. `ins` is warp-uniform.
__device__ __forceinline__ void ekf_insert(const EkfParams& p, const World& w, int D, int li,
                           bool ins, float rnj, float bnj, int lane) {
  float* P = w.P;
  const float xv = w.x[0], yv = w.x[1], thv = w.x[2];
  const float tb = thv + bnj;
  const float ct = cosf(tb), st = sinf(tb);
  const float ga = -rnj * st;  // G_x(0,2) = G_z(0,1)
  const float gb = rnj * ct;   // G_x(1,2) = G_z(1,1)
  for (int k = lane; k < D; k += 32) {
    w.hp0[k] = P[k] + ga * P[2 * D + k];
    w.hp1[k] = P[D + k] + gb * P[2 * D + k];
  }
  const float p00 = P[0], p01 = P[1], p02 = P[2];
  const float p11 = P[D + 1], p12 = P[D + 2], p22 = P[2 * D + 2];
  const float blk00 = p00 + 2.0f * ga * p02 + ga * ga * p22 +
                      ct * ct * p.w00f + ga * ga * p.w11f;
  const float blk01 = p01 + gb * p02 + ga * p12 + ga * gb * p22 +
                      ct * st * p.w00f + ga * gb * p.w11f;
  const float blk11 = p11 + 2.0f * gb * p12 + gb * gb * p22 +
                      st * st * p.w00f + gb * gb * p.w11f;
  __syncwarp();
  if (!ins) return;
  if (lane == 0) {
    w.x[li] = xv + rnj * ct;
    w.x[li + 1] = yv + rnj * st;
  }
  for (int k = lane; k < D; k += 32) {
    P[li * D + k] = w.hp0[k];
    P[(li + 1) * D + k] = w.hp1[k];
  }
  __syncwarp();
  for (int i = lane; i < D; i += 32) {
    P[i * D + li] = w.hp0[i];
    P[i * D + li + 1] = w.hp1[i];
  }
  __syncwarp();
  if (lane == 0) {
    P[li * D + li] = blk00;
    P[li * D + li + 1] = blk01;
    P[(li + 1) * D + li] = blk01;
    P[(li + 1) * D + li + 1] = blk11;
  }
  __syncwarp();
}

// Rtil = Rhat Jpc W Jpc^T Rhat^T through the unit (c1, s1) of heading plus
// bearing (fused_rollout.py:310-314, 498-501). The off-diagonal entry is
// rt01 = t01 * s1; the caller takes that last product itself.
__device__ __forceinline__ void iekf_rtil(const EkfParams& p, float rn,
                                          float c1, float s1, float& rt00,
                                          float& t01, float& rt11) {
  const float rr2 = rn * rn;
  rt00 = p.w00f * c1 * c1 + p.w11f * rr2 * s1 * s1;
  t01 = (p.w00f - p.w11f * rr2) * c1;
  rt11 = p.w00f * s1 * s1 + p.w11f * rr2 * c1 * c1;
}

// cos and sin of heading + bearing from the row-level cos/sin (:302-307).
__device__ __forceinline__ void iekf_line_of_sight(float th, float bn,
                                                   float& c1, float& s1) {
  const float cth = cosf(th), sth = sinf(th);
  const float cbn = cosf(bn), sbn = sinf(bn);
  c1 = cth * cbn - sth * sbn;
  s1 = sth * cbn + cth * sbn;
}

// RI-EKF predict (fused_rollout.py:207-240): P += var_th g g^T, with the
// yaw-noise column g built from the tick-start x and seen, before the mean
// moves. Entry 3+2jj of g is seen_jj x[4+2jj], entry 4+2jj is
// -seen_jj x[3+2jj]. The caller adds the 2x2 distance-noise block.
__device__ __forceinline__ void iekf_predict(const World& w, int D,
                                             float jac_d, float c, float s,
                                             float var_th, int lane) {
  float* g = w.pr;
  for (int i = lane; i < D; i += 32) {
    float gi;
    if (i == 0) {
      gi = jac_d * s + w.x[1];
    } else if (i == 1) {
      gi = -jac_d * c - w.x[0];
    } else if (i == 2) {
      gi = 1.0f;
    } else {
      const float sj = w.seen[(i - 3) >> 1];
      gi = ((i - 3) & 1) == 0 ? sj * w.x[i + 1] : -sj * w.x[i - 1];
    }
    g[i] = gi;
  }
  __syncwarp();
  for (int i = lane; i < D; i += 32) {
    const float vg = var_th * g[i];
    float* Pi = w.P + i * D;
    for (int k = 0; k < D; ++k) Pi[k] = Pi[k] + vg * g[k];
  }
  __syncwarp();
}

// RI-EKF update with landmark j (fused_rollout.py:292-382): constant
// H = [-I | 0 | +I], Cartesian innovation, exp retraction of every
// translation pair from the pre-update x. m_u = 0 gives xi = 0, an exact
// identity.
__device__ __forceinline__ void iekf_update(const EkfParams& p, const World& w,
                                            int D, int N, int li, float m_u,
                                            float rnj, float bnj, int lane) {
  float* P = w.P;
  float* xi = w.xc;
  // every read of x comes before the first write (:297-300, :351)
  const float xv = w.x[0], yv = w.x[1], thv = w.x[2];
  const float lmx = w.x[li], lmy = w.x[li + 1];
  float c1, s1, rt00, t01, rt11;
  iekf_line_of_sight(thv, bnj, c1, s1);
  const float yw0 = rnj * c1, yw1 = rnj * s1;
  iekf_rtil(p, rnj, c1, s1, rt00, t01, rt11);

  // P H^T from P's columns, H P from P's rows
  for (int i = lane; i < D; i += 32) {
    const float* Pi = P + i * D;
    w.pr[i] = Pi[li] - Pi[0];
    w.pb[i] = Pi[li + 1] - Pi[1];
  }
  for (int k = lane; k < D; k += 32) {
    w.hp0[k] = P[li * D + k] - P[k];
    w.hp1[k] = P[(li + 1) * D + k] - P[D + k];
  }
  __syncwarp();

  const float* pr = w.pr;
  const float* pb = w.pb;
  const float s00 = pr[li] - pr[0] + rt00;
  // rt01 = t01 * s1 joins each sum as one FMA: pinned, because nvcc chose
  // so with the pose stream compiled out and otherwise with it compiled in
  const float s01 = les::mad_pinned(t01, s1, pb[li] - pb[0]);
  const float s10 = les::mad_pinned(t01, s1, pr[li + 1] - pr[1]);
  const float s11 = pb[li + 1] - pb[1] + rt11;
  float det = s00 * s11 - s01 * s10;
  det = fabsf(det) > 1e-20f ? det : 1.0f;
  const float i00 = s11 / det, i01 = -s01 / det;
  const float i10 = -s10 / det, i11 = s00 / det;
  const float nu0 = yw0 - (lmx - xv);
  const float nu1 = yw1 - (lmy - yv);
  for (int i = lane; i < D; i += 32) {
    const float k0 = (pr[i] * i00 + pb[i] * i10) * m_u;
    const float k1 = (pr[i] * i01 + pb[i] * i11) * m_u;
    xi[i] = k0 * nu0 + k1 * nu1;
  }
  __syncwarp();

  // exp retraction (:342-368), with the small-angle branch
  const float dth = xi[2];
  const float cd = cosf(dth), sd = sinf(dth);
  const bool small = fabsf(dth) < 1e-6f;
  const float dsafe = small ? 1.0f : dth;
  const float va = small ? 1.0f - dth * dth / 6.0f : sd / dsafe;
  const float vb = small ? 0.5f * dth : (1.0f - cd) / dsafe;
  for (int jj = lane; jj < N; jj += 32) {
    const int a0 = 3 + 2 * jj;
    const float lx = w.x[a0], ly = w.x[a0 + 1];
    const float kx = xi[a0], ky = xi[a0 + 1];
    w.x[a0] = va * kx - vb * ky + cd * lx - sd * ly;
    w.x[a0 + 1] = vb * kx + va * ky + sd * lx + cd * ly;
  }
  if (lane == 0) {
    w.x[0] = va * xi[0] - vb * xi[1] + cd * xv - sd * yv;
    w.x[1] = vb * xi[0] + va * xi[1] + sd * xv + cd * yv;
    w.x[2] = les::wrap(thv + dth);
  }

  // P -= K (H P), lane i owns row i
  for (int i = lane; i < D; i += 32) {
    const float k0 = (pr[i] * i00 + pb[i] * i10) * m_u;
    const float k1 = (pr[i] * i01 + pb[i] * i11) * m_u;
    float* Pi = P + i * D;
    for (int k = 0; k < D; ++k) Pi[k] = Pi[k] - k0 * w.hp0[k] - k1 * w.hp1[k];
  }
  __syncwarp();
}

// RI-EKF insertion (fused_rollout.py:477-529): the new rows copy the OLD
// vehicle-position rows 0 and 1, the corner adds Rtil; rows, columns, then
// the block. `ins` is warp-uniform.
__device__ __forceinline__ void iekf_insert(const EkfParams& p, const World& w,
                                            int D, int li, bool ins, float rnj,
                                            float bnj, int lane) {
  float* P = w.P;
  const float xv = w.x[0], yv = w.x[1];
  float c1, s1, rt00, t01, rt11;
  iekf_line_of_sight(w.x[2], bnj, c1, s1);
  iekf_rtil(p, rnj, c1, s1, rt00, t01, rt11);
  const float rt01 = t01 * s1;
  for (int k = lane; k < D; k += 32) {
    w.hp0[k] = P[k];
    w.hp1[k] = P[D + k];
  }
  const float blk00 = P[0] + rt00;
  const float blk01 = P[1] + rt01;
  const float blk11 = P[D + 1] + rt11;
  __syncwarp();
  if (!ins) return;
  if (lane == 0) {
    w.x[li] = xv + rnj * c1;
    w.x[li + 1] = yv + rnj * s1;
  }
  for (int k = lane; k < D; k += 32) {
    P[li * D + k] = w.hp0[k];
    P[(li + 1) * D + k] = w.hp1[k];
  }
  __syncwarp();
  for (int i = lane; i < D; i += 32) {
    P[i * D + li] = w.hp0[i];
    P[i * D + li + 1] = w.hp1[i];
  }
  __syncwarp();
  if (lane == 0) {
    P[li * D + li] = blk00;
    P[li * D + li + 1] = blk01;
    P[(li + 1) * D + li] = blk01;
    P[(li + 1) * D + li + 1] = blk11;
  }
  __syncwarp();
}

template <bool kInvariant, bool kEmitTraj, int kMode>
__global__ void __launch_bounds__(32 * kWorldsPerBlock)
fused_ekf_rollout_kernel(const EkfParams p, const float* __restrict__ lms,
                         const float* __restrict__ cmds,
                         const float* __restrict__ noise, uint32_t seed,
                         int B, int T, int N, int predicated,
                         float* __restrict__ err_sum,
                         float* __restrict__ err_max,
                         float* __restrict__ true_pose,
                         float* __restrict__ x_out, float* __restrict__ P_out,
                         uint8_t* __restrict__ seen_out,
                         float* __restrict__ est_traj,
                         float* __restrict__ true_traj) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int world = blockIdx.x * (blockDim.x >> 5) + wib;
  if (world >= B) return;  // ragged edge: whole warps leave; no block barrier

  const int D = 3 + 2 * N;
  const int R = 2 * N + 8;
  World w;
  w.P = smem + (size_t)wib * world_floats(N, kEmitTraj);
  w.x = w.P + D * D;
  w.xc = w.x + D;
  w.pr = w.xc + D;
  w.pb = w.pr + D;
  w.hp0 = w.pb + D;
  w.hp1 = w.hp0 + D;
  w.u = w.hp1 + D;
  w.lmx = w.u + les::round_up(R, 4);
  w.lmy = w.lmx + N;
  w.vis = w.lmy + N;
  w.rn = w.vis + N;
  w.bn = w.rn + N;
  w.seen = w.bn + N;
  w.traj = w.P + world_floats(N, false);

  // ---- init (fused_rollout.py:134-147); P0 diag from ekf.cpp:11-18
  for (int i = lane; i < D * D; i += 32) w.P[i] = 0.0f;
  for (int i = lane; i < D; i += 32) w.x[i] = 0.0f;
  for (int j = lane; j < N; j += 32) {
    w.seen[j] = 0.0f;
    w.lmx[j] = lms[((size_t)world * N + j) * 2 + 0];
    w.lmy[j] = lms[((size_t)world * N + j) * 2 + 1];
  }
  __syncwarp();
  if (lane == 0) {
    w.x[0] = p.x0;
    w.x[1] = p.y0;
    w.x[2] = p.yaw0;
    w.P[0] = (float)(0.01 * 0.01);
    w.P[D + 1] = (float)(0.01 * 0.01);
    w.P[2 * D + 2] = (float)(0.005 * 0.005);
  }
  // truth pose and error stats: registers, the same value in every lane
  float tx = p.x0, ty = p.y0, tth = p.yaw0;
  float esum = 0.0f, emax = 0.0f;
  const float* cmd_w = cmds + (size_t)world * T * 2;
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    const float fwd = cmd_w[2 * t];
    const float ang = cmd_w[2 * t + 1];
    if (noise != nullptr) {
      for (int r = lane; r < R; r += 32)
        w.u[r] = noise[((size_t)t * R + r) * B + world];
    } else {
      for (int k = lane; k < (R + 3) / 4; k += 32) {
        const float4 v = les::philox_block(seed, world, t, k);
        w.u[4 * k] = v.x;
        w.u[4 * k + 1] = v.y;
        w.u[4 * k + 2] = v.z;
        w.u[4 * k + 3] = v.w;
      }
    }
    __syncwarp();

    // ---- truth propagation (:163-174): heading deliberately unwrapped
    const float d_n = les::clip(fwd + p.v00s * w.u[0], 0.0f, p.d_max);
    const float h_n = les::clip(ang + p.v11s * w.u[1], -p.th_max, p.th_max);
    tx = tx + d_n * cosf(tth);
    ty = ty + d_n * sinf(tth);
    tth = tth + h_n;

    // ---- sensing, all landmarks (:176-185)
    for (int j = lane; j < N; j += 32) {
      const float dxl = w.lmx[j] - tx;
      const float dyl = w.lmy[j] - ty;
      const float r = sqrtf(dxl * dxl + dyl * dyl);
      const float beta = les::wrap(les::atan2p(dyl, dxl) - tth);
      const bool v = (r <= p.r_max) && (beta > p.fov_min) && (beta < p.fov_max);
      w.vis[j] = v ? 1.0f : 0.0f;
      w.rn[j] = r + p.w00s * w.u[2 + j];
      w.bn[j] = beta + p.w11s * w.u[2 + N + j];
    }

    // ---- "sim" (:188-194): the error against the unmoved estimate, and the
    // tick ends; the barrier keeps the next tick's noise off this tick's reads
    if constexpr (kMode == kModeSim) {
      const float ex = w.x[0] - tx;
      const float ey = w.x[1] - ty;
      const float e = sqrtf(ex * ex + ey * ey);
      esum = esum + e;
      emax = les::max_nan(emax, e);
      __syncwarp();
      continue;
    }

    // ---- EKF predict (:195-259): rows 0 and 1 from row 2, THEN columns 0
    // and 1 from column 2, which holds the updated rows
    const float th = w.x[2];
    const float c = cosf(th), s = sinf(th);
    float eff_d, eff_th, var_d, var_th, jac_d;
    if (p.calibrated) {
      les::motion_moments(p, fwd, ang, eff_d, eff_th, var_d, var_th);
      jac_d = eff_d;
    } else {
      eff_d = fwd + p.v_d;
      eff_th = ang + p.v_th;
      var_d = p.v00f;
      var_th = p.v11f;
      jac_d = fwd;  // F_x from the raw command (ekf.cpp:47-50)
    }
    if constexpr (kInvariant) {
      iekf_predict(w, D, jac_d, c, s, var_th, lane);
    } else {
      const float u0 = -jac_d * s;
      const float u1 = jac_d * c;
      for (int k = lane; k < D; k += 32) {
        const float r2 = w.P[2 * D + k];
        w.P[k] = w.P[k] + u0 * r2;
        w.P[D + k] = w.P[D + k] + u1 * r2;
      }
      __syncwarp();
      for (int i = lane; i < D; i += 32) {
        float* Pi = w.P + i * D;
        const float c2 = Pi[2];
        Pi[0] = Pi[0] + c2 * u0;
        Pi[1] = Pi[1] + c2 * u1;
      }
      __syncwarp();
    }
    if (lane == 0) {
      w.P[0] = w.P[0] + c * c * var_d;
      w.P[1] = w.P[1] + s * c * var_d;
      w.P[D] = w.P[D] + s * c * var_d;
      w.P[D + 1] = w.P[D + 1] + s * s * var_d;
      // the RI-EKF's g[2] = 1 already carried var_th into P[2][2]
      if (!kInvariant) w.P[2 * D + 2] = w.P[2 * D + 2] + var_th;
      w.x[0] = w.x[0] + eff_d * c;
      w.x[1] = w.x[1] + eff_d * s;
      w.x[2] = les::wrap(th + eff_th);
    }
    __syncwarp();
    if (!kInvariant && p.stale) {
      for (int i = lane; i < D; i += 32) w.xc[i] = w.x[i];
      __syncwarp();
    }

    // ---- per landmark in id order: update, insert, then seen |= vis
    // (:278-593). The gates use the tick-start seen: seen[j] changes only
    // at the end of its own iteration. "nolm" runs no iteration (:268).
    for (int j = 0; j < (kMode == kModeFull ? N : 0); ++j) {
      const int li = 3 + 2 * j;
      const float sj = w.seen[j];
      const float vj = w.vis[j];
      const float m_u = vj * sj;
      const float m_i = vj * (1.0f - sj);
      const float rnj = w.rn[j], bnj = w.bn[j];
      if constexpr (kInvariant) {
        if (!predicated || m_u > 0.0f)
          iekf_update(p, w, D, N, li, m_u, rnj, bnj, lane);
        if (!predicated || m_i > 0.0f)
          iekf_insert(p, w, D, li, m_i > 0.0f, rnj, bnj, lane);
      } else {
        if (!predicated || m_u > 0.0f) ekf_update(p, w, D, li, m_u, rnj, bnj, lane);
        if (!predicated || m_i > 0.0f) ekf_insert(p, w, D, li, m_i > 0.0f, rnj, bnj, lane);
      }
      __syncwarp();
      if (lane == 0) w.seen[j] = les::max_nan(sj, vj);
    }
    __syncwarp();

    // ---- error metric (:599-603)
    const float ex = w.x[0] - tx;
    const float ey = w.x[1] - ty;
    const float e = sqrtf(ex * ex + ey * ey);
    esum = esum + e;
    emax = les::max_nan(emax, e);

    // ---- pose stream (:604-610): stage this tick, store a full buffer
    if constexpr (kEmitTraj) {
      const int s = t % kTrajTicks;
      if (lane < 3) {
        w.traj[3 * s + lane] = w.x[lane];
      } else if (lane < 6) {
        w.traj[3 * (kTrajTicks + s) + lane - 3] =
            lane == 3 ? tx : (lane == 4 ? ty : tth);
      }
      if (s == kTrajTicks - 1 || t == T - 1) {
        __syncwarp();
        const size_t base = ((size_t)world * T + (t - s)) * 3;
        for (int i = lane; i < 3 * (s + 1); i += 32) {
          est_traj[base + i] = w.traj[i];
          true_traj[base + i] = w.traj[3 * kTrajTicks + i];
        }
      }
    }
    __syncwarp();
  }

  if (lane == 0) {
    err_sum[world] = esum;
    err_max[world] = emax;
    true_pose[(size_t)world * 3 + 0] = tx;
    true_pose[(size_t)world * 3 + 1] = ty;
    true_pose[(size_t)world * 3 + 2] = tth;
  }
  for (int i = lane; i < D; i += 32) x_out[(size_t)world * D + i] = w.x[i];
  for (int i = lane; i < D * D; i += 32)
    P_out[(size_t)world * D * D + i] = w.P[i];
  for (int j = lane; j < N; j += 32)
    seen_out[(size_t)world * N + j] = w.seen[j] > 0.5f ? 1 : 0;
}

template <bool kInvariant, bool kEmitTraj, int kMode>
int launch_rollout(const EkfParams* p, const float* lms, const float* cmds,
                   const float* noise, uint32_t seed, int B, int T, int N,
                   int predicated, float* err_sum, float* err_max,
                   float* true_pose, float* x, float* P, uint8_t* seen,
                   float* est_traj, float* true_traj, void* stream) {
  const size_t per_world =
      (size_t)world_floats(N, kEmitTraj) * sizeof(float);
  if (per_world > kMaxSmem) return kErrSmem;
  int wpb = kWorldsPerBlock;
  while (wpb > 1 && wpb * per_world > kMaxSmem) --wpb;
  const size_t smem = wpb * per_world;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ekf_rollout_kernel<kInvariant, kEmitTraj, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + wpb - 1) / wpb);
  fused_ekf_rollout_kernel<kInvariant, kEmitTraj, kMode>
      <<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(
          *p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
          true_pose, x, P, seen, est_traj, true_traj);
  return (int)cudaGetLastError();
}

// est_traj and true_traj are both null (no pose stream) or both given, and
// given only with mode kModeFull
template <bool kInvariant>
int dispatch_rollout(const EkfParams* p, const float* lms, const float* cmds,
                     const float* noise, uint32_t seed, int B, int T, int N,
                     int predicated, int mode, float* err_sum, float* err_max,
                     float* true_pose, float* x, float* P, uint8_t* seen,
                     float* est_traj, float* true_traj, void* stream) {
  if ((est_traj == nullptr) != (true_traj == nullptr))
    return (int)cudaErrorInvalidValue;
  if (est_traj != nullptr) {
    if (mode != kModeFull) return (int)cudaErrorInvalidValue;
    return launch_rollout<kInvariant, true, kModeFull>(
        p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
        true_pose, x, P, seen, est_traj, true_traj, stream);
  }
  switch (mode) {
    case kModeFull:
      return launch_rollout<kInvariant, false, kModeFull>(
          p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
          true_pose, x, P, seen, nullptr, nullptr, stream);
    case kModeNoLm:
      return launch_rollout<kInvariant, false, kModeNoLm>(
          p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
          true_pose, x, P, seen, nullptr, nullptr, stream);
    case kModeSim:
      return launch_rollout<kInvariant, false, kModeSim>(
          p, lms, cmds, noise, seed, B, T, N, predicated, err_sum, err_max,
          true_pose, x, P, seen, nullptr, nullptr, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 the full tick, 1 no landmark loop, 2 the simulator only
extern "C" int les_fused_ekf_rollout(
    const EkfParams* p, const float* lms, const float* cmds,
    const float* noise, uint32_t seed, int B, int T, int N, int predicated,
    int mode, float* err_sum, float* err_max, float* true_pose, float* x,
    float* P, uint8_t* seen, float* est_traj, float* true_traj, void* stream) {
  return dispatch_rollout<false>(p, lms, cmds, noise, seed, B, T, N,
                                 predicated, mode, err_sum, err_max, true_pose,
                                 x, P, seen, est_traj, true_traj, stream);
}

extern "C" int les_fused_iekf_rollout(
    const EkfParams* p, const float* lms, const float* cmds,
    const float* noise, uint32_t seed, int B, int T, int N, int predicated,
    int mode, float* err_sum, float* err_max, float* true_pose, float* x,
    float* P, uint8_t* seen, float* est_traj, float* true_traj, void* stream) {
  return dispatch_rollout<true>(p, lms, cmds, noise, seed, B, T, N, predicated,
                                mode, err_sum, err_max, true_pose, x, P, seen,
                                est_traj, true_traj, stream);
}

extern "C" const char* les_error_string(int code) {
  if (code == kErrSmem)
    return "a world's state does not fit the 227 KB of shared memory a block "
           "can use (N too large)";
  return cudaGetErrorString((cudaError_t)code);
}
