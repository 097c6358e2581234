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
// multiply-adds), and each update runs two L-matvecs and a Du x Du Joseph
// pass. Device memory is not the limit: at B = 4096, T = 1000, N = 20 the
// kernel reads about 33 MB of commands and writes about 32 MB of covariance,
// once. The limit is the latency of the pivot-by-pivot Cholesky, whose steps
// depend on each other, and the instruction throughput of the shared-memory
// passes.
//
// What the design does about it. One warp per world, four worlds per block.
// P and the Cholesky factor L stay in shared memory for the whole rollout,
// row stride Du | 1 (odd, so a warp reading a column hits distinct banks),
// beside x, the predicted mean, the sigma weights, the eight sigma-row
// vectors and six scratch vectors: about 19.5 KB a world at N = 20. Lanes own
// rows of P and L for the factorisation, the matvecs and the Joseph pass, and
// sigma columns for the weighted sums, which end in butterfly shuffles (every
// lane gets the same bits). Only the lower triangle of L is computed; the
// Joseph pass computes each entry with i <= j once and mirrors it, so P stays
// exactly symmetric whatever nvcc contracts into FMA. Pivots past a world's
// highest seen slot, and landmarks a world does not update or insert, are
// skipped with warp-uniform branches (the TPU kernel skips per block of 128
// worlds); skipped or not, the result is the same.
//
// Numerics. Operation order follows the JAX kernel wherever it is not a sum
// over sigma columns or a matvec; those sums run in another order here, which
// the plain torch version copies (fused_ukf.py: lane_sum, row_dot), so that
// built with -fmad=false the kernel equals it bit for bit. nvcc contracts
// a*b+c into FMA by default, which is why the comparison of the default build
// with the plain version carries a tolerance. No fast-math: IEEE sqrtf and
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

constexpr int kWorldsPerBlock = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a Hopper block can use
constexpr int kErrSmem = 100000;     // les_error_string (fused_ekf_rollout.cu)
constexpr float kCholEps = 1e-8f;

__host__ __device__ inline int state_dim(int n, bool slam) {
  return slam ? 4 + 2 * n : 4;
}

// floats of shared memory per world: P and L (Du rows of stride Du | 1),
// then x, the predicted mean, the sigma weights, 8 sigma-row vectors and 6
// scratch vectors (Du each), the tick's noise rows, landmark x and y, vis,
// rn, bn, seen (N each)
__host__ __device__ inline int world_floats(int n, bool slam) {
  const int du = state_dim(n, slam);
  return les::round_up(2 * du * (du | 1) + 17 * du +
                           les::round_up(2 * n + 8, 4) + 6 * n,
                       4);
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

template <bool kSlam>
__global__ void __launch_bounds__(32 * kWorldsPerBlock)
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
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int world = blockIdx.x * (blockDim.x >> 5) + wib;
  if (world >= B) return;  // ragged edge: whole warps leave; no block barrier

  const int Du = state_dim(N, kSlam);
  const int S = Du | 1;  // row stride of P and L
  const int R = 2 * N + 8;
  float* P = smem + (size_t)wib * world_floats(N, kSlam);
  float* L = P + Du * S;
  float* x = L + Du * S;
  float* xp0 = x + Du;    // predicted mean, before this tick's updates
  float* wm = xp0 + Du;   // weight of each +/- sigma column pair
  float* pxn = wm + Du;   // propagated sigma rows, + half ...
  float* pyn = pxn + Du;
  float* pcn = pyn + Du;
  float* psn = pcn + Du;
  float* mxn = psn + Du;  // ... and - half
  float* myn = mxn + Du;
  float* mcn = myn + Du;
  float* msn = mcn + Du;
  float* g0 = msn + Du;   // scratch: predict's g_a (4 rows); update's
  float* g1 = g0 + Du;    // g_r, g_b, c_r, c_b, k0, k1
  float* g2 = g1 + Du;
  float* g3 = g2 + Du;
  float* k0v = g3 + Du;
  float* k1v = k0v + Du;
  float* u = k1v + Du;
  float* lmx = u + les::round_up(R, 4);
  float* lmy = lmx + N;
  float* vis = lmy + N;
  float* rn = vis + N;
  float* bn = rn + N;
  float* seen = bn + N;
  const float* sig_p[4] = {pxn, pyn, pcn, psn};
  const float* sig_m[4] = {mxn, myn, mcn, msn};
  const float w0 = p.w0;

  // ---- init (fused_ukf.py:120-134); P0 diag from ukf.cpp:9-18
  for (int i = lane; i < Du * S; i += 32) {
    P[i] = 0.0f;
    L[i] = 0.0f;
  }
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
    P[0] = (float)(0.01 * 0.01);
    P[S + 1] = (float)(0.01 * 0.01);
    P[2 * S + 2] = (float)(0.005 * 0.005);
    P[3 * S + 3] = (float)(0.005 * 0.005);
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
    for (int k = lane; k < Du; k += 32)
      wm[k] = wbar * (k < 4 ? 1.0f : seen[(k - 4) >> 1]);
    // L = lower triangle of P * scale (the upper one stays zero)
    for (int i = lane; i < Du; i += 32)
      for (int k = 0; k <= i; ++k) L[i * S + k] = P[i * S + k] * scale;
    __syncwarp();

    // pivot-clamped Cholesky in place (:205-245); pivots past the world's
    // highest seen slot are exact no-ops (rows and columns of unseen slots
    // are zero) and are skipped
    const int dmax = kSlam && predicated ? 4 + 2 * top : Du;
    for (int j = 0; j < Du; ++j) {
      if (j >= 4 && j >= dmax) break;
      const float pivot = L[j * S + j];
      const float ok = pivot > kCholEps ? 1.0f : 0.0f;
      const float dval = sqrtf(les::max_nan(pivot, kCholEps));
      const float f = ok / dval;
      for (int i = j + 1 + lane; i < Du; i += 32) L[i * S + j] = L[i * S + j] * f;
      __syncwarp();
      if (lane == 0) L[j * S + j] = dval;
      for (int i = j + 1 + lane; i < Du; i += 32) {
        const float bi = L[i * S + j];
        float* Li = L + i * S;
        for (int k = j + 1; k <= i; ++k) Li[k] = Li[k] - bi * L[k * S + j];
      }
      __syncwarp();
    }

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

    // sigma vehicle rows, column k of L is sigma pair k (:247-296)
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = lane; k < Du; k += 32) {
      const float la0 = L[k], la1 = L[S + k], la2 = L[2 * S + k];
      const float la3 = L[3 * S + k];
      propagate(xv0 + la0, xv1 + la1, xc + la2, xs + la3, mv, ca, sa, pxn[k],
                pyn[k], pcn[k], psn[k]);
      propagate(xv0 - la0, xv1 - la1, xc - la2, xs - la3, mv, ca, sa, mxn[k],
                myn[k], mcn[k], msn[k]);
      for (int a = 0; a < 4; ++a) acc[a] += wm[k] * (sig_p[a][k] + sig_m[a][k]);
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
    float p44[4][4];
    for (int a = 0; a < 4; ++a) {
      for (int b = a; b < 4; ++b) {
        float part = 0.0f;
        for (int k = lane; k < Du; k += 32) {
          const float dpa = sig_p[a][k] - m[a], dpb = sig_p[b][k] - m[b];
          const float dma = sig_m[a][k] - m[a], dmb = sig_m[b][k] - m[b];
          part += wm[k] * (dpa * dpb + dma * dmb);
        }
        float s = w0 * dcs[a] * dcs[b] + warp_sum(part);
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
    // vehicle-landmark cross rows: L @ g_a, g_a = wm (dps_a - dms_a)
    float* ga[4] = {g0, g1, g2, g3};
    for (int k = lane; k < Du; k += 32)
      for (int a = 0; a < 4; ++a)
        ga[a][k] = wm[k] * ((sig_p[a][k] - m[a]) - (sig_m[a][k] - m[a]));
    __syncwarp();
    for (int i = 4 + lane; i < Du; i += 32) {
      const float* Li = L + i * S;
      for (int a = 0; a < 4; ++a) {
        float c = 0.0f;
        for (int k = 0; k <= i; ++k) c += Li[k] * ga[a][k];
        P[a * S + i] = c;
        P[i * S + a] = c;
      }
    }
    if (lane == 0)
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) P[a * S + b] = p44[a][b];
    __syncwarp();

    // ---- pass 1: landmark updates in id order (:370-560)
    const bool committed = p.committed_yaw != 0;
    for (int j = 0; j < N; ++j) {
      const float m_u = kSlam ? vis[j] * seen[j] : vis[j];
      if (predicated && !(m_u > 0.0f)) continue;
      const float rnj = rn[j], bnj = bn[j];
      const int li = 4 + 2 * j;
      const float lmx_c = kSlam ? xp0[li] : lmx[j];
      const float lmy_c = kSlam ? xp0[li + 1] : lmy[j];

      // z of sigma column k (recomputed in the second sweep: bitwise the same)
      auto z_col = [&](int k, float& r_p, float& cb_p, float& sb_p, float& r_m,
                       float& cb_m, float& sb_m) {
        float lxp = lmx_c, lxm = lmx_c, lyp = lmy_c, lym = lmy_c;
        if (kSlam) {
          const float ll0 = L[li * S + k], ll1 = L[(li + 1) * S + k];
          lxp = lmx_c + ll0;
          lxm = lmx_c - ll0;
          lyp = lmy_c + ll1;
          lym = lmy_c - ll1;
        }
        z_of(p, lxp, lyp, pxn[k], pyn[k], committed ? cyawv : pcn[k],
             committed ? syawv : psn[k], r_p, cb_p, sb_p);
        z_of(p, lxm, lym, mxn[k], myn[k], committed ? cyawv : mcn[k],
             committed ? syawv : msn[k], r_m, cb_m, sb_m);
      };

      float a_r = 0.0f, a_s = 0.0f, a_c = 0.0f;
      for (int k = lane; k < Du; k += 32) {
        float r_p, cb_p, sb_p, r_m, cb_m, sb_m;
        z_col(k, r_p, cb_p, sb_p, r_m, cb_m, sb_m);
        a_r += wm[k] * (r_p + r_m);
        a_s += wm[k] * (sb_p + sb_m);
        a_c += wm[k] * (cb_p + cb_m);
      }
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

      // second sweep: S entries, sigma-weighted deviation sums, vehicle rows
      // of the cross-covariance, and g = wm (d_p - d_m) for the matvecs
      float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f, a_swr = 0.0f, a_swb = 0.0f;
      float a_hr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float a_hb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = lane; k < Du; k += 32) {
        float r_p, cb_p, sb_p, r_m, cb_m, sb_m;
        z_col(k, r_p, cb_p, sb_p, r_m, cb_m, sb_m);
        const float dr_p = r_p - z_r, dr_m = r_m - z_r;
        const float db_p = dev_b(cb_p, sb_p, mcb, msb);
        const float db_m = dev_b(cb_m, sb_m, mcb, msb);
        const float wk = wm[k];
        a00 += wk * (dr_p * dr_p + dr_m * dr_m);
        a01 += wk * (dr_p * db_p + dr_m * db_m);
        a11 += wk * (db_p * db_p + db_m * db_m);
        a_swr += wk * (dr_p + dr_m);
        a_swb += wk * (db_p + db_m);
        for (int a = 0; a < 4; ++a) {
          const float dpa = sig_p[a][k] - x[a];
          const float dma = sig_m[a][k] - x[a];
          a_hr[a] += wk * (dpa * dr_p + dma * dr_m);
          a_hb[a] += wk * (dpa * db_p + dma * db_m);
        }
        g0[k] = wk * (dr_p - dr_m);
        g1[k] = wk * (db_p - db_m);
      }
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
      __syncwarp();

      // cross-covariance rows: vehicle explicit, landmark delta + L-matvec
      float* c_r = g2;
      float* c_b = g3;
      for (int i = lane; i < Du; i += 32) {
        if (i < 4) {
          c_r[i] = h_r[i];
          c_b[i] = h_b[i];
        } else {
          const float* Li = L + i * S;
          float mr = 0.0f, mb = 0.0f;
          for (int k = 0; k <= i; ++k) {
            mr += Li[k] * g0[k];
            mb += Li[k] * g1[k];
          }
          const float delta = xp0[i] - x[i];
          c_r[i] = delta * sw_r + mr;
          c_b[i] = delta * sw_b + mb;
        }
      }

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
      __syncwarp();  // every lane has read x[0..3] before they change
      for (int i = lane; i < Du; i += 32) {
        const float k0 = (c_r[i] * i00 + c_b[i] * i01) * m_g;
        const float k1 = (c_r[i] * i01 + c_b[i] * i11) * m_g;
        k0v[i] = k0;
        k1v[i] = k1;
        x[i] = x[i] + k0 * nu_r + k1 * nu_b;
      }
      __syncwarp();
      // one-pass Joseph form, each entry with i <= j once and mirrored
      for (int i = lane; i < Du; i += 32) {
        const float k0i = k0v[i], k1i = k1v[i], cri = c_r[i], cbi = c_b[i];
        for (int jj = i; jj < Du; ++jj) {
          const float k0j = k0v[jj], k1j = k1v[jj];
          const float v = -(k0i * c_r[jj] + cri * k0j) -
                          (k1i * c_b[jj] + cbi * k1j) + s00 * (k0i * k0j) +
                          s01 * (k0i * k1j + k1i * k0j) + s11 * (k1i * k1j);
          const float pij = P[i * S + jj] + v;
          P[i * S + jj] = pij;
          P[jj * S + i] = pij;
        }
      }
      __syncwarp();
    }

    // ---- pass 2: insertions (SLAM only; :562-596): fresh W block, zero
    // cross terms; then seen |= vis
    if (kSlam) {
      const float yaw_now = les::atan2p(x[3], x[2]);
      for (int j = 0; j < N; ++j) {
        const float m_i = vis[j] * (1.0f - seen[j]);
        if (predicated && !(m_i > 0.0f)) continue;
        const int li = 4 + 2 * j;
        const float tb = yaw_now + bn[j];
        const float sx = x[0] + rn[j] * cosf(tb);
        const float sy = x[1] + rn[j] * sinf(tb);
        __syncwarp();
        if (m_i > 0.0f && lane == 0) {
          x[li] = sx;
          x[li + 1] = sy;
          P[li * S + li] = p.w00f;
          P[(li + 1) * S + li + 1] = p.w11f;
        }
        __syncwarp();
      }
      for (int j = lane; j < N; j += 32) seen[j] = les::max_nan(seen[j], vis[j]);
    }
    __syncwarp();

    // ---- error metric (:598-605)
    const float ex = x[0] - tx;
    const float ey = x[1] - ty;
    const float e = sqrtf(ex * ex + ey * ey);
    esum = esum + e;
    emax = les::max_nan(emax, e);
    __syncwarp();
  }

  if (lane == 0) {
    err_sum[world] = esum;
    err_max[world] = emax;
    rejects_out[world] = rej;
    true_pose[(size_t)world * 3 + 0] = tx;
    true_pose[(size_t)world * 3 + 1] = ty;
    true_pose[(size_t)world * 3 + 2] = tth;
  }
  for (int i = lane; i < Du; i += 32) x_out[(size_t)world * Du + i] = x[i];
  for (int e = lane; e < Du * Du; e += 32)
    P_out[(size_t)world * Du * Du + e] = P[(e / Du) * S + e % Du];
  for (int j = lane; j < N; j += 32)
    seen_out[(size_t)world * N + j] = seen[j] > 0.5f ? 1 : 0;
}

template <bool kSlam>
int launch_ukf(const UkfParams* p, const float* lms, const float* cmds,
               const float* noise, uint32_t seed, int B, int T, int N,
               int predicated, float* err_sum, float* err_max, float* rejects,
               float* true_pose, float* x, float* P, uint8_t* seen,
               void* stream) {
  const size_t per_world = (size_t)world_floats(N, kSlam) * sizeof(float);
  if (per_world > kMaxSmem) return kErrSmem;
  int wpb = kWorldsPerBlock;
  while (wpb > 1 && wpb * per_world > kMaxSmem) --wpb;
  const size_t smem = wpb * per_world;
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
