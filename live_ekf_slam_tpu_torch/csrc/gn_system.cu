// P3: the Gauss-Newton system of the bulk pose-graph solve, one launch a
// Gauss-Newton step of solve_schur_pcg for a batch of worlds
// (live_ekf_slam_tpu_torch/models/posegraph.py, _schur_system on CUDA
// tensors, through _gn_system). At the iterate (poses, lms) it writes what
// the step's factor, CG loop and line search read:
//
//   d (B, T+1, 3, 3), u (B, T, 3, 3): the damped block-tridiagonal pose part
//     of the Hessian (the chain's Jacobian products and each pose's unary
//     bearing-range block), inactive poses pinned;
//   ab, bb, cb, ar, br (B, T, K): the whitened bearing-range coefficients of
//     the valid measurements (bearing row [ab, bb, cb, -ab, -bb], range row
//     [ar, br, 0, -ar, -br] over (px, py, pth, lx, ly)); the invalid slots
//     are not written: the caller zeroes the buffers once a solve;
//   hll_inv (B, N, 3): the damped 2x2 landmark blocks inverted [xx, xy, yy];
//   gp (B, T+1, 3): the pose gradient -J^T r; gl (B, N, 2): the landmark
//     gradient masked by the active landmarks;
//   rhs (B, T+1, 3) = gp p_active - H_pl H_ll^-1 gl, the reduced system's
//     right-hand side; p_active (B, T+1), l_active (B, N) as floats.
//
// Inputs: the iterate, pose 0's prior (poses_init row 0), the odometry
// moments (posegraph._odom_moments: expected commands (B, T, 2) and
// residual sigmas (B, T, 3)) and validity (B, T), the measurements (range,
// bearing) (B, T, K, 2) and validity (B, T, K), the slot map by column (B, K)
// or per measurement (B, T K) (posegraph.LmSlots), timestep and M (B,), the
// damping (B,), and the sigmas, the log-map and fixed-heading modes from the
// host. float32 throughout, the formulas of posegraph._residuals,
// _jacobians, _meas_coeffs, _grad, _pose_blocks and _lm_hessian_inv, with
// the CUDA functions ATen calls for torch's (sinf, cosf, atan2f, sqrtf,
// rintf, IEEE quotients; wrap divides by 2 pi, as utils/geometry does).
//
// It replaces no Pallas kernel: in the JAX package this is the system part
// of solve_schur_pcg's Gauss-Newton step with its reduced rhs, which XLA
// fuses (live_ekf_slam_tpu/models/posegraph.py:1242-1279). In torch it was
// ~400 operations over the padded (B, T, K) slots a step.
//
// One block a world, kThreads threads; thread p owns pose rows t = p, p + P,
// .. (measurement row t - 1 attaches to pose t):
//  1. Row t from 0: the prior (t = 0), odometry factor t's terms (t < T),
//     factor t-1's (t > 0), then measurement row t-1's valid slots in index
//     order (the unary block, the gradient, the coefficient stores); each
//     valid measurement's H_ll and g_l terms go to the thread's own column of
//     per-landmark partials in shared memory ([landmark][thread]). The
//     thread computes factors t and t-1 itself (their sines again) rather
//     than trade them through shared memory.
//  2. A halving tree over the threads, fixed in order (a warp a partial row:
//     the levels above 16 in registers, the last five by shuffles), gives
//     the landmark sums; a thread a landmark forms H_ll^-1, gl and w =
//     H_ll^-1 gl in shared memory. A world of more landmarks than kGroup
//     walks its rows again for each further group, recomputing the same
//     terms (the sums do not depend on the grouping).
//  3. Row t again: rhs = gp p_active - the sum of its valid slots' H_pl w
//     terms in index order, the coefficients read back from device memory.
// No atomics: the order of every sum is fixed, so two runs give the same
// bits (F7), and the -fmad=false build gives the plain version's bits
// (posegraph._schur_system_reference spells this order, the threads as a
// dimension).
//
// What bounds it: device memory. At 1024 worlds x T = 1000, K = 20, N = 20
// it reads the iterate, the odometry, the validity masks (20 MB) and the
// 4.5% valid measurements, and writes d, u, gp, rhs and the valid slots'
// coefficients: 182 MB, 0.054 ms at 3.35 TB/s. The only local memory is
// sinf's and cosf's 32-byte buffer for arguments beyond 105615, which these
// angles never reach.
#include <cuda_runtime.h>

#include "smem_once.cuh"

namespace {

constexpr int kThreads = 256;  // a world's block (posegraph.SYSTEM_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 5;       // a landmark's: H_ll xx, xy, yy; g_l x, y
// landmarks a walk over the rows keeps partials for: 5 x 20 x 256 floats,
// 100 KB a block, two worlds an SM
constexpr int kGroup = 20;
constexpr float kTwoPi = 6.283185307179586f;

struct Graph {
  const float* poses;        // (B, T+1, 3)
  const float* lms;          // (B, N, 2)
  const float* poses_init;   // (B, T+1, 3): row 0 is the prior's mean
  const float* eff;          // (B, T, 2)
  const float* sig;          // (B, T, 3)
  const unsigned char* odom_valid;  // (B, T)
  const float* meas_rb;      // (B, T, K, 2)
  const unsigned char* meas_valid;  // (B, T, K)
  const int* slot;           // (B, K) or (B, T K)
  const int* timestep;       // (B,)
  const int* m;              // (B,)
  const float* damping;      // (B,)
};

struct System {
  float* d;
  float* u;
  float* ab;
  float* bb;
  float* cb;
  float* ar;
  float* br;
  float* hll_inv;
  float* gp;
  float* gl;
  float* rhs;
  float* p_active;
  float* l_active;
};

struct Shape {
  int T, K, N, by_column, exact_logmap, fix_theta;
  float prior_s[3], meas_s[2];
};

// utils/geometry.wrap_angle: torch divides by 2 pi as a tensor, a true
// quotient (kernel_math.cuh's wrap multiplies by its reciprocal)
__device__ __forceinline__ float wrap(float t) {
  return t - kTwoPi * rintf(t / kTwoPi);
}

// posegraph._logmap_vinv: V(th)^-1 = [[va, vb], [-vb, va]]
__device__ __forceinline__ void logmap_vinv(float th, float& va, float& vb) {
  const bool small = fabsf(th) < 1e-4f;
  const float ts = small ? 1.0f : th;
  const float a = small ? 1.0f - th * th / 6.0f : sinf(th) / ts;
  const float b = small ? th * 0.5f - th * th * th / 24.0f : (1.0f - cosf(th)) / ts;
  const float den = a * a + b * b;
  va = a / den;
  vb = b / den;
}

// odometry factor t: the whitened Jacobians ja = d r / d pose_t, jb =
// d r / d pose_{t+1} (row-major 3 x 3) and the residual, masked
struct Odometry {
  float ja[9], jb[9], r[3];
};

__device__ __forceinline__ void odometry(const Graph& g, const Shape& s,
                                         size_t world, int t, Odometry& o) {
  const float* pa = g.poses + (world * (s.T + 1) + t) * 3;
  const size_t ft = world * s.T + t;
  const float ath = pa[2];
  const float ca = cosf(ath), sa = sinf(ath);
  const float dx = pa[3] - pa[0], dy = pa[4] - pa[1];
  const float lx = ca * dx + sa * dy;
  const float ly = -sa * dx + ca * dy;
  const float lth = wrap(pa[5] - ath);
  const float e0 = g.eff[2 * ft], e1 = g.eff[2 * ft + 1];
  const float s0 = g.sig[3 * ft], s1 = g.sig[3 * ft + 1], s2 = g.sig[3 * ft + 2];
  const bool valid = g.odom_valid[ft] != 0;
  float ja[9] = {-ca, -sa, -sa * dx + ca * dy,
                 sa, -ca, -ca * dx - sa * dy,
                 0.0f, 0.0f, -1.0f};
  float jb[9] = {ca, sa, 0.0f, -sa, ca, 0.0f, 0.0f, 0.0f, 1.0f};
  float r0, r1, r2;
  if (s.exact_logmap) {
    // GTSAM's Pose2 between-factor error; the translation rows of the
    // Jacobians turn by M2 = V^-1(rth) R(-m_th)
    const float cm = cosf(e1), sm = sinf(e1);
    const float ex = lx - e0, ey = ly;
    const float rx = cm * ex + sm * ey;
    const float ry = -sm * ex + cm * ey;
    const float rth = wrap(lth - e1);
    float va, vb;
    logmap_vinv(rth, va, vb);
    r0 = (va * rx + vb * ry) / s0;
    r1 = (-vb * rx + va * ry) / s1;
    r2 = rth / s2;
    const float m00 = va * cm - vb * sm, m01 = va * sm + vb * cm;
    const float m10 = -vb * cm - va * sm, m11 = -vb * sm + va * cm;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a0 = ja[c], a1 = ja[3 + c], b0 = jb[c], b1 = jb[3 + c];
      ja[c] = m00 * a0 + m01 * a1;
      ja[3 + c] = m10 * a0 + m11 * a1;
      jb[c] = m00 * b0 + m01 * b1;
      jb[3 + c] = m10 * b0 + m11 * b1;
    }
  } else {
    r0 = (lx - e0) / s0;
    r1 = (ly - 0.0f) / s1;
    r2 = wrap(lth - e1) / s2;
  }
  const float inv[3] = {1.0f / s0, 1.0f / s1, 1.0f / s2};
  const float mask = valid ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.ja[3 * r + c] = ja[3 * r + c] * inv[r] * mask;
      o.jb[3 * r + c] = jb[3 * r + c] * inv[r] * mask;
    }
  if (s.fix_theta)
#pragma unroll
    for (int r = 0; r < 3; ++r) o.ja[3 * r + 2] = o.jb[3 * r + 2] = 0.0f;
  o.r[0] = valid ? r0 : 0.0f;
  o.r[1] = valid ? r1 : 0.0f;
  o.r[2] = valid ? r2 : 0.0f;
}

// out += a^T b, the rows summed in order
__device__ __forceinline__ void add_mtm(const float* a, const float* b, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = out[3 * i + j] +
                       (a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j]);
}

// out += -(m^T v)
__device__ __forceinline__ void add_neg_mtv(const float* m, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = out[i] + -(m[i] * v[0] + m[3 + i] * v[1] + m[6 + i] * v[2]);
}

// a measurement's whitened coefficients and residual (bearing, range)
struct Measurement {
  float ab, bb, cb, ar, br, rb, rr;
};

__device__ __forceinline__ void measurement(const float* pose, float lx, float ly,
                                            const float* rb, const Shape& s,
                                            Measurement& o) {
  const float mdx = lx - pose[0], mdy = ly - pose[1];
  const float rng = sqrtf(mdx * mdx + mdy * mdy);
  const float rs = rng > 0.0f ? rng : 1.0f;
  const float brg = wrap(atan2f(mdy, mdx) - pose[2]);
  o.rb = wrap(brg - rb[1]) / s.meas_s[0];
  o.rr = (rng - rb[0]) / s.meas_s[1];
  const float r2 = rs * rs;
  o.ab = mdy / r2 / s.meas_s[0];
  o.bb = -mdx / r2 / s.meas_s[0];
  o.cb = s.fix_theta ? 0.0f : -1.0f / s.meas_s[0];
  o.ar = -mdx / rs / s.meas_s[1];
  o.br = -mdy / rs / s.meas_s[1];
}

__global__ void __launch_bounds__(kThreads, 2)
gn_system_kernel(Graph g, System out, Shape s, int group) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t world = blockIdx.x;
  const int T = s.T, K = s.K, N = s.N;
  // part [5 group][P]; lm [N][2]; lsum [5][N]; wl [N][2]; cols [K]
  float* part = sm;
  float* lm = part + kSums * group * kThreads;
  float* lsum = lm + 2 * N;
  float* wl = lsum + kSums * N;
  int* cols = (int*)(wl + 2 * N);
  for (int i = tid; i < 2 * N; i += kThreads) lm[i] = __ldg(g.lms + world * 2 * N + i);
  if (s.by_column)
    for (int k = tid; k < K; k += kThreads) cols[k] = __ldg(g.slot + world * K + k);
  __syncthreads();
  const int* slotw = g.slot + world * (size_t)(s.by_column ? K : T * K);
  const unsigned char* validw = g.meas_valid + world * (size_t)T * K;
  const float* rbw = g.meas_rb + world * (size_t)T * K * 2;
  const float* posew = g.poses + world * (size_t)(T + 1) * 3;
  const size_t mw = world * (size_t)T * K;
  const float lam = __ldg(g.damping + world);
  const int ts = __ldg(g.timestep + world);
  auto slot_of = [&](int e, int k) { return s.by_column ? cols[k] : __ldg(slotw + e); };

  for (int n0 = 0; n0 < N; n0 += group) {
    const int ng = min(group, N - n0);
    const bool first = n0 == 0;
    // each thread's own column: zeroed and filled by that thread alone
    for (int q = 0; q < kSums * ng; ++q) part[q * kThreads + tid] = 0.0f;

    // ---- 1. the rows
    for (int t = tid; t <= T; t += kThreads) {
      float d[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float gr[3] = {0.0f, 0.0f, 0.0f};
      if (first) {
        if (t == 0) {  // the prior on pose 0
          const float* p0 = g.poses_init + world * (size_t)(T + 1) * 3;
          const float rp[3] = {(posew[0] - p0[0]) / s.prior_s[0],
                               (posew[1] - p0[1]) / s.prior_s[1],
                               wrap(posew[2] - p0[2]) / s.prior_s[2]};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float ip = 1.0f / s.prior_s[i];
            d[4 * i] = d[4 * i] + ip * ip;
            gr[i] = gr[i] + -ip * rp[i];
          }
        }
        Odometry o;
        if (t < T) {
          odometry(g, s, world, t, o);
          add_mtm(o.ja, o.ja, d);
          float uu[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          add_mtm(o.ja, o.jb, uu);
          float* ut = out.u + (world * T + t) * 9;
#pragma unroll
          for (int i = 0; i < 9; ++i) ut[i] = uu[i];
          add_neg_mtv(o.ja, o.r, gr);
        }
        if (t > 0) {
          odometry(g, s, world, t - 1, o);
          add_mtm(o.jb, o.jb, d);
          add_neg_mtv(o.jb, o.r, gr);
        }
      }
      if (t > 0) {  // measurement row t - 1, at pose t
        const float* pose = posew + 3 * t;
        float h[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float gm[3] = {0.0f, 0.0f, 0.0f};
        const int e0 = (t - 1) * K;
        for (int k = 0; k < K; ++k) {
          const int e = e0 + k;
          if (!validw[e]) continue;
          const int n = slot_of(e, k);
          if (n < 0 || n >= N) continue;  // no landmark slot: nothing to add
          Measurement ms;
          measurement(pose, lm[2 * n], lm[2 * n + 1], rbw + 2 * e, s, ms);
          const float ub = -ms.rb, ur = -ms.rr;
          const float px = ms.ab * ub + ms.ar * ur;
          const float py = ms.bb * ub + ms.br * ur;
          const float hxx = ms.ab * ms.ab + ms.ar * ms.ar;
          const float hxy = ms.ab * ms.bb + ms.ar * ms.br;
          const float hyy = ms.bb * ms.bb + ms.br * ms.br;
          if (first) {
            out.ab[mw + e] = ms.ab;
            out.bb[mw + e] = ms.bb;
            out.cb[mw + e] = ms.cb;
            out.ar[mw + e] = ms.ar;
            out.br[mw + e] = ms.br;
            h[0] = h[0] + hxx;
            h[1] = h[1] + hxy;
            h[2] = h[2] + ms.ab * ms.cb;
            h[3] = h[3] + hyy;
            h[4] = h[4] + ms.bb * ms.cb;
            h[5] = h[5] + ms.cb * ms.cb;
            gm[0] = gm[0] + px;
            gm[1] = gm[1] + py;
            gm[2] = gm[2] + ms.cb * ub;
          }
          const int j = n - n0;
          if (j >= 0 && j < ng) {
            float* pp = part + j * kThreads + tid;
            const int stride = ng * kThreads;
            pp[0] = pp[0] + hxx;
            pp[stride] = pp[stride] + hxy;
            pp[2 * stride] = pp[2 * stride] + hyy;
            pp[3 * stride] = pp[3 * stride] + -px;
            pp[4 * stride] = pp[4 * stride] + -py;
          }
        }
        if (first) {
          const float hm[9] = {h[0], h[1], h[2], h[1], h[3], h[4], h[2], h[4], h[5]};
#pragma unroll
          for (int i = 0; i < 9; ++i) d[i] = d[i] + hm[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) gr[i] = gr[i] + gm[i];
        }
      }
      if (first) {
        const float act = t <= ts ? 1.0f : 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i) d[4 * i] = d[4 * i] + (lam * d[4 * i] + (1.0f - act));
        if (s.fix_theta) {
          d[8] = d[8] + 1.0f;
          gr[2] = 0.0f;
        }
        float* dt = out.d + (world * (T + 1) + t) * 9;
#pragma unroll
        for (int i = 0; i < 9; ++i) dt[i] = d[i];
        float* gt = out.gp + (world * (T + 1) + t) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) gt[i] = gr[i];
        out.p_active[world * (T + 1) + t] = act;
      }
    }
    __syncthreads();

    // ---- 2. the halving tree over the threads: level h adds thread p + h's
    // partial to thread p's (p < h), h = P/2 .. 1; the levels above 16 in
    // registers
    for (int q = warp; q < kSums * ng; q += kWarps) {
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
      if (lane == 0) lsum[(q / ng) * N + n0 + q % ng] = x[0];
    }
    __syncthreads();
  }

  // the landmarks: H_ll damped and inverted, g_l masked, w = H_ll^-1 g_l
  const int m_used = __ldg(g.m + world);
  for (int l = tid; l < N; l += kThreads) {
    const float act = l < m_used ? 1.0f : 0.0f;
    const float damp = 1.0f + lam;
    const float hxx = lsum[l] * damp + (1.0f - act) + 1e-12f;
    const float hxy = lsum[N + l];
    const float hyy = lsum[2 * N + l] * damp + (1.0f - act) + 1e-12f;
    float det = hxx * hyy - hxy * hxy;
    det = fabsf(det) > 1e-30f ? det : 1.0f;
    const float i0 = hyy / det, i1 = -hxy / det, i2 = hxx / det;
    float* hi = out.hll_inv + (world * N + l) * 3;
    hi[0] = i0;
    hi[1] = i1;
    hi[2] = i2;
    const float gx = lsum[3 * N + l] * act, gy = lsum[4 * N + l] * act;
    out.gl[(world * N + l) * 2] = gx;
    out.gl[(world * N + l) * 2 + 1] = gy;
    out.l_active[world * N + l] = act;
    wl[2 * l] = i0 * gx + i1 * gy;
    wl[2 * l + 1] = i1 * gx + i2 * gy;
  }
  __syncthreads();

  // ---- 3. rhs = gp p_active - H_pl w, row by row (this thread's own writes
  // of gp and of the coefficients read back)
  for (int t = tid; t <= T; t += kThreads) {
    const size_t pt = world * (T + 1) + t;
    float y[3] = {0.0f, 0.0f, 0.0f};
    if (t > 0) {
      const int e0 = (t - 1) * K;
      for (int k = 0; k < K; ++k) {
        const int e = e0 + k;
        if (!validw[e]) continue;
        const int n = slot_of(e, k);
        if (n < 0 || n >= N) continue;
        const float a = out.ab[mw + e], b = out.bb[mw + e], c = out.cb[mw + e];
        const float ar = out.ar[mw + e], br = out.br[mw + e];
        const float wx = wl[2 * n], wy = wl[2 * n + 1];
        const float ub = -(a * wx + b * wy);
        const float ur = -(ar * wx + br * wy);
        y[0] = y[0] + (a * ub + ar * ur);
        y[1] = y[1] + (b * ub + br * ur);
        y[2] = y[2] + c * ub;
      }
    }
    const float act = out.p_active[pt];
#pragma unroll
    for (int i = 0; i < 3; ++i) out.rhs[pt * 3 + i] = out.gp[pt * 3 + i] * act - y[i];
  }
}

int group_of(int N) { return N < kGroup ? N : kGroup; }

// dynamic shared bytes a block: the partials, the landmarks, their sums and
// w, the by-column slots
long system_smem(int K, int N) {
  return ((long)kSums * group_of(N) * kThreads + 9L * N + K) * (long)sizeof(float);
}

}  // namespace

extern "C" int les_kernel_occupancy(const void* fn, int threads, int smem,
                                    int* out);

extern "C" int les_gn_system(
    const float* poses, const float* lms, const float* poses_init,
    const float* eff, const float* sig, const unsigned char* odom_valid,
    const float* meas_rb, const unsigned char* meas_valid, const int* slot,
    int by_column, const int* timestep, const int* m, const float* damping,
    float prior_s0, float prior_s1, float prior_s2, float meas_s0, float meas_s1,
    int exact_logmap, int fix_theta, int B, int T, int K, int N, float* d,
    float* u, float* ab, float* bb, float* cb, float* ar, float* br,
    float* hll_inv, float* gp, float* gl, float* rhs, float* p_active,
    float* l_active, void* stream) {
  const long smem = system_smem(K, N);
  if (B <= 0 || T < 0 || K <= 0 || N <= 0 || smem > les::kMaxSmem ||
      (long)(T + 1) * 9 > 0x7fffffffL || (long)T * K * 2 > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = les::allow_smem<gn_system_kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  const Graph g{poses, lms, poses_init, eff, sig, odom_valid, meas_rb,
                meas_valid, slot, timestep, m, damping};
  const System out{d, u, ab, bb, cb, ar, br, hll_inv, gp, gl, rhs, p_active, l_active};
  const Shape s{T, K, N, by_column, exact_logmap, fix_theta,
                {prior_s0, prior_s1, prior_s2}, {meas_s0, meas_s1}};
  gn_system_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(g, out, s, group_of(N));
  return (int)cudaGetLastError();
}

// The launch at K measurement slots and N landmarks as the card takes it
// (les_block_thomas_occupancy's out[6]; worlds a block 1).
extern "C" int les_gn_system_occupancy(int K, int N, int* out) {
  const long smem = system_smem(K, N);
  if (K <= 0 || N <= 0 || smem > les::kMaxSmem) return (int)cudaErrorInvalidValue;
  out[4] = 1;
  out[5] = (int)smem;
  const int rc =
      les_kernel_occupancy((const void*)gn_system_kernel, kThreads, out[5], out);
  les::forget_smem<gn_system_kernel>();
  return rc;
}
