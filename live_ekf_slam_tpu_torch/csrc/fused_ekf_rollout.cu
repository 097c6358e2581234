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
// Each world's P stays in shared memory for the whole rollout, with x, the
// gain and H P scratch vectors, the tick's noise and measurements beside it:
// 9.1 KB a world at N = 20. Registers hold the truth pose and the error
// stats. Four choices shape the tick:
// * The landmark walk is driven by ballots. Every gate of a tick depends only
//   on the tick-start seen and on vis (seen changes at the end of the tick),
//   so one __ballot_sync a word of 32 ids gives the updates of the tick and
//   one its insertions; the warp visits only their set bits, in id order, an
//   update before an insertion, and seen |= vis is one store a lane at the
//   end of the tick. A world visits ~1 of its N ids a tick, where the TPU
//   kernel masks all N per block of 256 worlds.
// * Only the seen block of P is walked. Rows and columns of a landmark not
//   yet seen hold exactly +0 in P and x, and every pass adds +0 or -0 to
//   them, which leaves +0 (x + k * nu and P - k * h with a zero factor): so
//   the predict, the update vectors, the downdate, the state update and the
//   insertion stop at D_act = 3 + 2 (1 + the highest id seen or visible this
//   tick), and skipping the rest changes no bit. predicated = 0 visits every
//   id and all D rows, with the gains masked to zero, as the TPU kernel does.
// * The rank-1 and rank-2 passes walk float4 chunks. P's row stride Dp is a
//   multiple of 4 (D = 43: 44), so an entry of the D_act x D_act block is
//   one of the four of a 16-byte chunk; the chunks, row by row, are dealt to
//   the lanes in turn (chunk c to lane c mod 32), so the slowest lane walks
//   ceil(D_act * ceil(D_act / 4) / 32) chunks where whole rows gave lanes
//   0-10 two rows of 43. Each row's gain pair is computed once and stored as
//   a float2 in place of the row's P H^T; a chunk takes one 8-byte load of
//   it, one 16-byte load of each H P vector and one load and one store of
//   the four entries: 1.25 shared-memory instructions an entry, where the
//   scalar walk took four. Dp / 4 is odd, so a column read (lane i at row
//   i) meets at most four lanes a bank.
// * Every entry of those passes keeps its expression and operation order,
//   and its products are pinned (les::mad_pinned): P - k0 h0 - k1 h1 of the
//   downdate as two FMAs, P + vg g of the RI-EKF predict as one, where nvcc
//   contracted them before.
//
// The pose stream (the JAX kernel's emit_traj=True output, _make_kernel lines
// 604-610) is a third template parameter: per tick the estimated pose x[0:3]
// and the true pose go to est_traj and true_traj, both (B, T, 3). A warp
// stages kTrajTicks ticks of its world in shared memory and then stores them
// as two contiguous runs of 3 * kTrajTicks floats, so the writes are
// coalesced and land in the layout the caller reads (the TPU's (T, 8, B)
// with two pad rows was its tile shape). With kEmitTraj = false nothing of
// it is compiled in.
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
// runs the full tick; the wrapper maps it to kModeFull. Built with
// -DLES_PHASE_CLOCKS the kernel also counts its cycles by phase of the tick
// (PhaseClock; a measurement build).
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

extern "C" int les_kernel_occupancy(const void* fn, int threads, int smem,
                                    int* out);  // occupancy.cu

namespace {

constexpr int kWorldsPerBlock = 4;
// the blocks an SM should hold at once: a register budget for the compiler
constexpr int kMinBlocksPerSm = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a Hopper block can use
constexpr int kErrSmem = 100000;     // launcher's own code: see les_error_string
constexpr int kTrajTicks = 32;       // ticks of the pose stream staged per store
constexpr unsigned kFull = 0xffffffffu;
// where a tick ends: after the whole of it, after the predict, after sensing
constexpr int kModeFull = 0, kModeNoLm = 1, kModeSim = 2;

// The tick's phases, as the -DLES_PHASE_CLOCKS build counts them. The gains
// and the state update count to kPhSolve.
enum Phase {
  kPhSim, kPhPredict, kPhGate, kPhVectors, kPhSolve, kPhDowndate, kPhInsert,
  kPhError, kPhases
};

#ifdef LES_PHASE_CLOCKS
// Per phase, the clock64() cycles lane 0 of every warp spent in it, summed
// over warps and ticks. A measurement build: the default build compiles none
// of it.
__device__ unsigned long long g_phase_cycles[kPhases];
struct PhaseClock {
  unsigned long long* clk;  // lane 0's counters, in the world's shared memory
  long long t;
  __device__ __forceinline__ void lap(int k, int lane) {
    __syncwarp();
    const long long now = clock64();
    if (lane == 0) clk[k] += (unsigned long long)(now - t);
    t = now;
  }
};
constexpr int kClockFloats = 2 * kPhases;
#else
struct PhaseClock {
  __device__ __forceinline__ void lap(int, int) {}
};
constexpr int kClockFloats = 0;
#endif

// P's row stride: a multiple of 4 (whole float4 chunks) whose quarter is odd
// (a column read, lane i at row i, meets at most four lanes a bank)
__host__ __device__ inline int row_stride(int d) {
  const int dp = les::round_up(d, 4);
  return (dp / 4) % 2 ? dp : dp + 4;
}

// floats of shared memory per world: P (D rows of stride Dp), then x, x
// snapshot, hp0, hp1 (Dp each), P H^T as (pr, pb) pairs (2 Dp), noise rows,
// landmark x and y, vis, rn, bn, seen (N each), and with the pose stream its
// staging buffer (estimated, then true poses)
__host__ __device__ inline int world_floats(int n, bool emit_traj) {
  const int d = 3 + 2 * n;
  const int dp = row_stride(d);
  return les::round_up(d * dp + 6 * dp + les::round_up(2 * n + 8, 4) + 6 * n,
                       4) +
         (emit_traj ? 6 * kTrajTicks : 0) + kClockFloats;
}

// Per-world working set in shared memory.
struct World {
  float* P;    // D x D, row stride Dp
  float* x;    // Dp
  float* xc;   // Dp: state snapshot after predict (stale-landmark compat);
               // the RI-EKF's correction xi
  float* hp0;  // Dp: h_r P, and the first new row at insertion
  float* hp1;  // Dp: h_b P, and the second new row at insertion
  float* prb;  // 2 Dp: (P h_r^T, P h_b^T) of row i at 2i, 2i + 1, then the
               // gain pair (k0, k1) of row i in their place; the RI-EKF
               // predict's yaw-noise column g in the first Dp
  float* u;    // 2N+8 noise rows of the tick (padded to 4)
  float* lmx;  // N true landmark positions
  float* lmy;
  float* vis;  // N visibility of the tick
  float* rn;   // N noisy ranges
  float* bn;   // N noisy bearings
  float* seen; // N
  float* traj; // 6 kTrajTicks: staged pose stream (kEmitTraj only)
};

__device__ __forceinline__ float4 chunk(const float* v, int q) {
  return reinterpret_cast<const float4*>(v)[q];
}

// Rewrites the float4 chunks of P's leading dact x dact block, row by row
// (the last chunk of a row reaches past dact into +0 entries or the row's
// padding, which the passes leave as they are): chunk c goes to lane
// c mod 32, which stores f(row, chunk index in the row, the chunk's value).
// Two chunks a step, both loaded before either is stored, so that the
// loads of the second wait with the first's.
template <class F>
__device__ __forceinline__ void walk_chunks(float* P, int Dp, int dact,
                                            int lane, F&& f) {
  const int Q = (dact + 3) >> 2;
  const int total = dact * Q;
  const int dr = 32 / Q, dq = 32 - dr * Q;  // a step of 32 chunks
  const auto next = [&](int& r, int& q) {
    r += dr;
    q += dq;
    if (q >= Q) {
      q -= Q;
      ++r;
    }
  };
  int r = lane / Q, q = lane - r * Q;
  int c = lane;
  for (; c + 32 < total; c += 64) {
    int r2 = r, q2 = q;
    next(r2, q2);
    float4* e1 = reinterpret_cast<float4*>(P + r * Dp) + q;
    float4* e2 = reinterpret_cast<float4*>(P + r2 * Dp) + q2;
    const float4 v1 = *e1, v2 = *e2;
    const float4 n1 = f(r, q, v1), n2 = f(r2, q2, v2);
    *e1 = n1;
    *e2 = n2;
    r = r2;
    q = q2;
    next(r, q);
  }
  if (c < total) {
    float4* e = reinterpret_cast<float4*>(P + r * Dp) + q;
    *e = f(r, q, *e);
  }
}

// P -= k0 hp0^T + k1 hp1^T over the dact block, the gains from prb: each
// entry as P - k0 hp0 - k1 hp1 in that order (fused_rollout.py:465-468)
__device__ __forceinline__ void rank2_downdate(const World& w, int Dp,
                                               int dact, int lane) {
  walk_chunks(w.P, Dp, dact, lane, [&](int r, int q, float4 v) {
    const float2 k = reinterpret_cast<const float2*>(w.prb)[r];
    const float4 a = chunk(w.hp0, q), b = chunk(w.hp1, q);
    v.x = les::mad_pinned(-k.y, b.x, les::mad_pinned(-k.x, a.x, v.x));
    v.y = les::mad_pinned(-k.y, b.y, les::mad_pinned(-k.x, a.y, v.y));
    v.z = les::mad_pinned(-k.y, b.z, les::mad_pinned(-k.x, a.z, v.z));
    v.w = les::mad_pinned(-k.y, b.w, les::mad_pinned(-k.x, a.w, v.w));
    return v;
  });
}

// EKF update with landmark j (fused_rollout.py:384-468). m_u is 0 or 1: a
// world with m_u = 0 gets K = 0, so x and P come out unchanged; the
// predicated kernel skips the call for it instead.
__device__ __forceinline__ void ekf_update(const EkfParams& p, const World& w,
                                           int Dp, int dact, int li, float m_u,
                                           float rnj, float bnj, int lane,
                                           PhaseClock& pc) {
  const float* P = w.P;
  float* prb = w.prb;
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
  for (int i = lane; i < dact; i += 32) {
    const float* Pi = P + i * Dp;
    const float c0 = Pi[0], c1 = Pi[1], c2 = Pi[2];
    const float cl0 = Pi[li], cl1 = Pi[li + 1];
    prb[2 * i] = (cl0 - c0) * a_r + (cl1 - c1) * b_r;
    prb[2 * i + 1] = (c0 - cl0) * a_b + (cl1 - c1) * b_b - c2;
  }
  // H P from P's rows (:457-463), over the chunks the downdate walks: the
  // one-sided spelling (P H^T)^T flips the sign of P's antisymmetric fp32
  // residue and diverges over long runs
  const int kend = (dact + 3) & ~3;
  for (int k = lane; k < kend; k += 32) {
    const float r0 = P[k], r1 = P[Dp + k], r2 = P[2 * Dp + k];
    const float rl0 = P[li * Dp + k], rl1 = P[(li + 1) * Dp + k];
    w.hp0[k] = (rl0 - r0) * a_r + (rl1 - r1) * b_r;
    w.hp1[k] = (r0 - rl0) * a_b + (rl1 - r1) * b_b - r2;
  }
  __syncwarp();
  pc.lap(kPhVectors, lane);

  const float pr0 = prb[0], pr1 = prb[2], pr2 = prb[4];
  const float pb0 = prb[1], pb1 = prb[3], pb2 = prb[5];
  const float prl0 = prb[2 * li], prl1 = prb[2 * li + 2];
  const float pbl0 = prb[2 * li + 1], pbl1 = prb[2 * li + 3];
  const float s00 = (-a_r * pr0 - b_r * pr1 + a_r * prl0 + b_r * prl1) + p.w00f;
  const float s01 = -a_r * pb0 - b_r * pb1 + a_r * pbl0 + b_r * pbl1;
  const float s10 = a_b * pr0 - b_b * pr1 - pr2 - a_b * prl0 + b_b * prl1;
  const float s11 = (a_b * pb0 - b_b * pb1 - pb2 - a_b * pbl0 + b_b * pbl1) +
                    p.w11f;
  float det = s00 * s11 - s01 * s10;
  det = fabsf(det) > 1e-20f ? det : 1.0f;
  const float i00 = s11 / det, i01 = -s01 / det;
  const float i10 = -s10 / det, i11 = s00 / det;

  const float ang_lm = les::wrap(les::atan2p(ddy, ddx) - thv);
  const float nu_r = rnj - dist - p.w_r;
  float nu_b = bnj - ang_lm - p.w_b;
  if (p.wrap_innov) nu_b = les::wrap(nu_b);  // compat leaves it unwrapped
  __syncwarp();  // every lane has read prb before the gains replace it

  // K = (P H^T) S^-1, row i by lane i, into prb; x += K nu (heading
  // re-wrapped, :447-449)
  for (int i = lane; i < dact; i += 32) {
    const float pr = prb[2 * i], pb = prb[2 * i + 1];
    const float k0 = (pr * i00 + pb * i10) * m_u;
    const float k1 = (pr * i01 + pb * i11) * m_u;
    prb[2 * i] = k0;
    prb[2 * i + 1] = k1;
    const float xn = w.x[i] + k0 * nu_r + k1 * nu_b;
    w.x[i] = (i == 2) ? les::wrap(xn) : xn;
  }
  __syncwarp();
  pc.lap(kPhSolve, lane);
  rank2_downdate(w, Dp, dact, lane);
  __syncwarp();
  pc.lap(kPhDowndate, lane);
}

// Masked landmark insertion (fused_rollout.py:531-593): the new rows and the
// 2x2 block come from the OLD P, then rows, columns and block are written in
// that order. `ins` is warp-uniform.
__device__ __forceinline__ void ekf_insert(const EkfParams& p, const World& w,
                                           int Dp, int dact, int li, bool ins,
                                           float rnj, float bnj, int lane,
                                           PhaseClock& pc) {
  float* P = w.P;
  const float xv = w.x[0], yv = w.x[1], thv = w.x[2];
  const float tb = thv + bnj;
  const float ct = cosf(tb), st = sinf(tb);
  const float ga = -rnj * st;  // G_x(0,2) = G_z(0,1)
  const float gb = rnj * ct;   // G_x(1,2) = G_z(1,1)
  for (int k = lane; k < dact; k += 32) {
    w.hp0[k] = P[k] + ga * P[2 * Dp + k];
    w.hp1[k] = P[Dp + k] + gb * P[2 * Dp + k];
  }
  const float p00 = P[0], p01 = P[1], p02 = P[2];
  const float p11 = P[Dp + 1], p12 = P[Dp + 2], p22 = P[2 * Dp + 2];
  const float blk00 = p00 + 2.0f * ga * p02 + ga * ga * p22 +
                      ct * ct * p.w00f + ga * ga * p.w11f;
  const float blk01 = p01 + gb * p02 + ga * p12 + ga * gb * p22 +
                      ct * st * p.w00f + ga * gb * p.w11f;
  const float blk11 = p11 + 2.0f * gb * p12 + gb * gb * p22 +
                      st * st * p.w00f + gb * gb * p.w11f;
  __syncwarp();
  if (ins) {
    if (lane == 0) {
      w.x[li] = xv + rnj * ct;
      w.x[li + 1] = yv + rnj * st;
    }
    for (int k = lane; k < dact; k += 32) {
      P[li * Dp + k] = w.hp0[k];
      P[(li + 1) * Dp + k] = w.hp1[k];
    }
    __syncwarp();
    for (int i = lane; i < dact; i += 32) {
      P[i * Dp + li] = w.hp0[i];
      P[i * Dp + li + 1] = w.hp1[i];
    }
    __syncwarp();
    if (lane == 0) {
      P[li * Dp + li] = blk00;
      P[li * Dp + li + 1] = blk01;
      P[(li + 1) * Dp + li] = blk01;
      P[(li + 1) * Dp + li + 1] = blk11;
    }
    __syncwarp();
  }
  pc.lap(kPhInsert, lane);
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
// -seen_jj x[3+2jj]; past dact they are +0 or -0, and the chunks' tails
// take +0. The caller adds the 2x2 distance-noise block.
__device__ __forceinline__ void iekf_predict(const World& w, int Dp, int dact,
                                             float jac_d, float c, float s,
                                             float var_th, int lane) {
  float* g = w.prb;
  if (lane == 0) {
    g[0] = jac_d * s + w.x[1];
    g[1] = -jac_d * c - w.x[0];
    g[2] = 1.0f;
  }
  for (int jj = lane; 3 + 2 * jj < dact; jj += 32) {
    const float sj = w.seen[jj];
    g[3 + 2 * jj] = sj * w.x[4 + 2 * jj];
    g[4 + 2 * jj] = -sj * w.x[3 + 2 * jj];
  }
  if (dact + lane < ((dact + 3) & ~3)) g[dact + lane] = 0.0f;
  __syncwarp();
  walk_chunks(w.P, Dp, dact, lane, [&](int r, int q, float4 v) {
    const float vg = var_th * g[r];
    const float4 gk = chunk(g, q);
    v.x = les::mad_pinned(vg, gk.x, v.x);
    v.y = les::mad_pinned(vg, gk.y, v.y);
    v.z = les::mad_pinned(vg, gk.z, v.z);
    v.w = les::mad_pinned(vg, gk.w, v.w);
    return v;
  });
  __syncwarp();
}

// RI-EKF update with landmark j (fused_rollout.py:292-382): constant
// H = [-I | 0 | +I], Cartesian innovation, exp retraction of every
// translation pair from the pre-update x. m_u = 0 gives xi = 0, an exact
// identity.
__device__ __forceinline__ void iekf_update(const EkfParams& p, const World& w,
                                            int Dp, int dact, int li, float m_u,
                                            float rnj, float bnj, int lane,
                                            PhaseClock& pc) {
  const float* P = w.P;
  float* prb = w.prb;
  float* xi = w.xc;
  // every read of x comes before the first write (:297-300, :351)
  const float xv = w.x[0], yv = w.x[1], thv = w.x[2];
  float c1, s1, rt00, t01, rt11;
  iekf_line_of_sight(thv, bnj, c1, s1);
  const float nu0 = rnj * c1 - (w.x[li] - xv);
  const float nu1 = rnj * s1 - (w.x[li + 1] - yv);
  iekf_rtil(p, rnj, c1, s1, rt00, t01, rt11);

  // P H^T from P's columns, H P from P's rows
  for (int i = lane; i < dact; i += 32) {
    const float* Pi = P + i * Dp;
    prb[2 * i] = Pi[li] - Pi[0];
    prb[2 * i + 1] = Pi[li + 1] - Pi[1];
  }
  const int kend = (dact + 3) & ~3;
  for (int k = lane; k < kend; k += 32) {
    w.hp0[k] = P[li * Dp + k] - P[k];
    w.hp1[k] = P[(li + 1) * Dp + k] - P[Dp + k];
  }
  __syncwarp();
  pc.lap(kPhVectors, lane);

  const float s00 = prb[2 * li] - prb[0] + rt00;
  // rt01 = t01 * s1 joins each sum as one FMA: pinned, because nvcc chose
  // so with the pose stream compiled out and otherwise with it compiled in
  const float s01 = les::mad_pinned(t01, s1, prb[2 * li + 1] - prb[1]);
  const float s10 = les::mad_pinned(t01, s1, prb[2 * li + 2] - prb[2]);
  const float s11 = prb[2 * li + 3] - prb[3] + rt11;
  float det = s00 * s11 - s01 * s10;
  det = fabsf(det) > 1e-20f ? det : 1.0f;
  const float i00 = s11 / det, i01 = -s01 / det;
  const float i10 = -s10 / det, i11 = s00 / det;
  __syncwarp();  // every lane has read prb before the gains replace it
  for (int i = lane; i < dact; i += 32) {
    const float pr = prb[2 * i], pb = prb[2 * i + 1];
    const float k0 = (pr * i00 + pb * i10) * m_u;
    const float k1 = (pr * i01 + pb * i11) * m_u;
    prb[2 * i] = k0;
    prb[2 * i + 1] = k1;
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
  for (int jj = lane; 3 + 2 * jj < dact; jj += 32) {
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
  pc.lap(kPhSolve, lane);
  rank2_downdate(w, Dp, dact, lane);
  __syncwarp();
  pc.lap(kPhDowndate, lane);
}

// RI-EKF insertion (fused_rollout.py:477-529): the new rows copy the OLD
// vehicle-position rows 0 and 1, the corner adds Rtil; rows, columns, then
// the block. `ins` is warp-uniform.
__device__ __forceinline__ void iekf_insert(const EkfParams& p, const World& w,
                                            int Dp, int dact, int li, bool ins,
                                            float rnj, float bnj, int lane,
                                            PhaseClock& pc) {
  float* P = w.P;
  const float xv = w.x[0], yv = w.x[1];
  float c1, s1, rt00, t01, rt11;
  iekf_line_of_sight(w.x[2], bnj, c1, s1);
  iekf_rtil(p, rnj, c1, s1, rt00, t01, rt11);
  const float rt01 = t01 * s1;
  for (int k = lane; k < dact; k += 32) {
    w.hp0[k] = P[k];
    w.hp1[k] = P[Dp + k];
  }
  const float blk00 = P[0] + rt00;
  const float blk01 = P[1] + rt01;
  const float blk11 = P[Dp + 1] + rt11;
  __syncwarp();
  if (ins) {
    if (lane == 0) {
      w.x[li] = xv + rnj * c1;
      w.x[li + 1] = yv + rnj * s1;
    }
    for (int k = lane; k < dact; k += 32) {
      P[li * Dp + k] = w.hp0[k];
      P[(li + 1) * Dp + k] = w.hp1[k];
    }
    __syncwarp();
    for (int i = lane; i < dact; i += 32) {
      P[i * Dp + li] = w.hp0[i];
      P[i * Dp + li + 1] = w.hp1[i];
    }
    __syncwarp();
    if (lane == 0) {
      P[li * Dp + li] = blk00;
      P[li * Dp + li + 1] = blk01;
      P[(li + 1) * Dp + li] = blk01;
      P[(li + 1) * Dp + li + 1] = blk11;
    }
    __syncwarp();
  }
  pc.lap(kPhInsert, lane);
}

template <bool kInvariant, bool kEmitTraj, int kMode>
__global__ void __launch_bounds__(32 * kWorldsPerBlock, kMinBlocksPerSm)
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
  extern __shared__ float4 smem4[];  // 16-byte aligned: the passes' chunks
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int world = blockIdx.x * (blockDim.x >> 5) + wib;
  if (world >= B) return;  // ragged edge: whole warps leave; no block barrier

  const int D = 3 + 2 * N;
  const int Dp = row_stride(D);
  const int R = 2 * N + 8;
  World w;
  w.P = reinterpret_cast<float*>(smem4) +
        (size_t)wib * world_floats(N, kEmitTraj);
  w.x = w.P + D * Dp;
  w.xc = w.x + Dp;
  w.hp0 = w.xc + Dp;
  w.hp1 = w.hp0 + Dp;
  w.prb = w.hp1 + Dp;
  w.u = w.prb + 2 * Dp;
  w.lmx = w.u + les::round_up(R, 4);
  w.lmy = w.lmx + N;
  w.vis = w.lmy + N;
  w.rn = w.vis + N;
  w.bn = w.rn + N;
  w.seen = w.bn + N;
  w.traj = w.P + world_floats(N, false) - kClockFloats;
  PhaseClock pc;
#ifdef LES_PHASE_CLOCKS
  pc.clk = reinterpret_cast<unsigned long long*>(
      w.P + world_floats(N, kEmitTraj) - kClockFloats);
  if (lane == 0)
    for (int k = 0; k < kPhases; ++k) pc.clk[k] = 0;
  pc.t = clock64();
#endif

  // ---- init (fused_rollout.py:134-147); P0 diag from ekf.cpp:11-18. P's
  // padding columns stay +0: the chunk passes read and rewrite them
  for (int i = lane; i < D * Dp; i += 32) w.P[i] = 0.0f;
  for (int i = lane; i < Dp; i += 32) w.x[i] = 0.0f;
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
    w.P[Dp + 1] = (float)(0.01 * 0.01);
    w.P[2 * Dp + 2] = (float)(0.005 * 0.005);
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
    pc.lap(kPhSim, lane);

    // ---- "sim" (:188-194): the error against the unmoved estimate, and the
    // tick ends; the barrier keeps the next tick's noise off this tick's reads
    if constexpr (kMode == kModeSim) {
      const float ex = w.x[0] - tx;
      const float ey = w.x[1] - ty;
      const float e = sqrtf(ex * ex + ey * ey);
      esum = esum + e;
      emax = les::max_nan(emax, e);
      __syncwarp();
      pc.lap(kPhError, lane);
      continue;
    }

    // ---- the block of P this tick touches: ids past the highest one seen
    // or visible have +0 rows and columns (lane j wrote vis[j] and seen[j])
    int dact = D;
    if (predicated) {
      int hi = -1;
      for (int j0 = 0; j0 < N; j0 += 32) {
        const int j = j0 + lane;
        const unsigned m = __ballot_sync(
            kFull, j < N && (w.seen[j] > 0.0f || w.vis[j] > 0.0f));
        if (m) hi = j0 + 31 - __clz(m);
      }
      dact = 3 + 2 * (hi + 1);
    }
    pc.lap(kPhGate, lane);

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
      iekf_predict(w, Dp, dact, jac_d, c, s, var_th, lane);
    } else {
      const float u0 = -jac_d * s;
      const float u1 = jac_d * c;
      for (int k = lane; k < dact; k += 32) {
        const float r2 = w.P[2 * Dp + k];
        w.P[k] = w.P[k] + u0 * r2;
        w.P[Dp + k] = w.P[Dp + k] + u1 * r2;
      }
      __syncwarp();
      for (int i = lane; i < dact; i += 32) {
        float* Pi = w.P + i * Dp;
        const float c2 = Pi[2];
        Pi[0] = Pi[0] + c2 * u0;
        Pi[1] = Pi[1] + c2 * u1;
      }
      __syncwarp();
    }
    if (lane == 0) {
      w.P[0] = w.P[0] + c * c * var_d;
      w.P[1] = w.P[1] + s * c * var_d;
      w.P[Dp] = w.P[Dp] + s * c * var_d;
      w.P[Dp + 1] = w.P[Dp + 1] + s * s * var_d;
      // the RI-EKF's g[2] = 1 already carried var_th into P[2][2]
      if (!kInvariant) w.P[2 * Dp + 2] = w.P[2 * Dp + 2] + var_th;
      w.x[0] = w.x[0] + eff_d * c;
      w.x[1] = w.x[1] + eff_d * s;
      w.x[2] = les::wrap(th + eff_th);
    }
    __syncwarp();
    if (!kInvariant && p.stale) {
      for (int i = lane; i < dact; i += 32) w.xc[i] = w.x[i];
      __syncwarp();
    }
    pc.lap(kPhPredict, lane);

    // ---- per landmark in id order: update, insert (:278-593). The gates
    // use the tick-start seen, so a ballot a word of 32 ids gives them all;
    // predicated = 0 visits every id. "nolm" runs no iteration (:268).
    if constexpr (kMode == kModeFull) {
      for (int j0 = 0; j0 < N; j0 += 32) {
        const int jl = j0 + lane;
        const float sl = jl < N ? w.seen[jl] : 0.0f;
        const float vl = jl < N ? w.vis[jl] : 0.0f;
        unsigned um = N - j0 >= 32 ? kFull : (1u << (N - j0)) - 1u;
        unsigned im = um;
        if (predicated) {
          um = __ballot_sync(kFull, vl * sl > 0.0f);
          im = __ballot_sync(kFull, vl * (1.0f - sl) > 0.0f);
        }
        for (unsigned todo = um | im; todo != 0u; todo &= todo - 1u) {
          const int b = __ffs(todo) - 1;
          const int j = j0 + b;
          const int li = 3 + 2 * j;
          const float sj = w.seen[j];
          const float vj = w.vis[j];
          const float m_u = vj * sj;
          const float m_i = vj * (1.0f - sj);
          const float rnj = w.rn[j], bnj = w.bn[j];
          pc.lap(kPhGate, lane);
          if ((um >> b) & 1u) {
            if constexpr (kInvariant)
              iekf_update(p, w, Dp, dact, li, m_u, rnj, bnj, lane, pc);
            else
              ekf_update(p, w, Dp, dact, li, m_u, rnj, bnj, lane, pc);
          }
          if ((im >> b) & 1u) {
            if constexpr (kInvariant)
              iekf_insert(p, w, Dp, dact, li, m_i > 0.0f, rnj, bnj, lane, pc);
            else
              ekf_insert(p, w, Dp, dact, li, m_i > 0.0f, rnj, bnj, lane, pc);
          }
        }
      }
      // seen |= vis, once for the tick: the walk has read every seen[j]
      __syncwarp();
      for (int j = lane; j < N; j += 32)
        w.seen[j] = les::max_nan(w.seen[j], w.vis[j]);
    }
    __syncwarp();
    pc.lap(kPhGate, lane);

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
    pc.lap(kPhError, lane);
  }
#ifdef LES_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase_cycles[k], pc.clk[k]);
#endif

  if (lane == 0) {
    err_sum[world] = esum;
    err_max[world] = emax;
    true_pose[(size_t)world * 3 + 0] = tx;
    true_pose[(size_t)world * 3 + 1] = ty;
    true_pose[(size_t)world * 3 + 2] = tth;
  }
  for (int i = lane; i < D; i += 32) x_out[(size_t)world * D + i] = w.x[i];
  for (int r = 0; r < D; ++r)
    for (int k = lane; k < D; k += 32)
      P_out[((size_t)world * D + r) * D + k] = w.P[r * Dp + k];
  for (int j = lane; j < N; j += 32)
    seen_out[(size_t)world * N + j] = w.seen[j] > 0.5f ? 1 : 0;
}

// worlds a block and dynamic shared bytes a block of the launch for N, or
// kErrSmem where a world does not fit
template <bool kEmitTraj>
int launch_shape(int N, int& wpb, size_t& smem) {
  const size_t per_world = (size_t)world_floats(N, kEmitTraj) * sizeof(float);
  if (per_world > kMaxSmem) return kErrSmem;
  wpb = kWorldsPerBlock;
  while (wpb > 1 && wpb * per_world > kMaxSmem) --wpb;
  smem = wpb * per_world;
  return 0;
}

template <bool kInvariant, bool kEmitTraj, int kMode>
int launch_rollout(const EkfParams* p, const float* lms, const float* cmds,
                   const float* noise, uint32_t seed, int B, int T, int N,
                   int predicated, float* err_sum, float* err_max,
                   float* true_pose, float* x, float* P, uint8_t* seen,
                   float* est_traj, float* true_traj, void* stream) {
  int wpb = 0;
  size_t smem = 0;
  const int rc = launch_shape<kEmitTraj>(N, wpb, smem);
  if (rc != 0) return rc;
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

template <bool kInvariant, bool kEmitTraj, int kMode>
int occupancy_of(int N, int* out) {
  int wpb = 0;
  size_t smem = 0;
  const int rc = launch_shape<kEmitTraj>(N, wpb, smem);
  if (rc != 0) return rc;
  out[4] = wpb;
  out[5] = (int)smem;
  return les_kernel_occupancy(
      (const void*)fused_ekf_rollout_kernel<kInvariant, kEmitTraj, kMode>,
      32 * wpb, (int)smem, out);
}

template <bool kInvariant>
int occupancy_mode(int emit_traj, int mode, int N, int* out) {
  if (emit_traj)
    return mode == kModeFull ? occupancy_of<kInvariant, true, kModeFull>(N, out)
                             : (int)cudaErrorInvalidValue;
  switch (mode) {
    case kModeFull:
      return occupancy_of<kInvariant, false, kModeFull>(N, out);
    case kModeNoLm:
      return occupancy_of<kInvariant, false, kModeNoLm>(N, out);
    case kModeSim:
      return occupancy_of<kInvariant, false, kModeSim>(N, out);
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

// The launch of N landmarks as the card takes it, for the instantiation
// <invariant, emit_traj, mode>: out = registers a thread, local (spill)
// bytes a thread, static shared bytes a block, blocks an SM, worlds a block,
// dynamic shared bytes a block.
extern "C" int les_ekf_occupancy(int invariant, int emit_traj, int mode, int N,
                                 int* out) {
  return invariant ? occupancy_mode<true>(emit_traj, mode, N, out)
                   : occupancy_mode<false>(emit_traj, mode, N, out);
}

// Copies the phase counters of the -DLES_PHASE_CLOCKS build into out
// (n = kPhases entries) and, with reset, zeroes them. Any other build has no
// counters and returns cudaErrorNotSupported.
extern "C" int les_ekf_phase_clocks(unsigned long long* out, int n,
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

extern "C" const char* les_error_string(int code) {
  if (code == kErrSmem)
    return "a world's state does not fit the 227 KB of shared memory a block "
           "can use (N too large)";
  return cudaGetErrorString((cudaError_t)code);
}
