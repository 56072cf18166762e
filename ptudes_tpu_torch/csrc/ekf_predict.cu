// K1: the whole per-scan EKF predict block in one launch.
//
// Replaces ptudes_tpu/ops/pallas_ekf.py:predict_block_pallas (kernel
// _make_kernel): K IMU mechanization steps (position, velocity, rotation-
// matrix attitude by Rodrigues; invalid samples skipped; the first valid
// sample of an uninitialised filter only latches the clock), the covariance
// chain P <- F P F^T + W with per-step symmetrisation, and the epilogue
// deskew twist log(T_in^-1 T_out).
//
// What bounds it on the card: latency, not bytes or FLOPs. The state is
// ~1.3 KB and K <= 64 steps of 18x18 products are ~0.4 MFLOP; the chain is
// serial in k, so the floor is the launch plus K short dependent steps. The
// TPU kernel builds F as a dense 18x18 matrix for the MXU, but F is the
// identity plus five 3x3 blocks ((POS, VEL) = dt I, (VEL, PHI) = -dt R
// hat(a), (VEL, BA) = -dt R, (PHI, PHI) = Rd^T, (PHI, BG) = -dt I): no row
// has more than 7 nonzeros, and rows BG and BA are the identity's.
//
// Design: one CTA of 10 warps. On this chain the step is latency-bound:
// with a warp or two per scheduler, a step costs about what its longest
// thread's instructions cost one after another, so the design keeps every
// thread's share of a step short and free of tests.
// - Warp 0 runs the nav. Lane k (and k + 32) loads step k's IMU row. The
//   clock (ts, init, eff_k = ok_k init, dt_k) is a warp max-scan: ts
//   before step k is the largest valid timestamp so far (with the carried
//   ts once the filter is initialised), init the largest valid flag, so
//   the latch rule holds and every value is the serial chain's bit for
//   bit. Lane k forms rd_k = rodrigues((w_k - bg) dt_k) and a_k - ba. In
//   the 3x3 attitude chain lane e < 9 owns element e of r: a step is three
//   shuffles of its row and matmul3's three-term sum for that element, so
//   the chain is the serial one's bit for bit. Lane k then writes F's rows
//   0-8 of step k to shared memory. After one CTA barrier warp 0 runs the
//   pos/vel chain (all lanes in lockstep, step k's values shuffled from
//   lane k), the quaternion and the twist, beside the covariance.
// - Warps 1-9 run the K covariance steps, one phase and one named barrier
//   each: the pair (i <= j) gets F_i P F_j^T + W_ij from F's nonzeros only
//   (POS rows 2, VEL 7, PHI 4, the rest 1), written to (i, j) and (j, i)
//   of the other P buffer. P is symmetric in storage (symmetrised once
//   when staged), so this is the TPU kernel's per-step symmetrised
//   F P F^T + W up to the order of the sums. A pair's terms are split over
//   up to 8 lanes (one term of its shorter row each, times the longer row
//   padded to 7 terms), summed by shuffles; the schedule is a table fixed
//   at compile time (make_cov_table), so a step is the same straight-line
//   code in every lane, with no test per term.
// The nav's scalar expressions are the serial version's, in the same order.
//
// The filter history (the JAX package's log path runs the unrolled XLA
// chain for it): with a non-null hist, each step's row is stored from the
// values that carry the state: warp 0's pos/vel chain (the lane that holds
// the step), its attitude record (rows' quaternions from r after the step,
// by the lane of the step) and the diagonal pairs' sums as the covariance
// threads write them to P. The kernel is built twice: the instance without
// the history has a constant null hist, so its stores and tests fold away
// (its code is the size it had before the history; a test at run time cost
// ~1 us a launch at K = 12-16).
#include "common.cuh"

namespace {

constexpr int S = 18;
constexpr int SS = S * S;
constexpr int POS = 0, VEL = 3, PHI = 6, BG = 9, BA = 12;
constexpr int kMaxSteps = 64;
constexpr int kCovWarps = 9;                 // 282 lanes for 171 pairs
constexpr int kCovThreads = 32 * kCovWarps;
constexpr int kThreads = 32 + kCovThreads;   // warp 0: the nav
constexpr int kFRows = 9;                    // F's rows POS, VEL, PHI
constexpr int kTerms = 7;                    // most nonzeros in a row of F
constexpr int kPad = 8;                      // a row's coefficients: 2 x 16 B
constexpr int kScal = 22;
constexpr unsigned kFull = 0xffffffffu;
// a history row: ts, pos[3], vel[3], quat[4], bias_gyr[3], bias_acc[3],
// grav[3], the covariance diagonal after the step[18]
constexpr int kHist = 38;
constexpr int kHistPos = 1, kHistVel = 4, kHistQuat = 7, kHistScal = 11,
              kHistCov = 20;

// scal input: pos[3] vel[3] quat[4] bg[3] ba[3] grav[3] ts init (22)
// imu input:  [K, 8] rows lacc[3] avel[3] ts valid
// out:        pos[3] vel[3] quat[4] ts init twist[6]           (18)
// The attitude chain runs in rotation-matrix form, like the TPU kernel;
// the quaternion conversions at both ends are done here too.
struct Smem {
  float P[2][SS];
  float4 coef[kMaxSteps][kFRows][kPad / 4];  // F's rows 0-8 of step k
  float4 ident[kPad / 4];                    // F's rows 9-17: 1, then 0
  float dt[kMaxSteps];
  float scal[kScal];
};

// The attitude chain's inputs and its record (apart from Smem, so the
// chain's loads can move ahead of its stores).
struct Chain {
  float rd[kMaxSteps][9];
  float eff[kMaxSteps];
};
struct Attitudes {
  float r[kMaxSteps + 1][9];  // r[k]: the attitude before step k
};

// One IMU step as its lane holds it (ok = 0 past the block).
struct Step {
  float t = 0.0f, ok = 0.0f, eff = 0.0f, dt = 0.0f;
  float ab[3] = {}, w[3] = {}, acc[3] = {};
};

__device__ __forceinline__ void cov_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCovThreads) : "memory");
}

// The nonzeros of F's row j: POS 2, VEL 7, PHI 4, the rest 1.
__host__ __device__ constexpr int row_terms(int j) {
  return j < VEL ? 2 : (j < PHI ? kTerms : (j < BG ? 4 : 1));
}

// The columns of F's row j, in term order: POS rows (j, VEL + j), VEL rows
// (j, PHI.., BA..), PHI rows (PHI.., BG + j), the rest (j).
__host__ __device__ constexpr int term_col(int j, int m) {
  if (j < VEL) return m == 1 ? VEL + j : j;
  if (j < PHI) return m == 0 ? j : (m <= 3 ? PHI + m - 1 : BA + m - 4);
  if (j < BG) return m < 3 ? PHI + m : (m == 3 ? BG + j - PHI : j);
  return j;
}

// ---- the nav (warp 0)

// The inclusive max-scan of v over the warp's lanes.
__device__ __forceinline__ float warp_max_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = fmaxf(v, u);
  }
  return v;
}

// ts before a step from the largest valid timestamp before it (-inf: none)
// and the carried clock: a fresh filter's first valid sample resets ts,
// later ones (and every one of an initialised filter) take the max.
__device__ __forceinline__ float clock_ts(float t_max, float ts0,
                                          float init0) {
  if (init0 > 0.0f) return fmaxf(t_max, ts0);
  return t_max > -INFINITY ? t_max : ts0;
}

// A step's eff and dt from the valid flags and timestamps before it
// (ok_ex, t_ex: their maxima) and the carried clock.
__device__ __forceinline__ void clock_step(Step& st, float ok_ex, float t_ex,
                                           float ts0, float init0) {
  const float init_b = fmaxf(init0, ok_ex);
  const float ts_b = clock_ts(t_ex, ts0, init0);
  st.eff = st.ok * init_b;
  st.dt = fmaxf(st.t - ts_b, 0.0f) * st.eff;
}

// The clock of steps lane (lo) and lane + 32 (hi): each keeps its eff and
// dt; ts and init become the block's end clock.
__device__ __forceinline__ void clock_scan(Step& lo, Step& hi, int lane,
                                           float& ts, float& init) {
  const float ts0 = ts, init0 = init;
  const float ok_in0 = warp_max_scan(lo.ok, lane);
  const float t_in0 = warp_max_scan(lo.ok > 0.0f ? lo.t : -INFINITY, lane);
  const float ok_lo = __shfl_sync(kFull, ok_in0, 31);
  const float t_lo = __shfl_sync(kFull, t_in0, 31);
  const float ok_in1 = fmaxf(ok_lo, warp_max_scan(hi.ok, lane));
  const float t_in1 = fmaxf(
      t_lo, warp_max_scan(hi.ok > 0.0f ? hi.t : -INFINITY, lane));
  // exclusive: the steps before this one
  const float ok_ex0 = __shfl_up_sync(kFull, ok_in0, 1);
  const float t_ex0 = __shfl_up_sync(kFull, t_in0, 1);
  const float ok_ex1 = __shfl_up_sync(kFull, ok_in1, 1);
  const float t_ex1 = __shfl_up_sync(kFull, t_in1, 1);
  clock_step(lo, lane == 0 ? 0.0f : ok_ex0, lane == 0 ? -INFINITY : t_ex0,
             ts0, init0);
  clock_step(hi, lane == 0 ? ok_lo : ok_ex1, lane == 0 ? t_lo : t_ex1, ts0,
             init0);
  ts = clock_ts(__shfl_sync(kFull, t_in1, 31), ts0, init0);
  init = fmaxf(init0, __shfl_sync(kFull, ok_in1, 31));
}

// Lane work of step k: a_k - ba, and rd_k and eff_k for the chain.
__device__ __forceinline__ void step_terms(Step& st, const float* scal,
                                           Chain& ch, int k, int k_steps) {
#pragma unroll
  for (int i = 0; i < 3; ++i) st.ab[i] = st.ab[i] - scal[13 + i];
  if (k >= k_steps) return;
  ptudes::rodrigues((st.w[0] - scal[10]) * st.dt,
                    (st.w[1] - scal[11]) * st.dt,
                    (st.w[2] - scal[12]) * st.dt, ch.rd[k]);
  ch.eff[k] = st.eff;
}

// The attitude chain: lane e < 9 holds element e = 3i + j of r, from r0;
// each step it takes row i by shuffles and forms matmul3's element (i, j)
// of r rd_k. Records the attitude before every step and after the last.
__device__ __forceinline__ void attitude_chain(const Chain& ch,
                                               Attitudes& at,
                                               const float* r0, int k_steps,
                                               int lane) {
  const int e = lane < 9 ? lane : 0, i = e / 3, j = e % 3;
  float re = r0[e];
  for (int k = 0; k < k_steps; ++k) {
    const float b0 = ch.rd[k][j], b1 = ch.rd[k][3 + j], b2 = ch.rd[k][6 + j];
    const bool eff = ch.eff[k] > 0.0f;
    const float a0 = __shfl_sync(kFull, re, 3 * i);
    const float a1 = __shfl_sync(kFull, re, 3 * i + 1);
    const float a2 = __shfl_sync(kFull, re, 3 * i + 2);
    if (lane < 9) at.r[k][e] = re;
    if (eff) re = a0 * b0 + a1 * b1 + a2 * b2;
  }
  if (lane < 9) at.r[k_steps][e] = re;
}

// Steps [k0, k1) of the pos/vel chain; with hist, the lane of step k
// stores pos and vel after it.
__device__ __forceinline__ void pos_vel_chain(const Step& st, int k0, int k1,
                                              float* pos, float* vel,
                                              float* hist, int lane) {
  for (int k = k0; k < k1; ++k) {
    const float dt = __shfl_sync(kFull, st.dt, k - k0);
    float acc_tot[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      acc_tot[i] = __shfl_sync(kFull, st.acc[i], k - k0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pos[i] = pos[i] + vel[i] * dt + 0.5f * acc_tot[i] * dt * dt;
      vel[i] = vel[i] + acc_tot[i] * dt;
    }
    if (hist != nullptr && lane == k - k0) {
      float* row = hist + k * kHist;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        row[kHistPos + i] = pos[i];
        row[kHistVel + i] = vel[i];
      }
    }
  }
}

// Step k's history row apart from pos, vel and the covariance: its
// timestamp, the attitude after it, and the biases and gravity.
__device__ __forceinline__ void history_row(const Smem& sm,
                                            const Attitudes& at,
                                            const Step& st, int k,
                                            int k_steps, float* hist) {
  if (k >= k_steps) return;
  float* row = hist + k * kHist;
  row[0] = st.t;
  ptudes::mat_to_quat(at.r[k + 1], row + kHistQuat);
#pragma unroll
  for (int i = 0; i < 9; ++i) row[kHistScal + i] = sm.scal[10 + i];
}

// Lane work of step k, at the attitude r before it: acc_tot_k and F's rows
// 0-8 in the terms of term_col: (POS, VEL) = dt I, (VEL, PHI) = -dt r
// hat(a), (VEL, BA) = -dt r, (PHI, PHI) = rd^T, (PHI, BG) = -dt I.
__device__ __forceinline__ void step_rows(Step& st, Smem& sm,
                                          const float* r, const float* rd,
                                          int k) {
  const float* ab = st.ab;
  const float dt = st.dt;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    st.acc[i] = r[3 * i] * ab[0] + r[3 * i + 1] * ab[1]
                + r[3 * i + 2] * ab[2] + sm.scal[16 + i];
  const float h[9] = {0.0f, -ab[2], ab[1], ab[2], 0.0f, -ab[0],
                      -ab[1], ab[0], 0.0f};
  float rh[9];
  ptudes::matmul3(r, h, rh);
  float4(*cf)[kPad / 4] = sm.coef[k];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cf[POS + i][0] = make_float4(1.0f, dt, 0.0f, 0.0f);
    cf[VEL + i][0] = make_float4(1.0f, -dt * rh[3 * i], -dt * rh[3 * i + 1],
                                 -dt * rh[3 * i + 2]);
    cf[VEL + i][1] = make_float4(-dt * r[3 * i], -dt * r[3 * i + 1],
                                 -dt * r[3 * i + 2], 0.0f);
    cf[PHI + i][0] = make_float4(rd[i], rd[3 + i], rd[6 + i], -dt);
    cf[POS + i][1] = zero;
    cf[PHI + i][1] = zero;
  }
  sm.dt[k] = dt;
}

// Load step k's IMU row into st (k < k_steps).
__device__ __forceinline__ void load_step(Step& st, const float* imu, int k,
                                          int k_steps) {
  if (k >= k_steps) return;
  const float* row = imu + 8 * k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    st.ab[i] = row[i];
    st.w[i] = row[3 + i];
  }
  st.t = row[6];
  st.ok = row[7];
}

// Warp 0, before the covariance: the clock, the attitude chain and F's
// rows of every step; leaves the clock in ts and init.
__device__ __forceinline__ void nav_front(Smem& sm, Chain& ch,
                                          Attitudes& at, Step& lo, Step& hi,
                                          int k_steps, int lane, float& ts,
                                          float& init) {
  ts = sm.scal[19];
  init = sm.scal[20];
  clock_scan(lo, hi, lane, ts, init);
  step_terms(lo, sm.scal, ch, lane, k_steps);
  step_terms(hi, sm.scal, ch, lane + 32, k_steps);
  float r0[9];
  ptudes::quat_to_mat(sm.scal + 6, r0);
  __syncwarp();
  attitude_chain(ch, at, r0, k_steps, lane);
  __syncwarp();
  if (lane < k_steps) step_rows(lo, sm, at.r[lane], ch.rd[lane], lane);
  if (lane + 32 < k_steps)
    step_rows(hi, sm, at.r[lane + 32], ch.rd[lane + 32], lane + 32);
}

// Warp 0, beside the covariance: the pos/vel chain and the history rows,
// then lane 0 writes the state, the clock and the twist.
__device__ __forceinline__ void nav_tail(const Smem& sm,
                                         const Attitudes& at,
                                         const Step& lo, const Step& hi,
                                         int k_steps, int lane, float ts,
                                         float init, float* out,
                                         float* hist) {
  float pos[3], vel[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = sm.scal[i];
    vel[i] = sm.scal[3 + i];
  }
  pos_vel_chain(lo, 0, min(k_steps, 32), pos, vel, hist, lane);
  pos_vel_chain(hi, 32, k_steps, pos, vel, hist, lane);
  if (hist != nullptr) {
    history_row(sm, at, lo, lane, k_steps, hist);
    history_row(sm, at, hi, lane + 32, k_steps, hist);
  }
  if (lane != 0) return;
  for (int i = 0; i < 3; ++i) {
    out[i] = pos[i];
    out[3 + i] = vel[i];
  }
  const float* r0 = at.r[0];
  const float* r = at.r[k_steps];
  ptudes::mat_to_quat(r, out + 6);
  out[10] = ts;
  out[11] = init;

  // deskew twist: log(T_in^-1 T_out)
  float r0t[9], rel_r[9], rel_t[3], dp[3];
  ptudes::transpose3(r0, r0t);
  ptudes::matmul3(r0t, r, rel_r);
  for (int i = 0; i < 3; ++i) dp[i] = pos[i] - sm.scal[i];
  for (int i = 0; i < 3; ++i)
    rel_t[i] = r0t[3 * i] * dp[0] + r0t[3 * i + 1] * dp[1]
               + r0t[3 * i + 2] * dp[2];
  ptudes::log_pose(rel_r, rel_t, out + 12);
}

// ---- the covariance (warps 1-9)

// The process noise W of step k on the diagonal entry i.
__device__ __forceinline__ float noise(int i, float dt, float acc_bias_std,
                                      float gyr_bias_std, float acc_vrw,
                                      float gyr_arw) {
  const int b = i / 3 * 3;
  if (b == VEL) return (dt * acc_bias_std) * (dt * acc_bias_std);
  if (b == PHI) return (dt * gyr_bias_std) * (dt * gyr_bias_std);
  if (b == BG) return dt * gyr_arw * gyr_arw;
  if (b == BA) return dt * acc_vrw * acc_vrw;
  return 0.0f;
}

// The covariance threads' schedule, fixed at compile time. A pair (o, n)
// of rows, o the one with fewer terms in F (F_o P F_n^T = F_n P F_o^T, P
// symmetric), gets one lane per term a of F's row o, rounded up to 8, 4, 2
// or 1 lanes; lane a takes F[o][a] sum_m F[n][m] P[col a of o][col m of
// n] over the 7 terms m of row n (zero coefficients past its nonzeros),
// and the pair's lanes sum by shuffles into lane 0 (a = 0). Lanes past
// row o's terms, and idle ones, take the zero coefficient slot. Blocks of
// one row-type pair each, in thread order:
// VEL x VEL (8 lanes), VEL x PHI, PHI x PHI (4), VEL x POS, PHI x POS,
// POS x POS (2), then one lane a pair for VEL, PHI, POS and the rest each
// with rows 9-17 and those among themselves.
constexpr int kZero = kPad - 1;  // coefficient slot 7 of every row is 0

struct CovTable {
  int o[kCovThreads], n[kCovThreads], a[kCovThreads],
      lanes[kCovThreads];
  int poff[kTerms][kCovThreads];  // offsets into P
};

constexpr CovTable make_cov_table() {
  struct Block {
    int r0, nr, c0, nc, tri;
  };
  constexpr Block blocks[] = {
      {VEL, 3, VEL, 3, 1}, {VEL, 3, PHI, 3, 0}, {PHI, 3, PHI, 3, 1},
      {VEL, 3, POS, 3, 0}, {PHI, 3, POS, 3, 0}, {POS, 3, POS, 3, 1},
      {VEL, 3, BG, 9, 0},  {PHI, 3, BG, 9, 0},  {POS, 3, BG, 9, 0},
      {BG, 9, BG, 9, 1}};
  CovTable t{};
  int c = 0;
  for (const Block& b : blocks) {
    for (int x = 0; x < b.nr; ++x) {
      for (int y = b.tri ? x : 0; y < b.nc; ++y) {
        const int i = b.r0 + x, j = b.c0 + y;
        const bool swap = row_terms(j) < row_terms(i);
        const int o = swap ? j : i, n = swap ? i : j;
        const int no = row_terms(o);
        const int lanes = no > 4 ? 8 : (no > 2 ? 4 : no);
        for (int g = 0; g < lanes; ++g, ++c) {
          t.o[c] = o;
          t.n[c] = n;
          t.a[c] = g < no ? g : kZero;
          t.lanes[c] = lanes;
          for (int m = 0; m < kTerms; ++m)
            t.poff[m][c] = term_col(o, g < no ? g : 0) * S + term_col(n, m);
        }
      }
    }
  }
  for (; c < kCovThreads; ++c) {  // idle lanes: a zero pair (0, 0)
    t.a[c] = kZero;
    t.lanes[c] = 1;
  }
  return t;
}

__device__ const CovTable kCov = make_cov_table();

// A covariance thread's schedule, loaded from kCov.
struct CovThread {
  int o, n, a, lanes;
  bool lead;
  int poff[kTerms];

  __device__ __forceinline__ explicit CovThread(int c) {
    o = __ldg(&kCov.o[c]);
    n = __ldg(&kCov.n[c]);
    a = __ldg(&kCov.a[c]);
    lanes = __ldg(&kCov.lanes[c]);
    lead = a == 0;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) poff[m] = __ldg(&kCov.poff[m][c]);
  }
};

// Warps 1-9: the K covariance steps; c is the thread's rank among them.
// With hist, a diagonal pair's lead lane stores its entry after each step.
__device__ __forceinline__ void cov_steps(Smem& sm, const CovThread& ct,
                                          int k_steps, int c,
                                          float* cov_out, float* hist,
                                          float acc_bias_std,
                                          float gyr_bias_std, float acc_vrw,
                                          float gyr_arw) {
  const int n_steps = ptudes::skip(ptudes::kSkipCovSteps) ? 0 : k_steps;
  for (int k = 0; k < n_steps; ++k) {
    const float* P = sm.P[k & 1];
    float* pn = sm.P[(k + 1) & 1];
    const float4* fo = ct.o < kFRows ? sm.coef[k][ct.o] : sm.ident;
    const float4* fn4 = ct.n < kFRows ? sm.coef[k][ct.n] : sm.ident;
    const float4 lo = fn4[0], hi = fn4[1];
    const float fn[kTerms] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
    float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      if (ptudes::skip(ptudes::kSkipCovMath)) break;
      if (m % 2) y1 += fn[m] * P[ct.poff[m]];
      else y0 += fn[m] * P[ct.poff[m]];
    }
    float x = reinterpret_cast<const float*>(fo)[ct.a] * (y0 + y1);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {  // the pair's lanes
      const float v = __shfl_xor_sync(kFull, x, off);
      if (off < ct.lanes) x += v;
    }
    if (ct.lead) {
      if (ct.o == ct.n) {
        x += noise(ct.o, sm.dt[k], acc_bias_std, gyr_bias_std, acc_vrw,
                   gyr_arw);
        if (hist != nullptr) hist[k * kHist + kHistCov + ct.o] = x;
      }
      pn[ct.o * S + ct.n] = x;
      pn[ct.n * S + ct.o] = x;
    }
    cov_barrier();
  }
  if (k_steps == 0) return;  // the input goes out as it came
  const float* P = sm.P[k_steps & 1];
  for (int i = c; i < SS; i += kCovThreads) cov_out[i] = P[i];
}

template <bool kLog>
__global__ void __launch_bounds__(kThreads)
ekf_predict_kernel(const float* __restrict__ scal,
                   const float* __restrict__ imu,
                   const float* __restrict__ cov_in,
                   float* __restrict__ out, float* __restrict__ cov_out,
                   float* __restrict__ hist_rows, int k_steps,
                   float acc_bias_std, float gyr_bias_std, float acc_vrw,
                   float gyr_arw) {
  float* const hist = kLog ? hist_rows : nullptr;
  __shared__ Smem sm;
  __shared__ Chain ch;
  __shared__ Attitudes at;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool nav_warp = tid < 32;
  Step lo, hi;  // warp 0: steps lane and lane + 32
  if (nav_warp) {
    load_step(lo, imu, lane, k_steps);
    load_step(hi, imu, lane + 32, k_steps);
  }
  for (int e = tid; e < SS; e += kThreads) {  // P symmetrised once
    const int i = e / S, j = e % S;
    const float v = cov_in[e];
    sm.P[0][e] = i == j ? v : 0.5f * (v + cov_in[j * S + i]);
    if (k_steps == 0) cov_out[e] = v;
  }
  if (tid < kScal) sm.scal[tid] = scal[tid];
  if (tid < kPad)
    reinterpret_cast<float*>(sm.ident)[tid] = tid == 0 ? 1.0f : 0.0f;
  const CovThread ct(nav_warp ? kCovThreads - 1 : tid - 32);
  __syncthreads();

  float ts, init;
  if (nav_warp) nav_front(sm, ch, at, lo, hi, k_steps, lane, ts, init);
  __syncthreads();

  if (nav_warp) {
    nav_tail(sm, at, lo, hi, k_steps, lane, ts, init, out, hist);
  } else {
    cov_steps(sm, ct, k_steps, tid - 32, cov_out, hist, acc_bias_std,
              gyr_bias_std, acc_vrw, gyr_arw);
  }
}

}  // namespace

// hist: [k_steps, 38] rows of the filter history, or null for none.
extern "C" int ptudes_ekf_predict(const float* scal, const float* imu,
                                  const float* cov_in, float* out,
                                  float* cov_out, float* hist, int k_steps,
                                  float acc_bias_std, float gyr_bias_std,
                                  float acc_vrw, float gyr_arw,
                                  cudaStream_t stream) {
  if (k_steps < 0 || k_steps > kMaxSteps) return cudaErrorInvalidValue;
  auto* kernel = hist != nullptr ? ekf_predict_kernel<true>
                                 : ekf_predict_kernel<false>;
  kernel<<<1, kThreads, 0, stream>>>(scal, imu, cov_in, out, cov_out, hist,
                                     k_steps, acc_bias_std, gyr_bias_std,
                                     acc_vrw, gyr_arw);
  return static_cast<int>(cudaGetLastError());
}
