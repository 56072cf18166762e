// K2: the whole EKF pose update in one launch.
//
// Replaces ptudes_tpu/ops/pallas_ekf.py:update_pose_pallas (kernel
// _make_update_kernel): the residual [t_meas - pos, log(R^T R_meas)], the
// 6x6 SPD innovation S = J P J^T + R by Cholesky, the gain K = P J^T S^-1,
// the Joseph (or simple) covariance update with symmetrisation, the error
// injection into the nominal state and the attitude-covariance projection
// G P_phi G^T. J selects the POS and PHI rows, so J P is six rows of P.
//
// What bounds it on the card: latency. ~3 KB of state and ~15 kFLOP; the
// kernel's time is its longest dependent chain plus its barriers. The
// first version ran the residual, S, its Cholesky and six serial solves
// for the columns of S^-1 on one thread while the CTA waited, five more
// CTA barriers for the products (the Joseph term recomputed 42 FMAs an
// entry), and the injection and projection on one thread again.
//
// Design: one CTA of 12 warps; warps 0-10 hold one covariance entry a
// thread (324 of 352), warp 11 the state injection.
// - Warp 0 factors S = L L^T: lane l < 21 holds entry (i, j), i >= j, of
//   S's lower triangle; step k takes the pivot by a shuffle, scales column
//   k by its reciprocal and updates the trailing block, one entry a lane
//   (the serial Cholesky's subtractions in their order). Then lane c < 18
//   solves S x = (P J^T)[c] by a forward and a back substitution: x is row
//   c of K, eighteen right-hand sides at once, no S^-1. The six pivots'
//   correctly rounded reciprocals stand in for every division (within an
//   ulp of the quotients): an IEEE division is a branch around its slow
//   path, and eighteen of them made most of this chain's time.
// - Meanwhile lane 0 of warp 1 forms the residual (quat_to_mat, R^T R_meas,
//   log_rot), which does not depend on S.
// - After one CTA barrier, warp 11 injects: lane c < 18 forms dx_c = K_c res
//   and the additive entries, lane 0 the attitude (Rodrigues, R R_dx,
//   mat_to_quat). Beside it, warps 0-10 form A = (I - K J) P = P - K (J P),
//   a 6-term dot an entry, and K R as an [18, 6] tile; after a named barrier
//   of those warps only, the Joseph entry is A_ij + sum_a (K R - A J^T)_ia
//   K_ja, one 6-term dot; after another, the symmetrised entries go out,
//   while warp 10 projects the attitude block G P_phi G^T, one element a
//   lane (matmul3's sums, shuffled between the lanes).
//
// Replica axis (the batched driver): one CTA a replica, its scal, P and
// outputs at fixed strides; replica b's result is a single launch's on its
// inputs, bit for bit.
#include "common.cuh"

namespace {

constexpr int S = 18;
constexpr int SS = S * S;
constexpr int PHI = 6;
constexpr int kCovWarps = 11;                   // 352 lanes, 324 entries
constexpr int kCovThreads = 32 * kCovWarps;
constexpr int kThreads = kCovThreads + 32;      // warp 11: the injection
constexpr int kProjWarp = 10;                   // the attitude projection
constexpr int kTri = 21;                        // S's lower triangle
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScal = 67;                       // a replica's scal row

// scal input: pos[3] vel[3] quat[4] bg[3] ba[3] grav[3]
//             measured pose 3x4 row-major[12] meas_cov[36]        (67)
// out:        pos[3] vel[3] quat[4] bg[3] ba[3] grav[3]           (19)
// The injection composes in rotation-matrix form, like the TPU kernel;
// the quaternion conversions at both ends are done here too.
struct Smem {
  float P[SS];    // the input covariance, then the Joseph form's result
  float A[SS];    // (I - K J) P
  float K[S][6];  // the gain
  float KR[S][6];  // K meas_cov
  float MC[6][6];
  float L[6][6];  // S's Cholesky factor, lower triangle, 1 / L_kk in place
                  // of its diagonal
  float res[6];
  float R[9];     // the attitude before the update
};

// row of P selected by J's a-th row (POS then PHI)
__device__ __forceinline__ int jp(int a) { return a < 3 ? a : PHI + a - 3; }

// The lane holding entry (i, j), i >= j, of a lower triangle.
__device__ __forceinline__ int tri_lane(int i, int j) {
  return i * (i + 1) / 2 + j;
}

__device__ __forceinline__ void cov_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCovThreads) : "memory");
}

// Warp 0: S's Cholesky factor into sm.L (the reciprocals of the pivots on
// the diagonal), then row `lane` of K (lane < 18) into sm.K.
__device__ __forceinline__ void gain(Smem& sm, int lane) {
  const bool on = lane < kTri;  // the others idle as copies of (0, 0)
  int i = 0;
  while (on && tri_lane(i + 1, 0) <= lane) ++i;
  const int j = on ? lane - tri_lane(i, 0) : 0;
  float a = sm.P[jp(i) * S + jp(j)] + sm.MC[i][j];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float d = sqrtf(fmaxf(__shfl_sync(kFull, a, tri_lane(k, k)),
                                1e-12f));
    const float inv = __frcp_rn(d);
    if (j == k) a = (i == k) ? inv : a * inv;  // column k of L
    const float li = __shfl_sync(kFull, a, i >= k ? tri_lane(i, k) : 0);
    const float lj = __shfl_sync(kFull, a, j >= k ? tri_lane(j, k) : 0);
    if (j > k) a -= li * lj;  // the trailing block
  }
  if (on) sm.L[i][j] = a;
  __syncwarp();
  if (lane >= S) return;
  float y[6], x[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {  // L y = (P J^T)[c]
    float s = sm.P[lane * S + jp(r)];
#pragma unroll
    for (int k = 0; k < r; ++k) s -= sm.L[r][k] * y[k];
    y[r] = s * sm.L[r][r];
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {  // L^T x = y
    float s = y[r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) s -= sm.L[k][r] * x[k];
    x[r] = s * sm.L[r][r];
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) sm.K[lane][r] = x[r];
}

// Warp 1, lane 0: the attitude and the residual.
__device__ __forceinline__ void residual(Smem& sm,
                                         const float* __restrict__ scal) {
  ptudes::quat_to_mat(scal + 6, sm.R);
  const float* pm = scal + 19;
  const float mr[9] = {pm[0], pm[1], pm[2], pm[4], pm[5], pm[6],
                       pm[8], pm[9], pm[10]};
  float rt[9], m[9], rv[3];
  ptudes::transpose3(sm.R, rt);
  ptudes::matmul3(rt, mr, m);
  ptudes::log_rot(m, rv);
  for (int k = 0; k < 3; ++k) {
    sm.res[k] = pm[4 * k + 3] - scal[k];
    sm.res[3 + k] = rv[k];
  }
}

// dx_c = K_c res.
__device__ __forceinline__ float dx_of(const Smem& sm, int c) {
  float s = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) s += sm.K[c][a] * sm.res[a];
  return s;
}

// Warp 11: the nominal state plus dx.
__device__ __forceinline__ void inject(const Smem& sm,
                                       const float* __restrict__ scal,
                                       float* __restrict__ out, int lane) {
  const int c = lane < S ? lane : 0;
  const float d = dx_of(sm, c);
  if (lane < PHI) out[c] = scal[c] + d;
  else if (lane >= PHI + 3 && lane < S) out[c + 1] = scal[c + 1] + d;
  const float dphi[3] = {__shfl_sync(kFull, d, PHI),
                         __shfl_sync(kFull, d, PHI + 1),
                         __shfl_sync(kFull, d, PHI + 2)};
  if (lane != 0) return;
  float rd[9], rn[9];
  ptudes::rodrigues(dphi[0], dphi[1], dphi[2], rd);
  ptudes::matmul3(sm.R, rd, rn);
  ptudes::mat_to_quat(rn, out + 6);
}

// Row a of G = I - hat(h).
__device__ __forceinline__ void g_row(int a, float hx, float hy, float hz,
                                      float* r) {
  r[0] = a == 0 ? 1.0f : (a == 1 ? -hz : hy);
  r[1] = a == 0 ? hz : (a == 1 ? 1.0f : -hx);
  r[2] = a == 0 ? -hy : (a == 1 ? hx : 1.0f);
}

// Warp 10: G C_phi G^T of the symmetrised attitude block, G = I -
// hat(dphi / 2); lane e < 9 is element (a, b) = (e / 3, e % 3).
__device__ __forceinline__ void project(const Smem& sm, const float* c_mat,
                                        float* __restrict__ cov_out,
                                        int lane) {
  const int e = lane < 9 ? lane : 0, a = e / 3, b = e % 3;
  const float hx = 0.5f * dx_of(sm, PHI), hy = 0.5f * dx_of(sm, PHI + 1),
              hz = 0.5f * dx_of(sm, PHI + 2);
  float ga[3], gb_row[3], blk[3];  // blk: column b of the symmetrised block
  g_row(a, hx, hy, hz, ga);
  g_row(b, hx, hy, hz, gb_row);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    blk[k] = 0.5f * (c_mat[(PHI + k) * S + PHI + b]
                     + c_mat[(PHI + b) * S + PHI + k]);
  // matmul3(G, blk), then matmul3(., G^T), one element a lane
  const float gb = ga[0] * blk[0] + ga[1] * blk[1] + ga[2] * blk[2];
  const float gb0 = __shfl_sync(kFull, gb, 3 * a);
  const float gb1 = __shfl_sync(kFull, gb, 3 * a + 1);
  const float gb2 = __shfl_sync(kFull, gb, 3 * a + 2);
  if (lane < 9)
    cov_out[(PHI + a) * S + PHI + b] =
        gb0 * gb_row[0] + gb1 * gb_row[1] + gb2 * gb_row[2];
}

__global__ void __launch_bounds__(kThreads)
ekf_update_kernel(const float* __restrict__ scal,
                  const float* __restrict__ cov_in, float* __restrict__ out,
                  float* __restrict__ cov_out, int joseph) {
  const int rep = blockIdx.x;
  scal += rep * kScal;
  cov_in += rep * SS;
  out += rep * 32;
  cov_out += rep * SS;
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < SS; e += kThreads) sm.P[e] = cov_in[e];
  if (tid < 36) sm.MC[tid / 6][tid % 6] = scal[31 + tid];
  __syncthreads();

  if (warp == 0) gain(sm, lane);
  else if (warp == 1 && lane == 0) residual(sm, scal);
  __syncthreads();

  if (warp == kCovWarps) {
    inject(sm, scal, out, lane);
    return;
  }
  const int i = tid / S, j = tid % S;
  const bool mine = tid < SS;
  if (mine) {  // A = P - K (J P)
    float v = sm.P[tid];
#pragma unroll
    for (int a = 0; a < 6; ++a) v -= sm.K[i][a] * sm.P[jp(a) * S + j];
    sm.A[tid] = v;
  }
  if (joseph && tid < S * 6) {  // K R
    const int r = tid / 6, a = tid % 6;
    float v = 0.0f;
#pragma unroll
    for (int b = 0; b < 6; ++b) v += sm.K[r][b] * sm.MC[b][a];
    sm.KR[r][a] = v;
  }
  cov_barrier();
  const float* c_mat = sm.A;
  if (joseph) {  // A (I - K J)^T + K R K^T
    if (mine) {
      float v = sm.A[tid];
#pragma unroll
      for (int a = 0; a < 6; ++a)
        v += (sm.KR[i][a] - sm.A[i * S + jp(a)]) * sm.K[j][a];
      sm.P[tid] = v;
    }
    cov_barrier();
    c_mat = sm.P;
  }
  const bool phi_blk = i >= PHI && i < PHI + 3 && j >= PHI && j < PHI + 3;
  if (mine && !phi_blk) cov_out[tid] = 0.5f * (c_mat[tid] + c_mat[j * S + i]);
  if (warp == kProjWarp) project(sm, c_mat, cov_out, lane);
}

}  // namespace

// batch replicas, each: scal [67], cov [18, 18], out [32], cov_out
// [18, 18], replica b's at b times those sizes.
extern "C" int ptudes_ekf_update(const float* scal, const float* cov_in,
                                 float* out, float* cov_out, int joseph,
                                 int batch, cudaStream_t stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  ekf_update_kernel<<<batch, kThreads, 0, stream>>>(scal, cov_in, out,
                                                    cov_out, joseph);
  return static_cast<int>(cudaGetLastError());
}
