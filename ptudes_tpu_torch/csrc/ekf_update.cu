// K2: the whole EKF pose update in one launch.
//
// Replaces ptudes_tpu/ops/pallas_ekf.py:update_pose_pallas (kernel
// _make_update_kernel): the residual [t_meas - pos, log(R^T R_meas)], the
// 6x6 SPD innovation inverse by Cholesky, the gain K = P J^T S^-1, the
// Joseph (or simple) covariance update with symmetrisation, the error
// injection into the nominal state and the attitude-covariance projection
// G P_phi G^T.
//
// What bounds it on the card: latency. ~2 KB of state and ~50 kFLOP; the
// plain form is ~150 tiny kernels (the unrolled Cholesky alone is dozens).
// Design: one CTA of 324 threads, one per covariance entry. Thread 0 does
// the scalar work (residual, Cholesky inverse, injection, projection); the
// 18x6 gain and the 18x18 products run one entry per thread, with shared
// memory and barriers between them.
#include "common.cuh"

namespace {

constexpr int S = 18;
constexpr int SS = S * S;
constexpr int PHI = 6;
constexpr int kThreads = 352;

// scal input: pos[3] vel[3] quat[4] bg[3] ba[3] grav[3]
//             measured pose 3x4 row-major[12] meas_cov[36]        (67)
// out:        pos[3] vel[3] quat[4] bg[3] ba[3] grav[3]           (22)
// The injection composes in rotation-matrix form, like the TPU kernel;
// the quaternion conversions at both ends are done here too.

// row of P selected by J_p's i-th row (POS then PHI)
__device__ __forceinline__ int jp_src(int i) { return i < 3 ? i : PHI + i - 3; }

__global__ void __launch_bounds__(kThreads)
ekf_update_kernel(const float* __restrict__ scal,
                  const float* __restrict__ cov_in, float* __restrict__ out,
                  float* __restrict__ cov_out, int joseph) {
  __shared__ float P[SS], A[SS], B[SS];
  __shared__ float Kg[S][6], Sinv[6][6], res[6], dx[S], MC[6][6];
  const int tid = threadIdx.x;
  const int i = tid / S, j = tid % S;
  const bool mine = tid < SS;
  if (mine) P[tid] = cov_in[tid];
  if (tid < 36) MC[tid / 6][tid % 6] = scal[31 + tid];
  __syncthreads();

  __shared__ float R[9];
  if (tid == 0) {
    ptudes::quat_to_mat(scal + 6, R);
    const float* pm = scal + 19;
    const float mr[9] = {pm[0], pm[1], pm[2], pm[4], pm[5], pm[6],
                         pm[8], pm[9], pm[10]};
    float rt[9], m[9], rv[3];
    ptudes::transpose3(R, rt);
    ptudes::matmul3(rt, mr, m);
    ptudes::log_rot(m, rv);
    for (int k = 0; k < 3; ++k) {
      res[k] = pm[4 * k + 3] - scal[k];
      res[3 + k] = rv[k];
    }
    float smat[6][6], l[6][6];
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b < 6; ++b)
        smat[a][b] = P[jp_src(a) * S + jp_src(b)] + MC[a][b];
    ptudes::cholesky<6>(smat, l);
    for (int col = 0; col < 6; ++col) {
      float e[6] = {0, 0, 0, 0, 0, 0}, x[6];
      e[col] = 1.0f;
      ptudes::cholesky_solve<6>(l, e, x);
      for (int a = 0; a < 6; ++a) Sinv[a][col] = x[a];
    }
  }
  __syncthreads();

  if (tid < S * 6) {  // K = (P J^T) S^-1
    const int a = tid / 6, b = tid % 6;
    float s = 0.0f;
    for (int l = 0; l < 6; ++l) s += P[a * S + jp_src(l)] * Sinv[l][b];
    Kg[a][b] = s;
  }
  __syncthreads();
  if (tid < S) {
    float s = 0.0f;
    for (int l = 0; l < 6; ++l) s += Kg[tid][l] * res[l];
    dx[tid] = s;
  }
  if (mine) {  // IKJ = I - K J_p
    float v = (i == j) ? 1.0f : 0.0f;
    if (j < 3) v -= Kg[i][j];
    if (j >= PHI && j < PHI + 3) v -= Kg[i][3 + j - PHI];
    B[tid] = v;
  }
  __syncthreads();
  if (mine) {  // A = IKJ P
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < S; ++l) s += B[i * S + l] * P[l * S + j];
    A[tid] = s;
  }
  __syncthreads();
  float c = 0.0f;
  if (mine) {
    if (joseph) {  // IKJ P IKJ^T + K R K^T
#pragma unroll
      for (int l = 0; l < S; ++l) c += A[i * S + l] * B[j * S + l];
      float krk = 0.0f;
      for (int a = 0; a < 6; ++a) {
        float km = 0.0f;
        for (int b = 0; b < 6; ++b) km += Kg[i][b] * MC[b][a];
        krk += km * Kg[j][a];
      }
      c += krk;
    } else {
      c = A[tid];
    }
  }
  __syncthreads();
  if (mine) P[tid] = c;
  __syncthreads();
  if (mine) A[tid] = 0.5f * (P[tid] + P[j * S + i]);
  __syncthreads();

  if (tid == 0) {
    const float dphi[3] = {dx[PHI], dx[PHI + 1], dx[PHI + 2]};
    float rd[9], rn[9];
    ptudes::rodrigues(dphi[0], dphi[1], dphi[2], rd);
    ptudes::matmul3(R, rd, rn);
    // attitude covariance projection, G = I - hat(dphi / 2)
    const float hx = 0.5f * dphi[0], hy = 0.5f * dphi[1], hz = 0.5f * dphi[2];
    const float g[9] = {1.0f, hz, -hy, -hz, 1.0f, hx, hy, -hx, 1.0f};
    float blk[9], gb[9], gbg[9], gt[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) blk[3 * a + b] = A[(PHI + a) * S + PHI + b];
    ptudes::matmul3(g, blk, gb);
    ptudes::transpose3(g, gt);
    ptudes::matmul3(gb, gt, gbg);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) A[(PHI + a) * S + PHI + b] = gbg[3 * a + b];
    for (int k = 0; k < 3; ++k) {
      out[k] = scal[k] + dx[k];
      out[3 + k] = scal[3 + k] + dx[3 + k];
      out[10 + k] = scal[10 + k] + dx[9 + k];
      out[13 + k] = scal[13 + k] + dx[12 + k];
      out[16 + k] = scal[16 + k] + dx[15 + k];
    }
    ptudes::mat_to_quat(rn, out + 6);
  }
  __syncthreads();
  if (mine) cov_out[tid] = A[tid];
}

}  // namespace

extern "C" int ptudes_ekf_update(const float* scal, const float* cov_in,
                                 float* out, float* cov_out, int joseph,
                                 cudaStream_t stream) {
  ekf_update_kernel<<<1, kThreads, 0, stream>>>(scal, cov_in, out, cov_out,
                                                joseph);
  return static_cast<int>(cudaGetLastError());
}
