// K4: the whole frozen-candidate robust Gauss-Newton ICP in one launch.
//
// Replaces ptudes_tpu/ops/pallas_icp.py:icp_loop_pallas (kernel
// _make_loop_kernel). Per iteration: transform the source by the current
// pose; masked nearest neighbour over the C candidates (lowest candidate
// row wins ties); robust weights k^2 / (k + r^2)^2; point-to-plane rows
// where the patch fit has quality >= q, point-to-point moments elsewhere;
// the 45 moment sums of the 6x6 normal equations; the motion prior toward
// the guess plus a 1e-8 Tikhonov floor; the Cholesky solve; the SE(3) exp
// update; early exit on |dx| < convergence. Epilogue: pose, correspondence
// count, iterations, |t| and |log R| of guess^-1 pose (the adaptive
// threshold's model deviation).
//
// What bounds it on the card: each iteration streams the candidates
// (16*C*N bytes = 1 MB at N = 2048, C = 32; they stay in the 50 MB L2 after
// the first pass) for ~20*C*N FLOPs, then a serial 6x6 solve. At these
// sizes launch and synchronisation latency dominate: the plain form pays
// ~150 kernel launches per iteration. Design: ONE persistent CTA holds the
// whole loop. Each of its 512 threads owns N/512 points and keeps the 45
// moment sums in registers; warp shuffles and one shared-memory pass
// reduce them; thread 0 builds the system, solves, updates the pose and
// the convergence flag in shared memory; a barrier publishes them. A
// multi-CTA version (a grid-wide reduction per iteration) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = ptudes::kGnAcc;

// scal: kern, max_d2, guess 3x4 row-major (12)                      (14)
// out:  pose 4x4 row-major (16), n_corr, iters, dev_t, dev_r        (20)

__global__ void __launch_bounds__(kThreads)
icp_loop_kernel(const float* __restrict__ src,   // [3, N]
                const float* __restrict__ feat,  // [8, N]
                const float* __restrict__ cx, const float* __restrict__ cy,
                const float* __restrict__ cz,
                const float* __restrict__ inf,   // [C, N]
                const float* __restrict__ scal, float* __restrict__ out,
                int n, int c, float plane_q, float conv2, float prior_rot,
                float prior_trans, int max_iterations) {
  __shared__ float red[kWarps][kAcc];
  __shared__ float sums[kAcc];
  __shared__ float pose[12];  // R (9) then t (3)
  __shared__ float gi_r[9], gi_t[3];  // guess^-1
  __shared__ int done;
  __shared__ int iters;
  __shared__ float n_corr;

  const int tid = threadIdx.x;
  const float kern = scal[0], max_d2 = scal[1];
  if (tid == 0) {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) pose[3 * a + b] = scal[2 + 4 * a + b];
      pose[9 + a] = scal[2 + 4 * a + 3];
    }
    ptudes::transpose3(pose, gi_r);
    for (int a = 0; a < 3; ++a)
      gi_t[a] = -(gi_r[3 * a] * pose[9] + gi_r[3 * a + 1] * pose[10]
                  + gi_r[3 * a + 2] * pose[11]);
    done = (max_iterations <= 0);
    iters = 0;
    n_corr = 0.0f;
  }
  __syncthreads();

  while (!done) {
    float r[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = pose[k];
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

    for (int p = tid; p < n; p += kThreads) {
      const float sx = src[p], sy = src[n + p], sz = src[2 * n + p];
      const float px = r[0] * sx + r[1] * sy + r[2] * sz + r[9];
      const float py = r[3] * sx + r[4] * sy + r[5] * sz + r[10];
      const float pz = r[6] * sx + r[7] * sy + r[8] * sz + r[11];
      ptudes::gn_point_moments(px, py, pz, p, n, c, feat, cx, cy, cz, inf,
                               kern, max_d2, plane_q, acc);
    }
    ptudes::gn_block_sum<kWarps>(acc, red, sums);

    if (tid == 0) {
      const float* m = sums;
      float a[6][6], b[6];
      ptudes::gn_assemble(m, a, b);
      const float tot_w = m[0] + m[44];
      if (prior_rot > 0.0f || prior_trans > 0.0f) {
        // xi = log(T_cur guess^-1)
        float rel_r[9], rel_t[3], xi[6];
        ptudes::compose(pose, pose + 9, gi_r, gi_t, rel_r, rel_t);
        ptudes::log_pose(rel_r, rel_t, xi);
        for (int u = 0; u < 6; ++u) {
          const float wp = tot_w * (u < 3 ? prior_rot : prior_trans);
          a[u][u] += wp;
          b[u] += wp * xi[u];
        }
      }
      float l[6][6], nb[6], dx[6];
      for (int u = 0; u < 6; ++u) {
        a[u][u] += 1e-8f;
        nb[u] = -b[u];
      }
      ptudes::cholesky<6>(a, l);
      ptudes::cholesky_solve<6>(l, nb, dx);
      float dr[9], dt[3], nr[9], nt[3];
      ptudes::exp_twist(dx, dr, dt);
      ptudes::compose(dr, dt, pose, pose + 9, nr, nt);
      for (int q = 0; q < 9; ++q) pose[q] = nr[q];
      for (int q = 0; q < 3; ++q) pose[9 + q] = nt[q];
      float dx2 = 0.0f;
      for (int u = 0; u < 6; ++u) dx2 += dx[u] * dx[u];
      n_corr = m[43];
      iters += 1;
      done = (dx2 < conv2) || (iters >= max_iterations);
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) out[4 * a + b] = pose[3 * a + b];
      out[4 * a + 3] = pose[9 + a];
      out[12 + a] = 0.0f;
    }
    out[15] = 1.0f;
    out[16] = n_corr;
    out[17] = static_cast<float>(iters);
    // model deviation guess^-1 pose
    float dev_r[9], dev_t[3], w[3];
    ptudes::compose(gi_r, gi_t, pose, pose + 9, dev_r, dev_t);
    out[18] = sqrtf(dev_t[0] * dev_t[0] + dev_t[1] * dev_t[1]
                    + dev_t[2] * dev_t[2]);
    ptudes::log_rot(dev_r, w);
    out[19] = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  }
}

}  // namespace

extern "C" int ptudes_icp_loop(const float* src, const float* feat,
                               const float* cx, const float* cy,
                               const float* cz, const float* inf,
                               const float* scal, float* out, int n, int c,
                               float plane_q, float conv2, float prior_rot,
                               float prior_trans, int max_iterations,
                               cudaStream_t stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  icp_loop_kernel<<<1, kThreads, 0, stream>>>(
      src, feat, cx, cy, cz, inf, scal, out, n, c, plane_q, conv2, prior_rot,
      prior_trans, max_iterations);
  return static_cast<int>(cudaGetLastError());
}
