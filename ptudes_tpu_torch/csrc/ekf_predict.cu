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
// serial in k. The plain form is ~40 tiny kernels per step.
// Design: one CTA. Thread 0 runs the serial nav recurrence for all K steps
// first (it does not depend on P) and leaves each step's F parameters in
// shared memory; then 324 threads (one per covariance entry) run the K
// covariance steps with the matrices in shared memory and a barrier
// between the two products and the symmetrisation.
#include "common.cuh"

namespace {

constexpr int S = 18;
constexpr int SS = S * S;
constexpr int POS = 0, VEL = 3, PHI = 6, BG = 9, BA = 12;
constexpr int kMaxSteps = 64;
constexpr int kThreads = 352;  // 11 warps >= 324 entries

// scal input: pos[3] vel[3] quat[4] bg[3] ba[3] grav[3] ts init (22)
// imu input:  [K, 8] rows lacc[3] avel[3] ts valid
// out:        pos[3] vel[3] quat[4] ts init twist[6]           (18)
// The attitude chain runs in rotation-matrix form, like the TPU kernel;
// the quaternion conversions at both ends are done here too.

__global__ void __launch_bounds__(kThreads)
ekf_predict_kernel(const float* __restrict__ scal,
                   const float* __restrict__ imu,
                   const float* __restrict__ cov_in,
                   float* __restrict__ out, float* __restrict__ cov_out,
                   int k_steps, float acc_bias_std, float gyr_bias_std,
                   float acc_vrw, float gyr_arw) {
  __shared__ float P[SS], F[SS], T[SS];
  __shared__ float st_dt[kMaxSteps], st_r[kMaxSteps][9],
      st_rh[kMaxSteps][9], st_rd[kMaxSteps][9];
  const int tid = threadIdx.x;
  for (int i = tid; i < SS; i += blockDim.x) P[i] = cov_in[i];

  if (tid == 0) {
    float pos[3], vel[3], r[9], bg[3], ba[3], grav[3];
    for (int i = 0; i < 3; ++i) {
      pos[i] = scal[i];
      vel[i] = scal[3 + i];
      bg[i] = scal[10 + i];
      ba[i] = scal[13 + i];
      grav[i] = scal[16 + i];
    }
    ptudes::quat_to_mat(scal + 6, r);
    float ts = scal[19], init = scal[20];
    float r0[9], p0[3];
    for (int i = 0; i < 9; ++i) r0[i] = r[i];
    for (int i = 0; i < 3; ++i) p0[i] = pos[i];

    for (int k = 0; k < k_steps; ++k) {
      const float* row = imu + 8 * k;
      const float t_k = row[6], ok = row[7];
      const float eff = ok * init;
      const float dt = fmaxf(t_k - ts, 0.0f) * eff;
      float acc_body[3], rd[9];
      for (int i = 0; i < 3; ++i) acc_body[i] = row[i] - ba[i];
      ptudes::rodrigues((row[3] - bg[0]) * dt, (row[4] - bg[1]) * dt,
                        (row[5] - bg[2]) * dt, rd);
      float acc_tot[3];
      for (int i = 0; i < 3; ++i)
        acc_tot[i] = r[3 * i] * acc_body[0] + r[3 * i + 1] * acc_body[1]
                     + r[3 * i + 2] * acc_body[2] + grav[i];
      // F parameters of this step, taken at the attitude BEFORE the step
      const float h[9] = {0.0f, -acc_body[2], acc_body[1],
                          acc_body[2], 0.0f, -acc_body[0],
                          -acc_body[1], acc_body[0], 0.0f};
      ptudes::matmul3(r, h, st_rh[k]);
      for (int i = 0; i < 9; ++i) {
        st_r[k][i] = r[i];
        st_rd[k][i] = rd[i];
      }
      st_dt[k] = dt;

      for (int i = 0; i < 3; ++i) {
        pos[i] = pos[i] + vel[i] * dt + 0.5f * acc_tot[i] * dt * dt;
        vel[i] = vel[i] + acc_tot[i] * dt;
      }
      if (eff > 0.0f) {
        float rn[9];
        ptudes::matmul3(r, rd, rn);
        for (int i = 0; i < 9; ++i) r[i] = rn[i];
      }
      if (ok > 0.0f) ts = (init > 0.0f) ? fmaxf(t_k, ts) : t_k;
      init = fmaxf(init, ok);
    }
    for (int i = 0; i < 3; ++i) {
      out[i] = pos[i];
      out[3 + i] = vel[i];
    }
    ptudes::mat_to_quat(r, out + 6);
    out[10] = ts;
    out[11] = init;

    // deskew twist: log(T_in^-1 T_out)
    float r0t[9], rel_r[9], rel_t[3], dp[3];
    ptudes::transpose3(r0, r0t);
    ptudes::matmul3(r0t, r, rel_r);
    for (int i = 0; i < 3; ++i) dp[i] = pos[i] - p0[i];
    for (int i = 0; i < 3; ++i)
      rel_t[i] = r0t[3 * i] * dp[0] + r0t[3 * i + 1] * dp[1]
                 + r0t[3 * i + 2] * dp[2];
    ptudes::log_pose(rel_r, rel_t, out + 12);
  }
  __syncthreads();

  const int i = tid / S, j = tid % S;
  const bool mine = tid < SS;
  for (int k = 0; k < k_steps; ++k) {
    const float dt = st_dt[k];
    if (mine) {
      // F = I + dt-scaled blocks; dt = 0 (masked step) gives exactly I
      float f = (i == j) ? 1.0f : 0.0f;
      const int bi = i / 3 * 3, bj = j / 3 * 3, ii = i - bi, jj = j - bj;
      if (bi == POS && bj == VEL && ii == jj) f = dt;
      if (bi == PHI && bj == BG && ii == jj) f = -dt;
      if (bi == VEL && bj == PHI) f = -dt * st_rh[k][3 * ii + jj];
      if (bi == VEL && bj == BA) f = -dt * st_r[k][3 * ii + jj];
      if (bi == PHI && bj == PHI) f = st_rd[k][3 * jj + ii];  // rot_dtheta^T
      F[tid] = f;
    }
    __syncthreads();
    if (mine) {  // T = F P
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < S; ++l) s += F[i * S + l] * P[l * S + j];
      T[tid] = s;
    }
    __syncthreads();
    float pn = 0.0f;
    if (mine) {  // P' = T F^T + W
#pragma unroll
      for (int l = 0; l < S; ++l) pn += T[i * S + l] * F[j * S + l];
      if (i == j) {
        const int b = i / 3 * 3;
        if (b == VEL) pn += (dt * acc_bias_std) * (dt * acc_bias_std);
        if (b == PHI) pn += (dt * gyr_bias_std) * (dt * gyr_bias_std);
        if (b == BG) pn += dt * gyr_arw * gyr_arw;
        if (b == BA) pn += dt * acc_vrw * acc_vrw;
      }
    }
    __syncthreads();
    if (mine) T[tid] = pn;
    __syncthreads();
    if (mine) P[tid] = 0.5f * (T[tid] + T[j * S + i]);
    __syncthreads();
  }
  if (mine) cov_out[tid] = P[tid];
}

}  // namespace

extern "C" int ptudes_ekf_predict(const float* scal, const float* imu,
                                  const float* cov_in, float* out,
                                  float* cov_out, int k_steps,
                                  float acc_bias_std, float gyr_bias_std,
                                  float acc_vrw, float gyr_arw,
                                  cudaStream_t stream) {
  if (k_steps < 0 || k_steps > kMaxSteps) return cudaErrorInvalidValue;
  ekf_predict_kernel<<<1, kThreads, 0, stream>>>(
      scal, imu, cov_in, out, cov_out, k_steps, acc_bias_std, gyr_bias_std,
      acc_vrw, gyr_arw);
  return static_cast<int>(cudaGetLastError());
}
