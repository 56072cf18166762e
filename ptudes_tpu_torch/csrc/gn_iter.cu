// K5: one robust Gauss-Newton build against prepped candidates.
//
// Replaces ptudes_tpu/ops/pallas_gn.py:gn_prepped_pallas (kernel _kernel).
// Per source point: transform by the current pose; masked nearest
// neighbour over the C lane-major candidates (lowest candidate row wins
// ties; invalid rows carry +1e30, so "found" is d2min < 1e30); robust
// weights k^2 / (k + r^2)^2; the point-to-plane row where the patch fit has
// quality >= q, point-to-point moments elsewhere. Output: the 6x6 JtJ, Jtr,
// the correspondence count (a float sum, exact below 2^24) and the total
// weight. It is the per-iteration form of K4 (icp_loop.cu), for the
// candidate-refresh loop whose re-gathers happen between iterations.
//
// What bounds it on the card: one build streams the candidates, 16*C*N
// bytes (10.5 MB at N = 8192, C = 80; resident in the 50 MB L2 after the
// gather writes them), for ~20*C*N FLOPs: memory-latency bound, and at
// these sizes launch-bound (two launches). Design: the TPU kernel sums
// into one output block that its sequential grid revisits; here blocks
// run in parallel in no order, so each CTA of 128 threads (one thread per
// point, 64 CTAs at N = 8192: a partial wave on 132 SMs) reduces its
// points' 45 sums (warp shuffles, one shared-memory pass) into its own
// row of partial[blocks, 45], and a second, single-CTA launch sums the
// rows in block order and assembles the system. No float atomics: the
// result repeats bit for bit. The per-point body is K4's
// (common.cuh: gn_point_moments).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // ptudes_tpu_torch/ops/cuda_gn.py:GN_BLOCK
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = ptudes::kGnAcc;

// scal: kern, max_d2, pose 3x4 row-major (12)                       (14)
// partial: [blocks, 45] moment sums per CTA
// out: jtj 6x6 row-major (36), jtr (6), n_corr, total_w             (44)

__global__ void __launch_bounds__(kThreads)
gn_iter_kernel(const float* __restrict__ src,   // [N, 3]
               const float* __restrict__ feat,  // [8, N]
               const float* __restrict__ cx, const float* __restrict__ cy,
               const float* __restrict__ cz,
               const float* __restrict__ inf,   // [C, N]
               const float* __restrict__ scal,
               float* __restrict__ partial, int n, int c, float plane_q) {
  __shared__ float red[kWarps][kAcc];
  __shared__ float sums[kAcc];
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) {
    const float kern = scal[0], max_d2 = scal[1];
    const float* r = scal + 2;  // [R | t] rows
    const float sx = src[3 * p], sy = src[3 * p + 1], sz = src[3 * p + 2];
    const float px = r[0] * sx + r[1] * sy + r[2] * sz + r[3];
    const float py = r[4] * sx + r[5] * sy + r[6] * sz + r[7];
    const float pz = r[8] * sx + r[9] * sy + r[10] * sz + r[11];
    ptudes::gn_point_moments(px, py, pz, p, n, c, feat, cx, cy, cz, inf,
                             kern, max_d2, plane_q, acc);
  }
  ptudes::gn_block_sum<kWarps>(acc, red, sums);
  if (threadIdx.x < kAcc)
    partial[blockIdx.x * kAcc + threadIdx.x] = sums[threadIdx.x];
}

__global__ void __launch_bounds__(64)
gn_iter_reduce_kernel(const float* __restrict__ partial, int blocks,
                      float* __restrict__ out) {
  __shared__ float m[kAcc];
  if (threadIdx.x < kAcc) {
    float v = 0.0f;
    for (int b = 0; b < blocks; ++b) v += partial[b * kAcc + threadIdx.x];
    m[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a[6][6], b[6];
    ptudes::gn_assemble(m, a, b);
    for (int u = 0; u < 6; ++u) {
      for (int v = 0; v < 6; ++v) out[6 * u + v] = a[u][v];
      out[36 + u] = b[u];
    }
    out[42] = m[43];
    out[43] = m[0] + m[44];
  }
}

}  // namespace

extern "C" int ptudes_gn_iter(const float* src, const float* feat,
                              const float* cx, const float* cy,
                              const float* cz, const float* inf,
                              const float* scal, float* partial, float* out,
                              int n, int c, float plane_q,
                              cudaStream_t stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  gn_iter_kernel<<<blocks, kThreads, 0, stream>>>(
      src, feat, cx, cy, cz, inf, scal, partial, n, c, plane_q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_iter_reduce_kernel<<<1, 64, 0, stream>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
