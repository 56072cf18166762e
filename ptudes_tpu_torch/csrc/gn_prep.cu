// K3: per-point patch plane fit over the gathered ICP candidates.
//
// Replaces ptudes_tpu/ops/pallas_gn.py:prep_with_plane_pallas (kernel
// _prep_feat_kernel): for each source point q, the moments of the candidate
// offsets d = c - q within the patch radius (count, sum d, sum d d^T), the
// covariance, its closed-form smallest eigenpair (planarity quality =
// (l_mid - l_min) / l_max) and the feat rows the ICP loop reads: normal,
// centroid, quality, source mask.
//
// What bounds it on the card: device-memory bytes. Each point reads its C
// candidates' x, y, z and validity once (16*C bytes: 1 MB at N = 2048,
// C = 32) for ~20*C FLOPs, far below the card's ~20 FLOP/byte balance.
// Design: one thread per point, looping over C with a private set of ten
// moment registers (common.cuh: patch_moments, plane_feat, shared with K6
// and K7). The candidate tensors keep the lane-major [C, N] layout of the
// TPU kernel, which on the GPU makes the 32 threads of a warp read 32
// consecutive floats of each row: fully coalesced. Moments are of offsets
// from q, so f32 never squares world-scale coordinates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ptq [4, N]: query x, y, z (source at the gather pose), source mask.
// cx/cy/cz/inf [C, N]: candidates, inf = 0 valid / 1e30 invalid.
// feat [8, N]: nx ny nz, centroid xyz, quality, mask.
__global__ void __launch_bounds__(kThreads)
gn_prep_kernel(const float* __restrict__ ptq, const float* __restrict__ cx,
               const float* __restrict__ cy, const float* __restrict__ cz,
               const float* __restrict__ inf, float* __restrict__ feat,
               int n, int c, float r2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float px = ptq[p], py = ptq[n + p], pz = ptq[2 * n + p];
  const ptudes::PatchMoments m =
      ptudes::patch_moments(px, py, pz, p, n, c, cx, cy, cz, inf, r2);
  ptudes::plane_feat(m, px, py, pz, ptq[3 * n + p], feat, p, n);
}

}  // namespace

extern "C" int ptudes_gn_prep(const float* ptq, const float* cx,
                              const float* cy, const float* cz,
                              const float* inf, float* feat, int n, int c,
                              float r2, cudaStream_t stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  gn_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ptq, cx, cy, cz, inf, feat, n, c, r2);
  return static_cast<int>(cudaGetLastError());
}
