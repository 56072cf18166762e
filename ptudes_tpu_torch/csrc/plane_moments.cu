// K7: per-point moments of the candidate offsets within the patch radius.
//
// Replaces ptudes_tpu/ops/pallas_gn.py:plane_moments_pallas (kernel
// _moments_kernel): for each query point q and its C lane-major candidates,
// the count n, sum d and sum d d^T (xx yy zz xy xz yz) of the offsets
// d = c - q of the valid candidates within the radius, written as
// out [16, N]: row 0 n, rows 1-3 Sd, rows 4-9 Sdd, rows 10-15 zero. It is
// the first half of K3 (the caller finishes cov = Sdd / n - m m^T); no
// pipeline path calls it since the JAX package moved the fit into K3.
//
// What bounds it on the card: device-memory bytes. Each point reads 16*C
// bytes of candidates once and writes 64 bytes (1.25 MB at N = 2048,
// C = 32: ~0.37 us at 3.35 TB/s) for ~20*C FLOPs. Design: one thread per
// point running common.cuh's patch_moments (K3's loop, the same
// arithmetic); lane-major rows make a warp's reads and writes coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;

// ptq [8, N]: rows 0-2 query x, y, z. cx/cy/cz/inf [C, N]. out [16, N].
__global__ void __launch_bounds__(kThreads)
plane_moments_kernel(const float* __restrict__ ptq,
                     const float* __restrict__ cx,
                     const float* __restrict__ cy,
                     const float* __restrict__ cz,
                     const float* __restrict__ inf, float* __restrict__ out,
                     int n, int c, float r2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const ptudes::PatchMoments m = ptudes::patch_moments(
      ptq[p], ptq[n + p], ptq[2 * n + p], p, n, c, cx, cy, cz, inf, r2);
  const float rows[10] = {m.s0, m.sx, m.sy, m.sz, m.sxx,
                          m.syy, m.szz, m.sxy, m.sxz, m.syz};
#pragma unroll
  for (int r = 0; r < 10; ++r) out[r * n + p] = rows[r];
#pragma unroll
  for (int r = 10; r < kRows; ++r) out[r * n + p] = 0.0f;
}

}  // namespace

extern "C" int ptudes_plane_moments(const float* ptq, const float* cx,
                                    const float* cy, const float* cz,
                                    const float* inf, float* out, int n,
                                    int c, float r2, cudaStream_t stream) {
  if (n <= 0 || c <= 0) return cudaErrorInvalidValue;
  plane_moments_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(ptq, cx, cy, cz, inf, out, n, c, r2);
  return static_cast<int>(cudaGetLastError());
}
