// K7: per-point moments of the candidate offsets within the patch radius.
//
// Replaces ptudes_tpu/ops/pallas_gn.py:plane_moments_pallas (kernel
// _moments_kernel): for each query point q and its C lane-major
// candidates, the count n, sum d and sum d d^T (xx yy zz xy xz yz) of the
// offsets d = c - q of the valid candidates within the radius, written as
// out [16, N]: row 0 n, rows 1-3 Sd, rows 4-9 Sdd, rows 10-15 zero. It is
// the first half of K3 (the caller finishes cov = Sdd / n - m m^T); no
// pipeline path calls it since the JAX package moved the fit into K3.
//
// What bounds it on the card: device-memory bytes. Each point reads 16*C
// bytes of candidates once and writes 64 bytes (1.2 MB at N = 2048,
// C = 32: ~0.36 us at 3.35 TB/s) for ~20*C operations. One thread a point
// over its C rows would fill 8 CTAs at N = 2048 on a 132-SM card, each
// thread a serial chain of C candidates.
//
// Design: K3's (gn_prep.cu): one warp a point, 8 points a CTA (256 CTAs
// at N = 2048); C <= 376 (the tiles within 47 KB, as K3's).
// - loads: the CTA reads rows cx, cy, cz, inf [C] of its 8 points, each
//   row's 8 consecutive points one 32-byte sector, all in flight before
//   the first store for C <= 96, into [x, y, z, inf][C rows][8 points]
//   tiles in shared memory; an element's row and point come from shifts
//   (a division by the runtime C a load costs more than the load); the
//   point's slot in a row is swizzled by the row (tile_at), so the
//   row-wise stores and each warp's reads of its point's column are both
//   free of bank conflicts;
// - moments: lane k of warp w adds candidates k, k + 32, ... of point w to
//   its ten moment registers (common.cuh:patch_add, K3's arithmetic); an
//   xor butterfly sums them over the warp (common.cuh:patch_warp_sum), so
//   the order of the sums is fixed and the moments are K3's bit for bit;
//   lane 0 leaves them in shared memory;
// - stores: after the second barrier the CTA writes out [16][8 points]
//   row by row, each row one 32-byte sector.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // points a CTA: a 32-byte sector of each row
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;
constexpr int kMoments = 10;
constexpr int kLoads = 3;  // elements of each array a thread loads at once
constexpr int kMaxSmem = 47 * 1024;
constexpr float kBig = 1e30f;

__host__ __device__ constexpr int tile_bytes(int c) {
  return 4 * c * kWarps * static_cast<int>(sizeof(float));
}

// Slot of (row r, point i) in a [rows][kWarps] tile (gn_prep.cu's rule):
// the point index is xor-swizzled by r / 4, so the rows r..r+31 of one
// point fall in 32 distinct banks.
__device__ __forceinline__ int tile_at(int r, int i) {
  return r * kWarps + (i ^ ((r >> 2) & (kWarps - 1)));
}

// ptq [8, N]: rows 0-2 query x, y, z. cx/cy/cz/inf [C, N]. out [16, N].
__global__ void __launch_bounds__(kThreads)
plane_moments_kernel(const float* __restrict__ ptq,
                     const float* __restrict__ cx,
                     const float* __restrict__ cy,
                     const float* __restrict__ cz,
                     const float* __restrict__ inf, float* __restrict__ out,
                     int n, int c, float r2) {
  extern __shared__ float tile[];  // [4][C][kWarps]: x, y, z, inf
  __shared__ float mom[kWarps][kMoments];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps;

  // ---- loads: element e of each array is row e / 8, point e % 8; kLoads
  // elements of the four arrays a thread in flight before the first store
  // (one pass for C <= 96)
  const int per = c * kWarps;
  for (int e0 = threadIdx.x; e0 < per; e0 += kThreads * kLoads) {
    float v[4][kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads, i = e % kWarps;
      const bool live = e < per && p0 + i < n;
      const size_t o = static_cast<size_t>(e / kWarps) * n + p0 + i;
      v[0][u] = live ? __ldg(cx + o) : 0.0f;
      v[1][u] = live ? __ldg(cy + o) : 0.0f;
      v[2][u] = live ? __ldg(cz + o) : 0.0f;
      v[3][u] = live ? __ldg(inf + o) : kBig;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      if (e < per) {
        const int s = tile_at(e / kWarps, e % kWarps);
#pragma unroll
        for (int a = 0; a < 4; ++a) tile[a * per + s] = v[a][u];
      }
    }
  }
  __syncthreads();

  // ---- moments: warp w is point p0 + w, lane k candidates k, k + 32, ...
  const int p = p0 + w;
  if (p < n) {
    const float px = __ldg(ptq + p), py = __ldg(ptq + n + p),
                pz = __ldg(ptq + 2 * n + p);
    ptudes::PatchMoments m;
    for (int k = lane; k < c; k += 32) {
      const int s = tile_at(k, w);
      ptudes::patch_add(m, tile[s] - px, tile[c * kWarps + s] - py,
                        tile[2 * c * kWarps + s] - pz,
                        tile[3 * c * kWarps + s], r2);
    }
    m = ptudes::patch_warp_sum(m);
    if (lane == 0) {
      const float rows[kMoments] = {m.s0, m.sx, m.sy, m.sz, m.sxx,
                                    m.syy, m.szz, m.sxy, m.sxz, m.syz};
#pragma unroll
      for (int r = 0; r < kMoments; ++r) mom[w][r] = rows[r];
    }
  }
  __syncthreads();

  // ---- stores: row r, point p0 + i
  if (threadIdx.x < kRows * kWarps) {
    const int r = threadIdx.x / kWarps, i = threadIdx.x - r * kWarps;
    if (p0 + i < n)
      out[static_cast<size_t>(r) * n + p0 + i] =
          r < kMoments ? mom[i][r] : 0.0f;
  }
}

}  // namespace

extern "C" int ptudes_plane_moments(const float* ptq, const float* cx,
                                    const float* cy, const float* cz,
                                    const float* inf, float* out, int n,
                                    int c, float r2, cudaStream_t stream) {
  if (n <= 0 || c <= 0 || tile_bytes(c) > kMaxSmem)
    return cudaErrorInvalidValue;
  plane_moments_kernel<<<(n + kWarps - 1) / kWarps, kThreads, tile_bytes(c),
                         stream>>>(ptq, cx, cy, cz, inf, out, n, c, r2);
  return static_cast<int>(cudaGetLastError());
}
