// K8 and K9: the voxel hashing of the grid front end (ops/voxel.py) in
// native uint32, in place of the int64-emulated op chains.
//
// K8 grid_prededup: voxel.window_prededup_mask in one launch. A point is
// dropped when its voxel id (the 31-bit spatial hash of its half-voxel
// coordinates) also appears at a valid, causally earlier pixel of its
// range-image window: the three rows above at columns -4..4 and the
// columns -4..-1 of its own row, 31 neighbours. Columns wrap mod W (a
// 360-degree sweep); rows do not (a row above row 0 is out of the window).
//
// K9 voxel_key: the stable-sort key of voxel.first_in_voxel_sorted, one
// int32 a point: ((drop << 31) | hash31) ^ (1 << 31). Its signed order is
// (dropped, hash) order, so a stable sort of it gives the permutation the
// two-key sort gives, in 32-bit radix passes.
//
// What bounds them on the card: latency, not bytes. At the bench shapes K8
// reads 1.7 MB (points and mask of a 128 x 1024 image) and writes 131 KB,
// ~0.55 us at 3.35 TB/s; K9 reads 0.5 MB and writes 131 KB at 32768
// points, ~0.17 us. The hashes are ~40 integer operations a point. On an
// H100 (700 W) K8 takes 7.8 us a launch: its 256 CTAs (about two an SM)
// each hash 7 x 136 halo pixels in four rounds of dependent loads; K9
// takes 1.2 us. Both replace op chains of ~1 ms a scan.
//
// Design (K8): a CTA takes a tile of kTileR rows x kTileC columns. Its
// threads hash the tile and its halo (kRows - 1 rows above, kCols columns
// either side, wrapped) into shared memory once, a masked or out-of-image
// pixel as "not valid", then each output pixel compares its id with its 31
// neighbours' there. The replica axis of the batched driver is grid z.
#include "common.cuh"

namespace {

constexpr int kRows = 4;   // window rows: the pixel's own and 3 above
constexpr int kCols = 4;   // window columns either side
constexpr int kTileR = 4;
constexpr int kTileC = 128;
constexpr int kHaloR = kTileR + kRows - 1;
constexpr int kHaloC = kTileC + 2 * kCols;
constexpr int kThreads = 256;
constexpr unsigned kHash31 = 0x7FFFFFFFu;

// voxel.spatial_hash(voxel.voxel_coords(p, vs), 1 << 31) of point i: one
// multiply by the f32 reciprocal (no contraction), so the coordinates
// equal XLA's and the plain version's.
__device__ __forceinline__ unsigned point_hash31(const float* __restrict__ pts,
                                                 size_t i, float inv_vs) {
  const int qx = static_cast<int>(floorf(__fmul_rn(pts[3 * i], inv_vs)));
  const int qy = static_cast<int>(floorf(__fmul_rn(pts[3 * i + 1], inv_vs)));
  const int qz = static_cast<int>(floorf(__fmul_rn(pts[3 * i + 2], inv_vs)));
  return ptudes::mix32(ptudes::coord_hash(qx, qy, qz)) & kHash31;
}

// pts [B, H*W, 3], mask [B, H*W] bool -> keep [B, H*W] bool.
__global__ void __launch_bounds__(kThreads)
grid_prededup_kernel(const float* __restrict__ pts,
                     const unsigned char* __restrict__ mask,
                     unsigned char* __restrict__ keep, int h, int w,
                     float inv_vs) {
  __shared__ unsigned ids[kHaloR][kHaloC];
  __shared__ unsigned char ok[kHaloR][kHaloC];
  const int r0 = blockIdx.y * kTileR, c0 = blockIdx.x * kTileC;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const float* p = pts + 3 * base;
  const unsigned char* m = mask + base;

  for (int e = threadIdx.x; e < kHaloR * kHaloC; e += kThreads) {
    const int i = e / kHaloC, j = e - i * kHaloC;
    const int r = r0 - (kRows - 1) + i;
    const int c = ((c0 - kCols + j) % w + w) % w;
    unsigned id = 0u;
    unsigned char v = 0;
    if (r >= 0 && r < h) {
      const size_t q = static_cast<size_t>(r) * w + c;
      v = m[q];
      if (v) id = point_hash31(p, q, inv_vs);
    }
    ids[i][j] = id;
    ok[i][j] = v;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kTileR * kTileC; e += kThreads) {
    const int i = e / kTileC, j = e - i * kTileC;
    const int r = r0 + i, c = c0 + j;
    if (r >= h || c >= w) continue;
    const int si = i + kRows - 1, sj = j + kCols;
    bool k = ok[si][sj] != 0;
    const unsigned id = ids[si][sj];
#pragma unroll
    for (int dr = 0; dr < kRows; ++dr)
#pragma unroll
      for (int dc = -kCols; dc <= kCols; ++dc) {
        if (dr == 0 && dc >= 0) continue;
        k = k && !(ok[si - dr][sj + dc] && ids[si - dr][sj + dc] == id);
      }
    keep[base + static_cast<size_t>(r) * w + c] = k;
  }
}

// pts [N, 3], mask [N] bool -> key [N] int32.
__global__ void __launch_bounds__(kThreads)
voxel_key_kernel(const float* __restrict__ pts,
                 const unsigned char* __restrict__ mask, int* __restrict__ key,
                 int n, float inv_vs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned drop = mask[i] ? 0u : 1u;
  key[i] = static_cast<int>(((drop << 31) | point_hash31(pts, i, inv_vs))
                            ^ 0x80000000u);
}

}  // namespace

extern "C" int ptudes_grid_prededup(const float* pts,
                                    const unsigned char* mask,
                                    unsigned char* keep, int h, int w, int b,
                                    float inv_vs, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || b <= 0 || b > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((w + kTileC - 1) / kTileC, (h + kTileR - 1) / kTileR, b);
  grid_prededup_kernel<<<grid, kThreads, 0, stream>>>(pts, mask, keep, h, w,
                                                      inv_vs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptudes_voxel_key(const float* pts, const unsigned char* mask,
                                int* key, int n, float inv_vs,
                                cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  voxel_key_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pts, mask, key, n, inv_vs);
  return static_cast<int>(cudaGetLastError());
}
