// K3: the per-point patch plane fit over the gathered ICP candidates and
// the lane-major candidate rows, in one launch.
//
// Replaces ptudes_tpu/ops/pallas_gn.py:prep_with_plane_pallas as a whole:
// its four transposes of the CandidateSet into lane-major [C, N] rows
// (:283-286) and the kernel _prep_feat_kernel. For each source point q:
// the moments of the candidate offsets d = c - q within the patch radius
// (count, sum d, sum d d^T), the covariance, its closed-form smallest
// eigenpair (planarity quality = (l_mid - l_min) / l_max) and the feat rows
// the ICP loop reads (normal, centroid, quality, source mask); and the
// candidates as the lane-major rows cx, cy, cz and inf (0 valid, 1e30
// invalid) that K4 and K5 read.
//
// What bounds it on the card: device-memory bytes. At the bench shapes
// (N = 2048, C = 32) it reads the CandidateSet (13 C bytes a point), the
// query points and the mask, and writes the lane-major rows (16 C bytes a
// point) and feat (32 bytes): ~2 MB, ~0.6 us at 3.35 TB/s, against ~20
// operations a candidate and ~150 a point for the finish. The first version
// ran one thread a point over rows that four transposes and a
// concatenation had made beforehand: 8 CTAs at N = 2048, each thread
// walking its C candidates and then the finish.
//
// Design: one warp a source point, 8 points a CTA (256 CTAs at N = 2048).
// - loads: the warp reads its point's contiguous 12 C-byte row of the
//   CandidateSet as consecutive floats and its C validity bytes (coalesced,
//   all in flight before the first store), and puts each value straight
//   into the CTA's output tiles in shared memory, [x, y, z, inf][C rows]
//   [8 points]; the point's slot in a row is swizzled by the row (tile_at),
//   so the warp's reads of its column and the row-wise stores below are
//   both free of bank conflicts;
// - moments: lane k adds candidates k, k + 32, ... of its point to its ten
//   moment registers (common.cuh:patch_add); an xor butterfly sums them
//   over the warp (common.cuh:patch_warp_sum) and lane 0 leaves them in
//   shared memory;
// - finish: after the one CTA barrier, lane i of warp 0 runs the eigen
//   finish of point i (common.cuh:plane_feat<true>: the means by the
//   count's reciprocal, smallest_eig unchanged), so eight lanes finish the
//   CTA's eight points at once and each feat row leaves as one 32-byte
//   sector; meanwhile warps 1-7 store the tiles row by row, each row's 8
//   consecutive points one 32-byte sector.
// The finish is a chain of one lane: its IEEE divisions, square roots,
// acosf and cosf make the larger part of the kernel's time.
// Moments are of offsets from q, so f32 never squares world-scale
// coordinates. The lane-major rows are copies: bit for bit the
// CandidateSet's values.
//
// Point mode (fit = 0, loss="point"): prep_with_plane_pallas skips the fit
// and writes feat as zeros, quality -1 (no correspondence takes the plane
// row) and the source mask (pallas_gn.py:288-295). The kernel is a template
// on the fit: the point instance drops the moments and the finish, lane i of
// warp 0 writing point i's constant feat column, so the lane-major rows keep
// their one launch; the plane instance is the code above.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // points a CTA: a 32-byte sector of each row
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 4;  // row floats and validity bytes a lane loads at once
constexpr int kMaxSmem = 47 * 1024;
constexpr float kBig = 1e30f;

// Shared bytes of a CTA's candidate tiles for c candidates a point.
__host__ __device__ constexpr int tile_bytes(int c) {
  return 4 * c * kWarps * static_cast<int>(sizeof(float));
}

// Slot of (row r, point i) in a [rows][kWarps] tile: the point index is
// xor-swizzled by r / 4, so the rows r..r+31 of one point fall in 32
// distinct banks and every 32 consecutive slots hold four whole rows.
__device__ __forceinline__ int tile_at(int r, int i) {
  return r * kWarps + (i ^ ((r >> 2) & (kWarps - 1)));
}

// pts [N, C, 3], valid [N, C] bool, q_w [N, 3]: the query points (source
// at the gather pose), mask [N] bool. Outputs feat [8, N] (nx ny nz,
// centroid xyz, quality, mask) and cx/cy/cz/inf [C, N].
template <bool kFit>
__global__ void __launch_bounds__(kThreads)
gn_prep_kernel(const float* __restrict__ pts,
               const unsigned char* __restrict__ valid,
               const float* __restrict__ q_w,
               const unsigned char* __restrict__ mask,
               float* __restrict__ feat, float* __restrict__ cx,
               float* __restrict__ cy, float* __restrict__ cz,
               float* __restrict__ inf, int n, int c, float r2) {
  extern __shared__ float tile[];  // [4][C][kWarps]: x, y, z, inf
  // each point's summed moments (PatchMoments, ten floats) and query
  __shared__ float mom_raw[kWarps][sizeof(ptudes::PatchMoments) / 4];
  __shared__ float4 query[kWarps];  // px, py, pz, mask
  auto* mom = reinterpret_cast<ptudes::PatchMoments*>(mom_raw);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps, p = p0 + w;
  float* t_inf = tile + 3 * c * kWarps;

  if (p < n) {
    // ---- loads: the point's row as consecutive floats and its validity
    // bytes, kLoads of each a lane in flight before the first store (one
    // pass for C <= 42), into the tiles
    [[maybe_unused]] const float px = __ldg(q_w + 3 * p),
                                 py = __ldg(q_w + 3 * p + 1),
                                 pz = __ldg(q_w + 3 * p + 2);
    const float* row = pts + static_cast<size_t>(p) * 3 * c;
    const unsigned char* ok = valid + static_cast<size_t>(p) * c;
    for (int e0 = 0; e0 < 3 * c; e0 += 32 * kLoads) {
      float v[kLoads];
      unsigned char b[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + lane + 32 * u;
        v[u] = e < 3 * c ? __ldg(row + e) : 0.0f;
        b[u] = e < c ? __ldg(ok + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + lane + 32 * u;
        if (e < 3 * c) {
          const int k = e / 3, a = e - 3 * k;
          tile[a * c * kWarps + tile_at(k, w)] = v[u];
        }
        if (e < c) t_inf[tile_at(e, w)] = b[u] ? 0.0f : kBig;
      }
    }
    if constexpr (kFit) {
      __syncwarp();

      // ---- moments: lane k is candidates k, k + 32, ...
      ptudes::PatchMoments m;
      for (int k = lane; k < c; k += 32) {
        const int s = tile_at(k, w);
        ptudes::patch_add(m, tile[s] - px, tile[c * kWarps + s] - py,
                          tile[2 * c * kWarps + s] - pz, t_inf[s], r2);
      }
      m = ptudes::patch_warp_sum(m);
      if (lane == 0) {
        mom[w] = m;
        query[w] = make_float4(px, py, pz, __ldg(mask + p) ? 1.0f : 0.0f);
      }
    }
  }
  __syncthreads();

  if (w == 0) {
    // ---- finish: lane i is point p0 + i
    const int q = p0 + lane;
    if (lane < kWarps && q < n) {
      if constexpr (kFit) {
        const float4 qm = query[lane];
        ptudes::plane_feat<true>(mom[lane], qm.x, qm.y, qm.z, qm.w, feat, q,
                                 n);
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) feat[r * n + q] = 0.0f;
        feat[6 * n + q] = -1.0f;
        feat[7 * n + q] = __ldg(mask + q) ? 1.0f : 0.0f;
      }
    }
    return;
  }
  // ---- stores (warps 1-7): row r, point p0 + i of each tile
  for (int e = threadIdx.x - 32; e < 4 * c * kWarps; e += kThreads - 32) {
    const int rr = e / kWarps, i = e - rr * kWarps;
    const int a = rr / c, r = rr - a * c;
    float* out = a == 0 ? cx : (a == 1 ? cy : (a == 2 ? cz : inf));
    if (p0 + i < n)
      out[static_cast<size_t>(r) * n + p0 + i] =
          tile[a * c * kWarps + tile_at(r, i)];
  }
}

}  // namespace

extern "C" int ptudes_gn_prep(const float* pts, const unsigned char* valid,
                              const float* q_w, const unsigned char* mask,
                              float* feat, float* cx, float* cy, float* cz,
                              float* inf, int n, int c, float r2, int fit,
                              cudaStream_t stream) {
  if (n <= 0 || c <= 0 || tile_bytes(c) > kMaxSmem)
    return cudaErrorInvalidValue;
  const int blocks = (n + kWarps - 1) / kWarps;
  if (fit)
    gn_prep_kernel<true><<<blocks, kThreads, tile_bytes(c), stream>>>(
        pts, valid, q_w, mask, feat, cx, cy, cz, inf, n, c, r2);
  else
    gn_prep_kernel<false><<<blocks, kThreads, tile_bytes(c), stream>>>(
        pts, valid, q_w, mask, feat, cx, cy, cz, inf, n, c, r2);
  return static_cast<int>(cudaGetLastError());
}
