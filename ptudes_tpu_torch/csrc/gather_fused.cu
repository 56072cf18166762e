// K6: the fused ICP candidate gather — probe match, top-V voxel selection,
// packed-point unpack, validity and the patch plane fit — in one launch.
//
// Replaces ptudes_tpu/ops/pallas_gather.py:gather_prep_fused (kernels
// _make_select_kernel and _make_prep_kernel). On the TPU the hashing, both
// row gathers and five transposes stay in XLA around the two kernels,
// because a DMA per scattered 32-byte row costs more than XLA's gather and
// the points sit on lanes in (NS, 128) tiles. On Hopper a warp reads its
// own rows.
//
// What bounds it on the card: the latency of two dependent rounds of
// scattered device-memory reads (the meta rows, then the point rows of the
// picked voxels) at a partial wave. Its bytes are ~0.5 us at 3.35 TB/s at
// the bench shapes (N = 2048, J = 7, R = 1, V = 4, P = 8): 2048 x 7 meta
// rows of 32 B, 2048 x 4 point rows of 32 B and 1.1 MB of lane-major
// candidates out. One thread a point gave 64 warps, each walking its J
// neighbours and V x P candidates one after another.
//
// Design: one warp per source point, 8 points a CTA (N warps fill the
// card), and nothing between the stages leaves the chip:
//   select: lane j < J hashes neighbour j (native uint32), walks the R
//     probes of its own 32-byte meta row (first match wins) and computes
//     the distance d_j of the representative, so the J loads are in flight
//     at once; a matched lane's rank is the number of matched lanes with a
//     smaller (d, j), and ranks below V are the selection, in the warp's
//     shared memory (optionally also written to aux i32 [5V, N]: slot,
//     count, corner x, y, z of each selected voxel);
//   prep: lane c takes the candidates c, c + 32, ... < V x P: its packed
//     int from the selected voxel's row (a voxel's P ints neighbour each
//     other), the unpack and the validity; the ten patch moments are summed
//     over the warp by shuffles and lane 0 runs the eigen finish;
//   stores: the lane-major cx/cy/cz/inf [V*P, N] and feat [8, N] are staged
//     as [rows x 8 points] tiles in shared memory, so each store
//     instruction writes whole 32-byte sectors of consecutive points.
//
// Semantics are the TPU select kernel's own, not ops/icp.gather_candidates':
// an unmatched neighbour has distance 1e30 (count 0, slot 0); ties go to the
// lowest neighbour index; once fewer than V voxels matched, every later
// selection is neighbour 0 (the iterative first-argmin over all-1e30
// distances) with neighbour 0's slot and count 0. Candidates decode from
// the selected key qc + offset[j] as (corner + (u + 0.5) / 1024) * vs: the
// product is exact, so the coordinates equal the plain version's bit for
// bit.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // points a CTA: a 32-byte sector of each row
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxV = 8;
constexpr int kMaxSmem = 47 * 1024;  // + the selection: 48 KB, no opt-in
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;
constexpr float kInvQ = 1.0f / 1024.0f;  // hashmap.QSCALE = 2^QBITS

// The 27 voxel neighbour offsets ordered by L1 norm (centre, 6 faces,
// 12 edges, 8 corners): hashmap._NEIGHBOR_OFFSETS / icp.neighbor_offsets.
__constant__ int kOffsets[27][3] = {
    {0, 0, 0},
    {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 1}, {0, 1, 0}, {1, 0, 0},
    {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 1}, {-1, 1, 0}, {0, -1, -1},
    {0, -1, 1}, {0, 1, -1}, {0, 1, 1}, {1, -1, 0}, {1, 0, -1}, {1, 0, 1},
    {1, 1, 0},
    {-1, -1, -1}, {-1, -1, 1}, {-1, 1, -1}, {-1, 1, 1}, {1, -1, -1},
    {1, -1, 1}, {1, 1, -1}, {1, 1, 1}};

// Shared bytes of a CTA's output tiles for c candidates a point.
__host__ __device__ constexpr int tile_bytes(int c) {
  return (4 * c + 8) * kWarps * static_cast<int>(sizeof(float));
}

// The sum of v over the warp, in every lane (fixed butterfly order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// pts [N, 3]: query points (the source at the gather pose); mask [N] bool;
// meta [cap, 8] i32; points [cap, P] i32 packed. Outputs feat [8, N],
// cx/cy/cz/inf [V*P, N] and, unless null, aux [5V, N]. plane = 0 is
// loss="point": feat rows 0-5 zero, quality -1.
__global__ void __launch_bounds__(kThreads)
gather_fused_kernel(const float* __restrict__ pts,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ meta,
                    const int* __restrict__ points, int* __restrict__ aux,
                    float* __restrict__ feat, float* __restrict__ cx,
                    float* __restrict__ cy, float* __restrict__ cz,
                    float* __restrict__ inf, int n, int cap, int n_nb,
                    int probes, int v_n, int ppv, float inv_vs, float vs,
                    float r2, int plane) {
  extern __shared__ float tile[];  // [4][C][kWarps] candidates, [8][kWarps]
  __shared__ int sel_slot[kWarps][kMaxV], sel_cnt[kWarps][kMaxV],
      sel_j[kWarps][kMaxV];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps, p = p0 + w;
  const int c_n = v_n * ppv;
  float* t_x = tile;
  float* t_y = t_x + c_n * kWarps;
  float* t_z = t_y + c_n * kWarps;
  float* t_inf = t_z + c_n * kWarps;
  float* t_feat = t_inf + c_n * kWarps;

  if (p < n) {
    const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
    // voxel.voxel_coords: one multiply by the f32 reciprocal, so nothing
    // can contract and the coordinates equal XLA's and the plain version's
    const int qx = static_cast<int>(floorf(px * inv_vs));
    const int qy = static_cast<int>(floorf(py * inv_vs));
    const int qz = static_cast<int>(floorf(pz * inv_vs));

    // ---- select: lane j is neighbour j
    bool found = false;
    int s = 0, cnt = 0;
    float d = kBig;
    if (lane < n_nb) {
      int fp, h0;
      ptudes::fingerprint_and_slot(qx + kOffsets[lane][0],
                                   qy + kOffsets[lane][1],
                                   qz + kOffsets[lane][2], cap, &fp, &h0);
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;
      for (int r = 0; r < probes && !found; ++r) {  // the first match wins
        const int sr = (h0 + r) & (cap - 1);
        const int* row = meta + 8 * static_cast<size_t>(sr);
        const int4 head = __ldg(reinterpret_cast<const int4*>(row));
        if (head.x == fp) {
          found = true;
          s = sr;
          cnt = head.y;
          rx = __int_as_float(head.z);
          ry = __int_as_float(head.w);
          rz = __int_as_float(__ldg(row + 4));
        }
      }
      if (found) {
        // (rx - px)^2 + (ry - py)^2 + (rz - pz)^2 rounded step by step, as
        // the TPU kernel and the plain version: a contracted FMA would
        // move ties
        const float dx = __fsub_rn(rx, px), dy = __fsub_rn(ry, py),
                    dz = __fsub_rn(rz, pz);
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
      }
    }
    // a match at d >= 1e30 is no match (the sentinel compares equal)
    const bool ok = found && d < kBig;
    const float key = ok ? d : kBig;
    const int slot0 = __shfl_sync(kFull, s, 0);  // the junk pick's slot
    const int n_ok = __popc(__ballot_sync(kFull, ok));
    int rank = 0;  // matched neighbours with a smaller (d, j)
    for (int i = 0; i < n_nb; ++i) {
      const float di = __shfl_sync(kFull, key, i);
      rank += (di < key || (di == key && i < lane)) ? 1 : 0;
    }
    if (ok && rank < v_n) {
      sel_slot[w][rank] = s;
      sel_cnt[w][rank] = cnt;
      sel_j[w][rank] = lane;
    }
    if (lane >= n_ok && lane < v_n) {  // fewer than V matched: neighbour 0
      sel_slot[w][lane] = slot0;
      sel_cnt[w][lane] = 0;
      sel_j[w][lane] = 0;
    }
    __syncwarp();
    if (aux != nullptr && lane < v_n) {
      const int j = sel_j[w][lane];
      aux[lane * n + p] = sel_slot[w][lane];
      aux[(v_n + lane) * n + p] = sel_cnt[w][lane];
      aux[(2 * v_n + lane) * n + p] = qx + kOffsets[j][0];
      aux[(3 * v_n + lane) * n + p] = qy + kOffsets[j][1];
      aux[(4 * v_n + lane) * n + p] = qz + kOffsets[j][2];
    }

    // ---- prep: lane c is candidates c, c + 32, ...
    ptudes::PatchMoments m;
    for (int c = lane; c < c_n; c += 32) {
      const int v = c / ppv, k = c - v * ppv;
      const int j = sel_j[w][v];
      const float cox = static_cast<float>(qx + kOffsets[j][0]);
      const float coy = static_cast<float>(qy + kOffsets[j][1]);
      const float coz = static_cast<float>(qz + kOffsets[j][2]);
      const int q = __ldg(points + static_cast<size_t>(sel_slot[w][v]) * ppv
                          + k);
      const float ux = static_cast<float>(q & 1023);
      const float uy = static_cast<float>((q >> 10) & 1023);
      const float uz = static_cast<float>((q >> 20) & 1023);
      const float x = __fmul_rn(cox + (ux + 0.5f) * kInvQ, vs);
      const float y = __fmul_rn(coy + (uy + 0.5f) * kInvQ, vs);
      const float z = __fmul_rn(coz + (uz + 0.5f) * kInvQ, vs);
      const float bad = (k < sel_cnt[w][v]) ? 0.0f : kBig;
      const int o = c * kWarps + w;
      t_x[o] = x; t_y[o] = y; t_z[o] = z; t_inf[o] = bad;
      if (plane) ptudes::patch_add(m, x - px, y - py, z - pz, bad, r2);
    }
    const float mk = mask[p] ? 1.0f : 0.0f;
    if (plane) {
      m.s0 = warp_sum(m.s0);
      m.sx = warp_sum(m.sx); m.sy = warp_sum(m.sy); m.sz = warp_sum(m.sz);
      m.sxx = warp_sum(m.sxx); m.syy = warp_sum(m.syy);
      m.szz = warp_sum(m.szz);
      m.sxy = warp_sum(m.sxy); m.sxz = warp_sum(m.sxz);
      m.syz = warp_sum(m.syz);
      if (lane == 0) ptudes::plane_feat(m, px, py, pz, mk, t_feat, w, kWarps);
    } else if (lane < 8) {
      // quality -1: never takes the plane row
      t_feat[lane * kWarps + w] = lane < 6 ? 0.0f : (lane == 6 ? -1.0f : mk);
    }
  }
  __syncthreads();

  // ---- stores: row r, point p0 + i of each tile at element r * 8 + i
  for (int e = threadIdx.x; e < c_n * kWarps; e += kThreads) {
    const int r = e / kWarps, i = e - r * kWarps;
    if (p0 + i < n) {
      const size_t o = static_cast<size_t>(r) * n + p0 + i;
      cx[o] = t_x[e]; cy[o] = t_y[e]; cz[o] = t_z[e]; inf[o] = t_inf[e];
    }
  }
  if (threadIdx.x < 8 * kWarps) {
    const int r = threadIdx.x / kWarps, i = threadIdx.x - r * kWarps;
    if (p0 + i < n) feat[static_cast<size_t>(r) * n + p0 + i] =
        t_feat[threadIdx.x];
  }
}

}  // namespace

extern "C" int ptudes_gather_fused(const float* pts, const unsigned char* mask,
                                   const int* meta, const int* points,
                                   int* aux, float* feat, float* cx,
                                   float* cy, float* cz, float* inf, int n,
                                   int cap, int n_nb, int probes, int v_n,
                                   int ppv, float inv_vs, float vs, float r2,
                                   int plane, cudaStream_t stream) {
  if (n <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || n_nb < 1
      || n_nb > 27 || probes < 1 || v_n < 1 || v_n > kMaxV || ppv < 1
      || tile_bytes(v_n * ppv) > kMaxSmem)
    return cudaErrorInvalidValue;
  gather_fused_kernel<<<(n + kWarps - 1) / kWarps, kThreads,
                        tile_bytes(v_n * ppv), stream>>>(
      pts, mask, meta, points, aux, feat, cx, cy, cz, inf, n, cap, n_nb,
      probes, v_n, ppv, inv_vs, vs, r2, plane);
  return static_cast<int>(cudaGetLastError());
}
