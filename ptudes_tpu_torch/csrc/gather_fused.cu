// K6: the fused ICP candidate gather — probe match, top-V voxel selection,
// packed-point unpack, validity and the patch plane fit — in two launches.
//
// Replaces ptudes_tpu/ops/pallas_gather.py:gather_prep_fused (kernels
// _make_select_kernel and _make_prep_kernel). On the TPU the hashing, both
// row gathers and five transposes stay in XLA around the two kernels,
// because a DMA per scattered 32-byte row costs more than XLA's gather and
// the points sit on lanes in (NS, 128) tiles. On Hopper a thread reads its
// own rows, so each launch is one thread per source point doing all of it:
//
//   select: voxel coords of the query point, J neighbour fingerprints and
//     home slots (native uint32 hash), R probes of its own 32-byte meta
//     rows, a running top-V list by representative distance. Writes aux
//     i32 [5V, N]: slot, count, corner x, y, z of each selected voxel.
//   prep: V x P packed points of the selected rows, unpack, validity, the
//     lane-major cx/cy/cz/inf [V*P, N] outputs (thread p writes column p:
//     a warp writes 32 consecutive floats of a row) and the ten-moment
//     patch plane fit with the eigen finish into feat [8, N].
//
// Semantics are the TPU select kernel's own, not ops/icp.gather_candidates':
// an unmatched neighbour has distance 1e30 (count 0, slot 0); ties go to the
// lowest neighbour index; once fewer than V voxels matched, every later
// selection is neighbour 0 (the iterative first-argmin over all-1e30
// distances) with count 0. Candidates decode from the selected key
// qc + offset[j] as (corner + (u + 0.5) / 1024) * vs: the product is exact,
// so the coordinates equal the plain version's bit for bit.
//
// What bounds it on the card: device-memory bytes, all of them scattered.
// At the bench shapes (N = 2048, J = 7, R = 1, V = 4, P = 8) a call reads
// 2048 x 7 meta rows of 32 B (459 KB) and 2048 x 4 point rows of 32 B
// (262 KB) and writes 1.1 MB of lane-major candidates: ~0.56 us at
// 3.35 TB/s. N = 2048 threads are a partial wave on 132 SMs, so the call
// is latency-bound (dependent hash -> row -> row loads); the design keeps
// every intermediate in registers and out of device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // 32 CTAs at N = 2048: more SMs' load units
constexpr int kMaxV = 8;
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

// pts [N, 3]: query points (source at the gather pose). meta [cap, 8] i32.
// aux [5V, N] i32: slot, count, corner x, y, z of each selected voxel.
__global__ void __launch_bounds__(kThreads)
gather_select_kernel(const float* __restrict__ pts,
                     const int* __restrict__ meta, int* __restrict__ aux,
                     int n, int cap, int n_nb, int probes, int v_n,
                     float inv_vs) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  // voxel.voxel_coords: one multiply by the f32 reciprocal, so nothing can
  // contract and the coordinates equal XLA's and the plain version's
  const int qx = static_cast<int>(floorf(px * inv_vs));
  const int qy = static_cast<int>(floorf(py * inv_vs));
  const int qz = static_cast<int>(floorf(pz * inv_vs));

  // the selected voxels so far, sorted by (distance, neighbour index)
  float top_d[kMaxV];
  int top_s[kMaxV], top_c[kMaxV], top_j[kMaxV];
#pragma unroll
  for (int k = 0; k < kMaxV; ++k) {
    top_d[k] = kBig;
    top_s[k] = 0; top_c[k] = 0; top_j[k] = 0;
  }
  int slot0 = 0;  // neighbour 0's slot (0 unless matched): the junk pick
  for (int j = 0; j < n_nb; ++j) {
    int fp, h0;
    ptudes::fingerprint_and_slot(qx + kOffsets[j][0], qy + kOffsets[j][1],
                                 qz + kOffsets[j][2], cap, &fp, &h0);
    bool found = false;
    int s = 0, cnt = 0;
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
    if (j == 0) slot0 = s;
    if (!found) continue;
    // (rx - px)^2 + (ry - py)^2 + (rz - pz)^2 rounded step by step, as the
    // TPU kernel and the plain version: a contracted FMA would move ties
    const float dx = __fsub_rn(rx, px), dy = __fsub_rn(ry, py),
                dz = __fsub_rn(rz, pz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    // insert after every entry with distance <= d (strict: equal distances
    // keep the lower neighbour index first)
#pragma unroll
    for (int k = kMaxV - 1; k > 0; --k) {
      if (top_d[k - 1] > d) {
        top_d[k] = top_d[k - 1]; top_s[k] = top_s[k - 1];
        top_c[k] = top_c[k - 1]; top_j[k] = top_j[k - 1];
      } else if (top_d[k] > d) {
        top_d[k] = d; top_s[k] = s; top_c[k] = cnt; top_j[k] = j;
      }
    }
    if (top_d[0] > d) {
      top_d[0] = d; top_s[0] = s; top_c[0] = cnt; top_j[0] = j;
    }
  }
#pragma unroll
  for (int v = 0; v < kMaxV; ++v) {
    if (v >= v_n) break;
    const bool ok = top_d[v] < kBig;
    const int j = ok ? top_j[v] : 0;
    aux[v * n + p] = ok ? top_s[v] : slot0;
    aux[(v_n + v) * n + p] = ok ? top_c[v] : 0;
    aux[(2 * v_n + v) * n + p] = qx + kOffsets[j][0];
    aux[(3 * v_n + v) * n + p] = qy + kOffsets[j][1];
    aux[(4 * v_n + v) * n + p] = qz + kOffsets[j][2];
  }
}

// pts [N, 3], mask [N] (bool), aux [5V, N] from the select kernel,
// points [cap, P] i32 packed. Outputs feat [8, N] and cx/cy/cz/inf
// [V*P, N]. plane = 0 is loss="point": feat rows 0-5 zero, quality -1.
__global__ void __launch_bounds__(kThreads)
gather_prep_kernel(const float* __restrict__ pts,
                   const unsigned char* __restrict__ mask,
                   const int* __restrict__ aux,
                   const int* __restrict__ points, float* __restrict__ feat,
                   float* __restrict__ cx, float* __restrict__ cy,
                   float* __restrict__ cz, float* __restrict__ inf, int n,
                   int v_n, int ppv, float vs, float r2, int plane) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  ptudes::PatchMoments m;
  for (int v = 0; v < v_n; ++v) {
    const int* row = points + static_cast<size_t>(aux[v * n + p]) * ppv;
    const int cnt = aux[(v_n + v) * n + p];
    const float cox = static_cast<float>(aux[(2 * v_n + v) * n + p]);
    const float coy = static_cast<float>(aux[(3 * v_n + v) * n + p]);
    const float coz = static_cast<float>(aux[(4 * v_n + v) * n + p]);
    for (int k = 0; k < ppv; ++k) {
      const int q = __ldg(row + k);
      const float ux = static_cast<float>(q & 1023);
      const float uy = static_cast<float>((q >> 10) & 1023);
      const float uz = static_cast<float>((q >> 20) & 1023);
      const float x = __fmul_rn(cox + (ux + 0.5f) * kInvQ, vs);
      const float y = __fmul_rn(coy + (uy + 0.5f) * kInvQ, vs);
      const float z = __fmul_rn(coz + (uz + 0.5f) * kInvQ, vs);
      const float bad = (k < cnt) ? 0.0f : kBig;
      const int o = (v * ppv + k) * n + p;
      cx[o] = x; cy[o] = y; cz[o] = z; inf[o] = bad;
      if (plane) ptudes::patch_add(m, x - px, y - py, z - pz, bad, r2);
    }
  }
  const float mk = mask[p] ? 1.0f : 0.0f;
  if (plane) {
    ptudes::plane_feat(m, px, py, pz, mk, feat, p, n);
  } else {
#pragma unroll
    for (int r = 0; r < 6; ++r) feat[r * n + p] = 0.0f;
    feat[6 * n + p] = -1.0f;  // quality -1: never takes the plane row
    feat[7 * n + p] = mk;
  }
}

}  // namespace

extern "C" int ptudes_gather_select(const float* pts, const int* meta,
                                    int* aux, int n, int cap, int n_nb,
                                    int probes, int v_n, float inv_vs,
                                    cudaStream_t stream) {
  if (n <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || n_nb < 1
      || n_nb > 27 || probes < 1 || v_n < 1 || v_n > kMaxV)
    return cudaErrorInvalidValue;
  gather_select_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(pts, meta, aux, n, cap, n_nb, probes, v_n,
                                   inv_vs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptudes_gather_prep(const float* pts, const unsigned char* mask,
                                  const int* aux, const int* points,
                                  float* feat, float* cx, float* cy,
                                  float* cz, float* inf, int n, int v_n,
                                  int ppv, float vs, float r2, int plane,
                                  cudaStream_t stream) {
  if (n <= 0 || v_n < 1 || v_n > kMaxV || ppv < 1)
    return cudaErrorInvalidValue;
  gather_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pts, mask, aux, points, feat, cx, cy, cz, inf, n, v_n, ppv, vs, r2,
      plane);
  return static_cast<int>(cudaGetLastError());
}
