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
// What bounds it on the card: one build reads the candidates once, 16*C*N
// bytes (10.5 MB at N = 8192, C = 80; resident in the 50 MB L2 after the
// gather writes them), for ~8*C*N operations: memory latency. Design
// (ops/cuda_gn.py:gn_plan): a CTA of 256 threads takes 32 consecutive
// points; each of its 8 warps scans one contiguous range of a point's C
// rows for all 32 points, so every load is one 128-byte row segment and
// N = 8192 is 256 CTAs, one full wave. Warp 0 combines the ranges' minima
// in range order with strict < (the lowest row still wins ties), adds the
// 32 points' moments and sums them over its lanes (a reduce-scatter) into
// the CTA's column of partial[45, blocks]. The TPU kernel sums into one
// output block that its sequential grid revisits; here the CTAs run in no
// order, so each takes an integer ticket after writing its column, and
// the CTA that draws the last ticket sums the 45 rows in a fixed order
// (warp w rows w, w + 8, ..., each lane a strided run of columns, then a
// butterfly over the lanes), assembles the system and resets the ticket
// to 0 for the next launch. The k-major layout keeps those reads
// coalesced, where per-CTA rows of 45 made the last CTA's reads strided.
// One launch per build; the ticket is the only atomic,
// so the float sums repeat bit for bit. The per-point body is
// K4's (common.cuh: gn_nearest, gn_add_moments).
//
// Replica axis (the batched driver's refresh loop, as gn_prepped_pallas
// gains a grid axis under jax.vmap): replica b's CTAs are grid row y = b,
// each replica with its own source, prepped rows (prep_stride floats
// apart), scal row, partial columns, ticket and out row, so replica b's
// output is a single launch's on its inputs, bit for bit. active[b] == 0
// (a replica that has converged or hit the cap) makes its CTAs return
// before any load: no ticket drawn, its out row left as it was. A single
// build passes one replica and no mask.
#include "common.cuh"

namespace {

constexpr int kTile = 32;                // points per CTA
constexpr int kGroups = 8;               // row ranges per point, one a warp
constexpr int kThreads = kTile * kGroups;  // ops/cuda_gn.py:GN_THREADS
constexpr int kAcc = ptudes::kGnAcc;
constexpr int kRowsPerWarp = (kAcc + kGroups - 1) / kGroups;  // last CTA

// Per replica:
// scal: kern, max_d2, pose 3x4 row-major (12)                       (14)
// partial: [45, blocks] moment sums, CTA b's in column b
// ticket: one int, 0 between launches
// out: jtj 6x6 row-major (36), jtr (6), n_corr, total_w             (44)
constexpr int kScal = 14, kOut = 44;

__global__ void __launch_bounds__(kThreads)
gn_iter_kernel(const float* __restrict__ src,   // [N, 3]
               const float* __restrict__ feat,  // [8, N]
               const float* __restrict__ cx, const float* __restrict__ cy,
               const float* __restrict__ cz,
               const float* __restrict__ inf,   // [C, N]
               const float* __restrict__ scal, float* __restrict__ partial,
               unsigned* __restrict__ ticket, float* __restrict__ out,
               const unsigned char* __restrict__ active, int n, int c,
               float plane_q, int prep_stride) {
  const size_t rep = blockIdx.y, o = rep * prep_stride;
  if (active != nullptr && !active[rep]) return;  // the whole CTA at once
  src += rep * 3 * n;
  feat += o;
  cx += o;
  cy += o;
  cz += o;
  inf += o;
  scal += rep * kScal;
  partial += rep * kAcc * gridDim.x;
  ticket += rep;
  out += rep * kOut;
  __shared__ float4 xchg[kGroups - 1][kTile];
  __shared__ float sums[kAcc];
  __shared__ int last;
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int p = blockIdx.x * kTile + lane;
  const bool valid = p < n;
  const float kern = scal[0], max_d2 = scal[1];
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  ptudes::Nearest nb;
  if (valid) {
    const float* r = scal + 2;  // [R | t] rows
    const float sx = src[3 * p], sy = src[3 * p + 1], sz = src[3 * p + 2];
    px = r[0] * sx + r[1] * sy + r[2] * sz + r[3];
    py = r[4] * sx + r[5] * sy + r[6] * sz + r[7];
    pz = r[8] * sx + r[9] * sy + r[10] * sz + r[11];
    if (!ptudes::skip(ptudes::kSkipNearest))
      ptudes::gn_nearest(px, py, pz, cx + p, cy + p, cz + p, inf + p, n,
                         ptudes::row_split(c, kGroups, group),
                         ptudes::row_split(c, kGroups, group + 1), nb);
  }
  if (group > 0)
    xchg[group - 1][lane] = make_float4(nb.d2, nb.qx, nb.qy, nb.qz);
  __syncthreads();
  if (group == 0) {
    for (int g = 1; g < kGroups; ++g) {
      const float4 v = xchg[g - 1][lane];
      nb.take(ptudes::Nearest{v.x, v.y, v.z, v.w});
    }
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
    if (valid && !ptudes::skip(ptudes::kSkipMoments))
      ptudes::gn_add_moments(px, py, pz, nb, feat + p, n, kern, max_d2,
                             plane_q, acc);
    float tot[2];
    ptudes::gn_warp_sum(acc, tot);
    if (2 * lane < kAcc) partial[2 * lane * gridDim.x + blockIdx.x] = tot[0];
    if (2 * lane + 1 < kAcc)
      partial[(2 * lane + 1) * gridDim.x + blockIdx.x] = tot[1];
    __threadfence();  // the column is visible before the ticket is
    __syncwarp();
    if (lane == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || ptudes::skip(ptudes::kSkipTail)) return;

  __threadfence();
  // warp w sums rows w, w + 8, ... of partial: lane l adds columns l,
  // l + 32, ... in order (the rows' loads issued together), then the lanes
  // in a fixed butterfly
  float run[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) run[j] = 0.0f;
#pragma unroll 4
  for (unsigned b = lane; b < gridDim.x; b += 32)
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int k = group + j * kGroups;
      if (k < kAcc) run[j] += __ldcg(partial + k * gridDim.x + b);
    }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      run[j] += __shfl_xor_sync(0xffffffffu, run[j], off);
    const int k = group + j * kGroups;
    if (lane == 0 && k < kAcc) sums[k] = run[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a[6][6], b[6];
    ptudes::gn_assemble(sums, a, b);
    for (int u = 0; u < 6; ++u) {
      for (int v = 0; v < 6; ++v) out[6 * u + v] = a[u][v];
      out[36 + u] = b[u];
    }
    out[42] = sums[43];
    out[43] = sums[0] + sums[44];
    *ticket = 0u;  // every other CTA has drawn its ticket
  }
}

}  // namespace

// replicas: grid rows; src [n, 3] a replica apart, the prepped rows
// prep_stride floats apart, scal [14], partial [45, blocks], one ticket
// and out [44] a replica apart; active: one byte a replica, or null (all)
extern "C" int ptudes_gn_iter(const float* src, const float* feat,
                              const float* cx, const float* cy,
                              const float* cz, const float* inf,
                              const float* scal, float* partial,
                              unsigned* ticket, float* out,
                              const unsigned char* active, int n, int c,
                              float plane_q, int replicas, int prep_stride,
                              cudaStream_t stream) {
  if (n <= 0 || c <= 0 || replicas <= 0 || replicas > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, replicas);
  gn_iter_kernel<<<grid, kThreads, 0, stream>>>(
      src, feat, cx, cy, cz, inf, scal, partial, ticket, out, active, n, c,
      plane_q, prep_stride);
  return static_cast<int>(cudaGetLastError());
}
