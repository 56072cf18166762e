// K4: the whole frozen-candidate robust Gauss-Newton ICP in one launch.
//
// Replaces ptudes_tpu/ops/pallas_icp.py:icp_loop_pallas (kernel
// _make_loop_kernel). Per iteration: transform the source by the current
// pose; masked nearest neighbour over the C candidates (lowest candidate
// row wins ties); robust weights k^2 / (k + r^2)^2; point-to-plane rows
// where the patch fit has quality >= q, point-to-point moments elsewhere;
// the 45 moment sums of the 6x6 normal equations; the motion prior toward
// the guess plus a 1e-8 Tikhonov floor; the Cholesky solve; the SE(3) exp
// update; early exit on |dx| < convergence. Epilogue: pose, correspondence
// count, iterations, |t| and |log R| of guess^-1 pose (the adaptive
// threshold's model deviation).
//
// What bounds it on the card: the candidates (16*C*N bytes, 1 MB at
// N = 2048, C = 32) are read once per iteration for ~8*C*N operations,
// and each iteration ends in a serial 6x6 solve: latency, not bytes or
// operations; once the candidates are staged, the one-thread solve is the
// largest part of an iteration (tools/exp_gn_stages.py). Design: one
// thread-block cluster (ops/cuda_icp.py:loop_plan, 8 CTAs) splits the
// source points into contiguous slices, one per CTA.
// - Staged (the slice's candidate, feat and source rows fit in shared
//   memory; 139 KB a CTA at the bench shapes): the rows are copied once,
//   by bulk asynchronous copies completing on one mbarrier, in their
//   [row][point] order, and every iteration reads them from shared memory,
//   as the TPU kernel keeps its inputs in VMEM. Streamed (larger shapes,
//   e.g. N = 8192, C = 80): the same loop reads the rows from device
//   memory each iteration, spread over the cluster's SMs.
// - A CTA pass covers 256 points as 8 tiles of 32; with two warps a point
//   (streamed) each point's C rows are split into two contiguous ranges,
//   whose minima are combined in range order with strict <. One warp a
//   point when staged (shared-memory reads keep up), two when streamed
//   (twice the device-memory loads in flight): loop_groups.
// - Each CTA reduces its 45 sums in a fixed order into its own
//   partial[iteration & 1]; one cluster barrier; then every CTA reads all
//   CTAs' partials through distributed shared memory in rank order and
//   runs the same solve, so pose and exit decision agree bit for bit
//   without a broadcast. The double buffer lets one barrier per iteration
//   suffice; a last barrier keeps each CTA's shared memory alive until its
//   peers have read it. No float atomics: the result repeats bit for bit.
//   Thread 0 computes the prior's SE(3) log between arriving at and
//   waiting on the barrier.
// The tensor cores do not apply: each point has its own candidate set (no
// shared operand), and the 45 moment sums are rank-1 updates of short
// vectors, so this stays on the CUDA cores.
//
// Replica axis (the batched driver): B clusters, replica b's on grid row
// y = b, each with its own source, prepped rows, guess, kernel width,
// max_d2, iteration count and convergence; clusters share nothing, so
// replica b's result is a single launch's on its inputs, bit for bit.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;              // points per tile (a warp's lanes)
constexpr int kTiles = 8;              // tiles per CTA pass
constexpr int kPass = kTile * kTiles;  // points per CTA pass
constexpr int kAcc = ptudes::kGnAcc;
constexpr int kSideRows = 11;          // feat (8) + source (3) rows
constexpr int kMaxCluster = 8;          // the portable cluster size

// Warps that split one point's rows (the other choice measured slower on
// each side: tools/exp_gn_stages.py).
__host__ __device__ constexpr int loop_groups(bool staged) {
  return (staged != ptudes::skip(ptudes::kSwapGroups)) ? 1 : 2;
}

// scal: kern, max_d2, guess 3x4 row-major (12)                      (14)
// out:  pose 4x4 row-major (16), n_corr, iters, dev_t, dev_r        (20)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into this CTA's shared memory; completes on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

struct Inputs {
  const float* src;   // [3, N]
  const float* feat;  // [8, N]
  const float* cx;    // [C, N] each
  const float* cy;
  const float* cz;
  const float* inf;

  // Row j of the staged slice order: cx, cy, cz, inf (c rows each), feat
  // (8), source (3).
  __device__ const float* row(int j, int c, int n) const {
    const float* base[6] = {cx, cy, cz, inf, feat, src};
    int b = j < 4 * c ? j / c : (j < 4 * c + 8 ? 4 : 5);
    int r = j < 4 * c ? j - b * c : (b == 4 ? j - 4 * c : j - 4 * c - 8);
    return base[b] + static_cast<size_t>(r) * n;
  }
};

// Copy this CTA's slice (points [start, start + cnt)) of all 4c + 11 rows
// into stage ([row][ppc]): bulk copies on one mbarrier when every row
// segment is 16-byte aligned, else plain loads and stores.
__device__ void stage_slice(const Inputs& in, float* stage, uint64_t* bar,
                            int n, int c, int ppc, int start, int cnt) {
  const int rows = 4 * c + kSideRows;
  const bool aligned =
      n % 4 == 0 && ppc % 4 == 0
      && ((reinterpret_cast<uintptr_t>(in.src)
           | reinterpret_cast<uintptr_t>(in.feat)
           | reinterpret_cast<uintptr_t>(in.cx)
           | reinterpret_cast<uintptr_t>(in.cy)
           | reinterpret_cast<uintptr_t>(in.cz)
           | reinterpret_cast<uintptr_t>(in.inf)) & 15u) == 0;
  if (aligned) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        mbar_arrive_expect_tx(bar, static_cast<unsigned>(rows) * cnt * 4u);
      }
      __syncwarp();
      if (cnt > 0)
        for (int j = threadIdx.x; j < rows; j += 32)
          bulk_copy(stage + static_cast<size_t>(j) * ppc,
                    in.row(j, c, n) + start, cnt * 4u, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(bar, 0);
  } else {
    for (int i = threadIdx.x; i < rows * cnt; i += blockDim.x) {
      const int j = i / cnt, p = i - j * cnt;
      stage[static_cast<size_t>(j) * ppc + p] = in.row(j, c, n)[start + p];
    }
  }
  __syncthreads();
}

// One GN step from the moment sums m: the normal equations, the prior
// toward the guess (xi = log(T_cur guess^-1), precomputed), the Tikhonov
// floor, the Cholesky solve and the SE(3) update of pose; returns |dx|^2.
__device__ float loop_step(const float* m, const float* xi, bool prior,
                           float prior_rot, float prior_trans, float* pose) {
  float a[6][6], b[6];
  ptudes::gn_assemble(m, a, b);
  if (prior) {
    const float tot_w = m[0] + m[44];
    for (int u = 0; u < 6; ++u) {
      const float wp = tot_w * (u < 3 ? prior_rot : prior_trans);
      a[u][u] += wp;
      b[u] += wp * xi[u];
    }
  }
  float l[6][6], nb[6], dx[6];
  for (int u = 0; u < 6; ++u) {
    a[u][u] += 1e-8f;
    nb[u] = -b[u];
  }
  ptudes::cholesky<6>(a, l);
  ptudes::cholesky_solve<6>(l, nb, dx);
  float dr[9], dt[3], nr[9], nt[3];
  ptudes::exp_twist(dx, dr, dt);
  ptudes::compose(dr, dt, pose, pose + 9, nr, nt);
  for (int q = 0; q < 9; ++q) pose[q] = nr[q];
  for (int q = 0; q < 3; ++q) pose[9 + q] = nt[q];
  float dx2 = 0.0f;
  for (int u = 0; u < 6; ++u) dx2 += dx[u] * dx[u];
  return dx2;
}

template <bool kStaged>
__global__ void __launch_bounds__(kPass * loop_groups(kStaged))
icp_loop_kernel(Inputs in, const float* __restrict__ scal,
                float* __restrict__ out, int n, int c, int ppc,
                float plane_q, float conv2, float prior_rot,
                float prior_trans, int max_iterations, int prep_stride) {
  {  // this replica's rows
    const size_t rep = blockIdx.y, o = rep * prep_stride;
    in.src += rep * 3 * n;
    in.feat += o;
    in.cx += o;
    in.cy += o;
    in.cz += o;
    in.inf += o;
    scal += rep * 14;
    out += rep * 20;
  }
  constexpr int kGroups = loop_groups(kStaged);
  // staged: cx, cy, cz, inf [c][ppc], feat [8][ppc], source [3][ppc]
  extern __shared__ __align__(16) float stage[];
  __shared__ float red[kTiles][kAcc];
  __shared__ float partial[2][kAcc];
  __shared__ float sums[kAcc];
  __shared__ float4 xchg[kGroups > 1 ? kGroups - 1 : 1]
                        [kGroups > 1 ? kPass : 1];
  __shared__ float pose[12];  // R (9) then t (3)
  __shared__ int done;
  __shared__ __align__(8) uint64_t bar;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), ranks = cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = warp % kTiles, group = warp / kTiles;
  const int k0 = ptudes::row_split(c, kGroups, group),
            k1 = ptudes::row_split(c, kGroups, group + 1);
  const int start = static_cast<int>(rank) * ppc;
  const int cnt = max(0, min(ppc, n - start));

  // this CTA's slice: row k of local point p at X[k * stride + p]
  const float *s_src, *s_feat, *s_cx, *s_cy, *s_cz, *s_inf;
  int stride;
  if constexpr (kStaged) {
    stage_slice(in, stage, &bar, n, c, ppc, start, cnt);
    const size_t cp = static_cast<size_t>(c) * ppc;
    s_cx = stage; s_cy = stage + cp; s_cz = stage + 2 * cp;
    s_inf = stage + 3 * cp; s_feat = stage + 4 * cp;
    s_src = s_feat + 8 * ppc;
    stride = ppc;
  } else {
    s_src = in.src + start; s_feat = in.feat + start;
    s_cx = in.cx + start; s_cy = in.cy + start; s_cz = in.cz + start;
    s_inf = in.inf + start;
    stride = n;
  }

  const float kern = scal[0], max_d2 = scal[1];
  const bool prior = prior_rot > 0.0f || prior_trans > 0.0f;
  float gi_r[9], gi_t[3];  // guess^-1, thread 0's
  int iters = 0;
  float n_corr = 0.0f;
  if (tid == 0) {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) pose[3 * a + b] = scal[2 + 4 * a + b];
      pose[9 + a] = scal[2 + 4 * a + 3];
    }
    ptudes::transpose3(pose, gi_r);
    for (int a = 0; a < 3; ++a)
      gi_t[a] = -(gi_r[3 * a] * pose[9] + gi_r[3 * a + 1] * pose[10]
                  + gi_r[3 * a + 2] * pose[11]);
    done = (max_iterations <= 0);
  }
  __syncthreads();

  for (int it = 0; !done; ++it) {
    float r[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) r[k] = pose[k];
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

    for (int base = 0; base < cnt; base += kPass) {
      const int slot = tile * kTile + lane, p = base + slot;
      const bool valid = p < cnt;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      ptudes::Nearest nb;
      if (valid) {
        const float sx = s_src[p], sy = s_src[stride + p],
                    sz = s_src[2 * stride + p];
        px = r[0] * sx + r[1] * sy + r[2] * sz + r[9];
        py = r[3] * sx + r[4] * sy + r[5] * sz + r[10];
        pz = r[6] * sx + r[7] * sy + r[8] * sz + r[11];
        if (!ptudes::skip(ptudes::kSkipNearest))
          ptudes::gn_nearest(px, py, pz, s_cx + p, s_cy + p, s_cz + p,
                             s_inf + p, stride, k0, k1, nb);
      }
      if constexpr (kGroups > 1) {
        if (group > 0)
          xchg[group - 1][slot] = make_float4(nb.d2, nb.qx, nb.qy, nb.qz);
        __syncthreads();
        if (group == 0)
          for (int g = 1; g < kGroups; ++g) {
            const float4 v = xchg[g - 1][slot];
            nb.take(ptudes::Nearest{v.x, v.y, v.z, v.w});
          }
      }
      if (group == 0 && valid && !ptudes::skip(ptudes::kSkipMoments))
        ptudes::gn_add_moments(px, py, pz, nb, s_feat + p, stride, kern,
                               max_d2, plane_q, acc);
      if constexpr (kGroups > 1) __syncthreads();  // xchg is reused
    }
    float* mine = partial[it & 1];
    ptudes::gn_block_sum<kTiles>(acc, red, mine);

    constexpr bool kCluster = !ptudes::skip(ptudes::kSkipCluster);
    if (kCluster) cluster_arrive();
    float xi[6];
    if (tid == 0 && prior) {
      // xi = log(T_cur guess^-1), while the peers catch up
      float rel_r[9], rel_t[3];
      ptudes::compose(pose, pose + 9, gi_r, gi_t, rel_r, rel_t);
      ptudes::log_pose(rel_r, rel_t, xi);
    }
    if (kCluster) cluster_wait();

    if (warp == 0) {
      // every CTA sums all partials in rank order: bit-identical sums; the
      // remote loads are issued together, then added in order
      float v0[kMaxCluster], v1[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < static_cast<int>(ranks)) {
          const float* peer =
              kCluster ? cluster.map_shared_rank(mine, q) : mine;
          v0[q] = peer[lane];
          v1[q] = lane + 32 < kAcc ? peer[lane + 32] : 0.0f;
        }
      float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < static_cast<int>(ranks)) {
          m0 += v0[q];
          m1 += v1[q];
        }
      sums[lane] = m0;
      if (lane + 32 < kAcc) sums[lane + 32] = m1;
      __syncwarp();
      if (lane == 0) {
        const float dx2 =
            ptudes::skip(ptudes::kSkipSolve)
                ? 1.0f
                : loop_step(sums, xi, prior, prior_rot, prior_trans, pose);
        n_corr = sums[43];
        iters += 1;
        done = (dx2 < conv2) || (iters >= max_iterations);
      }
    }
    __syncthreads();
  }
  cluster.sync();  // the peers have read this CTA's partials

  if (rank == 0 && tid == 0) {
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) out[4 * a + b] = pose[3 * a + b];
      out[4 * a + 3] = pose[9 + a];
      out[12 + a] = 0.0f;
    }
    out[15] = 1.0f;
    out[16] = n_corr;
    out[17] = static_cast<float>(iters);
    // model deviation guess^-1 pose
    float dev_r[9], dev_t[3], w[3];
    ptudes::compose(gi_r, gi_t, pose, pose + 9, dev_r, dev_t);
    out[18] = sqrtf(dev_t[0] * dev_t[0] + dev_t[1] * dev_t[1]
                    + dev_t[2] * dev_t[2]);
    ptudes::log_rot(dev_r, w);
    out[19] = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  }
}

template <bool kStaged>
cudaError_t launch_loop(const Inputs& in, const float* scal, float* out,
                        int n, int c, int ppc, int cluster, float plane_q,
                        float conv2, float prior_rot, float prior_trans,
                        int max_iterations, int batch, int prep_stride,
                        cudaStream_t stream) {
  auto kernel = icp_loop_kernel<kStaged>;
  const size_t smem =
      kStaged ? static_cast<size_t>(4 * c + kSideRows) * ppc * 4 : 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);
  cfg.blockDim = dim3(kPass * loop_groups(kStaged));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, in, scal, out, n, c, ppc, plane_q,
                            conv2, prior_rot, prior_trans, max_iterations,
                            prep_stride);
}

}  // namespace

// The launch plan (ops/cuda_icp.py:loop_plan): `cluster` CTAs, CTA r
// owning points [r * ppc, (r + 1) * ppc); staged != 0 copies each CTA's
// slice into (4c + 11) * ppc * 4 bytes of dynamic shared memory. batch
// replicas, each a cluster: src [3, n] and scal [14] and out [20] a replica
// apart, feat and the candidate rows prep_stride floats apart.
extern "C" int ptudes_icp_loop(const float* src, const float* feat,
                               const float* cx, const float* cy,
                               const float* cz, const float* inf,
                               const float* scal, float* out, int n, int c,
                               float plane_q, float conv2, float prior_rot,
                               float prior_trans, int max_iterations,
                               int cluster, int ppc, int staged, int batch,
                               int prep_stride, cudaStream_t stream) {
  if (n <= 0 || c <= 0 || cluster < 1 || cluster > kMaxCluster
      || ppc <= 0 || static_cast<long long>(ppc) * cluster < n
      || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const Inputs in{src, feat, cx, cy, cz, inf};
  const cudaError_t err =
      staged ? launch_loop<true>(in, scal, out, n, c, ppc, cluster, plane_q,
                                 conv2, prior_rot, prior_trans,
                                 max_iterations, batch, prep_stride, stream)
             : launch_loop<false>(in, scal, out, n, c, ppc, cluster, plane_q,
                                  conv2, prior_rot, prior_trans,
                                  max_iterations, batch, prep_stride,
                                  stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
