// Scalar SO(3)/SE(3) helpers shared by the kernels: the device-side
// counterparts of ptudes_tpu_torch.geom (same small-angle switches,
// _EPS = 1e-8). Matrices are 9 floats, row-major; poses are (R, t).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ptudes {

constexpr float kEps = 1e-8f;

// exp(rotvec) by Rodrigues' formula; also returns theta^2 and the
// (1 - cos)/theta^2 coefficient, which exp_twist reuses.
__device__ __forceinline__ void rodrigues(float wx, float wy, float wz,
                                          float* r, float* t2_out = nullptr,
                                          float* b_out = nullptr) {
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(t2);
  const bool small = theta < kEps;
  const float safe_t2 = small ? 1.0f : t2;
  const float a = small ? 1.0f - t2 / 6.0f : sinf(theta) / sqrtf(safe_t2);
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(theta)) / safe_t2;
  const float xx = wx * wx, yy = wy * wy, zz = wz * wz;
  const float xy = wx * wy, xz = wx * wz, yz = wy * wz;
  r[0] = 1.0f + b * (-yy - zz); r[1] = -a * wz + b * xy; r[2] = a * wy + b * xz;
  r[3] = a * wz + b * xy; r[4] = 1.0f + b * (-xx - zz); r[5] = -a * wx + b * yz;
  r[6] = -a * wy + b * xz; r[7] = a * wx + b * yz; r[8] = 1.0f + b * (-xx - yy);
  if (t2_out) *t2_out = t2;
  if (b_out) *b_out = b;
}

// xyzw quaternion -> rotation matrix (geom.so3.quat_to_mat).
__device__ __forceinline__ void quat_to_mat(const float* q, float* r) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.0f - 2.0f * (yy + zz); r[1] = 2.0f * (xy - wz); r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz); r[4] = 1.0f - 2.0f * (xx + zz); r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy); r[7] = 2.0f * (yz + wx); r[8] = 1.0f - 2.0f * (xx + yy);
}

// rotation matrix -> unit xyzw quaternion with w >= 0 (geom.so3.mat_to_quat:
// Shepperd's method, the first of equal pivots wins like argmax).
__device__ __forceinline__ void mat_to_quat(const float* m, float* q) {
  const float tr = m[0] + m[4] + m[8];
  const float c[4] = {tr, m[0] - m[4] - m[8], m[4] - m[0] - m[8],
                      m[8] - m[0] - m[4]};
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (c[k] > c[best]) best = k;
  float v[4];
  if (best == 0) {
    v[0] = m[7] - m[5]; v[1] = m[2] - m[6]; v[2] = m[3] - m[1];
    v[3] = 1.0f + tr;
  } else if (best == 1) {
    v[0] = 1.0f + m[0] - m[4] - m[8]; v[1] = m[1] + m[3]; v[2] = m[2] + m[6];
    v[3] = m[7] - m[5];
  } else if (best == 2) {
    v[0] = m[1] + m[3]; v[1] = 1.0f + m[4] - m[0] - m[8]; v[2] = m[5] + m[7];
    v[3] = m[2] - m[6];
  } else {
    v[0] = m[2] + m[6]; v[1] = m[5] + m[7]; v[2] = 1.0f + m[8] - m[0] - m[4];
    v[3] = m[3] - m[1];
  }
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
  const float d = fmaxf(n, kEps);
  const float sign = (v[3] < 0.0f) ? -1.0f : 1.0f;
  for (int k = 0; k < 4; ++k) q[k] = v[k] / d * sign;
}

// c = a @ b for 3x3 row-major matrices (c must not alias a or b).
__device__ __forceinline__ void matmul3(const float* a, const float* b,
                                        float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
                     + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void transpose3(const float* a, float* at) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) at[3 * j + i] = a[3 * i + j];
}

// (Ra, ta) o (Rb, tb): R = Ra Rb, t = Ra tb + ta.
__device__ __forceinline__ void compose(const float* ra, const float* ta,
                                        const float* rb, const float* tb,
                                        float* r, float* t) {
  matmul3(ra, rb, r);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = ra[3 * i] * tb[0] + ra[3 * i + 1] * tb[1] + ra[3 * i + 2] * tb[2]
           + ta[i];
}

// se(3) exp of a twist [rot, trans] -> (R, t).
__device__ __forceinline__ void exp_twist(const float* dx, float* r,
                                          float* t) {
  const float wx = dx[0], wy = dx[1], wz = dx[2];
  float t2, b;
  rodrigues(wx, wy, wz, r, &t2, &b);
  const float theta = sqrtf(t2);
  const bool small = theta < kEps;
  const float safe_t2 = small ? 1.0f : t2;
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f
                        : (theta - sinf(theta)) / (safe_t2 * sqrtf(safe_t2));
  const float xx = wx * wx, yy = wy * wy, zz = wz * wz;
  const float xy = wx * wy, xz = wx * wz, yz = wy * wz;
  const float v[9] = {1.0f + c * (-yy - zz), -b * wz + c * xy, b * wy + c * xz,
                      b * wz + c * xy, 1.0f + c * (-xx - zz), -b * wx + c * yz,
                      -b * wy + c * xz, b * wx + c * yz, 1.0f + c * (-xx - yy)};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = v[3 * i] * dx[3] + v[3 * i + 1] * dx[4] + v[3 * i + 2] * dx[5];
}

// SO(3) log by the direct axis-angle formula, stable for |rot| well below
// pi (EKF residuals, ICP refinements, one sweep of motion). The TPU
// kernels seed a Newton iteration because Mosaic lowers no arccos; CUDA
// has acosf. Returns theta.
__device__ __forceinline__ float log_rot(const float* r, float* w) {
  const float tr = r[0] + r[4] + r[8];
  const float cos_t = fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float theta = acosf(cos_t);
  const float t2 = theta * theta;
  const bool small = theta < 1e-4f;
  const float fac = small ? 0.5f + t2 / 12.0f
                          : theta / fmaxf(2.0f * sinf(theta), kEps);
  w[0] = fac * (r[7] - r[5]);
  w[1] = fac * (r[2] - r[6]);
  w[2] = fac * (r[3] - r[1]);
  return theta;
}

// SE(3) log -> twist [rot(3), trans(3)].
__device__ __forceinline__ void log_pose(const float* r, const float* t,
                                         float* tw) {
  const float theta = log_rot(r, tw);
  const float wx = tw[0], wy = tw[1], wz = tw[2];
  const float t2 = theta * theta;
  const bool small = theta < 1e-4f;
  const float safe_t2 = small ? 1.0f : t2;
  const float half = 0.5f * theta;
  const float cot = small ? 1.0f / 12.0f + t2 / 720.0f
                          : (1.0f - half * cosf(half) / fmaxf(sinf(half), kEps))
                                / safe_t2;
  const float xx = wx * wx, yy = wy * wy, zz = wz * wz;
  const float xy = wx * wy, xz = wx * wz, yz = wy * wz;
  const float vi[9] = {1.0f + cot * (-yy - zz), 0.5f * wz + cot * xy,
                       -0.5f * wy + cot * xz, -0.5f * wz + cot * xy,
                       1.0f + cot * (-xx - zz), 0.5f * wx + cot * yz,
                       0.5f * wy + cot * xz, -0.5f * wx + cot * yz,
                       1.0f + cot * (-xx - yy)};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    tw[3 + i] = vi[3 * i] * t[0] + vi[3 * i + 1] * t[1] + vi[3 * i + 2] * t[2];
}

// Cholesky solve of a symmetric positive-definite n x n system (n <= 6),
// pivots floored at 1e-12 like geom.linalg.solve_spd6.
template <int N>
__device__ __forceinline__ void cholesky(const float (*a)[N], float (*l)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= l[i][k] * l[j][k];
      l[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / l[j][j];
    }
}

template <int N>
__device__ __forceinline__ void cholesky_solve(const float (*l)[N],
                                               const float* b, float* x) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= l[k][i] * x[k];
    x[i] = s / l[i][i];
  }
}

// ---- the robust Gauss-Newton build shared by K4 (icp_loop.cu) and K5
// (gn_iter.cu): ptudes_tpu/ops/pallas_gn.py:_kernel's moment rows.
//
// The 45 moment sums of one build, per correspondence p (transformed),
// nearest candidate q, residual r = p - q, patch normal n and centroid c:
//   0 sum w_pt; 1-3 sum w_pt p; 4-9 sum w_pt p p^T (xx yy zz xy xz yz);
//   10-12 sum w_pt p x r; 13-15 sum w_pt r;
//   16-36 sum w_pl row row^T (upper triangle, row = [p x n, n]);
//   37-42 sum w_pl row s (s = n . (p - c)); 43 correspondences; 44 sum w_pl.
constexpr int kGnAcc = 45;

// Stages that tools/exp_gn_stages.py takes out of K4 and K5, and
// tools/exp_ekf_stages.py out of K1, to time the rest (nvcc
// -DPTUDES_SKIP=<mask>); the port's own build takes none out.
#ifndef PTUDES_SKIP
#define PTUDES_SKIP 0
#endif
enum Stage : unsigned {
  kSkipNearest = 1,   // K4, K5: the nearest-neighbour scan
  kSkipMoments = 2,   // K4, K5: the moment rows
  kSkipTail = 4,      // K5: the last CTA's sum and assembly
  kSkipCluster = 8,   // K4: the cluster barrier and the peers' partials
  kSkipSolve = 16,    // K4: the solve and the pose update
  kSwapGroups = 32,   // K4: the other row split (icp_loop.cu:loop_groups)
  kSkipCovMath = 64,  // K1: the covariance products (sums, stores and
                      // barriers stay)
  kSkipCovSteps = 128,  // K1: the covariance steps
};
__host__ __device__ constexpr bool skip(Stage s) {
  return (PTUDES_SKIP & s) != 0;
}

// The nearest candidate found so far: squared distance (+1e30 for an
// invalid row) and its coordinates; none yet is (inf, 0, 0, 0).
struct Nearest {
  float d2 = INFINITY, qx = 0.0f, qy = 0.0f, qz = 0.0f;

  // Take o only if strictly nearer: scanning rows, or the minima of
  // contiguous row ranges, in ascending order then keeps the lowest row
  // on ties (the masked first-argmin).
  __device__ __forceinline__ void take(const Nearest& o) {
    if (o.d2 < d2) *this = o;
  }
};

// The first row of group g when c rows are cut into groups contiguous,
// ascending ranges: group g owns rows [row_split(c, groups, g),
// row_split(c, groups, g + 1)) (ops/cuda_gn.py:row_groups).
__device__ __forceinline__ int row_split(int c, int groups, int g) {
  return g * c / groups;
}

// Rows [k0, k1) of one point's masked first-argmin nearest neighbour: the
// point (px, py, pz) already transformed, its candidate row k at
// cx[k * stride] (the pointers start at the point's column of the
// lane-major [C, stride] rows).
__device__ __forceinline__ void gn_nearest(
    float px, float py, float pz, const float* cx, const float* cy,
    const float* cz, const float* inf, int stride, int k0, int k1,
    Nearest& nb) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int o = k * stride;
    const float ux = cx[o], uy = cy[o], uz = cz[o];
    const float dx = ux - px, dy = uy - py, dz = uz - pz;
    const float d2 = dx * dx + dy * dy + dz * dz + inf[o];
    if (d2 < nb.d2) {  // strict: the lowest row wins ties
      nb.d2 = d2;
      nb.qx = ux; nb.qy = uy; nb.qz = uz;
    }
  }
}

// Add one source point's terms to acc, given its transformed position
// (px, py, pz) and nearest candidate nb: robust weights k^2 / (k + r^2)^2,
// the plane row where the patch fit has quality >= plane_q, point-to-point
// moments elsewhere. feat starts at the point's column of the [8, stride]
// feat rows.
__device__ __forceinline__ void gn_add_moments(
    float px, float py, float pz, const Nearest& nb, const float* feat,
    int stride, float kern, float max_d2, float plane_q, float* acc) {
  const float d2min = nb.d2, qx = nb.qx, qy = nb.qy, qz = nb.qz;
  const float nx = feat[0], ny = feat[stride], nz = feat[2 * stride];
  const float ccx = feat[3 * stride], ccy = feat[4 * stride],
              ccz = feat[5 * stride];
  const float quality = feat[6 * stride], mask = feat[7 * stride];
  const bool corr = (mask > 0.0f) && (d2min < 1e30f) && (d2min <= max_d2);
  const float s = nx * (px - ccx) + ny * (py - ccy) + nz * (pz - ccz);
  const bool use_pl = corr && (quality >= plane_q);
  const bool use_pt = corr && !use_pl;
  const float kp = kern + s * s, kq = kern + d2min;
  const float w_pl = use_pl ? (kern * kern) / (kp * kp) : 0.0f;
  const float w_pt = use_pt ? (kern * kern) / (kq * kq) : 0.0f;
  const float rx = px - qx, ry = py - qy, rz = pz - qz;
  acc[0] += w_pt;
  acc[1] += w_pt * px; acc[2] += w_pt * py; acc[3] += w_pt * pz;
  acc[4] += w_pt * px * px; acc[5] += w_pt * py * py;
  acc[6] += w_pt * pz * pz;
  acc[7] += w_pt * px * py; acc[8] += w_pt * px * pz;
  acc[9] += w_pt * py * pz;
  acc[10] += w_pt * (py * rz - pz * ry);
  acc[11] += w_pt * (pz * rx - px * rz);
  acc[12] += w_pt * (px * ry - py * rx);
  acc[13] += w_pt * rx; acc[14] += w_pt * ry; acc[15] += w_pt * rz;
  const float rv[6] = {py * nz - pz * ny, pz * nx - px * nz,
                       px * ny - py * nx, nx, ny, nz};
  int k = 16;
#pragma unroll
  for (int u = 0; u < 6; ++u)
#pragma unroll
    for (int v = u; v < 6; ++v) acc[k++] += w_pl * rv[u] * rv[v];
#pragma unroll
  for (int u = 0; u < 6; ++u) acc[37 + u] += w_pl * rv[u] * s;
  acc[43] += corr ? 1.0f : 0.0f;
  acc[44] += w_pl;
}

// One halving step of gn_warp_sum: lanes with bit `off` clear keep
// v[0, h) and send v[h, 2h) to their partner lane ^ off, the others the
// reverse; each adds what it receives to what it keeps.
template <int kHalf>
__device__ __forceinline__ void warp_halve(float* v, int off) {
  const bool up = (threadIdx.x & off) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = up ? v[i + kHalf] : v[i];
    const float send = up ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sum acc over the warp's 32 lanes by reduce-scatter (62 shuffles for the
// 45 values padded to 64, where a shuffle per value and level would take
// 225): lane l ends with the totals of values 2l and 2l + 1 in tot (zero
// past kGnAcc). The order of the additions is fixed.
__device__ __forceinline__ void gn_warp_sum(const float* acc, float* tot) {
  const bool up = (threadIdx.x & 16) != 0;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float lo = acc[i];
    const float hi = i + 32 < kGnAcc ? acc[i + 32] : 0.0f;
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 16);
  }
  warp_halve<16>(v, 8);
  warp_halve<8>(v, 4);
  warp_halve<4>(v, 2);
  warp_halve<2>(v, 1);
  tot[0] = v[0];
  tot[1] = v[1];
}

// Sum the kGnAcc values of the block's first kWarps warps into sums
// (shared): warp reduce-scatters, then one pass over the warps' partials
// in warp order, so the result does not depend on scheduling. Warps from
// kWarps on contribute nothing but must reach the barriers. Ends with a
// barrier.
template <int kWarps>
__device__ __forceinline__ void gn_block_sum(const float* acc,
                                             float (*red)[kGnAcc],
                                             float* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < kWarps) {
    float tot[2];
    gn_warp_sum(acc, tot);
    if (2 * lane < kGnAcc) red[warp][2 * lane] = tot[0];
    if (2 * lane + 1 < kGnAcc) red[warp][2 * lane + 1] = tot[1];
  }
  __syncthreads();
  if (threadIdx.x < kGnAcc) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    sums[threadIdx.x] = v;
  }
  __syncthreads();
}

// The 6x6 normal equations (a, symmetric, and b) from the moment sums m:
// the point-to-point block [trace I - Spp, hat(Sp); -hat(Sp), Sw I] and
// [Sum p x r, Sum r], plus the plane rows' sums.
__device__ __forceinline__ void gn_assemble(const float* m, float (*a)[6],
                                            float* b) {
  const float trc = m[4] + m[5] + m[6];
  for (int u = 0; u < 6; ++u) {
    b[u] = m[10 + u];
    for (int v = 0; v < 6; ++v) a[u][v] = 0.0f;
  }
  a[0][0] = trc - m[4]; a[1][1] = trc - m[5]; a[2][2] = trc - m[6];
  a[0][1] = -m[7]; a[0][2] = -m[8]; a[1][2] = -m[9];
  a[0][4] = -m[3]; a[0][5] = m[2];
  a[1][3] = m[3]; a[1][5] = -m[1];
  a[2][3] = -m[2]; a[2][4] = m[1];
  a[3][3] = m[0]; a[4][4] = m[0]; a[5][5] = m[0];
  int k = 16;
  for (int u = 0; u < 6; ++u)
    for (int v = u; v < 6; ++v) a[u][v] += m[k++];
  for (int u = 0; u < 6; ++u) b[u] += m[37 + u];
  for (int u = 0; u < 6; ++u)
    for (int v = 0; v < u; ++v) a[u][v] = a[v][u];
}

// ---- the voxel hash (ops/voxel.py, ops/hashmap.py) in native uint32:
// CUDA's 32-bit multiply wraps mod 2^32 as the JAX package's uint32 does.

// murmur3 finalizer (voxel.mix32).
__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The per-axis-mixed hash of a voxel coordinate (voxel.coord_hash).
__device__ __forceinline__ unsigned coord_hash(int x, int y, int z) {
  return mix32(static_cast<unsigned>(x) * 73856093u)
         ^ (mix32(static_cast<unsigned>(y) * 19349669u) * 0x9E3779B9u)
         ^ (mix32(static_cast<unsigned>(z) * 83492791u) * 0x517CC1B7u);
}

// Fingerprint (never 0) and home slot of a voxel in a power-of-two table
// of cap slots (hashmap._fingerprint_and_slot).
__device__ __forceinline__ void fingerprint_and_slot(int x, int y, int z,
                                                     int cap, int* fp,
                                                     int* slot) {
  const unsigned h = coord_hash(x, y, z);
  *slot = static_cast<int>(mix32(h) & static_cast<unsigned>(cap - 1));
  const unsigned f = mix32(h ^ 0xDEADBEEFu);
  *fp = static_cast<int>(f == 0u ? 1u : f);
}

// ---- the patch plane fit shared by K3 (gn_prep.cu), K6 (gather_fused.cu)
// and K7 (plane_moments.cu): ptudes_tpu/ops/pallas_gn.py:_moments_kernel
// and _prep_feat_kernel.

// Moments of the candidate offsets d = c - q within the patch radius.
struct PatchMoments {
  float s0 = 0, sx = 0, sy = 0, sz = 0, sxx = 0, syy = 0, szz = 0, sxy = 0,
        sxz = 0, syz = 0;
};

// Add one candidate at offset (dx, dy, dz) from the query point; inf is 0
// for a valid candidate and 1e30 otherwise, so only valid candidates within
// the radius (d2 <= r2) count.
__device__ __forceinline__ void patch_add(PatchMoments& m, float dx, float dy,
                                          float dz, float inf, float r2) {
  const float d2 = dx * dx + dy * dy + dz * dz + inf;
  if (d2 <= r2) {
    m.s0 += 1.0f;
    m.sx += dx; m.sy += dy; m.sz += dz;
    m.sxx += dx * dx; m.syy += dy * dy; m.szz += dz * dz;
    m.sxy += dx * dy; m.sxz += dx * dz; m.syz += dy * dz;
  }
}

// The sum of v over the warp, in every lane: an xor butterfly (offsets
// 16, 8, 4, 2, 1), so the order of the additions is fixed.
__device__ __forceinline__ float warp_sum_xor(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lanes' moments summed over the warp, in every lane (K3).
__device__ __forceinline__ PatchMoments patch_warp_sum(PatchMoments m) {
  m.s0 = warp_sum_xor(m.s0);
  m.sx = warp_sum_xor(m.sx); m.sy = warp_sum_xor(m.sy);
  m.sz = warp_sum_xor(m.sz);
  m.sxx = warp_sum_xor(m.sxx); m.syy = warp_sum_xor(m.syy);
  m.szz = warp_sum_xor(m.szz);
  m.sxy = warp_sum_xor(m.sxy); m.sxz = warp_sum_xor(m.sxz);
  m.syz = warp_sum_xor(m.syz);
  return m;
}

// Elementwise ops/plane.smallest_eigvec_sym3: closed-form trigonometric
// eigenvalues, eigenvector from the largest row-pair cross product
// (first maximum wins, like argmax). The TPU kernels seed a Newton arccos
// because Mosaic lowers none; acosf is exact to f32 here.
__device__ __forceinline__ void smallest_eig(float axx, float ayy, float azz,
                                             float axy, float axz, float ayz,
                                             float* n, float* quality) {
  const float eps = 1e-12f;
  const float m = (axx + ayy + azz) / 3.0f;
  const float bxx = axx - m, byy = ayy - m, bzz = azz - m;
  const float q = (bxx * bxx + byy * byy + bzz * bzz
                   + 2.0f * (axy * axy + axz * axz + ayz * ayz)) / 6.0f;
  const float det = (bxx * (byy * bzz - ayz * ayz) - axy * (axy * bzz - ayz * axz)
                     + axz * (axy * ayz - byy * axz)) / 2.0f;
  const float sq = sqrtf(fmaxf(q, eps));
  const float r = fminf(fmaxf(det / fmaxf(sq * sq * sq, eps), -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float l1 = m + 2.0f * sq * cosf(phi);
  const float l3 = m + 2.0f * sq * cosf(phi + 2.0f * 3.14159265358979f / 3.0f);
  const float l2 = 3.0f * m - l1 - l3;
  const float c00 = axx - l3, c11 = ayy - l3, c22 = azz - l3;
  const float v01x = axy * ayz - axz * c11, v01y = axz * axy - c00 * ayz,
              v01z = c00 * c11 - axy * axy;
  const float v02x = axy * c22 - axz * ayz, v02y = axz * axz - c00 * c22,
              v02z = c00 * ayz - axy * axz;
  const float v12x = c11 * c22 - ayz * ayz, v12y = ayz * axz - axy * c22,
              v12z = axy * ayz - c11 * axz;
  const float n01 = v01x * v01x + v01y * v01y + v01z * v01z;
  const float n02 = v02x * v02x + v02y * v02y + v02z * v02z;
  const float n12 = v12x * v12x + v12y * v12y + v12z * v12z;
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = !use01 && (n02 >= n12);
  const float vx = use01 ? v01x : (use02 ? v02x : v12x);
  const float vy = use01 ? v01y : (use02 ? v02y : v12y);
  const float vz = use01 ? v01z : (use02 ? v02z : v12z);
  const float vn = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, eps));
  n[0] = vx / vn;
  n[1] = vy / vn;
  n[2] = vz / vn;
  *quality = fminf(fmaxf((l2 - l3) / fmaxf(l1, eps), 0.0f), 1.0f);
}

// Finish the fit of point p into the feat rows [8, n]: normal, centroid
// (query + mean offset), quality (0 under 4 candidates), source mask.
// kRcp (K3): the means are the sums times the correctly rounded
// reciprocal of the count, within an ulp of the quotients, in place of
// nine IEEE divisions on the finish's dependent chain (each a branch
// around its slow path, and slow on a chain of one lane).
template <bool kRcp = false>
__device__ __forceinline__ void plane_feat(const PatchMoments& m, float px,
                                           float py, float pz, float mask,
                                           float* __restrict__ feat, int p,
                                           int n) {
  const float denom = fmaxf(m.s0, 1.0f);
  const float inv = kRcp ? __frcp_rn(denom) : 0.0f;
  const auto mean = [&](float s) { return kRcp ? s * inv : s / denom; };
  const float mx = mean(m.sx), my = mean(m.sy), mz = mean(m.sz);
  float nrm[3], quality;
  smallest_eig(mean(m.sxx) - mx * mx, mean(m.syy) - my * my,
               mean(m.szz) - mz * mz, mean(m.sxy) - mx * my,
               mean(m.sxz) - mx * mz, mean(m.syz) - my * mz, nrm,
               &quality);
  feat[p] = nrm[0];
  feat[n + p] = nrm[1];
  feat[2 * n + p] = nrm[2];
  feat[3 * n + p] = px + mx;
  feat[4 * n + p] = py + my;
  feat[5 * n + p] = pz + mz;
  feat[6 * n + p] = (m.s0 >= 4.0f) ? quality : 0.0f;
  feat[7 * n + p] = mask;
}

}  // namespace ptudes
