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
// moment registers. The candidate tensors keep the lane-major [C, N]
// layout of the TPU kernel, which on the GPU makes the 32 threads of a
// warp read 32 consecutive floats of each row: fully coalesced. Moments
// are of offsets from q, so f32 never squares world-scale coordinates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Elementwise ops/plane.smallest_eigvec_sym3: closed-form trigonometric
// eigenvalues, eigenvector from the largest row-pair cross product
// (first maximum wins, like argmax). The TPU kernel seeds a Newton arccos
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
  float s0 = 0, sx = 0, sy = 0, sz = 0, sxx = 0, syy = 0, szz = 0,
        sxy = 0, sxz = 0, syz = 0;
  for (int k = 0; k < c; ++k) {
    const int o = k * n + p;
    const float dx = cx[o] - px, dy = cy[o] - py, dz = cz[o] - pz;
    const float d2 = dx * dx + dy * dy + dz * dz + inf[o];
    if (d2 <= r2) {
      s0 += 1.0f;
      sx += dx; sy += dy; sz += dz;
      sxx += dx * dx; syy += dy * dy; szz += dz * dz;
      sxy += dx * dy; sxz += dx * dz; syz += dy * dz;
    }
  }
  const float denom = fmaxf(s0, 1.0f);
  const float mx = sx / denom, my = sy / denom, mz = sz / denom;
  float nrm[3], quality;
  smallest_eig(sxx / denom - mx * mx, syy / denom - my * my,
               szz / denom - mz * mz, sxy / denom - mx * my,
               sxz / denom - mx * mz, syz / denom - my * mz, nrm, &quality);
  feat[p] = nrm[0];
  feat[n + p] = nrm[1];
  feat[2 * n + p] = nrm[2];
  feat[3 * n + p] = px + mx;
  feat[4 * n + p] = py + my;
  feat[5 * n + p] = pz + mz;
  feat[6 * n + p] = (s0 >= 4.0f) ? quality : 0.0f;
  feat[7 * n + p] = ptq[3 * n + p];
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
