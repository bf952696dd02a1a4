// The group culling shared by K6 (tilecull.cu) and K7 (anyhit.cu): the
// clamped reciprocal of a direction and the ray's slab test against a
// group's box, in the TPU kernels' float32 order
// (tilecull_kernel.py::_safe_inv, _slab), and the staging of a group's
// rows into shared memory for nearest.cuh's exact test.
//
// A group-table row is [lo_x lo_y lo_z hi_x hi_y hi_z base end]; base and
// end are the group's rows in the Morton-ordered triangle pack.

#pragma once

#include "nearest.cuh"

namespace ptx {

constexpr int kMaxGroups = 64;
constexpr int kGroupCols = 8;
constexpr int kGroupTile = 128;   // rows staged at a time (8 KB)

// 1 / d, with |d| < 1e-30 replaced by +-1e-30 (+ for -0.0).
__device__ __forceinline__ float safe_inv(float d) {
  constexpr float kTiny = 1e-30f;
  return 1.0f / (fabsf(d) < kTiny ? (d < 0.f ? -kTiny : kTiny) : d);
}

// Entry and exit distances of the ray (p, 1 / d) through box g.
__device__ __forceinline__ void slab(const float* g, float px, float py,
                                     float pz, float ix, float iy, float iz,
                                     float& tn, float& tf) {
  const float t1x = (g[0] - px) * ix, t2x = (g[3] - px) * ix;
  const float t1y = (g[1] - py) * iy, t2y = (g[4] - py) * iy;
  const float t1z = (g[2] - pz) * iz, t2z = (g[5] - pz) * iz;
  tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// Copy rows [c0, c0 + n) of the pack (their four float4s of constants)
// into `tile`; every thread of the block calls it between barriers.
__device__ __forceinline__ void stage_rows(float4* tile,
                                           const float4* __restrict__ tri,
                                           int c0, int n) {
  for (int k = threadIdx.x; k < 4 * n; k += kBlock) {
    tile[k] = tri[(size_t)(c0 + (k >> 2)) * (kTriCols / 4) + (k & 3)];
  }
}

}  // namespace ptx
