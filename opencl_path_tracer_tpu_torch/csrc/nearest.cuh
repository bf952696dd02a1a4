// The exact ray-triangle test, and the nearest-triangle loop built on it,
// shared by K1 (minarg.cu), K4 (dense.cu), K13a (plucker_cand.cu, its t)
// and K13b (plucker_refine.cu): one ray per thread, its running
// (t, index) in registers, triangle constants staged through shared
// memory and read by broadcast.
//
// Per ray (P, D) and triangle (n, c0, m_k, d_k):
//   t = (c0 - dot(P, n)) / dot(D, n)       (an IEEE divide)
//   accept when t > 0 and dot(P, m_k) + t * dot(D, m_k) >= d_k, k = 1..3
// The loop keeps the least accepted t with the lowest triangle index (a
// strict < over triangles in index order); BIG and index 0 when nothing
// accepts. Rounding follows the reference exactly: each dot product is
// fma(a2, b2, fma(a0, b0, a1 * b1)) and each edge test fma(t, vm, pm);
// everything else is separately rounded (the sources build with
// --fmad=false).

#pragma once

#include <cuda_runtime.h>

namespace ptx {

constexpr int kBlock = 256;
constexpr int kTile = 256;        // triangles per shared-memory tile
constexpr int kTriCols = 24;      // floats per row of the triangle pack
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float dot3(float4 v, float x, float y, float z) {
  return __fmaf_rn(v.z, z, __fmaf_rn(v.x, x, v.y * y));
}

// t of the ray's plane crossing; nc = [n c0].
__device__ __forceinline__ float plane_t(float4 nc, float px, float py,
                                         float pz, float dx, float dy,
                                         float dz) {
  const float pn = dot3(nc, px, py, pz);
  const float vn = dot3(nc, dx, dy, dz);
  return (nc.w - pn) / vn;
}

// The exact test: c = [n c0] [m1 d1] [m2 d2] [m3 d3]; t receives the
// plane t. The edge tests stop at the first that fails.
__device__ __forceinline__ bool exact_hit(const float4* c, float px,
                                          float py, float pz, float dx,
                                          float dy, float dz, float& t) {
  t = plane_t(c[0], px, py, pz, dx, dy, dz);
  bool ok = t > 0.f;
#pragma unroll
  for (int e = 1; e < 4 && ok; ++e) {
    const float pm = dot3(c[e], px, py, pz);
    const float vm = dot3(c[e], dx, dy, dz);
    ok = __fmaf_rn(t, vm, pm) >= c[e].w;
  }
  return ok;
}

struct Nearest {
  float t;
  int g;
};

// Every thread of a kBlock-thread block calls this (it synchronises);
// `live` masks the ray of a thread past the end. `tile` holds kTile * 4
// float4s.
__device__ __forceinline__ Nearest nearest_triangle(
    float4* tile, const float4* __restrict__ tri, int n_tris, bool live,
    float px, float py, float pz, float dx, float dy, float dz) {
  Nearest best{kBig, 0};
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < 4 * n; k += kBlock) {
      // A pack row is 6 float4s; the first four hold the constants.
      tile[k] = tri[(size_t)(base + (k >> 2)) * (kTriCols / 4) + (k & 3)];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      float t;
      const float tm =
          exact_hit(&tile[4 * j], px, py, pz, dx, dy, dz, t) ? t : kBig;
      if (tm < best.t) {
        best.t = tm;
        best.g = base + j;
      }
    }
  }
  return best;
}

}  // namespace ptx
