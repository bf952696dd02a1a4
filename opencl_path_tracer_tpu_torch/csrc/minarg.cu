// K1: nearest triangle hit per ray, min + argmin over every triangle.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_minarg_kernel (launched by _run_minarg).
//
// What it computes, per ray (P, D) and triangle (n, c0, m_k, d_k):
//   t = (c0 - dot(P, n)) / dot(D, n)       (an IEEE divide)
//   accept when t > 0 and dot(P, m_k) + t * dot(D, m_k) >= d_k, k = 1..3
// and keeps the least accepted t with the lowest triangle index (a strict
// < over triangles in index order); BIG and index 0 when nothing accepts.
// Rounding follows the reference exactly: each dot product is
// fma(a2, b2, fma(a0, b0, a1 * b1)) and each edge test fma(t, vm, pm),
// everything else is separately rounded (built with --fmad=false).
//
// What bounds it on the H100: operations. Each (ray, triangle) pair costs
// about 48 float32 operations and no memory traffic: the rays are read
// once, and the triangle constants are staged through shared memory in
// tiles that every thread of the block reads by broadcast. The design
// keeps one ray per thread with its running (t, index) in registers, and
// masks the ray tail instead of padding it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 256;        // triangles per shared-memory tile
constexpr int kTriCols = 24;      // floats per row of the triangle pack
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float dot3(float4 v, float x, float y, float z) {
  return __fmaf_rn(v.z, z, __fmaf_rn(v.x, x, v.y * y));
}

__global__ void __launch_bounds__(kBlock)
minarg_kernel(const float* __restrict__ rays8, const float4* __restrict__ tri,
              float* __restrict__ t_out, float* __restrict__ g_out,
              int n_rays, int n_tris) {
  // Per triangle: [n c0] [m1 d1] [m2 d2] [m3 d3], 64 bytes.
  __shared__ float4 tile[kTile * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    px = rays8[i];
    py = rays8[n_rays + i];
    pz = rays8[2 * n_rays + i];
    dx = rays8[3 * n_rays + i];
    dy = rays8[4 * n_rays + i];
    dz = rays8[5 * n_rays + i];
  }
  float best_t = kBig;
  int best_g = 0;
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
      const float4 nc = tile[4 * j];
      const float pn = dot3(nc, px, py, pz);
      const float vn = dot3(nc, dx, dy, dz);
      const float t = (nc.w - pn) / vn;
      bool ok = t > 0.f;
#pragma unroll
      for (int e = 1; e < 4 && ok; ++e) {
        const float4 m = tile[4 * j + e];
        const float pm = dot3(m, px, py, pz);
        const float vm = dot3(m, dx, dy, dz);
        ok = __fmaf_rn(t, vm, pm) >= m.w;
      }
      const float tm = ok ? t : kBig;
      if (tm < best_t) {
        best_t = tm;
        best_g = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    g_out[i] = (float)best_g;
  }
}

}  // namespace

extern "C" int ptx_minarg(const float* rays8, const float* tri_pack,
                          float* t_out, float* g_out, int n_rays, int n_tris,
                          void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  minarg_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), t_out, g_out, n_rays,
      n_tris);
  return static_cast<int>(cudaGetLastError());
}
