// K15: the dense nearest hit with the winner's index and attributes, its
// dots rounded as the TPU kernel's one float32 matmul rounds them.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_mxu_kernel (launched by _run_mxu, behind
// make_mxu_intersect).
//
// What it computes, per ray (P, D) and triangle (n, c0, m_k, d_k) of K4's
// (T, 24) pack: the eight dots [pn vn pm1 vm1 pm2 vm2 pm3 vm3]. The
// reference computes them as a matmul of a tiled copy of these constants
// (8 rows of 8 columns per triangle, 3 of the 8 non-zero) with the ray rows
// [p(3) d(3) 0 0], summing a row in k order as one chain of fused
// multiply-adds, so a dot is fma(v2, a2, fma(v1, a1, v0 * a0)) + 0.0f: the
// five zero columns add exact zeros, which only turn a -0.0 dot into +0.0.
// Then
//   t = (c0 - pn) / vn, accepted when t > 0 and fma(t, vm_k, pm_k) >= d_k
// (the interpret-mode kernel's rounding, which is not K4's), the least
// accepted t with the lowest index (the reference's first-index argmin per
// tile with a strict < across tiles, whatever the tile), and the winner's
// [nx ny nz mati] + 0.0f (the one-hot float32 sum's sign of zero). A miss
// keeps t = BIG and index 0 with triangle 0's attributes, tile 0's latch.
//
// Out: six rows of n_rays floats [t, index, nx, ny, nz, mati].
//
// What bounds it on the H100: operations, as K4 (about 48 float32
// operations per (ray, triangle) pair). The loop is nearest.cuh's, with
// its staging of the first four float4s of each pack row through shared
// memory; only the dot differs. One ray per thread with its running
// (t, index) in registers.

#include "nearest.cuh"

namespace {

using namespace ptx;

__device__ __forceinline__ float mxu_dot(float4 v, float x, float y,
                                         float z) {
  return __fadd_rn(__fmaf_rn(v.z, z, __fmaf_rn(v.y, y, __fmul_rn(v.x, x))),
                   0.0f);
}

__global__ void __launch_bounds__(kBlock)
mxu_kernel(const float* __restrict__ rays8, const float4* __restrict__ tri,
           float* __restrict__ out, int n_rays, int n_tris) {
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
  float best_t = __int_as_float(0x7f800000);   // +inf: the first tm wins
  int best_g = 0;
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < 4 * n; k += kBlock) {
      tile[k] = tri[(size_t)(base + (k >> 2)) * (kTriCols / 4) + (k & 3)];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float4* c = &tile[4 * j];
      const float pn = mxu_dot(c[0], px, py, pz);
      const float vn = mxu_dot(c[0], dx, dy, dz);
      const float t = __fdiv_rn(__fsub_rn(c[0].w, pn), vn);
      bool ok = t > 0.f;
#pragma unroll
      for (int e = 1; e < 4 && ok; ++e) {
        const float pm = mxu_dot(c[e], px, py, pz);
        const float vm = mxu_dot(c[e], dx, dy, dz);
        ok = __fmaf_rn(t, vm, pm) >= c[e].w;
      }
      const float tm = ok ? t : kBig;
      if (tm < best_t) {
        best_t = tm;
        best_g = base + j;
      }
    }
  }
  if (!live) return;
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best_g * kTriCols;
  const size_t r = static_cast<size_t>(n_rays);
  out[i] = best_t;
  out[r + i] = (float)best_g;
  out[2 * r + i] = __fadd_rn(row[0], 0.0f);
  out[3 * r + i] = __fadd_rn(row[1], 0.0f);
  out[4 * r + i] = __fadd_rn(row[2], 0.0f);
  out[5 * r + i] = __fadd_rn(row[16], 0.0f);
}

}  // namespace

extern "C" int ptx_mxu(const float* rays8, const float* tri_pack, float* out,
                       int n_rays, int n_tris, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  mxu_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), out, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
