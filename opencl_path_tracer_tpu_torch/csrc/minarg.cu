// K1: nearest triangle hit per ray, min + argmin over every triangle.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_minarg_kernel (launched by _run_minarg).
//
// What it computes is the loop of nearest.cuh: the least accepted t per
// ray and the lowest triangle index that reaches it.
//
// What bounds it on the H100: operations. Each (ray, triangle) pair costs
// about 48 float32 operations and no memory traffic: the rays are read
// once, and the triangle constants are staged through shared memory in
// tiles that every thread of the block reads by broadcast. The design
// keeps one ray per thread with its running (t, index) in registers, and
// masks the ray tail instead of padding it.

#include "nearest.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
minarg_kernel(const float* __restrict__ rays8, const float4* __restrict__ tri,
              float* __restrict__ t_out, float* __restrict__ g_out,
              int n_rays, int n_tris) {
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
  const Nearest best =
      nearest_triangle(tile, tri, n_tris, live, px, py, pz, dx, dy, dz);
  if (live) {
    t_out[i] = best.t;
    g_out[i] = (float)best.g;
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
