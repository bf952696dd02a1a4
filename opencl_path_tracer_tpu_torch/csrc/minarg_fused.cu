// K14: K1's nearest triangle hit and K2's attribute fetch in one launch.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_minarg_fused_kernel (launched by _run_minarg_fused,
// the make_minarg_intersect(fuse_fetch=True) path). The TPU kernel holds
// the whole table in one VMEM block; this one loops over any table.
//
// What it computes: K1's (t, index) by the loop of nearest.cuh (the
// least accepted t, the lowest index on ties), then, in the same thread,
// K2's fetch of the winner's row: t (-1 on a miss), the normal and the
// material. On the TPU the fetch is a one-hot matmul over an exact bf16
// three-way split of the table; an indexed load of the float32 row gives
// the same bits, and `+ 0.0f` (never folded under --fmad=false) turns
// -0.0 into +0.0 as the one-hot sum does. A miss keeps index 0, so its
// lanes carry triangle 0's attributes, as K1 + K2's do. The result is K1
// then K2 bit for bit.
//
// What bounds it on the H100: operations, as K1 (about 48 float32
// operations per (ray, triangle) pair); it saves K2's launch and the
// round trip of (t, index) through memory, 20 bytes out per ray.

#include "nearest.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
minarg_fused_kernel(const float* __restrict__ rays8,
                    const float4* __restrict__ tri, float* __restrict__ t_out,
                    float* __restrict__ nx, float* __restrict__ ny,
                    float* __restrict__ nz, float* __restrict__ m,
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
  if (!live) return;
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best.g * kTriCols;
  t_out[i] = best.t < kBig ? best.t : -1.0f;
  nx[i] = __fadd_rn(row[0], 0.0f);
  ny[i] = __fadd_rn(row[1], 0.0f);
  nz[i] = __fadd_rn(row[2], 0.0f);
  m[i] = __fadd_rn(row[16], 0.0f);
}

}  // namespace

extern "C" int ptx_minarg_fused(const float* rays8, const float* tri_pack,
                                float* t_out, float* nx, float* ny, float* nz,
                                float* m, int n_rays, int n_tris,
                                void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  minarg_fused_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), t_out, nx, ny, nz, m,
      n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
