// K7: the any-hit shadow-ray test: is there a triangle whose exact hit t
// lies in (0, rmax)? One flag per ray.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// tilecull_kernel.py::_anyhit_kernel (launched by _run_anyhit).
//
// One ray per thread, 256 rays per block, over the Morton-ordered pack's
// groups in table order. A thread needs a group where its slab test
// passes, the box's entry tn is at most rmax (segment culling) and it is
// not yet occluded; the block stages the group's rows into shared memory
// (at most 8 KB at a time) only when some thread needs it
// (__syncthreads_or), so a block whose rays are all occluded skips every
// remaining group. A needing thread runs nearest.cuh's exact test op for
// op and stops at its first hit with t < rmax, so the flag equals
// (K4's nearest t is valid and below rmax) bit for bit.
//
// What bounds it on the H100: operations, about 48 float32 operations per
// (ray, triangle) pair that a ray's slab and segment tests let through
// (fewer where a ray stops early) plus about 25 per (ray, group) slab
// test; the rays and rmax are read once, one byte is written per ray.

#include "groups.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
anyhit_kernel(const float* __restrict__ rays8, int ray_stride,
              const float* __restrict__ rmax_in,
              const float4* __restrict__ tri, const float* __restrict__ groups,
              unsigned char* __restrict__ occ_out, int n_rays, int n_groups) {
  __shared__ float s_groups[kMaxGroups * kGroupCols];
  __shared__ float4 tile[kGroupTile * 4];
  for (int k = threadIdx.x; k < n_groups * kGroupCols; k += kBlock) {
    s_groups[k] = groups[k];
  }
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float rmax = 0.f;
  if (live) {
    px = rays8[i];
    py = rays8[ray_stride + i];
    pz = rays8[2 * ray_stride + i];
    dx = rays8[3 * ray_stride + i];
    dy = rays8[4 * ray_stride + i];
    dz = rays8[5 * ray_stride + i];
    rmax = rmax_in[i];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  bool occ = false;
  __syncthreads();
  for (int gi = 0; gi < n_groups; ++gi) {
    const float* g = s_groups + gi * kGroupCols;
    float tn, tf;
    slab(g, px, py, pz, ix, iy, iz, tn, tf);
    const bool need = live && !occ && tf >= tn && tf >= 0.f && tn <= rmax;
    if (!__syncthreads_or(need)) continue;
    const int end = static_cast<int>(g[7]);
    for (int c0 = static_cast<int>(g[6]); c0 < end; c0 += kGroupTile) {
      const int n = min(kGroupTile, end - c0);
      stage_rows(tile, tri, c0, n);
      __syncthreads();
      if (need && !occ) {
        for (int j = 0; j < n; ++j) {
          float t;
          if (exact_hit(&tile[4 * j], px, py, pz, dx, dy, dz, t) &&
              t < rmax) {
            occ = true;
            break;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) occ_out[i] = occ ? 1 : 0;
}

}  // namespace

extern "C" int ptx_anyhit(const float* rays8, int ray_stride,
                          const float* rmax, const float* tri_pack,
                          const float* groups, unsigned char* occ, int n_rays,
                          int n_groups, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1 || n_groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  anyhit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, rmax, reinterpret_cast<const float4*>(tri_pack),
      groups, occ, n_rays, n_groups);
  return static_cast<int>(cudaGetLastError());
}
