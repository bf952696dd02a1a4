// K6: the tile-culled nearest triangle hit per ray: the least accepted t
// and its row in the Morton-ordered pack, over groups of rows with boxes.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// tilecull_kernel.py::_tilecull_kernel (launched by _run_tilecull).
//
// One ray per thread, 256 rays per block. For each group, in table
// order, a thread needs the group where its slab test passes and the
// box's entry tn is below its best t; the block stages the group's rows
// into shared memory (at most 8 KB at a time) only when some thread
// needs it (__syncthreads_or, the counterpart of the TPU's pl.when over
// a 1,024-ray tile), and each needing thread runs nearest.cuh's exact
// test on them with a strict <. Groups and rows are scanned in order, so
// exact-t ties keep the first row in Morton order, and the result is the
// same for any block size: a group skipped at tn >= best t holds no hit
// below best t (its box is inflated against rounding).
//
// What bounds it on the H100: operations, about 48 float32 operations per
// (ray, triangle) pair that a ray's slab test lets through plus about 25
// per (ray, group) slab test; the rays are read once and the rows come
// from L2 into shared memory. Coherent rays (camera rays) skip most
// groups; incoherent bounce rays pass more of them.

#include "groups.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
tilecull_kernel(const float* __restrict__ rays8, int ray_stride,
                const float4* __restrict__ tri, const float* __restrict__ groups,
                float* __restrict__ t_out, float* __restrict__ g_out,
                int n_rays, int n_groups) {
  __shared__ float s_groups[kMaxGroups * kGroupCols];
  __shared__ float4 tile[kGroupTile * 4];
  for (int k = threadIdx.x; k < n_groups * kGroupCols; k += kBlock) {
    s_groups[k] = groups[k];
  }
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (live) {
    px = rays8[i];
    py = rays8[ray_stride + i];
    pz = rays8[2 * ray_stride + i];
    dx = rays8[3 * ray_stride + i];
    dy = rays8[4 * ray_stride + i];
    dz = rays8[5 * ray_stride + i];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  Nearest best{kBig, 0};
  __syncthreads();
  for (int gi = 0; gi < n_groups; ++gi) {
    const float* g = s_groups + gi * kGroupCols;
    float tn, tf;
    slab(g, px, py, pz, ix, iy, iz, tn, tf);
    const bool need = live && tf >= tn && tf >= 0.f && tn < best.t;
    if (!__syncthreads_or(need)) continue;
    const int end = static_cast<int>(g[7]);
    for (int c0 = static_cast<int>(g[6]); c0 < end; c0 += kGroupTile) {
      const int n = min(kGroupTile, end - c0);
      stage_rows(tile, tri, c0, n);
      __syncthreads();
      if (need) {
        for (int j = 0; j < n; ++j) {
          float t;
          const float tm =
              exact_hit(&tile[4 * j], px, py, pz, dx, dy, dz, t) ? t : kBig;
          if (tm < best.t) {
            best.t = tm;
            best.g = c0 + j;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    t_out[i] = best.t;
    g_out[i] = static_cast<float>(best.g);
  }
}

}  // namespace

extern "C" int ptx_tilecull(const float* rays8, int ray_stride,
                            const float* tri_pack, const float* groups,
                            float* t_out, float* g_out, int n_rays,
                            int n_groups, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1 || n_groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  tilecull_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, reinterpret_cast<const float4*>(tri_pack), groups,
      t_out, g_out, n_rays, n_groups);
  return static_cast<int>(cudaGetLastError());
}
