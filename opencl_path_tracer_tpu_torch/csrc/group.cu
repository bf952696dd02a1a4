// K16: the mask-grouped intersector (accel 'group').
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sorted_intersect.py::_group_kernel (launched by _run_group).
//
// What it computes: the rays come sorted by their bitmask of passing
// clusters, in groups of `block`; union[g] is the OR of group g's masks
// (at most 30 clusters). Each ray is tested against every cluster of its
// group's union in ascending cluster order (cluster_block.cuh: the lowest
// lane wins within a cluster, a strict < across clusters); rows [t nx ny
// nz mati] of a (5, Rpad) output, (BIG, 0, 0, 0, 0) where nothing hits.
// The rays are the (Rpad, 8) rows [p d 0 0].
//
// Layout: one thread per ray, blocks of kBlock consecutive rays (a block
// may straddle two groups when `block` is not a multiple of kBlock). For
// each cluster in order, the block stages it through shared memory when
// any of its threads needs it (__syncthreads_or), and those threads test
// it.
//
// What bounds it on the H100: operations, as K1, over the (ray, triangle)
// pairs of the union's clusters.

#include "cluster_block.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
group_kernel(const int* __restrict__ unions, const float* __restrict__ rays8,
             const float4* __restrict__ tri, float* __restrict__ out,
             int n_rays, int block, int n_clusters, int k) {
  __shared__ float4 tile[kTile * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  unsigned u = 0;
  if (live) {
    const float4 a = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i];
    const float4 b = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i + 1];
    px = a.x;
    py = a.y;
    pz = a.z;
    dx = a.w;
    dy = b.x;
    dz = b.y;
    u = static_cast<unsigned>(unions[i / block]);
  }
  Nearest best{kBig, 0};
  for (int ci = 0; ci < n_clusters; ++ci) {
    const bool take = (u >> ci) & 1u;
    if (__syncthreads_or(take)) {
      merge_cluster(tile, tri, ci * k, k, take, px, py, pz, dx, dy, dz, best);
    }
  }
  if (!live) return;
  float a[4];
  winner_attrs(tri, best, a);
  const size_t n = static_cast<size_t>(n_rays);
  out[i] = best.t;
  out[n + i] = a[0];
  out[2 * n + i] = a[1];
  out[3 * n + i] = a[2];
  out[4 * n + i] = a[3];
}

}  // namespace

extern "C" int ptx_group(const int* unions, const float* rays8,
                         const float* rows, float* out, int n_rays, int block,
                         int n_clusters, int k, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  group_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      unions, rays8, reinterpret_cast<const float4*>(rows), out, n_rays,
      block, n_clusters, k);
  return static_cast<int>(cudaGetLastError());
}
