// K17: the two-level cluster intersector (accel 'cluster').
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// cluster_kernel.py::_kernel (launched by _run).
//
// What it computes, per tile of tr rays (the (Rpad, 8) rows [p d 0 0],
// Rpad = G tr): the tile walks its cluster list ids[g, 0:cnt[g]] in list
// order (the clusters its interval slab test passes, nearest entry bound
// first), each ray keeping its nearest hit (cluster_block.cuh: the lowest
// lane within a cluster, a strict < across list slots). With early_exit
// the walk stops before slot s unless entry[g, s] < the largest best t of
// the tile's rays, the TPU's while-loop condition (the first test has
// max = BIG). Output rows of a (6, Rpad) tensor: [t (BIG on a miss),
// winner index c K + lane as float32, nx, ny, nz, mati], zeros on a miss.
//
// Layout: one CUDA block per tile, one thread per ray (tr <= 1024). Each
// listed cluster is staged through shared memory by the whole block; the
// early exit's maximum is a block reduction after each cluster.
//
// What bounds it on the H100: operations, as K1, over the (ray, triangle)
// pairs of the listed clusters (every passing cluster with early_exit
// off).

#include "cluster_block.cuh"

namespace {

using namespace ptx;

constexpr int kMaxTile = 1024;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : -kBig;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__global__ void __launch_bounds__(kMaxTile)
cluster_kernel(const float* __restrict__ rays8, const int* __restrict__ cnt,
               const int* __restrict__ ids, const float* __restrict__ entry,
               const float4* __restrict__ tri, float* __restrict__ out,
               int n_rays, int n_clusters, int k, int early_exit) {
  __shared__ float4 tile[kTile * 4];
  __shared__ float red[32];
  const int g = blockIdx.x;
  const int i = g * blockDim.x + threadIdx.x;
  const float4 a = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i];
  const float4 b = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i + 1];
  const int n_list = cnt[g];
  const int* list = ids + (size_t)g * n_clusters;
  const float* ent = entry + (size_t)g * n_clusters;
  Nearest best{kBig, 0};
  float max_best = kBig;
  for (int slot = 0; slot < n_list; ++slot) {
    if (early_exit && !(ent[slot] < max_best)) break;
    const int ci = list[slot];
    merge_cluster(tile, tri, ci * k, k, true, a.x, a.y, a.z, a.w, b.x, b.y,
                  best);
    if (early_exit) max_best = block_max(best.t, red);
  }
  float at[4];
  winner_attrs(tri, best, at);
  const size_t n = static_cast<size_t>(n_rays);
  out[i] = best.t;
  out[n + i] = best.t < kBig ? static_cast<float>(best.g) : 0.0f;
  out[2 * n + i] = at[0];
  out[3 * n + i] = at[1];
  out[4 * n + i] = at[2];
  out[5 * n + i] = at[3];
}

}  // namespace

extern "C" int ptx_cluster(const float* rays8, const int* cnt, const int* ids,
                           const float* entry, const float* rows, float* out,
                           int n_tiles, int tr, int n_clusters, int k,
                           int early_exit, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tr <= 0 || tr > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  cluster_kernel<<<n_tiles, tr, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, cnt, ids, entry, reinterpret_cast<const float4*>(rows), out,
      n_tiles * tr, n_clusters, k, early_exit);
  return static_cast<int>(cudaGetLastError());
}
