// K12: the VPU pairs round of the pair intersector (accel 'pair').
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sorted_intersect.py::_pair_kernel (launched by _run_pairs).
//
// What it computes, per (ray, cluster) pair of a list sorted by cluster
// key: the nearest hit among that cluster's K triangles (cluster_block.cuh)
// and the winner's normal and material; rows [t nx ny nz mati] of a
// (5, P) output. A pair of the dummy key C (or any key outside [0, C))
// is no work and keeps (BIG, 0, 0, 0, 0). The TPU walks each tile's runs
// of equal keys in a while loop; a pair has one key, so its result does
// not depend on the tiling.
//
// Layout: one thread per pair, blocks of kBlock consecutive pairs. The
// block walks its runs as the TPU kernel does: the key at the run's
// start is read by every thread, the run's cluster is staged through
// shared memory and tested by the threads in the run, and the next run
// starts after the count of pairs with that key (__syncthreads_count).
//
// What bounds it on the H100: operations, as K1 (12 float32 operations
// per (pair, triangle) test and 12 per edge test reached).

#include "cluster_block.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
pair_vpu_kernel(const int* __restrict__ keys, const float* __restrict__ rays8,
                const float4* __restrict__ tri, float* __restrict__ out,
                int n_pairs, int n_clusters, int k) {
  __shared__ float4 tile[kTile * 4];
  const int start = blockIdx.x * kBlock;
  const int i = start + threadIdx.x;
  const bool live = i < n_pairs;
  const size_t np = static_cast<size_t>(n_pairs);
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  int key = -1;
  if (live) {
    px = rays8[i];
    py = rays8[np + i];
    pz = rays8[2 * np + i];
    dx = rays8[3 * np + i];
    dy = rays8[4 * np + i];
    dz = rays8[5 * np + i];
    key = keys[i];
  }
  const int n_here = min(kBlock, n_pairs - start);
  Nearest best{kBig, 0};
  int pos = 0;
  while (pos < n_here) {
    const int ci = keys[start + pos];
    if (ci >= n_clusters) break;          // the dummy key sorts last
    const bool in_run = live && key == ci;
    if (ci >= 0) {
      merge_cluster(tile, tri, ci * k, k, in_run, px, py, pz, dx, dy, dz,
                    best);
    }
    pos += __syncthreads_count(in_run);
  }
  if (!live) return;
  float a[4];
  winner_attrs(tri, best, a);
  out[i] = best.t;
  out[np + i] = a[0];
  out[2 * np + i] = a[1];
  out[3 * np + i] = a[2];
  out[4 * np + i] = a[3];
}

}  // namespace

extern "C" int ptx_pair_vpu(const int* keys, const float* rays8p,
                            const float* rows, float* out, int n_pairs,
                            int n_clusters, int k, void* stream) {
  if (n_pairs <= 0) return 0;
  const int grid = (n_pairs + kBlock - 1) / kBlock;
  pair_vpu_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, rays8p, reinterpret_cast<const float4*>(rows), out, n_pairs,
      n_clusters, k);
  return static_cast<int>(cudaGetLastError());
}
