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
// What bounds it on the H100: operations, as K1 (12 float32 operations
// per (ray, triangle) test and 12 per edge test reached), over the tests
// the skip rule leaves, plus about 25 per (ray, sub-block) box test. The
// first kernel (cluster_simt_kernel below) tested every ray against every
// triangle of every listed cluster, staged through shared memory by the
// whole block. But a tile's list is one interval slab test of all its
// rays: on first-bounce tiles, whose directions span every axis, it
// lists nearly every cluster, and most of a ray's clusters are nowhere
// near its segment. This kernel walks the list in the same order and
// skips, per ray, each sub-block of kSub rows whose box (sub_cull.cuh,
// the table cluster_kernel.sub_boxes builds per scene) its segment to its
// running best misses; the rule proves such a sub-block holds no accepted
// t <= best, so no tie is skipped either, and each ray's (t, index) after
// each slot is the first kernel's bit for bit. So is the tile's largest
// best, and early_exit breaks where the first kernel does.
//
// Layout: one CUDA block per tile, one thread per ray (tr a multiple of
// 32, at most 1024). Nothing is staged for the block: each warp walks the
// list on its own, reading the rows and boxes through the read-only path
// (the stress scene's 9.5 MB of rows and 99.5 KB of boxes stay in L2).
// Per sub-block it takes the ballot of its rays whose box test passed and
// skips the sub-block when it is empty; a ballot of at most coop_max rays
// runs on all 32 lanes, one ray at a time (sub_cull.cuh's coop_sub_block,
// the __reduce_min_sync merge of K12); with more, each lane tests the rows
// against its own ray. Only early_exit synchronises the block (the
// maximum after each slot).
//
// Entry points: ptx_cluster (the kernel the wrapper launches);
// ptx_cluster_count (the same kernel, also adding to counter[0..4] the
// tests that reached the divide, the box tests that passed, those of them
// run by the whole warp, the edge tests reached and the box tests made);
// ptx_cluster_simt (the first kernel, kept to hold this one against whole
// launches and to time the two in turns; no wrapper on a render path
// reaches either of the last two).

#include <stdint.h>

#include "cluster_block.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

constexpr int kMaxTile = 1024;
constexpr int kRow = kTriCols / 4;   // float4s per pack row

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

__device__ __forceinline__ void write_out(const float4* __restrict__ tri,
                                          const Nearest& best, float* out,
                                          int n_rays, int i) {
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

__global__ void __launch_bounds__(kMaxTile)
cluster_simt_kernel(const float* __restrict__ rays8,
                    const int* __restrict__ cnt, const int* __restrict__ ids,
                    const float* __restrict__ entry,
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
  write_out(tri, best, out, n_rays, i);
}

template <bool COUNT>
__global__ void __launch_bounds__(kMaxTile)
cluster_cull_kernel(const float* __restrict__ rays8,
                    const int* __restrict__ cnt, const int* __restrict__ ids,
                    const float* __restrict__ entry,
                    const float4* __restrict__ tri,
                    const float4* __restrict__ sub, float* __restrict__ out,
                    int n_rays, int n_clusters, int k, int early_exit,
                    int coop_max, unsigned long long* __restrict__ counter) {
  __shared__ float red[32];
  const int g = blockIdx.x;
  const int i = g * blockDim.x + threadIdx.x;
  const float4 a = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i];
  const float4 b = reinterpret_cast<const float4*>(rays8)[2 * (size_t)i + 1];
  const float px = a.x, py = a.y, pz = a.z, dx = a.w, dy = b.x, dz = b.y;
  const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
  const int n_list = cnt[g];
  const int* list = ids + (size_t)g * n_clusters;
  const float* ent = entry + (size_t)g * n_clusters;
  const int nsb = (k + kSub - 1) / kSub;   // sub-blocks per cluster
  CullCounts ct;
  Nearest best{kBig, 0};
  float max_best = kBig;
#pragma unroll 1
  for (int slot = 0; slot < n_list; ++slot) {
    if (early_exit && !(ent[slot] < max_best)) break;
    const int ci = __ldg(&list[slot]);
    const float4* rows = tri + static_cast<size_t>(ci) * k * kRow;
    const float4* boxes = sub + static_cast<size_t>(ci) * nsb * 2;
#pragma unroll 1
    for (int s = 0; s < nsb; ++s) {
      const bool go =
          box_maybe(cr, __ldg(&boxes[2 * s]), __ldg(&boxes[2 * s + 1]),
                    best.t);
      if (COUNT) ++ct.made;
      const unsigned bal = __ballot_sync(kFull, go);
      if (!bal) continue;
      const int s0 = s * kSub, n = min(kSub, k - s0);
      const float4* r0 = rows + static_cast<size_t>(s0) * kRow;
      if (COUNT && go) {
        ++ct.box;
        ct.div += n;
      }
      if (__popc(bal) > coop_max) {
        // Many of the warp's rays: each tests the rows in order.
        if (go)
          lane_sub_block<kRow, COUNT>(r0, n, ci * k + s0, px, py, pz, dx, dy,
                                      dz, best, ct);
      } else {
        if (COUNT) {
          if (go) ++ct.coop;
          coop_edges<kRow>(r0, n, bal, px, py, pz, dx, dy, dz, ct);
        }
        coop_sub_block<kRow>(rows, s0, s0 + n, bal, px, py, pz, dx, dy, dz,
                             ci * k, best);
      }
    }
    if (early_exit) max_best = block_max(best.t, red);
  }
  write_out(tri, best, out, n_rays, i);
  if (COUNT) ct.add_to(counter);
}

template <bool COUNT>
int launch_cull(const float* rays8, const int* cnt, const int* ids,
                const float* entry, const float* rows, const float* sub,
                float* out, int n_tiles, int tr, int n_clusters, int k,
                int early_exit, int coop_max, void* counter, void* stream) {
  if (n_tiles <= 0) return 0;
  if (tr <= 0 || tr > kMaxTile || tr % 32 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16 ||
      reinterpret_cast<uintptr_t>(rays8) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cluster_cull_kernel<COUNT>
      <<<n_tiles, tr, 0, static_cast<cudaStream_t>(stream)>>>(
          rays8, cnt, ids, entry, reinterpret_cast<const float4*>(rows),
          reinterpret_cast<const float4*>(sub), out, n_tiles * tr,
          n_clusters, k, early_exit, coop_max,
          static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_cluster(const float* rays8, const int* cnt, const int* ids,
                           const float* entry, const float* rows,
                           const float* sub, float* out, int n_tiles, int tr,
                           int n_clusters, int k, int early_exit,
                           int coop_max, void* stream) {
  return launch_cull<false>(rays8, cnt, ids, entry, rows, sub, out, n_tiles,
                            tr, n_clusters, k, early_exit, coop_max, nullptr,
                            stream);
}

extern "C" int ptx_cluster_count(const float* rays8, const int* cnt,
                                 const int* ids, const float* entry,
                                 const float* rows, const float* sub,
                                 float* out, int n_tiles, int tr,
                                 int n_clusters, int k, int early_exit,
                                 int coop_max, void* counter, void* stream) {
  return launch_cull<true>(rays8, cnt, ids, entry, rows, sub, out, n_tiles,
                           tr, n_clusters, k, early_exit, coop_max, counter,
                           stream);
}

extern "C" int ptx_cluster_simt(const float* rays8, const int* cnt,
                                const int* ids, const float* entry,
                                const float* rows, float* out, int n_tiles,
                                int tr, int n_clusters, int k, int early_exit,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (tr <= 0 || tr > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  cluster_simt_kernel<<<n_tiles, tr, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, cnt, ids, entry, reinterpret_cast<const float4*>(rows), out,
      n_tiles * tr, n_clusters, k, early_exit);
  return static_cast<int>(cudaGetLastError());
}
