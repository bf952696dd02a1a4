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
// The rays are the (Rpad, 8) rows [p d 0 0]; a ray with D = 0 (the zero
// rays that pad a batch) hits nothing and takes no cluster.
//
// What bounds it on the H100: operations, as K1 (12 float32 operations
// per (ray, triangle) test that reaches the divide and 12 per edge test
// reached), over the sub-blocks the skip rule leaves, plus about 25 per
// (ray, sub-block) box test. The first kernel (group_simt_kernel below)
// staged each cluster of the union that any of its 256 threads took
// through shared memory (__syncthreads_or), and every taking ray tested
// all K triangles. This kernel walks the same clusters in the same order
// and skips, per ray, each sub-block of kSub rows whose box (sub_cull.cuh,
// the table cluster_kernel.cluster_sub_boxes builds per scene) its
// segment to its running best misses, K17's rule: such a sub-block holds
// no accepted t <= best, so no tie is skipped either, and each ray's
// (t, index) after each cluster is the first kernel's bit for bit, even
// for a cluster of the union that the ray's own mask does not have.
//
// Layout: one thread per ray, blocks of kBlock consecutive rays (a block
// may straddle two groups when `block` is not a multiple of kBlock), and
// nothing staged: each warp walks the OR of its lanes' unions in
// ascending order, a lane taking a cluster where its own union has the
// bit, and reads the rows and boxes through the read-only path. Per
// sub-block it takes the ballot of its rays whose box test passed and
// skips the sub-block when it is empty; a ballot of at most coop_max rays
// runs on all 32 lanes, one ray at a time (sub_cull.cuh's
// coop_sub_block); with more, each lane tests the rows against its own
// ray. The winner's attributes come last (cluster_block.cuh's
// winner_attrs).
//
// Entry points: ptx_group (the kernel the wrapper launches);
// ptx_group_count (the same kernel, also adding to counter[0..4] the
// tests that reached the divide, the box tests that passed, those of them
// run by the whole warp, the edge tests reached and the box tests made);
// ptx_group_simt (the first kernel, kept to hold this one against whole
// launches and to time the two in turns; no wrapper on a render path
// reaches either of the last two).

#include <stdint.h>

#include "cluster_block.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

constexpr int kRow = kTriCols / 4;   // float4s per pack row

__device__ __forceinline__ void write_out(const float4* __restrict__ tri,
                                          const Nearest& best, float* out,
                                          int n_rays, int i) {
  float a[4];
  winner_attrs(tri, best, a);
  const size_t n = static_cast<size_t>(n_rays);
  out[i] = best.t;
  out[n + i] = a[0];
  out[2 * n + i] = a[1];
  out[3 * n + i] = a[2];
  out[4 * n + i] = a[3];
}

__global__ void __launch_bounds__(kBlock)
group_simt_kernel(const int* __restrict__ unions,
                  const float* __restrict__ rays8,
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
  if (live) write_out(tri, best, out, n_rays, i);
}

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
group_cull_kernel(const int* __restrict__ unions,
                  const float* __restrict__ rays8,
                  const float4* __restrict__ tri,
                  const float4* __restrict__ sub, float* __restrict__ out,
                  int n_rays, int block, int n_clusters, int k, int coop_max,
                  unsigned long long* __restrict__ counter) {
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
    // A padding ray (D = 0) never hits: it takes no cluster.
    if (dx != 0.f || dy != 0.f || dz != 0.f)
      u = static_cast<unsigned>(unions[i / block]);
  }
  if (n_clusters < 32) u &= (1u << n_clusters) - 1u;
  const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
  const int nsb = (k + kSub - 1) / kSub;   // sub-blocks per cluster
  CullCounts ct;
  Nearest best{kBig, 0};
  // The warp's clusters, ascending: the OR of its lanes' unions.
#pragma unroll 1
  for (unsigned rest = __reduce_or_sync(kFull, u); rest; rest &= rest - 1) {
    const int ci = __ffs(rest) - 1;
    const bool take = (u >> ci) & 1u;
    const float4* rows = tri + static_cast<size_t>(ci) * k * kRow;
    const float4* boxes = sub + static_cast<size_t>(ci) * nsb * 2;
#pragma unroll 1
    for (int s = 0; s < nsb; ++s) {
      const bool go =
          take && box_maybe(cr, __ldg(&boxes[2 * s]),
                            __ldg(&boxes[2 * s + 1]), best.t);
      if (COUNT && take) ++ct.made;
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
  }
  if (live) write_out(tri, best, out, n_rays, i);
  if (COUNT) ct.add_to(counter);
}

template <bool COUNT>
int launch_cull(const int* unions, const float* rays8, const float* rows,
                const float* sub, float* out, int n_rays, int block,
                int n_clusters, int k, int coop_max, void* counter,
                void* stream) {
  if (n_rays <= 0) return 0;
  if (block <= 0 || k <= 0 || n_clusters < 1 || n_clusters > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16 ||
      reinterpret_cast<uintptr_t>(rays8) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  group_cull_kernel<COUNT>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          unions, rays8, reinterpret_cast<const float4*>(rows),
          reinterpret_cast<const float4*>(sub), out, n_rays, block,
          n_clusters, k, coop_max, static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_group(const int* unions, const float* rays8,
                         const float* rows, const float* sub, float* out,
                         int n_rays, int block, int n_clusters, int k,
                         int coop_max, void* stream) {
  return launch_cull<false>(unions, rays8, rows, sub, out, n_rays, block,
                            n_clusters, k, coop_max, nullptr, stream);
}

extern "C" int ptx_group_count(const int* unions, const float* rays8,
                               const float* rows, const float* sub,
                               float* out, int n_rays, int block,
                               int n_clusters, int k, int coop_max,
                               void* counter, void* stream) {
  return launch_cull<true>(unions, rays8, rows, sub, out, n_rays, block,
                           n_clusters, k, coop_max, counter, stream);
}

extern "C" int ptx_group_simt(const int* unions, const float* rays8,
                              const float* rows, float* out, int n_rays,
                              int block, int n_clusters, int k,
                              void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  group_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      unions, rays8, reinterpret_cast<const float4*>(rows), out, n_rays,
      block, n_clusters, k);
  return static_cast<int>(cudaGetLastError());
}
