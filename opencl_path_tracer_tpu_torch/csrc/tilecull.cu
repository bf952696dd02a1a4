// K6: the tile-culled nearest triangle hit per ray: the least accepted t
// and its row in the Morton-ordered pack, over groups of rows with boxes.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// tilecull_kernel.py::_tilecull_kernel (launched by _run_tilecull).
//
// What it computes: over the groups in table order, a ray needs a group
// where its slab test passes and the box's entry tn is below its best t,
// and then runs nearest.cuh's exact test on the group's rows in order
// with a strict <. So exact-t ties keep the first row in Morton order,
// and the result does not depend on how coarsely a kernel skips: a group
// skipped at tn >= best t holds no hit below best t (its box is inflated
// against rounding).
//
// What bounds it on the H100: operations, 12 float32 operations per
// (ray, triangle) test that reaches the divide and 12 per edge test
// reached, over the sub-blocks the rules leave, plus about 25 per (ray,
// group) slab test and per (ray, sub-block) box test; the rays are read
// once, (t, g) written once. The first kernel (tilecull_simt_kernel
// below) staged a group's rows into shared memory for the whole block of
// 256 rays where any of them needed it (__syncthreads_or), and each
// needing ray ran every row of the group. This kernel keeps the group
// test and, inside a needed group, skips per ray each sub-block of kSub
// rows whose box (sub_cull.cuh, the table tilecull_kernel.
// anyhit_sub_boxes builds per scene, K7's) the segment P + s D, 0 <= s
// <= best t, misses: the rule proves such a sub-block holds no accepted
// t <= best, so no tie is skipped either, and the (t, row) after each
// sub-block is the first kernel's bit for bit. A sub-block with a
// degenerate row has the infinite box and is never skipped (so zero-area
// strips behave as before), nor is any sub-block for a ray outside the
// rule's ranges (cull_ray's |P|_1 = inf widens every box to all space).
//
// Layout: one thread per ray, 256 rays a block, and nothing shared by the
// block: each warp walks the group table on its own, reading the groups,
// the boxes and the rows through the read-only path, and skips a group
// that none of its rays needs. Per sub-block it takes the ballot of its
// rays whose box test passed and skips the sub-block when it is empty; a
// ballot of at most coop_max rays runs on all 32 lanes, one ray at a
// time (sub_cull.cuh's coop_sub_block); with more, each lane tests the
// rows against its own ray.
//
// Entry points: ptx_tilecull (the kernel the wrapper launches);
// ptx_tilecull_count (the same kernel, also adding to counter[0..4] the
// tests that reached the divide, the box tests that passed, those of them
// run by the whole warp, the edge tests reached, and the group slab and
// box tests made); ptx_tilecull_simt (the first kernel, kept to hold this
// one against whole launches and to time the two in turns; no wrapper on
// a render path reaches either of the last two).

#include <stdint.h>

#include "groups.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

constexpr int kRow = kTriCols / 4;   // float4s per pack row

__global__ void __launch_bounds__(kBlock)
tilecull_simt_kernel(const float* __restrict__ rays8, int ray_stride,
                     const float4* __restrict__ tri,
                     const float* __restrict__ groups,
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

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
tilecull_cull_kernel(const float* __restrict__ rays8, int ray_stride,
                     const float4* __restrict__ tri,
                     const float* __restrict__ groups,
                     const float4* __restrict__ sub,
                     float* __restrict__ t_out, float* __restrict__ g_out,
                     int n_rays, int n_groups, int n_sub, int coop_max,
                     unsigned long long* __restrict__ counter) {
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
  const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
  CullCounts ct;
  Nearest best{kBig, 0};
  int sb = 0;   // the group's first sub-block in the table
#pragma unroll 1
  for (int gi = 0; gi < n_groups; ++gi) {
    const float* g = groups + gi * kGroupCols;
    float gb[kGroupCols];
#pragma unroll
    for (int q = 0; q < kGroupCols; ++q) gb[q] = __ldg(&g[q]);
    const int base = static_cast<int>(gb[6]), end = static_cast<int>(gb[7]);
    const int nsb = (end - base + kSub - 1) / kSub;
    float tn, tf;
    slab(gb, px, py, pz, ix, iy, iz, tn, tf);
    const bool need = live && tf >= tn && tf >= 0.f && tn < best.t;
    if (COUNT && live) ++ct.made;
    if (__any_sync(kFull, need)) {
#pragma unroll 1
      for (int s = 0; s < nsb; ++s) {
        // A sub-block past the table's end (a table built for other
        // groups) is never skipped.
        const float4* box = sub + 2 * static_cast<size_t>(sb + s);
        const bool go =
            need && (sb + s >= n_sub ||
                     box_maybe(cr, __ldg(&box[0]), __ldg(&box[1]), best.t));
        if (COUNT && need) ++ct.made;
        const unsigned bal = __ballot_sync(kFull, go);
        if (!bal) continue;
        const int s0 = base + s * kSub, n = min(kSub, end - s0);
        const float4* r0 = tri + static_cast<size_t>(s0) * kRow;
        if (COUNT && go) {
          ++ct.box;
          ct.div += n;
        }
        if (__popc(bal) > coop_max) {
          // Many of the warp's rays: each tests the rows in order.
          if (go)
            lane_sub_block<kRow, COUNT>(r0, n, s0, px, py, pz, dx, dy, dz,
                                        best, ct);
        } else {
          if (COUNT) {
            if (go) ++ct.coop;
            coop_edges<kRow>(r0, n, bal, px, py, pz, dx, dy, dz, ct);
          }
          coop_sub_block<kRow>(tri, s0, s0 + n, bal, px, py, pz, dx, dy, dz,
                               0, best);
        }
      }
    }
    sb += nsb;
  }
  if (live) {
    t_out[i] = best.t;
    g_out[i] = static_cast<float>(best.g);
  }
  if (COUNT) ct.add_to(counter);
}

template <bool COUNT>
int launch_cull(const float* rays8, int ray_stride, const float* tri_pack,
                const float* groups, const float* sub, float* t_out,
                float* g_out, int n_rays, int n_groups, int n_sub,
                int coop_max, void* counter, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri_pack) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  tilecull_cull_kernel<COUNT>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          rays8, ray_stride, reinterpret_cast<const float4*>(tri_pack),
          groups, reinterpret_cast<const float4*>(sub), t_out, g_out, n_rays,
          n_groups, n_sub, coop_max,
          static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_tilecull(const float* rays8, int ray_stride,
                            const float* tri_pack, const float* groups,
                            const float* sub, float* t_out, float* g_out,
                            int n_rays, int n_groups, int n_sub,
                            int coop_max, void* stream) {
  return launch_cull<false>(rays8, ray_stride, tri_pack, groups, sub, t_out,
                            g_out, n_rays, n_groups, n_sub, coop_max,
                            nullptr, stream);
}

extern "C" int ptx_tilecull_count(const float* rays8, int ray_stride,
                                  const float* tri_pack, const float* groups,
                                  const float* sub, float* t_out,
                                  float* g_out, int n_rays, int n_groups,
                                  int n_sub, int coop_max, void* counter,
                                  void* stream) {
  return launch_cull<true>(rays8, ray_stride, tri_pack, groups, sub, t_out,
                           g_out, n_rays, n_groups, n_sub, coop_max, counter,
                           stream);
}

extern "C" int ptx_tilecull_simt(const float* rays8, int ray_stride,
                                 const float* tri_pack, const float* groups,
                                 float* t_out, float* g_out, int n_rays,
                                 int n_groups, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1 || n_groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  tilecull_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, reinterpret_cast<const float4*>(tri_pack), groups,
      t_out, g_out, n_rays, n_groups);
  return static_cast<int>(cudaGetLastError());
}
