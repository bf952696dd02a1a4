// K7: the any-hit shadow-ray test: is there a triangle whose exact hit t
// lies in (0, rmax)? One flag per ray.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// tilecull_kernel.py::_anyhit_kernel (launched by _run_anyhit).
//
// What it computes: over the Morton-ordered pack's groups in table order,
// a ray needs a group where its slab test passes, the box's entry tn is
// at most rmax (segment culling) and it is not yet occluded, and then
// runs nearest.cuh's exact test op for op on the group's rows until its
// first hit with t < rmax. So the flag equals (K4's nearest t is valid
// and below rmax) bit for bit, but where a zero-area triangle's strip
// outside its group's box would occlude (the group culling never looks
// there; ROADMAP.md queue 3).
//
// What bounds it on the H100: operations, about 48 float32 operations
// per (ray, triangle) test the rules leave (12 to the divide, 12 per
// edge test reached; fewer where a ray stops early) plus about 25 per
// (ray, group) slab test and per (ray, sub-block) box test; the rays and
// rmax are read once, one byte is written per ray. The first kernel
// (anyhit_simt_kernel below) staged a group's rows into shared memory for
// the whole block of 256 rays where any of them needed it
// (__syncthreads_or), and each needing ray ran every row of the group up
// to its first hit. Shadow rays of later bounces leave scattered points:
// every block then needs nearly every group, and its lanes diverge. This
// kernel keeps the group test and, inside a needed group, skips per ray
// each sub-block of kSub rows whose box (sub_cull.cuh, the table
// tilecull_kernel.anyhit_sub_boxes builds per scene) the segment P + s D,
// 0 <= s <= rmax, misses: the rule proves it holds no accepted t <=
// rmax, so none below rmax either. A degenerate row's sub-block has the
// infinite box and is never skipped, which keeps the strips' behaviour.
// A ray with rmax <= 0 or NaN needs nothing (an accepted t is above 0).
//
// Layout: one thread per ray, 256 rays a block, and nothing shared by the
// block: each warp walks the groups on its own, reading the group table,
// the boxes and the rows through the read-only path, and leaves as soon
// as all its rays are occluded or need nothing. Per sub-block it takes
// the ballot of its rays whose box test passed and skips the sub-block
// when it is empty; a ballot of at most coop_max rays runs on all 32
// lanes, one ray at a time (lane l tests row l, __any_sync decides); with
// more, each lane tests the rows against its own ray until its first
// hit.
//
// Entry points: ptx_anyhit (the kernel the wrapper launches);
// ptx_anyhit_count (the same kernel, also adding to counter[0..4] the
// tests that reached the divide, the box tests that passed, those of them
// run by the whole warp, the edge tests reached, and the group slab and
// box tests made); ptx_anyhit_simt (the first kernel, kept to hold this
// one against whole launches and to time the two in turns; no wrapper on
// a render path reaches either of the last two).

#include <stdint.h>

#include "groups.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

constexpr int kRow = kTriCols / 4;   // float4s per pack row

__global__ void __launch_bounds__(kBlock)
anyhit_simt_kernel(const float* __restrict__ rays8, int ray_stride,
                   const float* __restrict__ rmax_in,
                   const float4* __restrict__ tri,
                   const float* __restrict__ groups,
                   unsigned char* __restrict__ occ_out, int n_rays,
                   int n_groups) {
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

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
anyhit_cull_kernel(const float* __restrict__ rays8, int ray_stride,
                   const float* __restrict__ rmax_in,
                   const float4* __restrict__ tri,
                   const float* __restrict__ groups,
                   const float4* __restrict__ sub,
                   unsigned char* __restrict__ occ_out, int n_rays,
                   int n_groups, int n_sub, int coop_max,
                   unsigned long long* __restrict__ counter) {
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
  const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
  // A ray past the end has rmax = 0: it needs nothing either.
  const bool idle = !(rmax > 0.f);
  const int lane = threadIdx.x & 31;
  CullCounts ct;
  bool occ = false;
  int sb = 0;   // the group's first sub-block in the table
#pragma unroll 1
  for (int gi = 0; gi < n_groups; ++gi) {
    if (__all_sync(kFull, occ || idle)) break;
    const float* g = groups + gi * kGroupCols;
    float gb[kGroupCols];
#pragma unroll
    for (int q = 0; q < kGroupCols; ++q) gb[q] = __ldg(&g[q]);
    const int base = static_cast<int>(gb[6]), end = static_cast<int>(gb[7]);
    const int nsb = (end - base + kSub - 1) / kSub;
    float tn, tf;
    slab(gb, px, py, pz, ix, iy, iz, tn, tf);
    const bool need = !idle && !occ && tf >= tn && tf >= 0.f && tn <= rmax;
    if (COUNT && !idle && !occ) ++ct.made;
    if (__any_sync(kFull, need)) {
#pragma unroll 1
      for (int s = 0; s < nsb; ++s) {
        // A sub-block past the table's end (a table built for other
        // groups) is never skipped.
        const float4* box = sub + 2 * static_cast<size_t>(sb + s);
        const bool test = need && !occ;
        const bool go =
            test && (sb + s >= n_sub ||
                     box_maybe(cr, __ldg(&box[0]), __ldg(&box[1]), rmax));
        if (COUNT && test) ++ct.made;
        const unsigned bal = __ballot_sync(kFull, go);
        if (!bal) continue;
        const int s0 = base + s * kSub, n = min(kSub, end - s0);
        const float4* r0 = tri + static_cast<size_t>(s0) * kRow;
        if (COUNT && go) ++ct.box;
        if (__popc(bal) > coop_max) {
          // Many of the warp's rays: each tests the rows in order up to
          // its first hit below rmax.
          if (!go) continue;
          for (int j = 0; j < n; ++j) {
            float t;
            const bool hit =
                exact_hit(r0 + j * kRow, px, py, pz, dx, dy, dz, t) &&
                t < rmax;
            if (COUNT) {
              ++ct.div;
              ct.edge += edges_reached(r0 + j * kRow, px, py, pz, dx, dy, dz);
            }
            if (hit) {
              occ = true;
              break;
            }
          }
        } else {
          if (COUNT && go) ++ct.coop;
          // One ray of the ballot at a time: lane l tests row l.
          for (unsigned rest = bal; rest; rest &= rest - 1) {
            const int src = __ffs(rest) - 1;
            const float qx = __shfl_sync(kFull, px, src);
            const float qy = __shfl_sync(kFull, py, src);
            const float qz = __shfl_sync(kFull, pz, src);
            const float ex = __shfl_sync(kFull, dx, src);
            const float ey = __shfl_sync(kFull, dy, src);
            const float ez = __shfl_sync(kFull, dz, src);
            const float rm = __shfl_sync(kFull, rmax, src);
            float t;
            const bool hit =
                lane < n &&
                exact_hit(r0 + lane * kRow, qx, qy, qz, ex, ey, ez, t) &&
                t < rm;
            if (COUNT && lane < n) {
              ++ct.div;
              ct.edge +=
                  edges_reached(r0 + lane * kRow, qx, qy, qz, ex, ey, ez);
            }
            if (__any_sync(kFull, hit) && lane == src) occ = true;
          }
        }
      }
    }
    sb += nsb;
  }
  if (live) occ_out[i] = occ ? 1 : 0;
  if (COUNT) ct.add_to(counter);
}

template <bool COUNT>
int launch_cull(const float* rays8, int ray_stride, const float* rmax,
                const float* tri_pack, const float* groups, const float* sub,
                unsigned char* occ, int n_rays, int n_groups, int n_sub,
                int coop_max, void* counter, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri_pack) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  anyhit_cull_kernel<COUNT>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          rays8, ray_stride, rmax, reinterpret_cast<const float4*>(tri_pack),
          groups, reinterpret_cast<const float4*>(sub), occ, n_rays,
          n_groups, n_sub, coop_max,
          static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_anyhit(const float* rays8, int ray_stride,
                          const float* rmax, const float* tri_pack,
                          const float* groups, const float* sub,
                          unsigned char* occ, int n_rays, int n_groups,
                          int n_sub, int coop_max, void* stream) {
  return launch_cull<false>(rays8, ray_stride, rmax, tri_pack, groups, sub,
                            occ, n_rays, n_groups, n_sub, coop_max, nullptr,
                            stream);
}

extern "C" int ptx_anyhit_count(const float* rays8, int ray_stride,
                                const float* rmax, const float* tri_pack,
                                const float* groups, const float* sub,
                                unsigned char* occ, int n_rays, int n_groups,
                                int n_sub, int coop_max, void* counter,
                                void* stream) {
  return launch_cull<true>(rays8, ray_stride, rmax, tri_pack, groups, sub,
                           occ, n_rays, n_groups, n_sub, coop_max, counter,
                           stream);
}

extern "C" int ptx_anyhit_simt(const float* rays8, int ray_stride,
                               const float* rmax, const float* tri_pack,
                               const float* groups, unsigned char* occ,
                               int n_rays, int n_groups, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 1 || n_groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  anyhit_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, rmax, reinterpret_cast<const float4*>(tri_pack),
      groups, occ, n_rays, n_groups);
  return static_cast<int>(cudaGetLastError());
}
