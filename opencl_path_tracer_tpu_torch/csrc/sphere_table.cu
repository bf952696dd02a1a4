// K3b: nearest analytic-sphere hit per ray over a sphere table of any
// size, with the winner's outward normal and material.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sphere_kernel.py::_sphere_table_kernel (launched by _run_sphere_table),
// which takes over from the baked K3 above 64 spheres.
//
// Table rows [cx cy cz rad inv_rad ccdot mati live], ccdot = c.c - r^2
// and inv_rad = 1/r in float32 from the host. Per (ray, sphere):
//   b = p.d - d.c;  cc = (p.p - 2 p.c) + ccdot;  disc = b*b - cc
//   t = -b - sqrt(max(disc, 0)) if that is > 0, else -b + sqrt(...)
//   a hit needs disc > 0, t > 0 and live > 0; a strict < over the table
//   in order keeps the lower index on ties (the TPU's min + argmin).
// Then the winner's row is fetched (on the TPU a one-hot matmul over a
// bf16 three-way split, exact; here an indexed load, with `+ 0.0f` for
// the one-hot sum's +0.0) and n = (p + t d - c) * inv_rad. On a miss
// t = -1 and the normal and material are 0. The rounding follows
// interpret-mode XLA on the CPU, found by probing it: each dot product
// is fma(a2, b2, fma(a0, b0, a1 * b1)), disc is fma(b, b, -cc) and
// p + t d is fma(d, t, p); everything else rounds separately
// (--fmad=false). So the result is the least (t, index) over the valid
// pairs with t < BIG, in any order of the spheres.
//
// What bounds it on the H100: operations. The first kernel
// (sphere_table_simt_kernel below: one thread per ray, the table staged
// in shared memory) ran the whole chain for every (ray, sphere) pair, five
// shared-memory loads, the two dots, disc, an IEEE sqrtf, both roots, the
// select and the compares, about 40 instructions a pair, and was issue
// bound on it. Almost none of it is needed: on the many-light scene's
// camera rays 0.2 % of the pairs have disc > 0. This kernel:
//  - walks groups of at most kGroup = 8 spheres (Morton order of the
//    centres, built on the host once per scene: sphere_kernel.
//    sphere_groups) and skips, per ray, a group whose widened box its
//    segment P + s D, 0 <= s <= best, misses (sub_cull.cuh's box_maybe,
//    with the sphere margin proved below), where no sphere of the group
//    can give a valid t <= best;
//  - in a group that some lane of the warp enters, computes b, cc and
//    disc for each sphere, and runs the sqrt, the roots, the select and
//    the merge only where some lane of the warp that entered has disc > 0
//    for some sphere of the group (one warp vote a group, __any_sync);
//  - merges with t < best or (t == best and index < best index), from
//    (BIG, -1): the groups are not in table order, and this gives the
//    least (t, index) over the valid pairs with t < BIG in any order, the
//    first kernel's (t, index) bit for bit, each pair's arithmetic being
//    the first kernel's;
//  - a group that few rays of a warp enter still runs on every lane: a
//    path that spread such a group's (ray, sphere) pairs over all 32
//    lanes measured no faster in turns on an H100 at any ballot threshold
//    tried (4 to 32, many-lights first-bounce rays) and was dropped;
//  - stages the group table through shared memory kChunk groups at a time
//    (any size), where every lane of a warp reads the same address. Passing
//    the groups by value as a kernel parameter (__grid_constant__, the
//    constant bank) was measured slower in turns on an H100 at the only
//    sizes this kernel receives (make_sphere_intersect sends it more than
//    64 spheres, 9 groups or more): 0.186 against 0.141 ms at 9 groups
//    (many-lights first-bounce rays), 0.143 against 0.130 at 18
//    (stress-analytic camera rays); it won only at 1 group (0.045 against
//    0.048), and was removed.
//    Rows with live <= 0 (or NaN) never hit and are left out of the
//    groups; a group's unused places hold ccdot = +inf, whose cc is +inf
//    or NaN, so disc is never > 0 there.
//
// The sphere margin. u = 2^-24. Take a sphere row (c, ccdot), finite, with
// |c_i| <= 2^60 and |ccdot| <= 2^120, and a ray (P, D) with |P_i| <= 2^60
// and |fl(D.D) - 1| <= 2^-20 (so |D|^2 = 1 + delta, |delta| <= 19.1u;
// fl(D.D) is dot3(D, D) rounded as above). Let the rounded arithmetic give
// disc > 0 and a valid t > 0, and let X = P + t D exactly. With r_eff^2 =
// |c|^2 - ccdot (the sphere the row describes: ccdot is c.c - r^2
// rounded), S = |P| + |c| and W^2 = S^2 + |ccdot|:
//   |X - c|^2 - r_eff^2 = f(t) + (cc* - cc) + 2 t (b* - b) + t^2 delta,
// where b* = D.(P - c) and cc* = |P|^2 - 2 P.c + ccdot are exact and f(s) =
// s^2 + 2 b s + cc is the quadratic of the rounded b and cc. Each dot3 is
// within 3.01u sum |a_i b_i| of the exact dot, so |b - b*| <= 4.03u S and
// |cc - cc*| <= 5.02u S^2 + 1.01u |ccdot|; then |b| <= 1.0001 S, |cc| <=
// 1.0001 W^2, Delta = b^2 - cc in (0, 2.0003 W^2] (disc = RN(Delta) > 0
// implies Delta > 0), sq = RN(sqrt(disc)) <= 1.4144 W and t = RN(-b +- sq)
// <= 2.415 W. With t' = -b +- sq exactly, (t' + b)^2 = sq^2 is within
// 3.01u Delta of Delta, and t is within u t' of t', so |f(t)| <= 12.87u
// W^2; the other terms are at most 5.02u W^2, 19.47u W^2 and (2.415 W)^2
// 19.1u = 111.4u W^2: 148.8u W^2 in all. Gradual underflow adds at most
// 2^-150 a rounding, under 32 roundings, which changes the sum by less than
// 2^-120 (1 + W): with W' = W + 2^-50 the sum stays below 256u W'^2. So
// |X - c| <= sqrt(max(r_eff^2, 0) + 256u W'^2) <= r_box + 2^-8 W', r_box =
// sqrt(max(r_eff^2, 0)), and W' <= |P|_1 + |c| + sqrt(|ccdot|) + 2^-50. No
// product or sum overflows in these ranges. So X lies in the box [c -
// r_box - m, c + r_box + m] with m = A + Gp |P|_1, Gp = 2^-8 and A = 2^-8
// (|c| + sqrt(|ccdot|) + 2^-50): the group table holds per group the union
// of its spheres' boxes [c - r_box, c + r_box] (lo, hi), A the largest of
// its spheres', and Gp, built on the host in float64, r_box and A enlarged
// for float64's own roundings and all rounded outward to float32, as K12's
// table [lo A] [hi Gp] (pair_vpu.cu's header). And since X = P + t D with
// 0 < t <= best, the segment P + s D, 0 <= s <= best, meets the group's box
// widened by I = A + Gp |P|_1: where box_maybe (which rounds outward and
// answers false only where that segment certainly misses) is false, no
// sphere of the group has a valid t <= best, a tie at best included, so
// the group is skipped in any order. This holds for grazing rays (disc just
// above 0), tangent points on a box face, origins inside a sphere and any
// radius: no step assumed the ray enters the sphere, only that the rounded
// arithmetic accepted it. A ray outside the ranges (a component that is
// not finite, |P_i| > 2^60, or a direction not of unit length) gets I = inf
// and skips nothing; a group with a sphere outside them gets an infinite
// box and is never skipped. best only falls, so a group skipped once stays
// right.
//
// Entry points: ptx_sphere_table (the kernel the wrapper launches);
// ptx_sphere_table_count (the same kernel, also adding to counter[0..4]
// the (ray, group) box tests made, those that passed, the pairs whose disc
// was computed in the groups a ray entered, the pairs with disc > 0 there,
// and the (warp, group) steps that some lane of the warp entered);
// ptx_sphere_table_simt (the first kernel, kept to hold this one against
// whole launches and to time the two in turns; no wrapper on a render path
// reaches either of the last two).

#include <stdint.h>

#include <cuda_runtime.h>

#include "sub_cull.cuh"

namespace {

using ptx::box_maybe;
using ptx::CullRay;
using ptx::cull_ray;
using ptx::kFull;

constexpr int kBlock = 256;
constexpr int kCols = 8;
constexpr float kBig = 3.0e38f;
constexpr int kStaticSmem = 48 * 1024;
// The group table: per group kGroupF4 float4s, [lo A] [hi Gp], kGroup
// members [cx cy cz ccdot], then the members' table indices as int bits
// (-1 in an unused place).
constexpr int kGroup = 8;
constexpr int kGroupF4 = 2 + kGroup + kGroup / 4;
// Groups staged at a time in shared memory.
constexpr int kChunk = 32;

struct Outs {
  float *t, *nx, *ny, *nz, *m;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, ay * by));
}

// The ray as the loop reads it.
struct SphereRay {
  float px, py, pz, dx, dy, dz, p_dot_d, p_dot_p;
  CullRay cr;
};

__device__ __forceinline__ SphereRay sphere_ray(float px, float py, float pz,
                                                float dx, float dy,
                                                float dz) {
  SphereRay r;
  r.px = px;
  r.py = py;
  r.pz = pz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.p_dot_d = dot3(px, py, pz, dx, dy, dz);
  r.p_dot_p = dot3(px, py, pz, px, py, pz);
  r.cr = cull_ray(px, py, pz, dx, dy, dz);
  // The margin's ranges (the header); a NaN fails every comparison.
  const float lim = 0x1p60f;
  const bool in_range = fabsf(px) <= lim && fabsf(py) <= lim &&
                        fabsf(pz) <= lim &&
                        fabsf(dot3(dx, dy, dz, dx, dy, dz) - 1.0f) <=
                            0x1p-20f;
  if (!in_range) r.cr.pn = INFINITY;
  return r;
}

struct Best {
  float t;
  int s;
};

struct Counts {
  unsigned made = 0, passed = 0, disc = 0, sqrt = 0, warp = 0;
};

// Whether (t, s) comes before (bt, bs): the lower t, on a tie the lower
// table index.
__device__ __forceinline__ bool before(float t, int s, float bt, int bs) {
  return t < bt || (t == bt && s < bs);
}

// Groups [0, n) of the staged table (float4 j of group g at
// at[g * kGroupF4 + j]) against the lane's ray, merged into best. Every
// lane of the warp calls this (warp votes); a lane whose ray is not live
// enters no group.
template <bool COUNT>
__device__ __forceinline__ void scan_groups(const float4* at, int n,
                                            const SphereRay& r, bool live,
                                            Best& best, Counts& ct) {
#pragma unroll 1
  for (int g = 0; g < n; ++g) {
    const int e = g * kGroupF4;
    const bool go = live && box_maybe(r.cr, at[e], at[e + 1], best.t);
    if (COUNT) {
      ct.made += live;
      ct.passed += go;
    }
    if (!__any_sync(kFull, go)) continue;
    if (COUNT && (threadIdx.x & 31) == 0) ++ct.warp;
    // disc of every member first, then one vote: the sqrt, the roots and
    // the merge run only where some lane of the warp can hit.
    float b_half[kGroup], disc[kGroup];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4 c = at[e + 2 + k];
      b_half[k] = r.p_dot_d - dot3(r.dx, r.dy, r.dz, c.x, c.y, c.z);
      const float cc =
          (r.p_dot_p - 2.0f * dot3(r.px, r.py, r.pz, c.x, c.y, c.z)) + c.w;
      disc[k] = __fmaf_rn(b_half[k], b_half[k], -cc);
      any |= disc[k] > 0.f;
    }
    const float4 ia = at[e + 2 + kGroup], ib = at[e + 3 + kGroup];
    const int idx[kGroup] = {
        __float_as_int(ia.x), __float_as_int(ia.y), __float_as_int(ia.z),
        __float_as_int(ia.w), __float_as_int(ib.x), __float_as_int(ib.y),
        __float_as_int(ib.z), __float_as_int(ib.w)};
    if (COUNT) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        ct.disc += go && idx[k] >= 0;
        ct.sqrt += go && disc[k] > 0.f;
      }
    }
    if (!__any_sync(kFull, go && any)) continue;
    if (!go) continue;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (disc[k] > 0.f) {
        const float sq = sqrtf(disc[k]);
        const float t_near = -b_half[k] - sq;
        const float t = t_near > 0.f ? t_near : -b_half[k] + sq;
        if (t > 0.f && before(t, idx[k], best.t, best.s)) {
          best.t = t;
          best.s = idx[k];
        }
      }
    }
  }
}

// The winner's row of the (S, 8) table into lane i's outputs, as the first
// kernel writes them.
__device__ __forceinline__ void write_hit(const float* __restrict__ tab,
                                          const SphereRay& r, Best best,
                                          int i, Outs out) {
  const bool hit = best.t < kBig;
  const float* row = tab + static_cast<size_t>(hit ? best.s : 0) * kCols;
  const float safe_t = hit ? best.t : 0.f;
  const float inv_r = __fadd_rn(__ldg(row + 4), 0.0f);
  const float nx =
      (__fmaf_rn(r.dx, safe_t, r.px) - __fadd_rn(__ldg(row), 0.0f)) * inv_r;
  const float ny =
      (__fmaf_rn(r.dy, safe_t, r.py) - __fadd_rn(__ldg(row + 1), 0.0f)) *
      inv_r;
  const float nz =
      (__fmaf_rn(r.dz, safe_t, r.pz) - __fadd_rn(__ldg(row + 2), 0.0f)) *
      inv_r;
  out.t[i] = hit ? best.t : -1.0f;
  out.nx[i] = hit ? nx : 0.f;
  out.ny[i] = hit ? ny : 0.f;
  out.nz[i] = hit ? nz : 0.f;
  out.m[i] = hit ? __fadd_rn(__ldg(row + 6), 0.0f) : 0.f;
}

__device__ __forceinline__ SphereRay load_ray(const float* __restrict__ rays8,
                                              int i, int n_rays) {
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (i < n_rays) {
    px = rays8[i];
    py = rays8[n_rays + i];
    pz = rays8[2 * n_rays + i];
    dx = rays8[3 * n_rays + i];
    dy = rays8[4 * n_rays + i];
    dz = rays8[5 * n_rays + i];
  }
  return sphere_ray(px, py, pz, dx, dy, dz);
}

// The counts of a warp added to counter[0..4] by its lane 0.
__device__ __forceinline__ void add_counts(const Counts& ct,
                                           unsigned long long* counter) {
  const unsigned v[5] = {ct.made, ct.passed, ct.disc, ct.sqrt, ct.warp};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const unsigned w = __reduce_add_sync(kFull, v[k]);
    if ((threadIdx.x & 31) == 0) atomicAdd(&counter[k], (unsigned long long)w);
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
sphere_shared_kernel(const float* __restrict__ rays8,
                     const float* __restrict__ tab,
                     const float4* __restrict__ groups, Outs out, int n_rays,
                     int n_groups, unsigned long long* __restrict__ counter) {
  __shared__ float4 s[kChunk * kGroupF4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const SphereRay r = load_ray(rays8, i, n_rays);
  Best best{kBig, -1};
  Counts ct;
  for (int g0 = 0; g0 < n_groups; g0 += kChunk) {
    const int n = min(kChunk, n_groups - g0);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kGroupF4; k += kBlock)
      s[k] = groups[static_cast<size_t>(g0) * kGroupF4 + k];
    __syncthreads();
    scan_groups<COUNT>(s, n, r, i < n_rays, best, ct);
  }
  if (i < n_rays) write_hit(tab, r, best, i, out);
  if (COUNT) add_counts(ct, counter);
}

template <bool COUNT>
int launch(const float* rays8, const float* table, const float* groups,
           Outs out, int n_rays, int n_groups, void* counter, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(groups) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  sphere_shared_kernel<COUNT><<<grid, kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      rays8, table, reinterpret_cast<const float4*>(groups), out, n_rays,
      n_groups, static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float dot3s(float ax, float ay, float az,
                                       const float* c) {
  return dot3(ax, ay, az, c[0], c[1], c[2]);
}

__global__ void __launch_bounds__(kBlock)
sphere_table_simt_kernel(const float* __restrict__ rays8,
                         const float* __restrict__ tab, Outs out, int n_rays,
                         int n_spheres) {
  extern __shared__ float s_tab[];
  for (int k = threadIdx.x; k < n_spheres * kCols; k += kBlock) {
    s_tab[k] = tab[k];
  }
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float px = rays8[i], py = rays8[n_rays + i], pz = rays8[2 * n_rays + i];
  const float dx = rays8[3 * n_rays + i], dy = rays8[4 * n_rays + i],
              dz = rays8[5 * n_rays + i];
  const float p_dot_d = dot3(px, py, pz, dx, dy, dz);
  const float p_dot_p = dot3(px, py, pz, px, py, pz);
  float best_t = kBig;
  int best_s = 0;
  for (int s = 0; s < n_spheres; ++s) {
    const float* c = s_tab + s * kCols;
    const float b_half = p_dot_d - dot3s(dx, dy, dz, c);
    const float cc = (p_dot_p - 2.0f * dot3s(px, py, pz, c)) + c[5];
    const float disc = __fmaf_rn(b_half, b_half, -cc);
    const float sq = sqrtf(disc < 0.f ? 0.f : disc);
    const float t_near = -b_half - sq;
    const float t_far = -b_half + sq;
    const float t = t_near > 0.f ? t_near : t_far;
    if (disc > 0.f && t > 0.f && c[7] > 0.f && t < best_t) {
      best_t = t;
      best_s = s;
    }
  }
  const bool hit = best_t < kBig;
  const float* row = s_tab + best_s * kCols;
  const float safe_t = hit ? best_t : 0.f;
  const float inv_r = __fadd_rn(row[4], 0.0f);
  const float nx = (__fmaf_rn(dx, safe_t, px) - __fadd_rn(row[0], 0.0f)) * inv_r;
  const float ny = (__fmaf_rn(dy, safe_t, py) - __fadd_rn(row[1], 0.0f)) * inv_r;
  const float nz = (__fmaf_rn(dz, safe_t, pz) - __fadd_rn(row[2], 0.0f)) * inv_r;
  out.t[i] = hit ? best_t : -1.0f;
  out.nx[i] = hit ? nx : 0.f;
  out.ny[i] = hit ? ny : 0.f;
  out.nz[i] = hit ? nz : 0.f;
  out.m[i] = hit ? __fadd_rn(row[6], 0.0f) : 0.f;
}

}  // namespace

extern "C" int ptx_sphere_table(const float* rays8, const float* table,
                                const float* groups, float* t_out, float* nx,
                                float* ny, float* nz, float* m, int n_rays,
                                int n_groups, void* stream) {
  return launch<false>(rays8, table, groups, Outs{t_out, nx, ny, nz, m},
                       n_rays, n_groups, nullptr, stream);
}

extern "C" int ptx_sphere_table_count(const float* rays8, const float* table,
                                      const float* groups, float* t_out,
                                      float* nx, float* ny, float* nz,
                                      float* m, int n_rays, int n_groups,
                                      void* counter, void* stream) {
  return launch<true>(rays8, table, groups, Outs{t_out, nx, ny, nz, m},
                      n_rays, n_groups, counter, stream);
}

extern "C" int ptx_sphere_table_simt(const float* rays8, const float* table,
                                     float* t_out, float* nx, float* ny,
                                     float* nz, float* m, int n_rays,
                                     int n_spheres, void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_spheres) * kCols * sizeof(float);
  if (n_spheres < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sphere_table_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  sphere_table_simt_kernel<<<grid, kBlock, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      rays8, table, Outs{t_out, nx, ny, nz, m}, n_rays, n_spheres);
  return static_cast<int>(cudaGetLastError());
}
