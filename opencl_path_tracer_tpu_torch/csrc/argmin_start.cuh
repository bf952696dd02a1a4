// The reference's start for K1 (minarg.cu) and K14 (minarg_fused.cu).
//
// The reference (_minarg_kernel, _minarg_fused_kernel, and the port's
// plain versions minarg_plain and minarg_fused_plain) takes per ray the
// least tm over the pack's rows in index order, the lowest index on ties,
// with tm = t where the row accepts the ray and BIG where it does not: a
// start of +inf, every row competing. The kernels' loops merge only the
// accepted rows, with a strict <, into a start of (BIG, 0). The two agree
// wherever row 0's tm is at most BIG. The reference's state after row 0
// is then (tm0, 0) with tm0 <= BIG, so from there on no row that does not
// accept can win (BIG < best fails) and both merge the same accepted rows
// in the same order; and (BIG, 0) merged with row 0 gives (tm0, 0) too
// (an accepted t0 < BIG wins, and a t0 equal to BIG or a row that does not
// accept leaves (BIG, 0)). They differ only where row 0 accepts the ray
// with t above BIG (finite inputs allow it: a degenerate row, or a
// subnormal direction): the reference then takes the first later row that
// does not accept, at (BIG, its index), or an accepted t below t0, where
// the kernels keep (BIG, 0).
//
// So each kernel tests row 0 before its loop with a filter that passes
// wherever RN(num / vn) may exceed BIG (row0_may_exceed_big: a float4 load
// that every lane shares and two dots, no divide) and, for the rare ray
// that passes it, runs the exact test of row 0 (row0_above_big) and,
// where it accepts above BIG, the reference's scan over the whole pack
// (reference_scan, from global memory), whose result replaces the loop's:
// K1 after its loop, in the same kernel (held to 40 registers, as its
// loop takes), K14 in a second kernel of its launch (the scan beside its
// loop cost that loop its uniform registers; minarg_fused.cu). The first
// kernels do the same after nearest.cuh's loop. The part after the loop
// reads the pack through volatile loads (ldg_after), which the compiler
// neither hoists above the loop nor overlaps by unrolling the scan.

#pragma once

#include "nearest.cuh"

namespace ptx {

// A read-only load that stays where it is written: after the caller's
// loop, so that nothing of the rare path lives across it.
__device__ __forceinline__ float4 ldg_after(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Whether the plane t of row 0 of the (n_tris, 24) pack, RN(num / vn),
// may exceed BIG: false only where it cannot. With s = num carrying vn's
// sign bit (num / vn = s / |vn|), RN(num / vn) > BIG implies num / vn >
// BIG exactly (BIG is a float32 and the rounding is monotone), so s > BIG
// |vn| >= RD(BIG |vn|); for vn = +-0 the quotient exceeds BIG only as
// +inf, where s > 0 = RD(BIG |vn|) too, and a NaN quotient never exceeds
// BIG.
__device__ __forceinline__ bool row0_may_exceed_big(
    const float4* __restrict__ tri, float px, float py, float pz, float dx,
    float dy, float dz) {
  const float4 nc = __ldg(tri);
  const float vn = dot3(nc, dx, dy, dz);
  const float num = nc.w - dot3(nc, px, py, pz);
  const float s = __int_as_float(__float_as_int(num) ^
                                 (__float_as_int(vn) & 0x80000000));
  return s > __fmul_rd(kBig, fabsf(vn));
}

// Whether row 0 accepts the ray with t > BIG (nearest.cuh's exact test),
// for a ray that passed row0_may_exceed_big; after the caller's loop.
__device__ __forceinline__ bool row0_above_big(const float4* __restrict__ tri,
                                               float px, float py, float pz,
                                               float dx, float dy,
                                               float dz) {
  const float4 c[4] = {ldg_after(tri), ldg_after(tri + 1),
                       ldg_after(tri + 2), ldg_after(tri + 3)};
  float t;
  return exact_hit(c, px, py, pz, dx, dy, dz, t) && t > kBig;
}

// The reference's argmin over the whole pack for a ray whose row 0
// accepted it above BIG: from (t0, 0), each later row competes with tm (t
// where it accepts, BIG elsewhere) under a strict <.
__device__ __forceinline__ Nearest reference_scan(
    const float4* __restrict__ tri, int n_tris, float px, float py, float pz,
    float dx, float dy, float dz) {
  const float4 c0[4] = {ldg_after(tri), ldg_after(tri + 1),
                        ldg_after(tri + 2), ldg_after(tri + 3)};
  float t0;
  exact_hit(c0, px, py, pz, dx, dy, dz, t0);
  Nearest best{t0, 0};
#pragma unroll 1
  for (int g = 1; g < n_tris; ++g) {
    const float4* r = tri + static_cast<size_t>(g) * (kTriCols / 4);
    const float4 c[4] = {ldg_after(r), ldg_after(r + 1), ldg_after(r + 2),
                         ldg_after(r + 3)};
    float t;
    const float tm = exact_hit(c, px, py, pz, dx, dy, dz, t) ? t : kBig;
    if (tm < best.t) {
      best.t = tm;
      best.g = g;
    }
  }
  return best;
}

}  // namespace ptx
