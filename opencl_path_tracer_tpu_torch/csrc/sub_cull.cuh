// The sub-block skip rule shared by K12 (pair_vpu.cu), K17 (cluster.cu),
// K7 (anyhit.cu), K6 (tilecull.cu), K16 (group.cu), K14 (minarg_fused.cu)
// and K15 (mxu.cu): a ray skips a sub-block of at most kSub consecutive
// triangle-pack rows when its segment P + s D, 0 <= s <= best, misses the
// sub-block's box widened by I = A + Gp |P|_1, the slab test rounded
// outward. The argument that such a sub-block holds no row that the exact
// test (nearest.cuh) accepts with t <= best is in pair_vpu.cu's header;
// the per-scene table ([lo A] [hi Gp], two float4s a sub-block) is built
// on the host (cluster_kernel.sub_boxes). Also here: a sub-block run for a
// few rays of a warp by all 32 lanes or by each lane for its own ray, the
// count of the edge tests the exact test reaches (for the counting
// entries), all three over the exact test their template parameter Test
// names (ExactHit, nearest.cuh's, by default), and K14's and K15's loop
// over a whole pack in row order.

#pragma once

#include "nearest.cuh"

namespace ptx {

constexpr int kSub = 32;      // rows per sub-block (the table's)
constexpr unsigned kFull = 0xffffffffu;

// A ray as the skip rule reads it: the origin, the reciprocals of D
// rounded down and up, and |P|_1 rounded up (infinite for a ray outside
// the rule's ranges).
struct CullRay {
  float p[3], rlo[3], rhi[3], pn;
};

__device__ __forceinline__ CullRay cull_ray(float px, float py, float pz,
                                            float dx, float dy, float dz) {
  CullRay c;
  const float d[3] = {dx, dy, dz};
  c.p[0] = px;
  c.p[1] = py;
  c.p[2] = pz;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c.rlo[i] = __frcp_rd(d[i]);
    c.rhi[i] = __frcp_ru(d[i]);
  }
  const float ap = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
  const float ad = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz));
  const bool in_range = ap <= 0x1p64f && ad <= 0x1p40f && ad >= 0x1p-64f;
  c.pn = in_range ? __fadd_ru(__fadd_ru(fabsf(px), fabsf(py)), fabsf(pz))
                  : INFINITY;
  return c;
}

// Whether the segment P + s D, 0 <= s <= best, may meet the sub-block's
// box [lo - I, hi + I], I = A + Gp |P|_1 (blo = [lo A], bhi = [hi Gp]);
// false only where it certainly misses (pair_vpu.cu's rule).
__device__ __forceinline__ bool box_maybe(const CullRay& c, float4 blo,
                                          float4 bhi, float best) {
  const float wid = __fadd_ru(blo.w, __fmul_ru(bhi.w, c.pn));   // I
  const float lo[3] = {blo.x, blo.y, blo.z}, hi[3] = {bhi.x, bhi.y, bhi.z};
  float smin = 0.f, smax = best;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a = __fadd_rd(__fadd_rd(lo[i], -wid), -c.p[i]);
    const float b = __fadd_ru(__fadd_ru(hi[i], wid), -c.p[i]);
    // D_i's sign bit: the lower end of s comes from a (clear) or b (set).
    const bool neg = __float_as_int(c.rlo[i]) < 0;
    const float x = neg ? b : a, y = neg ? a : b;
    smin = fmaxf(smin, __fmul_rd(x, x < 0.f ? c.rhi[i] : c.rlo[i]));
    smax = fminf(smax, __fmul_ru(y, y < 0.f ? c.rlo[i] : c.rhi[i]));
  }
  return smin <= smax;
}

// The exact test as the runs below take it (their parameter Test):
// hit(c, P, D, t) says whether row c (its first four float4s [n c0] [m1
// d1] [m2 d2] [m3 d3]) competes for the ray's nearest hit, with t its value
// in the strict < merge; plane and edge are the plane t and one edge test,
// which edges_reached counts. ExactHit is nearest.cuh's exact_hit: a row
// competes where it accepts the ray, with its t.
struct ExactHit {
  static __device__ __forceinline__ bool hit(const float4* c, float px,
                                             float py, float pz, float dx,
                                             float dy, float dz, float& t) {
    return exact_hit(c, px, py, pz, dx, dy, dz, t);
  }
  static __device__ __forceinline__ float plane(float4 nc, float px,
                                                float py, float pz, float dx,
                                                float dy, float dz) {
    return plane_t(nc, px, py, pz, dx, dy, dz);
  }
  static __device__ __forceinline__ bool edge(float4 m, float t, float px,
                                              float py, float pz, float dx,
                                              float dy, float dz) {
    return __fmaf_rn(t, dot3(m, dx, dy, dz), dot3(m, px, py, pz)) >= m.w;
  }
};

// The rows [s0, s1) (at most 32) of `rows` (kStride float4s apart, the
// constants in the first four) for the rays of the warp's ballot `bal`,
// one ray at a time: lane l tests row s0 + l against the ray (taken by
// shuffle), and the ray's lane merges the least (t, index) accepted, as
// the sequential scan would (a strict < against its best; a lower index
// wins a tie within the sub-block, an earlier sub-block across them).
// Row j's index is base + j.
template <int kStride, class Test = ExactHit>
__device__ __forceinline__ void coop_sub_block(
    const float4* rows, int s0, int s1, unsigned bal, float px, float py,
    float pz, float dx, float dy, float dz, int base, Nearest& best) {
  const int lane = threadIdx.x & 31;
  const int j = s0 + lane;
  for (unsigned rest = bal; rest; rest &= rest - 1) {
    const int src = __ffs(rest) - 1;
    const float qx = __shfl_sync(kFull, px, src);
    const float qy = __shfl_sync(kFull, py, src);
    const float qz = __shfl_sync(kFull, pz, src);
    const float ex = __shfl_sync(kFull, dx, src);
    const float ey = __shfl_sync(kFull, dy, src);
    const float ez = __shfl_sync(kFull, dz, src);
    unsigned tb = 0xffffffffu;   // no hit; an accepted t > 0 orders as bits
    float t;
    if (j < s1 && Test::hit(&rows[kStride * j], qx, qy, qz, ex, ey, ez, t))
      tb = __float_as_uint(t);
    const unsigned tm = __reduce_min_sync(kFull, tb);
    const unsigned jm = __reduce_min_sync(
        kFull, tb == tm ? static_cast<unsigned>(j) : 0xffffffffu);
    if (lane == src && tm != 0xffffffffu && __uint_as_float(tm) < best.t) {
      best.t = __uint_as_float(tm);
      best.g = base + static_cast<int>(jm);
    }
  }
}

// The edge tests that Test reaches for a row (t > 0, then each edge until
// one fails), for the counting entries only.
template <class Test = ExactHit>
__device__ __forceinline__ int edges_reached(const float4* c, float px,
                                             float py, float pz, float dx,
                                             float dy, float dz) {
  const float t = Test::plane(c[0], px, py, pz, dx, dy, dz);
  int n = 0;
  bool ok = t > 0.f;
#pragma unroll
  for (int e = 1; e < 4 && ok; ++e) {
    ++n;
    ok = Test::edge(c[e], t, px, py, pz, dx, dy, dz);
  }
  return n;
}

// Counting entries' tallies, added to counter[0..4] once per thread.
struct CullCounts {
  unsigned long long div = 0;    // (ray, row) tests that reached the divide
  unsigned long long box = 0;    // (ray, sub-block) box tests that passed
  unsigned long long coop = 0;   // of those, run by the whole warp
  unsigned long long edge = 0;   // edge tests reached in the rows of div
  unsigned long long made = 0;   // box (and slab) tests made

  __device__ void add_to(unsigned long long* counter) const {
    atomicAdd(&counter[0], div);
    atomicAdd(&counter[1], box);
    atomicAdd(&counter[2], coop);
    atomicAdd(&counter[3], edge);
    atomicAdd(&counter[4], made);
  }
};

// The rows [r0, r0 + n) (kStride float4s apart) against the lane's own
// ray in order, merged into best with a strict < (row j's index is base +
// j); with COUNT, the edge tests reached are added to ct.edge.
template <int kStride, bool COUNT, class Test = ExactHit>
__device__ __forceinline__ void lane_sub_block(
    const float4* r0, int n, int base, float px, float py, float pz,
    float dx, float dy, float dz, Nearest& best, CullCounts& ct) {
  for (int j = 0; j < n; ++j) {
    float t;
    if (Test::hit(r0 + j * kStride, px, py, pz, dx, dy, dz, t) &&
        t < best.t) {
      best.t = t;
      best.g = base + j;
    }
    if (COUNT)
      ct.edge +=
          edges_reached<Test>(r0 + j * kStride, px, py, pz, dx, dy, dz);
  }
}

// For the counting entries: the edge tests that coop_sub_block reaches
// on the rows [r0, r0 + n) for the rays of the ballot bal (lane l's row
// against each ray), added to ct.edge.
template <int kStride, class Test = ExactHit>
__device__ __forceinline__ void coop_edges(const float4* r0, int n,
                                           unsigned bal, float px, float py,
                                           float pz, float dx, float dy,
                                           float dz, CullCounts& ct) {
  const int lane = threadIdx.x & 31;
  for (unsigned rest = bal; rest; rest &= rest - 1) {
    const int src = __ffs(rest) - 1;
    const float q[6] = {__shfl_sync(kFull, px, src),
                        __shfl_sync(kFull, py, src),
                        __shfl_sync(kFull, pz, src),
                        __shfl_sync(kFull, dx, src),
                        __shfl_sync(kFull, dy, src),
                        __shfl_sync(kFull, dz, src)};
    if (lane < n)
      ct.edge += edges_reached<Test>(r0 + lane * kStride, q[0], q[1], q[2],
                                     q[3], q[4], q[5]);
  }
}

// K14's and K15's loop: the nearest row of the whole (n_tris, 24) pack
// `tri` for the lane's ray, merged into best, the pack's sub-blocks of
// kSub rows in row order, each with its two float4s of the table `sub`
// (cluster_kernel.sub_boxes over the one span [0, n_tris)). A live ray
// skips a sub-block whose box its segment to best misses (the rule
// proves no row there competes with a t < best: a row's t is its accepted
// t, and K15's rows that do not accept it compete with BIG, which is not
// below best once best <= BIG), and skips nothing while best > BIG (K15's
// start, +inf, and a row accepted above BIG). A ballot of at most
// coop_max rays runs a sub-block on all 32 lanes (coop_sub_block), a
// larger one each lane for its own ray (lane_sub_block); both merge as the
// scan in row order with a strict < does, so best ends as that scan's
// (t, index) bit for bit. Every lane of the warp calls this (ballots and
// shuffles); a lane whose ray is not live tests nothing. With COUNT, ct
// gets the counts of CullCounts (made: the box tests of the live rays).
template <class Test, bool COUNT>
__device__ __forceinline__ void nearest_in_order(
    const float4* __restrict__ tri, const float4* __restrict__ sub,
    int n_tris, bool live, float px, float py, float pz, float dx, float dy,
    float dz, int coop_max, Nearest& best, CullCounts& ct) {
  constexpr int kRow = kTriCols / 4;   // float4s per pack row
  const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
  const int nsb = (n_tris + kSub - 1) / kSub;
#pragma unroll 1
  for (int s = 0; s < nsb; ++s) {
    const float4* box = sub + 2 * s;
    const bool go =
        live && (best.t > kBig ||
                 box_maybe(cr, __ldg(&box[0]), __ldg(&box[1]), best.t));
    if (COUNT && live) ++ct.made;
    const unsigned bal = __ballot_sync(kFull, go);
    if (!bal) continue;
    const int s0 = s * kSub, n = min(kSub, n_tris - s0);
    const float4* r0 = tri + static_cast<size_t>(s0) * kRow;
    if (COUNT && go) {
      ++ct.box;
      ct.div += n;
    }
    if (__popc(bal) > coop_max) {
      // Many of the warp's rays: each tests the rows in order.
      if (go)
        lane_sub_block<kRow, COUNT, Test>(r0, n, s0, px, py, pz, dx, dy, dz,
                                          best, ct);
    } else {
      if (COUNT) {
        if (go) ++ct.coop;
        coop_edges<kRow, Test>(r0, n, bal, px, py, pz, dx, dy, dz, ct);
      }
      coop_sub_block<kRow, Test>(tri, s0, s0 + n, bal, px, py, pz, dx, dy,
                                 dz, 0, best);
    }
  }
}

}  // namespace ptx
