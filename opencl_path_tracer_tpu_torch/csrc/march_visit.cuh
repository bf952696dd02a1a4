// The cluster visit shared by K18 (march.cu), K19 (flat.cu) and K20
// (lazy.cu): one lane per thread, a CUDA block of kMarchLanes lanes lying
// in one block of tr sorted lanes, so every thread of it walks the same
// visit list and the visits' shared-memory staging is uniform.
//
// Per visit (lane, cluster cid of cs triangles), the body of the TPU's
// _march_kernel, _flat_kernel and _lazy_kernel, which is K10's
// (pair_visit.cu, kept apart so K10 stays as measured): the conservative
// bf16 Plucker edge tests E_k (the 18 exact products of the packed bf16
// weights and the lane's bf16 features summed in two float32
// accumulators, even and odd terms, then added: XLA's CPU dot order)
// against the per-lane eps fma(epsA_k, m, epsB_k), m = max |P x D| with
// each component fma(a, b, -(c d)); the exact t = (c0 - dot(P, n)) /
// dot(D, n) with t > 0; the two least (t, index) candidates; K1's exact
// test on each (nearest.cuh; the TPU fetches the rows through a one-hot
// matmul over the exact bf16 3-split, here the float32 row of tric +
// 0.0f). The first candidate that passes is the visit's hit; when both
// fail and a second existed the visit is pending. Hits merge by (t, g)
// lexicographic minimum, g = cid * cs + index as float32 (exact below
// 2^24), so the order of visits does not matter.
//
// A thread stages a quarter of the cluster's weights (as float32) and
// constants, 64 triangles at a time, in shared memory; the candidates'
// exact rows come from global memory (L2).

#pragma once

#include <stdint.h>

#include "nearest.cuh"

namespace ptx {

constexpr int kMarchLanes = 128;   // lanes per CUDA block (tr % 128 == 0)
constexpr int kMarchTile = 64;     // triangles per shared-memory tile
constexpr int kMarchW = 18;        // used trig and feature columns (of 32)

struct MarchShared {
  float tw[kMarchTile][3][kMarchW];
  float tk[kMarchTile][10];   // n, c0, epsA(3), epsB(3)
};

struct MarchLane {
  float px, py, pz, dx, dy, dz, ml;
  float f[kMarchW];
};

// The running best of a lane: t, g (float32), pend (0 or 1), and whether
// a visit replaced the start row (then nx, ny, nz and mati come from
// tric's row g).
struct MarchBest {
  float t, g, pend;
  bool got;
};

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Lane i of the (8, n) rays and (32, n) bf16 features.
__device__ __forceinline__ MarchLane load_lane(const float* __restrict__ rays8,
                                               const uint16_t* __restrict__ feat,
                                               size_t n, size_t i) {
  MarchLane L;
  L.px = rays8[i];
  L.py = rays8[n + i];
  L.pz = rays8[2 * n + i];
  L.dx = rays8[3 * n + i];
  L.dy = rays8[4 * n + i];
  L.dz = rays8[5 * n + i];
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) L.f[q] = bf16_bits_to_float(feat[q * n + i]);
  L.ml = fmaxf(fmaxf(fabsf(__fmaf_rn(L.py, L.dz, -__fmul_rn(L.pz, L.dy))),
                     fabsf(__fmaf_rn(L.pz, L.dx, -__fmul_rn(L.px, L.dz)))),
               fabsf(__fmaf_rn(L.px, L.dy, -__fmul_rn(L.py, L.dx))));
  return L;
}

__device__ __forceinline__ bool exact_row(const float* __restrict__ tric,
                                          int g, const MarchLane& L) {
  const float* r = tric + static_cast<size_t>(g) * kTriCols;
  float4 cc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    cc[e] = make_float4(__fadd_rn(r[4 * e], 0.0f), __fadd_rn(r[4 * e + 1], 0.0f),
                        __fadd_rn(r[4 * e + 2], 0.0f),
                        __fadd_rn(r[4 * e + 3], 0.0f));
  float t;
  return exact_hit(cc, L.px, L.py, L.pz, L.dx, L.dy, L.dz, t);
}

// Visit cluster cid (>= 0) and merge its hit into b. Every thread of the
// block calls it with the same cid (it synchronises). Returns whether the
// visit left the lane pending.
__device__ __forceinline__ bool march_visit(MarchShared& sh,
                                            const uint16_t* __restrict__ trig,
                                            const float* __restrict__ tric,
                                            int cid, int cs,
                                            const MarchLane& L, MarchBest& b) {
  const int cbase = cid * cs;
  float m1 = kBig, m2 = kBig;
  int a1 = 0, a2 = 0;
  for (int base = 0; base < cs; base += kMarchTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kMarchTile * 3 * kMarchW; k += kMarchLanes) {
      const int j = k / (3 * kMarchW), e = (k / kMarchW) % 3, q = k % kMarchW;
      const size_t row = 3 * static_cast<size_t>(cbase) + e * cs + base + j;
      sh.tw[j][e][q] = bf16_bits_to_float(trig[row * 32 + q]);
    }
    for (int k = threadIdx.x; k < kMarchTile * 10; k += kMarchLanes) {
      const int j = k / 10, q = k % 10;
      sh.tk[j][q] = tric[static_cast<size_t>(cbase + base + j) * kTriCols +
                         (q < 4 ? q : 13 + q)];
    }
    __syncthreads();
    for (int j = 0; j < kMarchTile; ++j) {
      const float4 nc4 =
          make_float4(sh.tk[j][0], sh.tk[j][1], sh.tk[j][2], sh.tk[j][3]);
      const float vn = dot3(nc4, L.dx, L.dy, L.dz);
      const bool pos = vn > 0.f;
      bool valid = true;
#pragma unroll
      for (int e = 0; e < 3 && valid; ++e) {
        const float* w = sh.tw[j][e];
        float ae = w[0] * L.f[0];
        float ao = w[1] * L.f[1];
#pragma unroll
        for (int q = 2; q < kMarchW; q += 2) {
          ae = __fmaf_rn(w[q], L.f[q], ae);
          ao = __fmaf_rn(w[q + 1], L.f[q + 1], ao);
        }
        const float ek = ae + ao;
        const float ep = __fmaf_rn(sh.tk[j][4 + e], L.ml, sh.tk[j][7 + e]);
        valid = pos ? ek >= -ep : ek <= ep;
      }
      float tm = kBig;
      if (valid) {
        const float t = (nc4.w - dot3(nc4, L.px, L.py, L.pz)) / vn;
        if (t > 0.f) tm = t;
      }
      const int lj = base + j;
      if (tm < m1) {
        m2 = m1;
        a2 = a1;
        m1 = tm;
        a1 = lj;
      } else if (tm < m2) {
        m2 = tm;
        a2 = lj;
      }
    }
  }
  const bool v1 = m1 < kBig && exact_row(tric, cbase + a1, L);
  const bool v2 = m2 < kBig && exact_row(tric, cbase + a2, L);
  if (v1 || v2) {
    const bool use2 = !v1;
    const float ct = use2 ? m2 : m1;
    const float cg = static_cast<float>(cbase + (use2 ? a2 : a1));
    if (ct < b.t || (ct == b.t && cg < b.g)) {
      b.t = ct;
      b.g = cg;
      b.got = true;
    }
  }
  return !v1 && !v2 && m2 < kBig;
}

// Write lane i's seven rows [t nx ny nz mati g pend] to out (7, n): the
// attributes of tric's row g (+ 0.0f: the one-hot fetch's sign of zero)
// when a visit replaced the start, else nx0..m0.
__device__ __forceinline__ void store_rows(float* __restrict__ out, size_t n,
                                           size_t i, const MarchBest& b,
                                           const float* __restrict__ tric,
                                           float nx0, float ny0, float nz0,
                                           float m0) {
  if (b.got) {
    const float* r = tric + static_cast<size_t>(b.g) * kTriCols;
    nx0 = __fadd_rn(r[0], 0.0f);
    ny0 = __fadd_rn(r[1], 0.0f);
    nz0 = __fadd_rn(r[2], 0.0f);
    m0 = __fadd_rn(r[16], 0.0f);
  }
  out[i] = b.t;
  out[n + i] = nx0;
  out[2 * n + i] = ny0;
  out[3 * n + i] = nz0;
  out[4 * n + i] = m0;
  out[5 * n + i] = b.g;
  out[6 * n + i] = b.pend;
}

}  // namespace ptx
