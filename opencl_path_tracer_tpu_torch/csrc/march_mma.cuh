// The cluster visit of K18 (march.cu), K19 (flat.cu), K20 (lazy.cu) and
// K10 (pair_visit.cu) with the edge values on the tensor cores: the visit
// of march_visit.cuh, the same bits, another schedule (mma_prologue sets
// up a CUDA block of 128 lanes once, mma_visit merges one cluster into
// each lane's best).
//
// A visit (lane, cluster cid of cs triangles) needs, per (lane, triangle),
// the three bf16 Plucker edge values E_k = sum_q w_kq f_q (18 exact bf16
// products; columns 18-31 of the packs are zero). The TPU ran those
// products on its matrix unit; on the float32 cores they were most of the
// 125 instructions per test of the first K18. Here each warp owns 32
// lanes (two m16 tiles) and runs, per tile of 8 triangles and edge, one
// mma.sync.m16n8k16 (features 0-15) and one m16n8k8 (features 16-23, of
// which 16 and 17 are used) in bf16 with float32 sums. A thread's C
// fragments hold E_0, E_1, E_2 at eight (lane, triangle) positions: lanes
// g and g + 8 of each m tile, triangles 2 tig and 2 tig + 1 of the n tile
// (g = lane id / 4, tig = lane id % 4).
//
// The bits. K18 must decide E_k >= -ep_k (vn > 0) or E_k <= ep_k exactly
// as the float32 chain of march_visit.cuh does (two accumulators, even and
// odd terms), and NVIDIA does not specify how a tensor core rounds its
// sums. So the tensor cores only filter, behind a certified margin:
//   delta_k = 2^-14 S_k + d0,  S_k = sum_q |w_kq| F_q,
// F_q the largest |f_q| over the CUDA block's 128 lanes (taken once per
// launch), S_k summed as the tile is staged, everything rounded up. S_k
// bounds sum_q |w_kq f_q| for every lane of the block; per feature column
// it is far tighter than sum_q |w_kq| max_q F_q, since the large weights
// (c0 m - d n) pair with the small features (D). The chain is off the
// exact sum by at most about 9 2^-24 S_k (two chains of 9 exact products,
// 8 roundings each, and their add); published measurements of NVIDIA
// tensor cores (Fasi, Higham, Mikaitis, Pranesh, "Numerical behavior of
// NVIDIA tensor cores", PeerJ CS 2021) show exact products and aligned,
// truncated sums, under 2^-19 S_k per k step. d0 = 2^-110 + 2^-126
// sum_q F_q covers products, sums and subnormal weights that a tensor
// core may flush to zero. So |E_mma - E_chain| is under delta_k with more
// than tenfold to spare, and with s = +1 (vn > 0) or -1 and
// u = s E_mma + ep_k (one rounding, inside the spare):
//   u > delta_k      the chain's test passes;
//   u < -delta_k     it fails;
//   otherwise, or E_mma not finite, the edge is recomputed with the
//   chain itself (march_visit.cuh's order, from the staged weights and the
//   block's features, kept in shared memory as float32) and compared as
//   there.
// A weight that is not finite makes S_k infinite or NaN, and a feature
// that is subnormal or not finite makes F_q infinite: no test they touch
// is decided by the tensor cores. ep_k, vn, s, the exact
// t = (c0 - n.P) / vn, the t > 0 test and the candidates' exact test
// (nearest.cuh through exact_row) are computed as march_visit.cuh computes
// them (the sources build with --fmad=false).
//
// The schedule. Per n tile a thread first asks, without a branch, which
// of its eight positions no edge test certainly fails (mma_maybe: about
// 20 instructions a test); few positions pass that filter (the lines
// that cross the triangle, and the rare ones in the margin), so the exact
// pass over them (mma_edges, the t division, the top-two update) runs for
// a small share of a warp's n tiles. A thread keeps, per lane, the top two of its own positions,
// visited in ascending triangle index with the strict < of the sequential
// scan; at the end of a visit the four threads of a quad merge their lists
// in (t, index) lexicographic order, which gives the scan's pair (its m1
// and m2 are the two least (t, index) pairs). Each thread of the quad then
// owns one of the quad's four lanes: it runs K1's exact test on that
// lane's two candidates and keeps the lane's running best, as
// march_visit.cuh does. The tests stay in the fragment layout because
// shared-memory loads bound the alternative: trading the fragments through
// shared memory to test one lane per thread costs three 16-byte
// broadcasts of triangle constants per test; here a thread loads the
// constants of its two triangles once per n tile and uses them for its
// four lanes.
//
// Staging: 64 triangles at a time, their weight rows as 12 words (bf16
// columns 0-17, then zeros; conflict-free fragment loads) and their
// constants [n delta_0] [epsA delta_1] [epsB delta_2] [c0] in rows of five
// float4s (conflict-free for the four triangle pairs of a warp), in shared
// memory, with the block's lanes (origin, direction, features).

#pragma once

#include <stdint.h>

#include "march_visit.cuh"

namespace ptx {

constexpr int kMmaTile = 64;   // triangles per staged tile
constexpr int kWRow = 12;      // 32-bit words per staged weight row
constexpr int kKRow = 5;       // float4s per staged constant row (4 used)

struct MmaShared {
  uint32_t w[kMmaTile][3][kWRow];
  float4 k[kMmaTile][kKRow];   // [n delta_0] [epsA delta_1] [epsB delta_2] [c0]
  float f[kMarchW][kMarchLanes];   // the block's features
  float ray[6][kMarchLanes];   // the block's lanes: P, D
  float fq[kMarchW];           // the block's F_q
};

// D += A B: m16n8k16 and m16n8k8, bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// True when the bf16 bits h are subnormal (not zero) or not finite: the
// margin does not cover a tensor core that flushes them.
__device__ __forceinline__ bool bf16_outside(uint32_t h) {
  const uint32_t ex = (h >> 7) & 0xffu;
  return ex == 0xffu || (ex == 0u && (h & 0x7fu) != 0u);
}

// The chain of march_visit.cuh for one edge: weight words w (bf16 pairs)
// against the features fl[q * kMarchLanes] of a lane. Rarely called, so
// kept out of line.
__device__ __noinline__ float chain_edge(const uint32_t* w, const float* fl) {
  float f[kMarchW], x[kMarchW];
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) {
    f[q] = fl[q * kMarchLanes];
    const uint32_t word = w[q >> 1];
    x[q] = bf16_bits_to_float(
        static_cast<uint16_t>((q & 1) ? word >> 16 : word & 0xffffu));
  }
  float ae = __fmul_rn(x[0], f[0]);
  float ao = __fmul_rn(x[1], f[1]);
#pragma unroll
  for (int q = 2; q < kMarchW; q += 2) {
    ae = __fmaf_rn(x[q], f[q], ae);
    ao = __fmaf_rn(x[q + 1], f[q + 1], ao);
  }
  return __fadd_rn(ae, ao);
}

// A lane as the filter reads it: direction and m = max |P x D| (the
// origin and features are in shared memory).
struct MmaLane {
  float dx, dy, dz, ml;
};

// Whether no edge test of lane L against a staged triangle (constants c)
// certainly fails, from the tensor cores' E: the tests that need more
// than the margin (those that pass, and the rare ones in the band).
__device__ __forceinline__ bool mma_maybe(float E0, float E1, float E2,
                                          const float4 (&c)[3],
                                          const MmaLane& L) {
  const float4 n = c[0], ea = c[1], eb = c[2];
  const float vn = dot3(n, L.dx, L.dy, L.dz);
  const float sg = vn > 0.f ? 1.f : -1.f;
  const float E[3] = {E0, E1, E2};
  const float epsA[3] = {ea.x, ea.y, ea.z}, epsB[3] = {eb.x, eb.y, eb.z};
  const float del[3] = {n.w, ea.w, eb.w};
  bool fail = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float u = __fmaf_rn(sg, E[e], __fmaf_rn(epsA[e], L.ml, epsB[e]));
    fail |= fabsf(E[e]) <= 3.402823466e38f && u < -del[e];
  }
  return !fail;
}

// The edge tests of lane L against a staged triangle (constants c, weight
// rows w), decided as the chain decides them: from the tensor cores' E
// outside the margin, by the chain inside it (or for a non-finite E).
template <bool COUNT>
__device__ __forceinline__ bool mma_edges(const float (&E)[3],
                                          const float4 (&c)[3], float vn,
                                          const MmaLane& L,
                                          const uint32_t (*w)[kWRow],
                                          const float* fl,
                                          unsigned long long& cnt) {
  const bool pos = vn > 0.f;
  const float sg = pos ? 1.f : -1.f;
  const float4 n = c[0], ea = c[1], eb = c[2];
  const float epsA[3] = {ea.x, ea.y, ea.z}, epsB[3] = {eb.x, eb.y, eb.z};
  const float del[3] = {n.w, ea.w, eb.w};
  bool valid = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ep = __fmaf_rn(epsA[e], L.ml, epsB[e]);
    const float u = __fmaf_rn(sg, E[e], ep);
    const bool fin = fabsf(E[e]) <= 3.402823466e38f;
    if (!valid || (fin && u > del[e])) continue;
    if (fin && u < -del[e]) {
      valid = false;
      continue;
    }
    if (COUNT) ++cnt;
    const float ek = chain_edge(w[e], fl);
    valid = pos ? ek >= -ep : ek <= ep;
  }
  return valid;
}

// The two least (t, index) candidates of a lane over a thread's positions.
struct Top2 {
  float m1, m2;
  int a1, a2;
};

__device__ __forceinline__ bool lex_less(float t, int a, float s, int b) {
  return t < s || (t == s && a < b);
}

// Merge x with the list of the thread `mask` lanes away in the quad, in
// (t, index) lexicographic order.
__device__ __forceinline__ void merge_top2(Top2& x, int mask) {
  const float o1 = __shfl_xor_sync(0xffffffffu, x.m1, mask);
  const float o2 = __shfl_xor_sync(0xffffffffu, x.m2, mask);
  const int b1 = __shfl_xor_sync(0xffffffffu, x.a1, mask);
  const int b2 = __shfl_xor_sync(0xffffffffu, x.a2, mask);
  if (lex_less(o1, b1, x.m1, x.a1)) {
    if (lex_less(x.m1, x.a1, o2, b2)) {
      x.m2 = x.m1;
      x.a2 = x.a1;
    } else {
      x.m2 = o2;
      x.a2 = b2;
    }
    x.m1 = o1;
    x.a1 = b1;
  } else if (lex_less(o1, b1, x.m2, x.a2)) {
    x.m2 = o1;
    x.a2 = b1;
  }
}

// Stage triangles [base, base + 64) of cluster cid: weight rows and
// constants, delta_k = 2^-14 S_k + d0 from the block's F_q (d0 covers
// flushed subnormal weights, see the kernel). Every thread calls it.
__device__ __forceinline__ void mma_stage(MmaShared& sh,
                                          const uint16_t* __restrict__ trig,
                                          const float* __restrict__ tric,
                                          int cbase, int cs, int base,
                                          float d0) {
  for (int r = threadIdx.x; r < 3 * kMmaTile; r += kMarchLanes) {
    const int e = r / kMmaTile, j = r % kMmaTile;
    const size_t row = 3 * static_cast<size_t>(cbase) + e * cs + base + j;
    const uint4* src = reinterpret_cast<const uint4*>(trig + row * 32);
    uint4 q[3] = {src[0], src[1], src[2]};
    q[2].y = q[2].z = q[2].w = 0u;   // columns 18-23
    const uint32_t wd[9] = {q[0].x, q[0].y, q[0].z, q[0].w, q[1].x,
                            q[1].y, q[1].z, q[1].w, q[2].x};
    // S_k = sum_q |w_kq| F_q rounded up; a weight that is not finite
    // makes it infinite or NaN, so no test of the row is certified.
    float sk = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      sk = __fmaf_ru(fabsf(__uint_as_float(wd[k] << 16)), sh.fq[2 * k], sk);
      sk = __fmaf_ru(fabsf(__uint_as_float(wd[k] & 0xffff0000u)),
                     sh.fq[2 * k + 1], sk);
    }
    uint4* dst = reinterpret_cast<uint4*>(sh.w[j][e]);
    dst[0] = q[0];
    dst[1] = q[1];
    dst[2] = q[2];
    sh.k[j][e].w = __fmaf_ru(sk, 0x1p-14f, d0);
  }
  for (int j = threadIdx.x; j < kMmaTile; j += kMarchLanes) {
    const float4* r = reinterpret_cast<const float4*>(
        tric + static_cast<size_t>(cbase + base + j) * kTriCols);
    const float4 a = r[0], b = r[4], c = r[5];   // cols 0-3, 16-19, 20-23
    // n (cols 0-2), epsA (17-19), epsB (20-22), c0 (3); the delta_k of
    // the rows above fill the fourth components of the first three.
    float* k = reinterpret_cast<float*>(sh.k[j]);
    k[0] = a.x;
    k[1] = a.y;
    k[2] = a.z;
    k[4] = b.y;
    k[5] = b.z;
    k[6] = b.w;
    k[8] = c.x;
    k[9] = c.y;
    k[10] = c.z;
    k[12] = a.w;
  }
}

// What a CUDA block of 128 lanes sets up once for its visits
// (mma_prologue): the four lanes of this thread's fragments, [m tile][g
// or g + 8]; the warp's A fragments, features 0-15 (k16) and 16-17 (k8,
// on tig 0; zero elsewhere); the margin's absolute term d0; and ol, the
// lane this thread owns at the end of each visit (its exact tests, its
// running best and its output: the quad's four lanes, one each).
struct MmaBlock {
  MmaLane L[2][2];
  uint32_t A[2][4], A8[2][2];
  float d0;
  int ol;
};

// The features of K18, K19 and K20: lane i's bf16 bits from the (32, n)
// array `feat`.
struct PackedFeatures {
  const uint16_t* __restrict__ feat;
  size_t nn;
  __device__ __forceinline__ void operator()(size_t i, const float (&)[6],
                                             uint32_t (&h)[kMarchW]) const {
#pragma unroll
    for (int q = 0; q < kMarchW; ++q) h[q] = feat[q * nn + i];
  }
};

// Features q and q + 1 of block lane li as one bf16 pair (low half q).
__device__ __forceinline__ uint32_t sh_feat_pair(const MmaShared& sh, int q,
                                                 int li) {
  return (__float_as_uint(sh.f[q][li]) >> 16) |
         (__float_as_uint(sh.f[q + 1][li]) & 0xffff0000u);
}

// Set up the block of lanes [b0, b0 + 128) of the (8, n) rays. Each
// thread takes its own lane: its origin and direction, and its bf16
// features from features(i, ray, h) (PackedFeatures reads them from an
// array; K10 computes them from the ray), which it stores beside the lane
// in shared memory (as float32, exactly), with the block's F_q (the
// largest |feature q| of its lanes, infinite for a column where a feature
// is subnormal or not finite) and d0 from them. Then each thread reads
// the four lanes of its fragments back from there. Every thread calls it
// (it synchronises).
template <typename Features>
__device__ __forceinline__ void mma_prologue(MmaShared& sh,
                                             const float* __restrict__ rays8,
                                             size_t nn, size_t b0,
                                             MmaBlock& m,
                                             const Features& features) {
  const int lid = threadIdx.x & 31, g = lid >> 2, tig = lid & 3;
  const int wl = threadIdx.x & ~31;   // the warp's first lane in the block
  unsigned int* fq = reinterpret_cast<unsigned int*>(sh.fq);
  if (threadIdx.x < kMarchW) fq[threadIdx.x] = 0u;
  float r[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    r[k] = rays8[k * nn + b0 + threadIdx.x];
    sh.ray[k][threadIdx.x] = r[k];
  }
  uint32_t h[kMarchW];
  features(b0 + threadIdx.x, r, h);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) {
    const float f = bf16_bits_to_float(static_cast<uint16_t>(h[q]));
    sh.f[q][threadIdx.x] = f;
    atomicMax(&fq[q], bf16_outside(h[q]) ? 0x7f800000u
                                         : __float_as_uint(fabsf(f)));
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int li = wl + 16 * mt + 8 * hh + g;
      MmaLane& l = m.L[mt][hh];
      const float px = sh.ray[0][li], py = sh.ray[1][li], pz = sh.ray[2][li];
      l.dx = sh.ray[3][li];
      l.dy = sh.ray[4][li];
      l.dz = sh.ray[5][li];
      l.ml = fmaxf(fmaxf(fabsf(__fmaf_rn(py, l.dz, -__fmul_rn(pz, l.dy))),
                         fabsf(__fmaf_rn(pz, l.dx, -__fmul_rn(px, l.dz)))),
                   fabsf(__fmaf_rn(px, l.dy, -__fmul_rn(py, l.dx))));
      m.A[mt][hh] = sh_feat_pair(sh, 2 * tig, li);
      m.A[mt][2 + hh] = sh_feat_pair(sh, 2 * tig + 8, li);
      m.A8[mt][hh] = tig == 0 ? sh_feat_pair(sh, 16, li) : 0u;
    }
  }
  // d0 = 2^-110 + 2^-126 sum_q F_q, rounded up (the margin's absolute
  // term, with the subnormal weights a tensor core may flush).
  float d0 = 0.f;
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) d0 = __fadd_ru(d0, sh.fq[q]);
  m.d0 = __fmaf_ru(d0, 0x1p-126f, 0x1p-110f);
  m.ol = wl + 16 * (tig >> 1) + 8 * (tig & 1) + g;
}

// mma_prologue with the features of the (32, n) bf16 array feat.
__device__ __forceinline__ void mma_prologue(MmaShared& sh,
                                             const float* __restrict__ rays8,
                                             const uint16_t* __restrict__ feat,
                                             size_t nn, size_t b0,
                                             MmaBlock& m) {
  mma_prologue(sh, rays8, nn, b0, m, PackedFeatures{feat, nn});
}

// Visit cluster cid (>= 0) of cs triangles with the block set up by
// mma_prologue and merge its hit into b, the running best of the owned
// lane m.ol, as march_visit.cuh does. Every thread of the block calls it
// with the same cid (it synchronises). Returns whether the visit left the
// owned lane pending. With COUNT, cnt gains the edge tests the margin
// sent to the float32 chain.
template <bool COUNT>
__device__ __forceinline__ bool mma_visit(MmaShared& sh,
                                          const uint16_t* __restrict__ trig,
                                          const float* __restrict__ tric,
                                          int cid, int cs, const MmaBlock& m,
                                          MarchBest& b,
                                          unsigned long long& cnt) {
  const int lid = threadIdx.x & 31, g = lid >> 2, tig = lid & 3;
  const int wl = threadIdx.x & ~31;
  const int omt = tig >> 1, oh = tig & 1;
  const int cbase = cid * cs;
  Top2 tp[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) tp[mt][h] = Top2{kBig, kBig, 0, 0};
  for (int base = 0; base < cs; base += kMmaTile) {
    __syncthreads();
    mma_stage(sh, trig, tric, cbase, cs, base, m.d0);
    __syncthreads();
    for (int nt = 0; nt < kMmaTile / 8; ++nt) {
      const int jr = 8 * nt + g;   // this thread's B column (triangle)
      uint32_t bw[3][3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        bw[e][0] = sh.w[jr][e][tig];
        bw[e][1] = sh.w[jr][e][4 + tig];
        bw[e][2] = sh.w[jr][e][8 + tig];
      }
      // This thread's two triangles (C columns 2 tig and 2 tig + 1).
      const int j0 = 8 * nt + 2 * tig;
      float4 kc[2][3];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int q = 0; q < 3; ++q) kc[cc][q] = sh.k[j0 + cc][q];
      float C[2][3][4];
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          C[mt][e][0] = C[mt][e][1] = C[mt][e][2] = C[mt][e][3] = 0.f;
          mma_k16(C[mt][e], m.A[mt], bw[e][0], bw[e][1]);
          mma_k8(C[mt][e], m.A8[mt][0], m.A8[mt][1], bw[e][2]);
        }
      // The positions (lane, triangle) that no edge test certainly
      // fails; then those, decided exactly, in triangle order per lane.
      unsigned int maybe = 0u;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 2 * h + cc;
            if (mma_maybe(C[mt][0][r], C[mt][1][r], C[mt][2][r], kc[cc],
                          m.L[mt][h]))
              maybe |= 1u << (4 * mt + r);
          }
      if (!maybe) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int r = 2 * h + cc, j = j0 + cc;
            if (!(maybe >> (4 * mt + r) & 1u)) continue;
            const MmaLane& l = m.L[mt][h];
            const int li = wl + 16 * mt + 8 * h + g;   // the lane's index
            const float vn = dot3(kc[cc][0], l.dx, l.dy, l.dz);
            const float E[3] = {C[mt][0][r], C[mt][1][r], C[mt][2][r]};
            if (!mma_edges<COUNT>(E, kc[cc], vn, l, sh.w[j], &sh.f[0][li],
                                  cnt))
              continue;
            const float t = (sh.k[j][3].x -
                             dot3(kc[cc][0], sh.ray[0][li], sh.ray[1][li],
                                  sh.ray[2][li])) /
                            vn;
            if (!(t > 0.f)) continue;
            Top2& x = tp[mt][h];
            const int lj = base + j;
            if (t < x.m1) {
              x.m2 = x.m1;
              x.a2 = x.a1;
              x.m1 = t;
              x.a1 = lj;
            } else if (t < x.m2) {
              x.m2 = t;
              x.a2 = lj;
            }
          }
    }
  }
  // The quad's lists merged; the owned lane's two candidates.
  Top2 o = tp[0][0];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      merge_top2(tp[mt][h], 1);
      merge_top2(tp[mt][h], 2);
      if (mt == omt && h == oh) o = tp[mt][h];
    }
  MarchLane Lo;
  Lo.px = sh.ray[0][m.ol];
  Lo.py = sh.ray[1][m.ol];
  Lo.pz = sh.ray[2][m.ol];
  Lo.dx = sh.ray[3][m.ol];
  Lo.dy = sh.ray[4][m.ol];
  Lo.dz = sh.ray[5][m.ol];
  const bool v1 = o.m1 < kBig && exact_row(tric, cbase + o.a1, Lo);
  const bool v2 = o.m2 < kBig && exact_row(tric, cbase + o.a2, Lo);
  if (v1 || v2) {
    const bool use2 = !v1;
    const float ct = use2 ? o.m2 : o.m1;
    const float cg = static_cast<float>(cbase + (use2 ? o.a2 : o.a1));
    if (ct < b.t || (ct == b.t && cg < b.g)) {
      b.t = ct;
      b.g = cg;
      b.got = true;
    }
  }
  return !v1 && !v2 && o.m2 < kBig;
}

}  // namespace ptx
