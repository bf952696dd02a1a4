// K10: the pairs round of the pair intersector (thin and full forms).
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// pair_mxu.py::_pair_visit_core (built by _mk_pair_visit_kernel,
// launched by _run_pair_visits).
//
// What it computes. The pairs (ray, cluster key) come sorted by key, in
// tiles of trp; every pair of a tile is tested against every cluster
// whose run of keys touches the tile (the TPU's visit list: run starts
// and tile starts), and the dummy key c is never visited. Per visit,
// over the cluster's cs triangles: the conservative bf16 Plucker edge
// tests E_k (the 18 exact products of the packed bf16 weights and the
// ray's bf16 features summed in two float32 accumulators, even and odd
// terms, then added: XLA's CPU dot order, as K13a) against the per-lane
// eps fma(epsA_k, m, epsB_k), m = max |P x D| with each component
// fma(a, b, -(c d)); the exact t = (c0 - dot(P, n)) / dot(D, n) with
// t > 0; the two least (t, index) candidates; K1's exact test on each
// (nearest.cuh; the TPU fetches the rows through a one-hot matmul over
// the exact bf16 3-split, here the float32 row of tric + 0.0f). The first
// candidate that passes is the visit's hit; when both fail and a second
// existed the pair is pending. Visits merge by (t, g) lexicographic
// minimum over hits, g = cluster * cs + index, pend by maximum, so
// their order does not matter. Output per pair: t (BIG on a miss) and
// g * 2 + pend as float32 (g = 0 without a hit).
//
// What bounds it on the H100: operations. Per (pair, triangle) test 3 x
// 18 multiply-adds for E (the TPU ran them on its matrix unit; the bound
// charges them at the bf16 tensor-core rate) and about 26 float32
// operations more. The first kernel (pair_simt_kernel below) ran
// everything on the float32 cores, one pair per thread, with an early-exit
// edge loop: about 232 G tests/s, as the first K18. This one runs the
// tensor-core visit of K18, K19 and K20 (march_mma.cuh's mma_visit: the E
// values by bf16 mma.sync behind the certified margin, the float32 chain
// only inside it, the quad merge of the top two and the owned lane's exact
// tests), so its outputs are the first kernel's bit for bit. What stays
// K10's: a CUDA block of 128 pairs lies in one tile of trp pairs and
// visits every cluster whose run of keys touches the whole tile (the
// TPU's visit list, on which pend depends), listed in shared memory from
// the sorted keys; the dummy key c is never visited (a block whose tile
// starts with it, dummy pairs only, writes misses at once). The
// features of (P x D, D) are computed from the rays in the kernel
// (RayFeatures, given to mma_prologue, which K18, K19 and K20 give their
// (32, n) array instead), each thread for its own lane, through shared
// memory into the A fragments: no feature pass and no (32, n) array on
// the path. The outputs are written at the lane each thread owns after
// the quad merge (MmaBlock::ol).
//
// The full form (thin=False on the TPU, the 'pairmx' payload) runs the
// same visits and quad merge and writes five streams instead of two: t,
// the winner's nx, ny, nz (columns 0, 1 and 2 of its tric row + 0.0f, the
// bits of the TPU's exact 3-split one-hot sum) and m * 2 + pend (m its
// column 16, + 0.0f). A lane with no hit writes zeros and m = 0, as the
// TPU's accumulator starts, so a miss writes pend alone.
//
// infeat: the TPU kernel can compute the features itself (_infeat_rows).
// Interpret mode contracts its cross products there into fma(a, b,
// -(c d)), where plucker_feat rounds each product and the difference
// separately (probed on the CPU: every hi and lo bit of 16,384 random
// rays matches the fused form, 1.5 % of the lo parts miss the separate
// one), so both entries take the fused features as a template flag.
//
// Entry points: ptx_pair_visit (thin) and ptx_pair_visit_full (five
// streams), each with an infeat flag (the kernels the wrappers launch);
// ptx_pair_visit_count (the same kernel, also adding to *counter the edge
// tests the margin sent to the chain); ptx_pair_visit_simt (the first
// kernel, kept to hold this one against whole launches and to time the
// two in turns; no wrapper on a render path reaches either of the last
// two). The first kernel's E sum is written out here rather than shared
// with plucker_cand.cu through a header, so it stays as measured.

#include <stdint.h>

#include "march_mma.cuh"

namespace {

using namespace ptx;

constexpr int kPairBlock = 128;   // pairs per block (trp % 128 == 0)
constexpr int kVisitTile = 64;    // triangles per shared-memory tile
constexpr int kW = 18;            // used trig columns (of 32)
constexpr int kMaxTrp = 1024;
constexpr int kTricCols = 24;

__device__ __forceinline__ uint32_t rne_bf16(uint32_t u) {
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

__device__ __forceinline__ float fetch0(const float* row, int k) {
  return __fadd_rn(row[k], 0.0f);
}

__global__ void __launch_bounds__(kPairBlock)
pair_simt_kernel(const int* __restrict__ keys,
                 const float* __restrict__ rays8,
                 const uint16_t* __restrict__ trig,
                 const float* __restrict__ tric, float* __restrict__ t_out,
                 float* __restrict__ gp_out, int n_pairs, int trp, int cs,
                 int c) {
  __shared__ float tw[kVisitTile][3][kW];
  __shared__ float tk[kVisitTile][10];   // n, c0, epsA(3), epsB(3)
  __shared__ int clist[kMaxTrp];
  __shared__ int ncl;
  const int i = blockIdx.x * kPairBlock + threadIdx.x;   // i < n_pairs
  const int tile0 = (blockIdx.x * kPairBlock / trp) * trp;
  if (threadIdx.x == 0) ncl = 0;
  __syncthreads();
  // The clusters of this tile: the keys at the run starts inside it.
  for (int q = tile0 + threadIdx.x; q < tile0 + trp; q += kPairBlock) {
    const int k = keys[q];
    if (k < c && (q == tile0 || keys[q - 1] != k))
      clist[atomicAdd(&ncl, 1)] = k;
  }
  const size_t n = static_cast<size_t>(n_pairs);
  const float px = rays8[i], py = rays8[n + i], pz = rays8[2 * n + i];
  const float dx = rays8[3 * n + i], dy = rays8[4 * n + i],
              dz = rays8[5 * n + i];
  float f[kW];
  {
    const float phi[6] = {__fsub_rn(__fmul_rn(py, dz), __fmul_rn(pz, dy)),
                          __fsub_rn(__fmul_rn(pz, dx), __fmul_rn(px, dz)),
                          __fsub_rn(__fmul_rn(px, dy), __fmul_rn(py, dx)),
                          dx, dy, dz};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float hi = __uint_as_float(rne_bf16(__float_as_uint(phi[q])));
      const float lo = __uint_as_float(
          rne_bf16(__float_as_uint(__fsub_rn(phi[q], hi))));
      f[q] = hi;
      f[6 + q] = lo;
      f[12 + q] = hi;
    }
  }
  const float ml = fmaxf(
      fmaxf(fabsf(__fmaf_rn(py, dz, -__fmul_rn(pz, dy))),
            fabsf(__fmaf_rn(pz, dx, -__fmul_rn(px, dz)))),
      fabsf(__fmaf_rn(px, dy, -__fmul_rn(py, dx))));
  float bt = kBig;
  int bg = 0;
  float pend = 0.0f;
  __syncthreads();
  const int nc = ncl;
  for (int v = 0; v < nc; ++v) {
    const int cid = clist[v];
    const int cbase = cid * cs;
    float m1 = kBig, m2 = kBig;
    int a1 = 0, a2 = 0;
    for (int base = 0; base < cs; base += kVisitTile) {
      __syncthreads();
      for (int k = threadIdx.x; k < kVisitTile * 3 * kW; k += kPairBlock) {
        const int j = k / (3 * kW), e = (k / kW) % 3, q = k % kW;
        const size_t row = 3 * static_cast<size_t>(cbase) + e * cs + base + j;
        tw[j][e][q] = __uint_as_float(static_cast<uint32_t>(trig[row * 32 + q])
                                      << 16);
      }
      for (int k = threadIdx.x; k < kVisitTile * 10; k += kPairBlock) {
        const int j = k / 10, q = k % 10;
        tk[j][q] = tric[static_cast<size_t>(cbase + base + j) * kTricCols +
                        (q < 4 ? q : 13 + q)];
      }
      __syncthreads();
      for (int j = 0; j < kVisitTile; ++j) {
        const float4 nc4 = make_float4(tk[j][0], tk[j][1], tk[j][2], tk[j][3]);
        const float vn = dot3(nc4, dx, dy, dz);
        const bool pos = vn > 0.f;
        bool valid = true;
#pragma unroll
        for (int e = 0; e < 3 && valid; ++e) {
          const float* w = tw[j][e];
          float ae = w[0] * f[0];
          float ao = w[1] * f[1];
#pragma unroll
          for (int q = 2; q < kW; q += 2) {
            ae = __fmaf_rn(w[q], f[q], ae);
            ao = __fmaf_rn(w[q + 1], f[q + 1], ao);
          }
          const float ek = ae + ao;
          const float ep = __fmaf_rn(tk[j][4 + e], ml, tk[j][7 + e]);
          valid = pos ? ek >= -ep : ek <= ep;
        }
        float tm = kBig;
        if (valid) {
          const float t = (nc4.w - dot3(nc4, px, py, pz)) / vn;
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
    bool v1 = false, v2 = false;
    float t_;
    if (m1 < kBig) {
      const float* r = tric + static_cast<size_t>(cbase + a1) * kTricCols;
      float4 cc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cc[e] = make_float4(fetch0(r, 4 * e), fetch0(r, 4 * e + 1),
                            fetch0(r, 4 * e + 2), fetch0(r, 4 * e + 3));
      v1 = exact_hit(cc, px, py, pz, dx, dy, dz, t_);
    }
    if (m2 < kBig) {
      const float* r = tric + static_cast<size_t>(cbase + a2) * kTricCols;
      float4 cc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cc[e] = make_float4(fetch0(r, 4 * e), fetch0(r, 4 * e + 1),
                            fetch0(r, 4 * e + 2), fetch0(r, 4 * e + 3));
      v2 = exact_hit(cc, px, py, pz, dx, dy, dz, t_);
    }
    const bool use2 = !v1 && v2;
    if (!v1 && !v2 && m2 < kBig) pend = 1.0f;
    if (v1 || use2) {
      const float ct = use2 ? m2 : m1;
      const int cg = cbase + (use2 ? a2 : a1);
      if (ct < bt || (ct == bt && cg < bg)) {
        bt = ct;
        bg = cg;
      }
    }
  }
  t_out[i] = bt;
  gp_out[i] = __fadd_rn(__fmul_rn(static_cast<float>(bg), 2.0f), pend);
}

// a * b - c * d, each product and the difference rounded separately
// (plucker_feat's), or as fma(a, b, -(c d)) (FUSED: _infeat_rows').
template <bool FUSED>
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return FUSED ? __fmaf_rn(a, b, -__fmul_rn(c, d))
               : __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// The bf16 bits of the features [phi_hi(6), phi_lo(6), phi_hi(6)] of a
// ray r = (P, D), phi = (P x D, D), the cross product rounded as
// cross_term<FUSED>, for mma_prologue.
template <bool FUSED>
struct RayFeatures {
  __device__ __forceinline__ void operator()(size_t, const float (&r)[6],
                                             uint32_t (&h)[kMarchW]) const {
    const float px = r[0], py = r[1], pz = r[2], dx = r[3], dy = r[4],
                dz = r[5];
    const float phi[6] = {cross_term<FUSED>(py, dz, pz, dy),
                          cross_term<FUSED>(pz, dx, px, dz),
                          cross_term<FUSED>(px, dy, py, dx),
                          dx, dy, dz};
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const uint32_t hi = rne_bf16(__float_as_uint(phi[q]));
      const uint32_t lo = rne_bf16(
          __float_as_uint(__fsub_rn(phi[q], __uint_as_float(hi))));
      h[q] = hi >> 16;
      h[6 + q] = lo >> 16;
      h[12 + q] = hi >> 16;
    }
  }
};

// Per-pair outputs: out[0] t, out[1] g * 2 + pend (thin), or out[1..3]
// the winner's normal and out[4] m * 2 + pend (FULL).
template <bool COUNT, bool FULL, bool FUSED>
__global__ void __launch_bounds__(kMarchLanes, 3)
pair_mma_kernel(const int* __restrict__ keys, const float* __restrict__ rays8,
                const uint16_t* __restrict__ trig,
                const float* __restrict__ tric, float* __restrict__ out0,
                float* __restrict__ out1, float* __restrict__ out2,
                float* __restrict__ out3, float* __restrict__ out4,
                int n_pairs, int trp, int cs, int c,
                unsigned long long* __restrict__ counter) {
  __shared__ MmaShared sh;
  __shared__ int clist[kMaxTrp];
  __shared__ int ncl;
  const size_t nn = static_cast<size_t>(n_pairs);
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kMarchLanes;
  const size_t tile0 = (b0 / trp) * trp;
  if (keys[tile0] >= c) {   // keys ascend: a tile of dummy pairs, misses
    const size_t i = b0 + threadIdx.x;
    out0[i] = kBig;
    out1[i] = 0.f;
    if (FULL) out2[i] = out3[i] = out4[i] = 0.f;
    return;
  }
  if (threadIdx.x == 0) ncl = 0;
  __syncthreads();
  // The clusters of this tile, as the first kernel lists them (their
  // order does not change the merge).
  for (size_t q = tile0 + threadIdx.x; q < tile0 + trp; q += kMarchLanes) {
    const int k = keys[q];
    if (k < c && (q == tile0 || keys[q - 1] != k))
      clist[atomicAdd(&ncl, 1)] = k;
  }
  __syncthreads();
  const int nc = ncl;
  MmaBlock m;
  mma_prologue(sh, rays8, nn, b0, m, RayFeatures<FUSED>{});
  MarchBest b{kBig, 0.f, 0.f, false};
  unsigned long long cnt = 0;
  for (int v = 0; v < nc; ++v)
    if (mma_visit<COUNT>(sh, trig, tric, clist[v], cs, m, b, cnt))
      b.pend = 1.f;
  const size_t i = b0 + m.ol;
  out0[i] = b.t;
  if (FULL) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (b.got) {
      const float* r = tric + static_cast<size_t>(b.g) * kTricCols;
      a[0] = fetch0(r, 0);
      a[1] = fetch0(r, 1);
      a[2] = fetch0(r, 2);
      a[3] = fetch0(r, 16);
    }
    out1[i] = a[0];
    out2[i] = a[1];
    out3[i] = a[2];
    out4[i] = __fadd_rn(__fmul_rn(a[3], 2.0f), b.pend);
  } else {
    out1[i] = __fadd_rn(__fmul_rn(b.g, 2.0f), b.pend);
  }
  if (COUNT && cnt) atomicAdd(counter, cnt);
}

cudaError_t check_args(const void* trig, const float* tric, int n_pairs,
                       int trp, int cs, int c) {
  if (trp <= 0 || trp > kMaxTrp || trp % kPairBlock || n_pairs % trp ||
      cs <= 0 || cs % kVisitTile || cs % kMmaTile || c <= 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(trig) % 16 ||
      reinterpret_cast<uintptr_t>(tric) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <bool COUNT, bool FULL, bool FUSED>
int launch_mma(const int* keys, const float* rays8p, const void* trig,
               const float* tric, float* const (&out)[5], int n_pairs,
               int trp, int cs, int c, void* counter, void* stream) {
  if (n_pairs <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n_pairs, trp, cs, c);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  pair_mma_kernel<COUNT, FULL, FUSED>
      <<<n_pairs / kMarchLanes, kMarchLanes, 0,
         static_cast<cudaStream_t>(stream)>>>(
          keys, rays8p, static_cast<const uint16_t*>(trig), tric, out[0],
          out[1], out[2], out[3], out[4], n_pairs, trp, cs, c,
          static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

template <bool FULL>
int launch_visit(const int* keys, const float* rays8p, const void* trig,
                 const float* tric, float* const (&out)[5], int n_pairs,
                 int trp, int cs, int c, int infeat, void* stream) {
  return infeat ? launch_mma<false, FULL, true>(keys, rays8p, trig, tric, out,
                                                n_pairs, trp, cs, c, nullptr,
                                                stream)
                : launch_mma<false, FULL, false>(keys, rays8p, trig, tric,
                                                 out, n_pairs, trp, cs, c,
                                                 nullptr, stream);
}

}  // namespace

extern "C" int ptx_pair_visit(const int* keys, const float* rays8p,
                              const void* trig, const float* tric, float* t,
                              float* gp, int n_pairs, int trp, int cs, int c,
                              int infeat, void* stream) {
  float* const out[5] = {t, gp, nullptr, nullptr, nullptr};
  return launch_visit<false>(keys, rays8p, trig, tric, out, n_pairs, trp, cs,
                             c, infeat, stream);
}

extern "C" int ptx_pair_visit_full(const int* keys, const float* rays8p,
                                   const void* trig, const float* tric,
                                   float* t, float* nx, float* ny, float* nz,
                                   float* mp, int n_pairs, int trp, int cs,
                                   int c, int infeat, void* stream) {
  float* const out[5] = {t, nx, ny, nz, mp};
  return launch_visit<true>(keys, rays8p, trig, tric, out, n_pairs, trp, cs,
                            c, infeat, stream);
}

extern "C" int ptx_pair_visit_count(const int* keys, const float* rays8p,
                                    const void* trig, const float* tric,
                                    float* t, float* gp, int n_pairs, int trp,
                                    int cs, int c, void* counter,
                                    void* stream) {
  float* const out[5] = {t, gp, nullptr, nullptr, nullptr};
  return launch_mma<true, false, false>(keys, rays8p, trig, tric, out,
                                        n_pairs, trp, cs, c, counter, stream);
}

extern "C" int ptx_pair_visit_simt(const int* keys, const float* rays8p,
                                   const void* trig, const float* tric,
                                   float* t, float* gp, int n_pairs, int trp,
                                   int cs, int c, void* stream) {
  if (n_pairs <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n_pairs, trp, cs, c);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  pair_simt_kernel<<<n_pairs / kPairBlock, kPairBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, rays8p, static_cast<const uint16_t*>(trig), tric, t, gp, n_pairs,
      trp, cs, c);
  return static_cast<int>(cudaGetLastError());
}
