// K15: the dense nearest hit with the winner's index and attributes, its
// dots rounded as the TPU kernel's one float32 matmul rounds them.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_mxu_kernel (launched by _run_mxu, behind
// make_mxu_intersect).
//
// What it computes, per ray (P, D) and triangle (n, c0, m_k, d_k) of K4's
// (T, 24) pack: the eight dots [pn vn pm1 vm1 pm2 vm2 pm3 vm3]. The
// reference computes them as a matmul of a tiled copy of these constants
// (8 rows of 8 columns per triangle, 3 of the 8 non-zero) with the ray rows
// [p(3) d(3) 0 0], summing a row in k order as one chain of fused
// multiply-adds, so a dot is fma(v2, a2, fma(v1, a1, v0 * a0)) + 0.0f: the
// five zero columns add exact zeros, which only turn a -0.0 dot into +0.0.
// Then
//   t = (c0 - pn) / vn, accepted when t > 0 and fma(t, vm_k, pm_k) >= d_k
// (the interpret-mode kernel's rounding, which is not K4's), tm = t where
// accepted and BIG elsewhere, the lexicographic least (tm, index) (the
// reference's first-index argmin per tile with a strict < across tiles,
// whatever the tile, from a start of +inf: the first row's tm always
// wins), and the winner's [nx ny nz mati] + 0.0f (the one-hot float32
// sum's sign of zero). A miss keeps t = BIG and index 0 with triangle 0's
// attributes, tile 0's latch.
//
// Out: six rows of n_rays floats [t, index, nx, ny, nz, mati].
//
// What bounds it on the H100: operations, 12 float32 operations per
// (ray, triangle) test that reaches the divide and 12 per edge test
// reached, plus about 25 per (ray, sub-block) box test; the rays, the
// pack and its table read once, six rows out. The first kernel
// (mxu_simt_kernel below) staged every row of the pack through shared
// memory for the block and ran every (ray, triangle) test. This kernel is
// K14's (minarg_fused.cu): the pack's sub-blocks of kSub = 32 rows in row
// order, each skipped per ray where the box of the table
// cluster_kernel.sub_boxes builds over the one span [0, T) (once per
// scene) misses the ray's segment P + s D, 0 <= s <= best, through
// sub_cull.cuh's nearest_in_order with this kernel's test, MxuHit.
//
// Why the skip rule holds for this test. The rule (pair_vpu.cu's header)
// needs each dot of the test within 3.01u sum |v_i x_i| of the exact dot
// (u = 2^-24), the divide and the edge tests' fma as nearest.cuh has them.
// A product and two fmas in any order of the terms meet that bound (each
// rounding adds at most u of a partial sum, and each partial sum is at
// most sum |v_i x_i|), and the `+ 0.0f` is exact, so K15's dots meet it.
// So a skipped sub-block holds no row accepted with t <= best.
//
// Why the start of +inf forbids skipping while best > BIG. A row that does
// not accept the ray competes with tm = BIG. Once best <= BIG no such row
// wins (strict <), and the rule covers the rows that accept. But while
// best > BIG (at the start, or after rows accepted only above BIG: finite
// inputs allow it, a degenerate row with t = (c0 - pn) / vn in (BIG,
// FLT_MAX]) the first row that does not accept wins with (BIG, its index),
// and the rule says nothing about such rows. So the loop skips nothing
// while best > BIG; sub-block 0 is never skipped. Every row competes in
// the merge (MxuHit::hit is always true, with t = tm), so the strict <
// across sub-blocks with the lowest index within one gives the first
// kernel's (t, index) bit for bit, signed zeros included (the dots' and
// the attributes' `+ 0.0f` stay). A ray with D = 0 (padding, never a hit:
// its t is +-inf or NaN and an infinite t fails an edge test on vm = 0)
// tests nothing and keeps (BIG, 0), the first kernel's result for it.
//
// Entry points: ptx_mxu (the kernel the wrapper launches); ptx_mxu_count
// (the same kernel, also adding to counter[0..4] the tests that reached
// the divide, the box tests that passed, those of them run by the whole
// warp, the edge tests reached and the box tests made); ptx_mxu_simt (the
// first kernel, kept to hold this one against whole launches and to time
// the two in turns; no wrapper on a render path reaches either of the
// last two).

#include <stdint.h>

#include "sub_cull.cuh"

namespace {

using namespace ptx;

__device__ __forceinline__ float mxu_dot(float4 v, float x, float y,
                                         float z) {
  return __fadd_rn(__fmaf_rn(v.z, z, __fmaf_rn(v.y, y, __fmul_rn(v.x, x))),
                   0.0f);
}

// K15's exact test for sub_cull.cuh's runs: every row competes, with tm
// (t where the row accepts the ray, BIG elsewhere).
struct MxuHit {
  static __device__ __forceinline__ float plane(float4 nc, float px,
                                                float py, float pz, float dx,
                                                float dy, float dz) {
    return __fdiv_rn(__fsub_rn(nc.w, mxu_dot(nc, px, py, pz)),
                     mxu_dot(nc, dx, dy, dz));
  }
  static __device__ __forceinline__ bool edge(float4 m, float t, float px,
                                              float py, float pz, float dx,
                                              float dy, float dz) {
    return __fmaf_rn(t, mxu_dot(m, dx, dy, dz), mxu_dot(m, px, py, pz)) >=
           m.w;
  }
  static __device__ __forceinline__ bool hit(const float4* c, float px,
                                             float py, float pz, float dx,
                                             float dy, float dz, float& t) {
    const float tp = plane(c[0], px, py, pz, dx, dy, dz);
    bool ok = tp > 0.f;
#pragma unroll
    for (int e = 1; e < 4 && ok; ++e)
      ok = edge(c[e], tp, px, py, pz, dx, dy, dz);
    t = ok ? tp : kBig;
    return true;
  }
};

// The winner's six outputs for lane i.
__device__ __forceinline__ void write_winner(const float4* __restrict__ tri,
                                             float best_t, int best_g, int i,
                                             float* __restrict__ out,
                                             int n_rays) {
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best_g * kTriCols;
  const size_t r = static_cast<size_t>(n_rays);
  out[i] = best_t;
  out[r + i] = (float)best_g;
  out[2 * r + i] = __fadd_rn(row[0], 0.0f);
  out[3 * r + i] = __fadd_rn(row[1], 0.0f);
  out[4 * r + i] = __fadd_rn(row[2], 0.0f);
  out[5 * r + i] = __fadd_rn(row[16], 0.0f);
}

__global__ void __launch_bounds__(kBlock)
mxu_simt_kernel(const float* __restrict__ rays8,
                const float4* __restrict__ tri, float* __restrict__ out,
                int n_rays, int n_tris) {
  __shared__ float4 tile[kTile * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    px = rays8[i];
    py = rays8[n_rays + i];
    pz = rays8[2 * n_rays + i];
    dx = rays8[3 * n_rays + i];
    dy = rays8[4 * n_rays + i];
    dz = rays8[5 * n_rays + i];
  }
  float best_t = __int_as_float(0x7f800000);   // +inf: the first tm wins
  int best_g = 0;
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < 4 * n; k += kBlock) {
      tile[k] = tri[(size_t)(base + (k >> 2)) * (kTriCols / 4) + (k & 3)];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float4* c = &tile[4 * j];
      const float pn = mxu_dot(c[0], px, py, pz);
      const float vn = mxu_dot(c[0], dx, dy, dz);
      const float t = __fdiv_rn(__fsub_rn(c[0].w, pn), vn);
      bool ok = t > 0.f;
#pragma unroll
      for (int e = 1; e < 4 && ok; ++e) {
        const float pm = mxu_dot(c[e], px, py, pz);
        const float vm = mxu_dot(c[e], dx, dy, dz);
        ok = __fmaf_rn(t, vm, pm) >= c[e].w;
      }
      const float tm = ok ? t : kBig;
      if (tm < best_t) {
        best_t = tm;
        best_g = base + j;
      }
    }
  }
  if (live) write_winner(tri, best_t, best_g, i, out, n_rays);
}

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
mxu_kernel(const float* __restrict__ rays8, const float4* __restrict__ tri,
           const float4* __restrict__ sub, float* __restrict__ out,
           int n_rays, int n_tris, int coop_max,
           unsigned long long* __restrict__ counter) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (i < n_rays) {
    px = rays8[i];
    py = rays8[n_rays + i];
    pz = rays8[2 * n_rays + i];
    dx = rays8[3 * n_rays + i];
    dy = rays8[4 * n_rays + i];
    dz = rays8[5 * n_rays + i];
  }
  const bool live = i < n_rays && (dx != 0.f || dy != 0.f || dz != 0.f);
  CullCounts ct;
  // +inf: the first row's tm wins (a ray that tests nothing keeps BIG).
  Nearest best{live ? __int_as_float(0x7f800000) : kBig, 0};
  nearest_in_order<MxuHit, COUNT>(tri, sub, n_tris, live, px, py, pz, dx, dy,
                                  dz, coop_max, best, ct);
  if (i < n_rays) write_winner(tri, best.t, best.g, i, out, n_rays);
  if (COUNT) ct.add_to(counter);
}

template <bool COUNT>
int launch(const float* rays8, const float* tri_pack, const float* sub,
           float* out, int n_rays, int n_tris, int coop_max, void* counter,
           void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri_pack) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  mxu_kernel<COUNT><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack),
      reinterpret_cast<const float4*>(sub), out, n_rays, n_tris, coop_max,
      static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_mxu(const float* rays8, const float* tri_pack,
                       const float* sub, float* out, int n_rays, int n_tris,
                       int coop_max, void* stream) {
  return launch<false>(rays8, tri_pack, sub, out, n_rays, n_tris, coop_max,
                       nullptr, stream);
}

extern "C" int ptx_mxu_count(const float* rays8, const float* tri_pack,
                             const float* sub, float* out, int n_rays,
                             int n_tris, int coop_max, void* counter,
                             void* stream) {
  return launch<true>(rays8, tri_pack, sub, out, n_rays, n_tris, coop_max,
                      counter, stream);
}

extern "C" int ptx_mxu_simt(const float* rays8, const float* tri_pack,
                            float* out, int n_rays, int n_tris,
                            void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  mxu_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), out, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
