// K13a: the two nearest Plucker candidates per ray.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_cand_kernel (launched by _run_candidates).
//
// What it computes, per ray: the features phi = [P x D, D] (each product
// and difference rounded separately) split into bf16 hi = RNE(phi) and
// lo = RNE(phi - hi) by integer bit arithmetic; per triangle and edge k
// the Plucker product E_k = sum of the 18 exact products of the packed
// bf16 weights [w_hi, w_hi, w_lo] with [phi_hi, phi_lo, phi_hi], in two
// float32 accumulators (even terms, odd terms, in order) that are then
// added, the order of XLA's CPU dot in the reference; acceptance is the
// eps-loosened sign test (a superset of K1/K4's accepts) with t > 0,
// and t is K1's exact expression. It keeps, per chunk of `chunk`
// triangles, the first (t, index) minimum and the next (BIG and the
// chunk's first index when fewer than two accept), and merges chunks in
// order, ties to the lower index: the TPU kernel's top-2 bit for bit.
//
// What bounds it on the H100: operations. The TPU runs the E products on
// its matrix unit; their count (3 x 18 multiply-adds per (ray, triangle)
// pair) is charged at the bf16 tensor-core rate in the bound, though
// this first kernel runs them on the float32 cores, one ray per thread,
// with the bf16 weights (as float32) and the triangle constants staged
// through shared memory in tiles of 64 triangles read by broadcast. The
// edge tests stop at the first that fails, and the divide for t runs
// only where all three pass. The features are computed in the kernel,
// so no (32, R) feature array travels through device memory. Tensor
// cores (mma/wgmma bf16) are the later redesign.

#include <stdint.h>

#include "nearest.cuh"

namespace {

using namespace ptx;

constexpr int kCandTile = 64;     // triangles per shared-memory tile
constexpr int kW = 18;            // used trig columns (of 32)

__device__ __forceinline__ uint32_t rne_bf16(uint32_t u) {
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

struct Top2 {
  float t1, t2;
  int g1, g2;
};

__global__ void __launch_bounds__(kBlock)
plucker_cand_kernel(const float* __restrict__ rays8, int ray_stride,
                    const uint16_t* __restrict__ trig,
                    const float4* __restrict__ tric, float* __restrict__ out,
                    int n_rays, int n_tris, int chunk) {
  __shared__ float tw[kCandTile][3][kW];
  __shared__ float4 tc[kCandTile][2];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  const size_t rs = static_cast<size_t>(ray_stride);
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    px = rays8[i];
    py = rays8[rs + i];
    pz = rays8[2 * rs + i];
    dx = rays8[3 * rs + i];
    dy = rays8[4 * rs + i];
    dz = rays8[5 * rs + i];
  }
  // Features: f[0..5] = phi_hi, f[6..11] = phi_lo, f[12..17] = phi_hi.
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
  Top2 run{kBig, kBig, 0, 0};
  for (int cbase = 0; cbase < n_tris; cbase += chunk) {
    Top2 loc{kBig, kBig, cbase, cbase};
    for (int base = cbase; base < cbase + chunk; base += kCandTile) {
      __syncthreads();
      // trig is chunk-major: edge e of triangle cbase + c sits at row
      // 3 cbase + e chunk + c (a tile never spans two chunks).
      for (int k = threadIdx.x; k < kCandTile * 3 * kW; k += blockDim.x) {
        const int j = k / (3 * kW), e = (k / kW) % 3, q = k % kW;
        const int row = 3 * cbase + e * chunk + (base - cbase) + j;
        tw[j][e][q] = __uint_as_float(
            static_cast<uint32_t>(trig[(size_t)row * 32 + q]) << 16);
      }
      for (int k = threadIdx.x; k < kCandTile * 2; k += blockDim.x) {
        tc[k >> 1][k & 1] = tric[(size_t)base * 2 + k];
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < kCandTile; ++j) {
        const float4 nc = tc[j][0];       // n, c0
        const float4 eps = tc[j][1];      // eps1, eps2, eps3, 0
        const float vn = dot3(nc, dx, dy, dz);
        const bool pos = vn > 0.f;
        // The loosened sign tests, edge by edge, stopping at the first
        // that fails: E_k >= -eps_k for every k when vn > 0, else
        // E_k <= eps_k (an AND, so the early exit changes no result).
        bool valid = true;
#pragma unroll
        for (int k = 0; k < 3 && valid; ++k) {
          const float* w = tw[j][k];
          // The products of two bf16 values are exact in float32, so
          // fma(w, f, acc) rounds once, as acc + w * f does.
          float ae = w[0] * f[0];
          float ao = w[1] * f[1];
#pragma unroll
          for (int q = 2; q < kW; q += 2) {
            ae = __fmaf_rn(w[q], f[q], ae);
            ao = __fmaf_rn(w[q + 1], f[q + 1], ao);
          }
          const float e = ae + ao;
          const float ek = k == 0 ? eps.x : (k == 1 ? eps.y : eps.z);
          valid = pos ? e >= -ek : e <= ek;
        }
        // t only where the sign tests pass: K1's expression, t > 0.
        float tm = kBig;
        if (valid) {
          const float t = (nc.w - dot3(nc, px, py, pz)) / vn;
          if (t > 0.f) tm = t;
        }
        const int gj = base + j;
        if (tm < loc.t1) {
          loc.t2 = loc.t1;
          loc.g2 = loc.g1;
          loc.t1 = tm;
          loc.g1 = gj;
        } else if (tm < loc.t2) {
          loc.t2 = tm;
          loc.g2 = gj;
        }
      }
    }
    if (cbase == 0) {
      run = loc;
      continue;
    }
    // Merge the running top-2 with the chunk's, ties to the lower index.
    const bool bet = loc.t1 < run.t1 || (loc.t1 == run.t1 && loc.g1 < run.g1);
    const float r = bet ? run.t1 : loc.t1;
    const int rg = bet ? run.g1 : loc.g1;
    const float s = bet ? loc.t2 : run.t2;
    const int sg = bet ? loc.g2 : run.g2;
    if (bet) {
      run.t1 = loc.t1;
      run.g1 = loc.g1;
    }
    const bool bet2 = s < r || (s == r && sg < rg);
    run.t2 = bet2 ? s : r;
    run.g2 = bet2 ? sg : rg;
  }
  if (live) {
    const size_t n = static_cast<size_t>(n_rays);
    out[i] = run.t1;
    out[n + i] = (float)run.g1;
    out[2 * n + i] = run.t2;
    out[3 * n + i] = (float)run.g2;
  }
}

}  // namespace

extern "C" int ptx_plucker_cand(const float* rays8, int ray_stride,
                                const void* trig, const float* tric,
                                float* out, int n_rays, int n_tris,
                                int chunk, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0 || chunk <= 0 || chunk % kCandTile || n_tris % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  plucker_cand_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, static_cast<const uint16_t*>(trig),
      reinterpret_cast<const float4*>(tric), out, n_rays, n_tris, chunk);
  return static_cast<int>(cudaGetLastError());
}
