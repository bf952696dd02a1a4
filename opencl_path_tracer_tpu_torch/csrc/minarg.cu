// K1: nearest triangle hit per ray, min + argmin over every triangle.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_minarg_kernel (launched by _run_minarg).
//
// What it computes is the reference's argmin: per ray the least tm over
// the triangles in index order, tm = t where the exact test accepts and
// BIG elsewhere, the lowest index on ties. Its loops are nearest.cuh's
// (the accepted rows merged into a start of (BIG, 0)), which give the same
// (t, index) unless triangle 0 accepts the ray above BIG; such a ray takes
// the reference's own scan instead (argmin_start.cuh), after the loop.
//
// What bounds it on the H100: operations. The rays are read once, and
// the triangle constants are staged through shared memory in tiles of 256
// that every thread of the block reads by broadcast (nearest.cuh's
// staging). The first kernel (minarg_simt_kernel below, nearest.cuh's
// loop, then the same step for triangle 0 above BIG) paid the IEEE
// divide t = (c0 - n.P) / (n.D) for every pair and then tested edges
// until one failed, about 45 instructions a pair, even where t could not
// beat the ray's running best. This one settles the
// pairs it can before the divide, with num = c0 - n.P and vn = n.D rounded as
// nearest.cuh rounds them:
//   (a) num and vn not of one strict sign (either is +-0 or NaN, or the
//       signs differ): t = RN(num / vn) is <= 0 or NaN and fails t > 0,
//       or vn = +-0 with num != 0 and t = +-inf, which is never below the
//       running best (at most BIG = 3e38);
//   (b) |num| >= RU(best |vn|): the product rounded up bounds the exact
//       one from above, so the exact quotient is >= best, and a
//       correctly rounded divide is monotone, so t >= best and the
//       strict < fails. No margin is needed, subnormals included; a
//       product that overflows to inf rejects nothing.
// Rule (a)'s infinite t needs the running best to be at most BIG. It is:
// the loops start at (BIG, 0) and best only falls. The reference's start
// of +inf, under which best exceeds BIG after a triangle 0 accepted above
// BIG, is not the loops' start: such a ray's output comes from
// argmin_start.cuh's scan, and its loop result is dropped, so the rules
// never see a best above BIG.
// Only the other pairs divide, then test t > 0 (which still catches an
// underflow to 0) and t < best, and only then read the three edge rows
// and test them as nearest.cuh's exact_hit does. So the outputs are the
// first kernel's bit for bit.
//
// A warp still runs the divide where one of its lanes needs it, so the
// cull pays only where a warp's rays reject the same triangles: camera
// rays (one origin, near-parallel directions) skip the divide in about
// half the steps; bounce rays (directions spread over a hemisphere)
// seldom do, and there the cull's test and branch cost more than they
// save. So each warp first measures the spread of its rays' unit
// directions (per axis, the largest less the least; rays with a zero or
// non-finite direction left out), and a warp whose spread reaches
// kJointSpread on some axis runs the joint loop instead, which has no
// cull and no branch per ray: it divides for both of a thread's rays and
// tests their edges together until both have failed. Both loops give the
// same bits, so the choice moves only the time. Each thread holds
// kRays = 2 rays, which halves the shared-memory broadcasts per pair
// (two measured faster than one in turns); the ray tail is masked (a ray
// past the end is a zero ray, which rule (b) rejects everywhere), not
// padded.
//
// Entry points: ptx_minarg (the kernel the wrapper launches);
// ptx_minarg_count (the same kernel, also adding to counter[0] the pairs
// that reached the divide, to counter[1] those that reached the edge
// tests and to counter[2] the warps that ran the joint loop);
// ptx_minarg_simt (the first kernel, kept to hold this one against whole
// launches and to time the two in turns; no wrapper on a render path
// reaches either of the last two).

#include "argmin_start.cuh"

namespace {

using namespace ptx;

constexpr int kRays = 2;   // rays per thread
// A warp whose unit directions spread this far on some axis runs the
// joint loop.
constexpr float kJointSpread = 1.0f;

__global__ void __launch_bounds__(kBlock)
minarg_simt_kernel(const float* __restrict__ rays8,
                   const float4* __restrict__ tri, float* __restrict__ t_out,
                   float* __restrict__ g_out, int n_rays, int n_tris) {
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
  const bool maybe =
      live && row0_may_exceed_big(tri, px, py, pz, dx, dy, dz);
  Nearest best =
      nearest_triangle(tile, tri, n_tris, live, px, py, pz, dx, dy, dz);
  if (maybe && row0_above_big(tri, px, py, pz, dx, dy, dz))
    best = reference_scan(tri, n_tris, px, py, pz, dx, dy, dz);
  if (live) {
    t_out[i] = best.t;
    g_out[i] = (float)best.g;
  }
}

// Whether t = RN(num / vn) could pass t > 0 and t < best (rules (a) and
// (b) above; false only where it certainly cannot). best is positive.
// s is num with vn's sign bit applied, so num / vn = s / |vn|: s > 0
// holds exactly when num and vn are of one strict sign (false for +-0
// and NaN), and then s = |num|; a vn of +-0 (or NaN) makes the bound 0
// (or NaN), which nothing is below.
__device__ __forceinline__ bool may_be_nearer(float num, float vn,
                                              float best) {
  const float s = __int_as_float(__float_as_int(num) ^
                                 (__float_as_int(vn) & 0x80000000));
  return (s > 0.f) & (s < __fmul_ru(best, fabsf(vn)));
}

// The divide and the exact test of one pair that the cull let through:
// t = num / vn, t > 0, t < best, then the edge rows, nearest.cuh's
// exact_hit from the divide on.
template <bool COUNT>
__device__ __forceinline__ void divide_and_test(
    const float4* tile, int j, int g, float num, float vn, float px,
    float py, float pz, float dx, float dy, float dz, Nearest& best,
    unsigned long long& n_div, unsigned long long& n_edge) {
  if (COUNT) ++n_div;
  const float t = num / vn;
  if (!(t > 0.f && t < best.t)) return;
  if (COUNT) ++n_edge;
  bool ok = true;
#pragma unroll
  for (int e = 1; e < 4 && ok; ++e) {
    const float4 c = tile[4 * j + e];
    const float pm = dot3(c, px, py, pz);
    const float vm = dot3(c, dx, dy, dz);
    ok = __fmaf_rn(t, vm, pm) >= c.w;
  }
  if (ok) {
    best.t = t;
    best.g = g;
  }
}

// One tile through the culled loop.
template <bool COUNT>
__device__ __forceinline__ void culled_tile(
    const float4* tile, int base, int n, const float (&px)[kRays],
    const float (&py)[kRays], const float (&pz)[kRays],
    const float (&dx)[kRays], const float (&dy)[kRays],
    const float (&dz)[kRays], Nearest (&best)[kRays],
    unsigned long long& n_div, unsigned long long& n_edge) {
  for (int j = 0; j < n; ++j) {
    const float4 nc = tile[4 * j];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const float vn = dot3(nc, dx[r], dy[r], dz[r]);
      const float num = nc.w - dot3(nc, px[r], py[r], pz[r]);
      if (!may_be_nearer(num, vn, best[r].t)) continue;
      divide_and_test<COUNT>(tile, j, base + j, num, vn, px[r], py[r],
                             pz[r], dx[r], dy[r], dz[r], best[r], n_div,
                             n_edge);
    }
  }
}

// Whether the warp's rays spread their unit directions by kJointSpread
// or more on some axis (the same answer on every lane).
__device__ __forceinline__ bool spread_wide(const float (&dx)[kRays],
                                            const float (&dy)[kRays],
                                            const float (&dz)[kRays]) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    // A zero or non-finite direction gives NaN, which fminf and fmaxf
    // leave out.
    const float s = rsqrtf(dx[r] * dx[r] + dy[r] * dy[r] + dz[r] * dz[r]);
    const float u[3] = {dx[r] * s, dy[r] * s, dz[r] * s};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = isfinite(s) ? u[k] : NAN;
      lo[k] = fminf(lo[k], v);
      hi[k] = fmaxf(hi[k], v);
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], m));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], m));
    }
  return hi[0] - lo[0] >= kJointSpread || hi[1] - lo[1] >= kJointSpread ||
         hi[2] - lo[2] >= kJointSpread;
}

// One tile through the joint loop: every pair divided, a thread's rays
// tested together, the edges until both have failed (nearest.cuh's
// exact_hit for each ray).
template <bool COUNT>
__device__ __forceinline__ void joint_tile(
    const float4* tile, int base, int n, const float (&px)[kRays],
    const float (&py)[kRays], const float (&pz)[kRays],
    const float (&dx)[kRays], const float (&dy)[kRays],
    const float (&dz)[kRays], Nearest (&best)[kRays],
    unsigned long long& n_div, unsigned long long& n_edge) {
  for (int j = 0; j < n; ++j) {
    const float4 nc = tile[4 * j];
    float t[kRays];
    bool ok[kRays];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const float vn = dot3(nc, dx[r], dy[r], dz[r]);
      const float num = nc.w - dot3(nc, px[r], py[r], pz[r]);
      t[r] = num / vn;
      ok[r] = t[r] > 0.f && t[r] < best[r].t;
      any |= ok[r];
      if (COUNT) {
        ++n_div;
        n_edge += ok[r];
      }
    }
    if (!any) continue;
#pragma unroll
    for (int e = 1; e < 4 && any; ++e) {
      const float4 c = tile[4 * j + e];
      any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const float pm = dot3(c, px[r], py[r], pz[r]);
        const float vm = dot3(c, dx[r], dy[r], dz[r]);
        ok[r] = ok[r] && __fmaf_rn(t[r], vm, pm) >= c.w;
        any |= ok[r];
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      if (ok[r]) {
        best[r].t = t[r];
        best[r].g = base + j;
      }
    }
  }
}

// At most 40 registers (six blocks an SM), as the loops take without the
// rare path after them (argmin_start.cuh): left to itself the compiler
// gave the kernel 62 for that path, and it ran 2.5-6.6 % slower.
template <bool COUNT>
__global__ void __launch_bounds__(kBlock, 6)
minarg_cull_kernel(const float* __restrict__ rays8,
                   const float4* __restrict__ tri, float* __restrict__ t_out,
                   float* __restrict__ g_out, int n_rays, int n_tris,
                   unsigned long long* __restrict__ counter) {
  __shared__ float4 tile[kTile * 4];
  float px[kRays], py[kRays], pz[kRays], dx[kRays], dy[kRays], dz[kRays];
  Nearest best[kRays];
  bool maybe[kRays];   // row 0 may accept the ray above BIG
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = (blockIdx.x * kRays + r) * kBlock + threadIdx.x;
    px[r] = py[r] = pz[r] = dx[r] = dy[r] = dz[r] = 0.f;
    if (i < n_rays) {
      px[r] = rays8[i];
      py[r] = rays8[n_rays + i];
      pz[r] = rays8[2 * n_rays + i];
      dx[r] = rays8[3 * n_rays + i];
      dy[r] = rays8[4 * n_rays + i];
      dz[r] = rays8[5 * n_rays + i];
    }
    best[r] = Nearest{kBig, 0};
    maybe[r] = i < n_rays && row0_may_exceed_big(
                                 tri, px[r], py[r], pz[r], dx[r], dy[r], dz[r]);
  }
  unsigned long long n_div = 0, n_edge = 0;
  const bool joint = spread_wide(dx, dy, dz);
  for (int base = 0; base < n_tris; base += kTile) {
    const int n = min(kTile, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < 4 * n; k += kBlock) {
      // A pack row is 6 float4s; the first four hold the constants.
      tile[k] = tri[(size_t)(base + (k >> 2)) * (kTriCols / 4) + (k & 3)];
    }
    __syncthreads();
    if (joint) {
      joint_tile<COUNT>(tile, base, n, px, py, pz, dx, dy, dz, best, n_div,
                        n_edge);
    } else {
      culled_tile<COUNT>(tile, base, n, px, py, pz, dx, dy, dz, best, n_div,
                         n_edge);
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = (blockIdx.x * kRays + r) * kBlock + threadIdx.x;
    if (i < n_rays) {
      if (maybe[r] &&
          row0_above_big(tri, px[r], py[r], pz[r], dx[r], dy[r], dz[r]))
        best[r] = reference_scan(tri, n_tris, px[r], py[r], pz[r], dx[r],
                                 dy[r], dz[r]);
      t_out[i] = best[r].t;
      g_out[i] = (float)best[r].g;
    } else if (COUNT && joint) {
      n_div -= n_tris;   // the masked ray's divides are no pairs
    }
  }
  if (COUNT) {
    atomicAdd(&counter[0], n_div);
    atomicAdd(&counter[1], n_edge);
    if (joint && (threadIdx.x & 31) == 0)
      atomicAdd(&counter[2], 1ull);
  }
}

template <bool COUNT>
int launch_cull(const float* rays8, const float* tri_pack, float* t_out,
                float* g_out, int n_rays, int n_tris, void* counter,
                void* stream) {
  if (n_rays <= 0) return 0;
  const int per_block = kRays * kBlock;
  const int grid = (n_rays + per_block - 1) / per_block;
  minarg_cull_kernel<COUNT>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          rays8, reinterpret_cast<const float4*>(tri_pack), t_out, g_out,
          n_rays, n_tris, static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_minarg(const float* rays8, const float* tri_pack,
                          float* t_out, float* g_out, int n_rays, int n_tris,
                          void* stream) {
  return launch_cull<false>(rays8, tri_pack, t_out, g_out, n_rays, n_tris,
                            nullptr, stream);
}

extern "C" int ptx_minarg_count(const float* rays8, const float* tri_pack,
                                float* t_out, float* g_out, int n_rays,
                                int n_tris, void* counter, void* stream) {
  return launch_cull<true>(rays8, tri_pack, t_out, g_out, n_rays, n_tris,
                           counter, stream);
}

extern "C" int ptx_minarg_simt(const float* rays8, const float* tri_pack,
                               float* t_out, float* g_out, int n_rays,
                               int n_tris, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  minarg_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), t_out, g_out, n_rays,
      n_tris);
  return static_cast<int>(cudaGetLastError());
}
