// K14: K1's nearest triangle hit and K2's attribute fetch in one launch.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_minarg_fused_kernel (launched by _run_minarg_fused,
// the make_minarg_intersect(fuse_fetch=True) path). The TPU kernel holds
// the whole table in one VMEM block; this one loops over any table.
//
// What it computes: K1's (t, index) (the reference's argmin: the least
// tm, t where a row accepts and BIG elsewhere, the lowest index on ties;
// (BIG, 0) when nothing accepts), then, in the same
// thread, K2's fetch of the winner's row: t (-1 on a miss), the normal
// and the material. On the TPU the fetch is a one-hot matmul over an
// exact bf16 three-way split of the table; an indexed load of the float32
// row gives the same bits, and `+ 0.0f` (never folded under --fmad=false)
// turns -0.0 into +0.0 as the one-hot sum does. A miss keeps the
// argmin's index (0 unless row 0 accepts the ray above BIG), so its lanes
// carry that row's attributes, as K1 + K2's do. The result is K1 then K2
// bit for bit.
//
// What bounds it on the H100: operations, 12 float32 operations per
// (ray, triangle) test that reaches the divide and 12 per edge test
// reached, plus about 25 per (ray, sub-block) box test; the rays, the
// pack and its table read once, five rows out. The first kernel
// (minarg_fused_simt_kernel below, nearest.cuh's loop) staged every row
// of the pack through shared memory for the block and ran every (ray,
// triangle) test: an IEEE divide and up to three edge tests each. This
// kernel walks the pack's sub-blocks of kSub = 32 rows in row order
// (sub_cull.cuh's nearest_in_order) and skips per ray each sub-block whose
// box (the table cluster_kernel.sub_boxes builds over the one span [0, T),
// once per scene) its segment P + s D, 0 <= s <= best t, misses: the rule
// (pair_vpu.cu's header) proves such a sub-block holds no accepted t <=
// best, so no tie is skipped either, and the strict < across sub-blocks
// with the lowest index within one gives the first kernel's (t, index)
// bit for bit. The loop merges accepted rows into (BIG, 0), so its best
// never exceeds BIG; that is the reference's argmin unless row 0 accepts
// the ray above BIG (argmin_start.cuh). The kernel flags, one bit a ray,
// the rays that row 0 may accept above BIG (argmin_start.cuh's filter,
// before the loop), and a second kernel of the same launch (start_kernel,
// a thread for 32 flags) replaces a flagged ray's outputs where row 0
// does accept it above BIG with argmin_start.cuh's scan and its fetch.
// That scan is kept out of this kernel: any loop with a divide beside the
// main loop (inlined, out of line, or a second pass of the loop) cost the
// loop its uniform registers (the sub-block count and ballots; VOTEU in
// the SASS) and K14 1.2-8 % in turns on an H100 (runtime/cull_ab.py;
// PERF.md). A ray with D = 0
// (padding) accepts no row (t is +-inf or NaN, and an infinite t fails the
// edge tests on a zero vm) and tests none: it keeps (BIG, 0). Each mesh's
// triangles are one run of pack rows, so sub-blocks in row order are
// compact boxes.
//
// Layout: one thread per ray, kBlock rays a block, nothing shared by the
// block; the table and the rows come through the read-only path. Per
// sub-block a warp takes the ballot of its rays whose box test passed; a
// ballot of at most coop_max rays runs the sub-block on all 32 lanes, one
// ray at a time, else each lane tests the rows against its own ray.
//
// Entry points: ptx_minarg_fused (the kernel the wrapper launches);
// ptx_minarg_fused_count (the same kernel, also adding to counter[0..4]
// the tests that reached the divide, the box tests that passed, those of
// them run by the whole warp, the edge tests reached and the box tests
// made); ptx_minarg_fused_simt (the first kernel, kept to hold this one
// against whole launches and to time the two in turns; no wrapper on a
// render path reaches either of the last two).

#include <stdint.h>

#include "argmin_start.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

struct Rows5 {
  float *t, *nx, *ny, *nz, *m;
};

// K2's fetch of the winner's row into lane i's outputs.
__device__ __forceinline__ void write_fetch(const float4* __restrict__ tri,
                                            const Nearest& best, int i,
                                            Rows5 out) {
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best.g * kTriCols;
  out.t[i] = best.t < kBig ? best.t : -1.0f;
  out.nx[i] = __fadd_rn(row[0], 0.0f);
  out.ny[i] = __fadd_rn(row[1], 0.0f);
  out.nz[i] = __fadd_rn(row[2], 0.0f);
  out.m[i] = __fadd_rn(row[16], 0.0f);
}

__global__ void __launch_bounds__(kBlock)
minarg_fused_simt_kernel(const float* __restrict__ rays8,
                         const float4* __restrict__ tri, Rows5 out,
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
  const bool maybe =
      live && row0_may_exceed_big(tri, px, py, pz, dx, dy, dz);
  Nearest best =
      nearest_triangle(tile, tri, n_tris, live, px, py, pz, dx, dy, dz);
  if (maybe && row0_above_big(tri, px, py, pz, dx, dy, dz))
    best = reference_scan(tri, n_tris, px, py, pz, dx, dy, dz);
  if (live) write_fetch(tri, best, i, out);
}

template <bool COUNT>
__global__ void __launch_bounds__(kBlock)
minarg_fused_kernel(const float* __restrict__ rays8,
                    const float4* __restrict__ tri,
                    const float4* __restrict__ sub, Rows5 out,
                    unsigned* __restrict__ flags, int n_rays, int n_tris,
                    int coop_max, unsigned long long* __restrict__ counter) {
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
  const bool maybe =
      live && row0_may_exceed_big(tri, px, py, pz, dx, dy, dz);
  Nearest best{kBig, 0};
  nearest_in_order<ExactHit, COUNT>(tri, sub, n_tris, live, px, py, pz, dx,
                                    dy, dz, coop_max, best, ct);
  if (i < n_rays) write_fetch(tri, best, i, out);
  // The warp's rays that row 0 may accept above BIG, one bit each, for
  // start_kernel (a warp wholly past the end writes nothing).
  const unsigned bits = __ballot_sync(kFull, maybe);
  if ((threadIdx.x & 31) == 0 && i < n_rays) flags[i >> 5] = bits;
  if (COUNT) ct.add_to(counter);
}

// The reference's start for the rays minarg_fused_kernel flagged: one
// thread a word of flags (32 rays); for each flagged ray whose row 0
// accepts it above BIG, argmin_start.cuh's scan and K2's fetch of its
// winner replace the kernel's outputs.
__global__ void __launch_bounds__(kBlock)
start_kernel(const float* __restrict__ rays8, const float4* __restrict__ tri,
             const unsigned* __restrict__ flags, Rows5 out, int n_rays,
             int n_tris) {
  const int w = blockIdx.x * kBlock + threadIdx.x;
  if (w >= (n_rays + 31) / 32) return;
  for (unsigned bits = flags[w]; bits; bits &= bits - 1) {
    const int i = 32 * w + __ffs(bits) - 1;
    const float px = rays8[i], py = rays8[n_rays + i];
    const float pz = rays8[2 * n_rays + i], dx = rays8[3 * n_rays + i];
    const float dy = rays8[4 * n_rays + i], dz = rays8[5 * n_rays + i];
    if (row0_above_big(tri, px, py, pz, dx, dy, dz))
      write_fetch(tri, reference_scan(tri, n_tris, px, py, pz, dx, dy, dz),
                  i, out);
  }
}

template <bool COUNT>
int launch(const float* rays8, const float* tri_pack, const float* sub,
           Rows5 out, void* flags, int n_rays, int n_tris, int coop_max,
           void* counter, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tri_pack) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  auto* words = static_cast<unsigned*>(flags);
  minarg_fused_kernel<COUNT><<<grid, kBlock, 0, st>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack),
      reinterpret_cast<const float4*>(sub), out, words, n_rays, n_tris,
      coop_max, static_cast<unsigned long long*>(counter));
  const int n_words = (n_rays + 31) / 32;
  start_kernel<<<(n_words + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack), words, out, n_rays,
      n_tris);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_minarg_fused(const float* rays8, const float* tri_pack,
                                const float* sub, float* t_out, float* nx,
                                float* ny, float* nz, float* m, void* flags,
                                int n_rays, int n_tris, int coop_max,
                                void* stream) {
  return launch<false>(rays8, tri_pack, sub, Rows5{t_out, nx, ny, nz, m},
                       flags, n_rays, n_tris, coop_max, nullptr, stream);
}

extern "C" int ptx_minarg_fused_count(const float* rays8,
                                      const float* tri_pack, const float* sub,
                                      float* t_out, float* nx, float* ny,
                                      float* nz, float* m, void* flags,
                                      int n_rays, int n_tris, int coop_max,
                                      void* counter, void* stream) {
  return launch<true>(rays8, tri_pack, sub, Rows5{t_out, nx, ny, nz, m},
                      flags, n_rays, n_tris, coop_max, counter, stream);
}

extern "C" int ptx_minarg_fused_simt(const float* rays8,
                                     const float* tri_pack, float* t_out,
                                     float* nx, float* ny, float* nz,
                                     float* m, int n_rays, int n_tris,
                                     void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  minarg_fused_simt_kernel<<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      rays8, reinterpret_cast<const float4*>(tri_pack),
      Rows5{t_out, nx, ny, nz, m}, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
