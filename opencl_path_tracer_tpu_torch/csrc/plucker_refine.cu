// K13b: the exact re-test of K13a's two candidates per ray.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_refine_kernel (launched by _run_refine).
//
// What it computes, per ray: each candidate's constants (the TPU fetches
// them with a one-hot bf16 matmul over an exact 3-way split of the
// table, which returns the float32 values with -0.0 turned into +0.0;
// here an indexed load of the float32 row plus `+ 0.0f`; an index past
// the table reads zeros, the TPU's padding), then K1's exact test. The
// first candidate that passes is K4's winner; a lane with no candidate,
// or with one spurious candidate and no second, is a confirmed miss;
// both failing with a second candidate present is PENDING (a third
// accepted triangle might win). Rows out: t (-1 on a miss or pending),
// nx, ny, nz, mati of the chosen candidate (the first's when neither
// passed), and pending as 0/1.
//
// What bounds it on the H100: bytes. It reads the ray (24 bytes), the
// candidates (16 bytes) and two gathered 68-byte rows that stay in L2
// (the table is tens of KB), and writes 24 bytes per ray; one thread
// per ray.

#include "nearest.cuh"

namespace {

using namespace ptx;

// Loads row g's 16 test constants (+ 0.0f) into c and returns its mati.
__device__ __forceinline__ float load_row(const float* __restrict__ tri,
                                          int g, int n_tris, float4* c) {
  if (g < 0 || g >= n_tris) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    return 0.f;
  }
  const float* row = tri + (size_t)g * kTriCols;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[k] = make_float4(__fadd_rn(row[4 * k], 0.f),
                       __fadd_rn(row[4 * k + 1], 0.f),
                       __fadd_rn(row[4 * k + 2], 0.f),
                       __fadd_rn(row[4 * k + 3], 0.f));
  }
  return __fadd_rn(row[16], 0.f);
}

__global__ void __launch_bounds__(kBlock)
plucker_refine_kernel(const float* __restrict__ rays8, int ray_stride,
                      const float* __restrict__ cand,
                      const float* __restrict__ tri, float* __restrict__ out,
                      int n_rays, int n_tris) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const size_t rs = static_cast<size_t>(ray_stride);
  const size_t n = static_cast<size_t>(n_rays);
  const float px = rays8[i], py = rays8[rs + i], pz = rays8[2 * rs + i];
  const float dx = rays8[3 * rs + i], dy = rays8[4 * rs + i],
              dz = rays8[5 * rs + i];
  const float t1 = cand[i], t2 = cand[2 * n + i];
  const int g1 = static_cast<int>(cand[n + i]);
  const int g2 = static_cast<int>(cand[3 * n + i]);
  float4 c1[4], c2[4];
  const float m1 = load_row(tri, g1, n_tris, c1);
  const float m2 = load_row(tri, g2, n_tris, c2);
  float te;
  const bool has1 = t1 < kBig, has2 = t2 < kBig;
  const bool v1 = exact_hit(c1, px, py, pz, dx, dy, dz, te) && has1;
  const bool v2 = exact_hit(c2, px, py, pz, dx, dy, dz, te) && has2;
  const bool use2 = !v1 && v2;
  const bool miss = !has1 || (!v1 && !has2);
  const bool pend = !v1 && !v2 && has2;
  const float4 nc = use2 ? c2[0] : c1[0];
  out[i] = (miss || pend) ? -1.0f : (use2 ? t2 : t1);
  out[n + i] = nc.x;
  out[2 * n + i] = nc.y;
  out[3 * n + i] = nc.z;
  out[4 * n + i] = use2 ? m2 : m1;
  out[5 * n + i] = pend ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int ptx_plucker_refine(const float* rays8, int ray_stride,
                                  const float* cand, const float* tri_pack,
                                  float* out, int n_rays, int n_tris,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  plucker_refine_kernel<<<grid, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, cand, tri_pack, out, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
