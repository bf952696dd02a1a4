// K8: the smooth refine. After K1's (t, g), the winner's face normal and
// material, and its vertex normals interpolated at the hit point.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// shading_kernel.py::_smooth_refine_kernel (launched by
// _run_smooth_refine).
//
// On the TPU both rows (the face row of the triangle pack and the
// 17-column shading row) come out of one one-hot matmul over exact bf16
// three-way splits; here they are indexed loads of the float32 rows,
// which give the same bits, with `+ 0.0f` (__fadd_rn, never folded)
// where the one-hot sum turns -0.0 into +0.0. The arithmetic is the
// interpret-mode kernel's, with its fused multiply-adds at the same
// places (__fmaf_rn; the file builds with --fmad=false): p = fma(d, t, o),
// u = fma(pz, gu2, fma(px, gu0, py * gu1)) + u0, the blends
// fma(v, n3, fma(w, n1, u * n2)) and |n|^2 likewise. The normal is
// scaled by 1 / sqrt(|n|^2), both correctly rounded (XLA's rsqrt on the
// CPU is an approximation, an ulp or two away). On a miss (t1 >= BIG)
// t = -1 and the face row is triangle 0's, as K1's miss index is 0.
//
// What bounds it on the H100: bytes. Per ray it reads six ray floats,
// t1 and g1, and writes five floats; the two gathered rows come from
// tables of a few hundred KB that stay in L2. One thread per ray.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTriCols = 24;
constexpr int kShadeCols = 17;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float fetch(const float* row, int k) {
  return __fadd_rn(row[k], 0.0f);
}

// dot(p, s[b..b+2]) + s[off] with the reference's contraction.
__device__ __forceinline__ float dot4(const float* s, int b, int off,
                                      float px, float py, float pz) {
  const float a = __fmul_rn(py, fetch(s, b + 1));
  const float c = __fmaf_rn(px, fetch(s, b), a);
  return __fadd_rn(__fmaf_rn(pz, fetch(s, b + 2), c), fetch(s, off));
}

__device__ __forceinline__ float blend(const float* s, int k, float w,
                                       float u, float v) {
  const float a = __fmul_rn(u, fetch(s, 11 + k));
  return __fmaf_rn(v, fetch(s, 14 + k), __fmaf_rn(w, fetch(s, 8 + k), a));
}

__global__ void __launch_bounds__(kBlock)
smooth_refine_kernel(const float* __restrict__ rays8,
                     const float* __restrict__ t1,
                     const float* __restrict__ g1,
                     const float* __restrict__ tri,
                     const float* __restrict__ shade,
                     float* __restrict__ t_out, float* __restrict__ nx,
                     float* __restrict__ ny, float* __restrict__ nz,
                     float* __restrict__ m, int n_rays, int n_tris) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  int g = static_cast<int>(g1[i]);
  g = g < 0 ? 0 : (g >= n_tris ? n_tris - 1 : g);
  const float* row = tri + static_cast<size_t>(g) * kTriCols;
  const float* s = shade + static_cast<size_t>(g) * kShadeCols;
  const float t = t1[i];
  const bool hit = t < kBig;
  const float safe_t = hit ? t : 0.0f;
  const float px = __fmaf_rn(rays8[3 * n_rays + i], safe_t, rays8[i]);
  const float py =
      __fmaf_rn(rays8[4 * n_rays + i], safe_t, rays8[n_rays + i]);
  const float pz =
      __fmaf_rn(rays8[5 * n_rays + i], safe_t, rays8[2 * n_rays + i]);
  const float u = dot4(s, 0, 6, px, py, pz);
  const float v = dot4(s, 3, 7, px, py, pz);
  const float w = __fsub_rn(__fsub_rn(1.0f, u), v);
  const float sx = blend(s, 0, w, u, v);
  const float sy = blend(s, 1, w, u, v);
  const float sz = blend(s, 2, w, u, v);
  const float nn2 =
      __fmaf_rn(sz, sz, __fmaf_rn(sx, sx, __fmul_rn(sy, sy)));
  const bool big = nn2 > 1e-12f;
  const bool use = hit && big;
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(big ? nn2 : 1.0f));
  t_out[i] = hit ? t : -1.0f;
  nx[i] = use ? __fmul_rn(sx, inv) : fetch(row, 0);
  ny[i] = use ? __fmul_rn(sy, inv) : fetch(row, 1);
  nz[i] = use ? __fmul_rn(sz, inv) : fetch(row, 2);
  m[i] = fetch(row, 16);
}

}  // namespace

extern "C" int ptx_smooth_refine(const float* rays8, const float* t1,
                                 const float* g1, const float* tri_pack,
                                 const float* shading_pack, float* t_out,
                                 float* nx, float* ny, float* nz, float* m,
                                 int n_rays, int n_tris, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  smooth_refine_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rays8, t1, g1, tri_pack, shading_pack, t_out, nx, ny, nz, m, n_rays,
      n_tris);
  return static_cast<int>(cudaGetLastError());
}
