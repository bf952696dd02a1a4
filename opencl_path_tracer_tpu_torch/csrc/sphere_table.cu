// K3b: nearest analytic-sphere hit per ray over a sphere table of any
// size, with the winner's outward normal and material.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sphere_kernel.py::_sphere_table_kernel (launched by _run_sphere_table),
// which takes over from the baked K3 above 64 spheres.
//
// Table rows [cx cy cz rad inv_rad ccdot mati live], ccdot = c.c - r^2
// and inv_rad = 1/r in float32 from the host. Per (ray, sphere):
//   b = p.d - d.c;  cc = (p.p - 2 p.c) + ccdot;  disc = b*b - cc
//   t = -b - sqrt(max(disc, 0)) if that is > 0, else -b + sqrt(...)
//   a hit needs disc > 0, t > 0 and live > 0; a strict < over the table
//   in order keeps the lower index on ties (the TPU's min + argmin).
// Then the winner's row is fetched (on the TPU a one-hot matmul over a
// bf16 three-way split, exact; here an indexed load, with `+ 0.0f` for
// the one-hot sum's +0.0) and n = (p + t d - c) * inv_rad. On a miss
// t = -1 and the normal and material are 0. The rounding follows
// interpret-mode XLA on the CPU, found by probing it: each dot product
// is fma(a2, b2, fma(a0, b0, a1 * b1)), disc is fma(b, b, -cc) and
// p + t d is fma(d, t, p); everything else rounds separately
// (--fmad=false).
//
// What bounds it on the H100: operations at the many-light scene's 66
// spheres (about 19 float32 operations per (ray, sphere) pair against 24
// bytes read and 20 written per ray). One thread per ray with its best
// (t, index) in registers; the table sits in shared memory (2 KB at 66
// spheres) and is read by broadcast.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kCols = 8;
constexpr float kBig = 3.0e38f;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, ay * by));
}

__global__ void __launch_bounds__(kBlock)
sphere_table_kernel(const float* __restrict__ rays8,
                    const float* __restrict__ tab, float* __restrict__ t_out,
                    float* __restrict__ nx_out, float* __restrict__ ny_out,
                    float* __restrict__ nz_out, float* __restrict__ m_out,
                    int n_rays, int n_spheres) {
  extern __shared__ float s_tab[];
  for (int k = threadIdx.x; k < n_spheres * kCols; k += kBlock) {
    s_tab[k] = tab[k];
  }
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float px = rays8[i], py = rays8[n_rays + i], pz = rays8[2 * n_rays + i];
  const float dx = rays8[3 * n_rays + i], dy = rays8[4 * n_rays + i],
              dz = rays8[5 * n_rays + i];
  const float p_dot_d = dot3(px, py, pz, dx, dy, dz);
  const float p_dot_p = dot3(px, py, pz, px, py, pz);
  float best_t = kBig;
  int best_s = 0;
  for (int s = 0; s < n_spheres; ++s) {
    const float* c = s_tab + s * kCols;
    const float b_half = p_dot_d - dot3(dx, dy, dz, c[0], c[1], c[2]);
    const float cc =
        (p_dot_p - 2.0f * dot3(px, py, pz, c[0], c[1], c[2])) + c[5];
    const float disc = __fmaf_rn(b_half, b_half, -cc);
    const float sq = sqrtf(disc < 0.f ? 0.f : disc);
    const float t_near = -b_half - sq;
    const float t_far = -b_half + sq;
    const float t = t_near > 0.f ? t_near : t_far;
    if (disc > 0.f && t > 0.f && c[7] > 0.f && t < best_t) {
      best_t = t;
      best_s = s;
    }
  }
  const bool hit = best_t < kBig;
  const float* row = s_tab + best_s * kCols;
  const float safe_t = hit ? best_t : 0.f;
  const float inv_r = __fadd_rn(row[4], 0.0f);
  const float nx = (__fmaf_rn(dx, safe_t, px) - __fadd_rn(row[0], 0.0f)) * inv_r;
  const float ny = (__fmaf_rn(dy, safe_t, py) - __fadd_rn(row[1], 0.0f)) * inv_r;
  const float nz = (__fmaf_rn(dz, safe_t, pz) - __fadd_rn(row[2], 0.0f)) * inv_r;
  t_out[i] = hit ? best_t : -1.0f;
  nx_out[i] = hit ? nx : 0.f;
  ny_out[i] = hit ? ny : 0.f;
  nz_out[i] = hit ? nz : 0.f;
  m_out[i] = hit ? __fadd_rn(row[6], 0.0f) : 0.f;
}

}  // namespace

extern "C" int ptx_sphere_table(const float* rays8, const float* table,
                                float* t_out, float* nx, float* ny, float* nz,
                                float* m, int n_rays, int n_spheres,
                                void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_spheres) * kCols * sizeof(float);
  if (n_spheres < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        sphere_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  sphere_table_kernel<<<grid, kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rays8, table, t_out, nx, ny, nz, m, n_rays, n_spheres);
  return static_cast<int>(cudaGetLastError());
}
