// K3: nearest analytic-sphere hit per ray, with its outward normal and
// material.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sphere_kernel.py::_sphere_kernel (launched by _run_spheres), which bakes
// up to 64 spheres into the kernel as constants.
//
// Per (ray, sphere), in the reference's order (sphere_kernel.py:64-83):
//   b = p.d - d.c;  cc = (p.p - 2 p.c) + ccdot;  disc = b*b - cc
//   sq = sqrt(max(disc, 0));  t = -b - sq if that is > 0 else -b + sq
//   a hit needs disc > 0 and t > 0; a strict < keeps the lower index.
//   n = (p + t d - c) * inv_rad.
// ccdot = c.c - r^2 and inv_rad = 1/r are float32 constants from the
// host (sphere_kernel.py:121-128). Dot products are
// fma(a2, b2, fma(a0, b0, a1 * b1)); b*b - cc and p + t d are fused as in
// the reference; everything else rounds separately (--fmad=false).
// On a miss t = -1 and the normal and material are 0.
//
// What bounds it on the H100: bytes at two spheres (24 bytes read and 20
// written per ray against ~40 operations per sphere); operations from
// about eight spheres on. The sphere table sits in shared memory; one
// thread per ray keeps its best hit in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxSpheres = 64;
constexpr int kCols = 8;          // cx cy cz rad inv_rad ccdot mati 0
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, ay * by));
}

__global__ void __launch_bounds__(kBlock)
spheres_kernel(const float* __restrict__ rays8, const float* __restrict__ tab,
               float* __restrict__ t_out, float* __restrict__ nx_out,
               float* __restrict__ ny_out, float* __restrict__ nz_out,
               float* __restrict__ m_out, int n_rays, int n_spheres) {
  __shared__ float s_tab[kMaxSpheres * kCols];
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
  float best_t = kBig, bnx = 0.f, bny = 0.f, bnz = 0.f, bm = 0.f;
  for (int s = 0; s < n_spheres; ++s) {
    const float* c = s_tab + s * kCols;
    const float cx = c[0], cy = c[1], cz = c[2];
    const float b_half = p_dot_d - dot3(dx, dy, dz, cx, cy, cz);
    const float cc = (p_dot_p - 2.0f * dot3(px, py, pz, cx, cy, cz)) + c[5];
    const float disc = __fmaf_rn(b_half, b_half, -cc);
    const float sq = sqrtf(disc < 0.f ? 0.f : disc);
    const float t_near = -b_half - sq;
    const float t_far = -b_half + sq;
    const float t = t_near > 0.f ? t_near : t_far;
    if (disc > 0.f && t > 0.f && t < best_t) {
      best_t = t;
      bnx = (__fmaf_rn(dx, t, px) - cx) * c[4];
      bny = (__fmaf_rn(dy, t, py) - cy) * c[4];
      bnz = (__fmaf_rn(dz, t, pz) - cz) * c[4];
      bm = c[6];
    }
  }
  t_out[i] = best_t < kBig ? best_t : -1.0f;
  nx_out[i] = bnx;
  ny_out[i] = bny;
  nz_out[i] = bnz;
  m_out[i] = bm;
}

}  // namespace

extern "C" int ptx_spheres(const float* rays8, const float* table,
                           float* t_out, float* nx, float* ny, float* nz,
                           float* m, int n_rays, int n_spheres, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_spheres < 1 || n_spheres > kMaxSpheres) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  spheres_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, table, t_out, nx, ny, nz, m, n_rays, n_spheres);
  return static_cast<int>(cudaGetLastError());
}
