// K2: the face normal and material of the K1 winner.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_refine1_kernel (launched by _run_refine1).
//
// On the TPU the fetch is a one-hot matmul over an exact bf16 three-way
// split of the triangle table; here it is an indexed load of the float32
// row, which gives the same bits. The one-hot sum turns -0.0 into +0.0,
// which the `+ 0.0f` below (__fadd_rn, never folded) reproduces.
// t = -1 where t1 >= BIG (a miss); the miss lanes then carry triangle 0's
// attributes, as on the TPU.
//
// What bounds it on the H100: bytes. It reads two floats per ray and a
// gathered row that stays in L2 (the pack is at most a few hundred KB),
// and writes five floats per ray; one thread per ray.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTriCols = 24;
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kBlock)
refine1_kernel(const float* __restrict__ t1, const float* __restrict__ g1,
               const float* __restrict__ tri, float* __restrict__ t_out,
               float* __restrict__ nx, float* __restrict__ ny,
               float* __restrict__ nz, float* __restrict__ m, int n_rays,
               int n_tris) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  int g = static_cast<int>(g1[i]);
  g = g < 0 ? 0 : (g >= n_tris ? n_tris - 1 : g);
  const float* row = tri + static_cast<size_t>(g) * kTriCols;
  const float t = t1[i];
  t_out[i] = t < kBig ? t : -1.0f;
  nx[i] = __fadd_rn(row[0], 0.0f);
  ny[i] = __fadd_rn(row[1], 0.0f);
  nz[i] = __fadd_rn(row[2], 0.0f);
  m[i] = __fadd_rn(row[16], 0.0f);
}

}  // namespace

extern "C" int ptx_refine1(const float* t1, const float* g1,
                           const float* tri_pack, float* t_out, float* nx,
                           float* ny, float* nz, float* m, int n_rays,
                           int n_tris, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  refine1_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      t1, g1, tri_pack, t_out, nx, ny, nz, m, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
