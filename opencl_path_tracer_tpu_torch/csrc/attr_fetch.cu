// K11: the winners' attributes, fetched once per ray at the end of the
// pair intersector.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// pair_mxu.py::_attr_fetch_kernel (launched by fetch_attrs).
//
// What it computes, per ray with winning cluster-ordered triangle g:
// columns 0, 1, 2 and 16 (the face normal and the material) of row g of
// tric, each + 0.0f (__fadd_rn, never folded: the TPU's one-hot matmul
// over the exact bf16 3-split of the row turns -0.0 into +0.0); zeros
// where g < 0 (the winner came from the seed or the dense tail). The
// TPU sorted the rays by cluster and fetched with a visit-list matmul,
// which only its matrix unit needed; the values are the same.
//
// What bounds it on the H100: bytes. Per ray it reads g and writes four
// floats; the gathered rows come from a table of a few MB that stays in
// L2. One thread per ray.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTricCols = 24;

__global__ void __launch_bounds__(kBlock)
attr_fetch_kernel(const float* __restrict__ g, const float* __restrict__ tric,
                  float* __restrict__ nx, float* __restrict__ ny,
                  float* __restrict__ nz, float* __restrict__ m, int n_rays,
                  int n_rows) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float gf = g[i];
  if (!(gf >= 0.0f) || gf >= static_cast<float>(n_rows)) {
    nx[i] = ny[i] = nz[i] = m[i] = 0.0f;
    return;
  }
  const float* r = tric + static_cast<size_t>(gf) * kTricCols;
  nx[i] = __fadd_rn(r[0], 0.0f);
  ny[i] = __fadd_rn(r[1], 0.0f);
  nz[i] = __fadd_rn(r[2], 0.0f);
  m[i] = __fadd_rn(r[16], 0.0f);
}

}  // namespace

extern "C" int ptx_attr_fetch(const float* g, const float* tric, float* nx,
                              float* ny, float* nz, float* m, int n_rays,
                              int n_rows, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  attr_fetch_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      g, tric, nx, ny, nz, m, n_rays, n_rows);
  return static_cast<int>(cudaGetLastError());
}
