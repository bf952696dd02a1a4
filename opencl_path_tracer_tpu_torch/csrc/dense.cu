// K4: dense nearest hit per ray with the winner's index and attributes.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// intersect_kernel.py::_kernel (launched by _run, the exact intersector
// behind pallas_first_intersect and the fused pipeline's rotating exact
// slice).
//
// What it computes: K1's (t, index) by the loop of nearest.cuh, then the
// winner's normal and material from its pack row. On the TPU the
// attributes ride a one-hot sum per chunk, which turns -0.0 into +0.0
// (reproduced by `+ 0.0f`, never folded under --fmad=false); a miss
// keeps index 0, so miss lanes carry row 0's attributes, the TPU's latch
// of the first row of the first block.
//
// Two layouts of the six output rows, each row `out_stride` floats apart:
//   hit_rows == 0: [t (BIG on a miss), index, nx, ny, nz, mati];
//   hit_rows == 1: [t (-1 on a miss), nx, ny, nz, mati, 0], the fused
//   pipeline's hit rows with pending cleared, written straight into the
//   exact slice's columns of the (6, N) rows K13b produced.
//
// What bounds it on the H100: operations, as K1 (about 48 float32
// operations per (ray, triangle) pair), plus 24 bytes written per ray.
// The rays are read in place through a row stride, so the fused
// pipeline's column slice of its (8, N) ray rows needs no copy.

#include "nearest.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kBlock)
dense_kernel(const float* __restrict__ rays8, int ray_stride,
             const float4* __restrict__ tri, float* __restrict__ out,
             int out_stride, int hit_rows, int n_rays, int n_tris) {
  __shared__ float4 tile[kTile * 4];
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
  const Nearest best =
      nearest_triangle(tile, tri, n_tris, live, px, py, pz, dx, dy, dz);
  if (!live) return;
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best.g * kTriCols;
  const float nx = __fadd_rn(row[0], 0.0f);
  const float ny = __fadd_rn(row[1], 0.0f);
  const float nz = __fadd_rn(row[2], 0.0f);
  const float m = __fadd_rn(row[16], 0.0f);
  const size_t os = static_cast<size_t>(out_stride);
  if (hit_rows) {
    out[i] = best.t < kBig ? best.t : -1.0f;
    out[os + i] = nx;
    out[2 * os + i] = ny;
    out[3 * os + i] = nz;
    out[4 * os + i] = m;
    out[5 * os + i] = 0.0f;
  } else {
    out[i] = best.t;
    out[os + i] = (float)best.g;
    out[2 * os + i] = nx;
    out[3 * os + i] = ny;
    out[4 * os + i] = nz;
    out[5 * os + i] = m;
  }
}

}  // namespace

extern "C" int ptx_dense(const float* rays8, int ray_stride,
                         const float* tri_pack, float* out, int out_stride,
                         int hit_rows, int n_rays, int n_tris, void* stream) {
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  dense_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, reinterpret_cast<const float4*>(tri_pack), out,
      out_stride, hit_rows, n_rays, n_tris);
  return static_cast<int>(cudaGetLastError());
}
