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
//
// What the design does about it. One thread per ray fills the card only
// when there are enough rays: 16,384 lanes make 64 blocks of 256 on 132
// SMs. The wrapper then splits the triangles into `splits` chunks of
// `chunk` (a multiple of kTile): block (x, s) runs nearest.cuh's loop over
// chunk s for ray block x and writes its (t, index) to a workspace, and a
// second kernel combines the chunks of each ray in chunk order with a
// strict <. Every (ray, triangle) test rounds as in the single loop, and a
// first-index minimum per chunk, combined in order with a strict <, is
// the whole loop's lexicographic (t, index) minimum, so the bits do not
// depend on the split. A chunk that misses keeps t = BIG and never wins,
// so a miss stays index 0. With splits == 1 the first kernel writes the
// outputs itself: one launch and no workspace.

#include "nearest.cuh"

namespace {

using namespace ptx;

// The winner's attributes from its pack row, `+ 0.0f` each, and the six
// output rows in either layout.
__device__ __forceinline__ void write_hit(const float4* __restrict__ tri,
                                          float* __restrict__ out,
                                          size_t os, int hit_rows, int i,
                                          Nearest best) {
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best.g * kTriCols;
  const float nx = __fadd_rn(row[0], 0.0f);
  const float ny = __fadd_rn(row[1], 0.0f);
  const float nz = __fadd_rn(row[2], 0.0f);
  const float m = __fadd_rn(row[16], 0.0f);
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

// kSplit == false: the whole pack, outputs written here (gridDim.y == 1).
// kSplit == true: chunk blockIdx.y of `chunk` triangles, its (t, index)
// written to part_t / part_g at [blockIdx.y * n_rays + ray].
template <bool kSplit>
__global__ void __launch_bounds__(kBlock)
dense_kernel(const float* __restrict__ rays8, int ray_stride,
             const float4* __restrict__ tri, float* __restrict__ out,
             int out_stride, int hit_rows, int n_rays, int n_tris, int chunk,
             float* __restrict__ part_t, int* __restrict__ part_g) {
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
  if (kSplit) {
    const int lo = blockIdx.y * chunk;
    const Nearest best = nearest_triangle(
        tile, tri + (size_t)lo * (kTriCols / 4), min(chunk, n_tris - lo),
        live, px, py, pz, dx, dy, dz);
    if (!live) return;
    const size_t k = (size_t)blockIdx.y * n_rays + i;
    part_t[k] = best.t;
    part_g[k] = best.g + lo;
    return;
  }
  const Nearest best =
      nearest_triangle(tile, tri, n_tris, live, px, py, pz, dx, dy, dz);
  if (!live) return;
  write_hit(tri, out, static_cast<size_t>(out_stride), hit_rows, i, best);
}

// The chunks of each ray in chunk order, strict <, then the attributes.
__global__ void __launch_bounds__(kBlock)
combine_kernel(const float4* __restrict__ tri, float* __restrict__ out,
               int out_stride, int hit_rows, int n_rays, int splits,
               const float* __restrict__ part_t,
               const int* __restrict__ part_g) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  Nearest best{kBig, 0};
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const size_t k = (size_t)s * n_rays + i;
    const float t = part_t[k];
    const int g = part_g[k];
    if (t < best.t) {
      best.t = t;
      best.g = g;
    }
  }
  write_hit(tri, out, static_cast<size_t>(out_stride), hit_rows, i, best);
}

}  // namespace

// splits == 1: one launch, workspace unused (may be null). splits > 1:
// chunk * (splits - 1) < n_tris <= chunk * splits, chunk a multiple of
// kTile, and workspace holds 2 * splits * n_rays 32-bit words.
extern "C" int ptx_dense(const float* rays8, int ray_stride,
                         const float* tri_pack, float* out, int out_stride,
                         int hit_rows, int n_rays, int n_tris, int splits,
                         int chunk, float* workspace, void* stream) {
  if (n_rays <= 0) return 0;
  if (splits < 1 || (splits > 1 && (chunk <= 0 || chunk % kTile ||
                                    (long long)chunk * (splits - 1) >= n_tris ||
                                    (long long)chunk * splits < n_tris ||
                                    workspace == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tri = reinterpret_cast<const float4*>(tri_pack);
  const int blocks = (n_rays + kBlock - 1) / kBlock;
  if (splits == 1) {
    dense_kernel<false><<<blocks, kBlock, 0, st>>>(
        rays8, ray_stride, tri, out, out_stride, hit_rows, n_rays, n_tris,
        n_tris, nullptr, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  float* part_t = workspace;
  int* part_g = reinterpret_cast<int*>(workspace + (size_t)splits * n_rays);
  dense_kernel<true><<<dim3(blocks, splits), kBlock, 0, st>>>(
      rays8, ray_stride, tri, out, out_stride, hit_rows, n_rays, n_tris,
      chunk, part_t, part_g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  combine_kernel<<<blocks, kBlock, 0, st>>>(tri, out, out_stride, hit_rows,
                                            n_rays, splits, part_t, part_g);
  return static_cast<int>(cudaGetLastError());
}
