// K18: the block march.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// march_kernel.py::_march_kernel (launched by _run_march).
//
// What it computes. The lanes come sorted by (direction octant, origin
// Morton cell) in blocks of tr; block b visits the K clusters
// clist[b K .. b K + K - 1] (-1 is a dummy visit, which changes nothing:
// the TPU kernel merges it with found = false). Each visit is
// march_visit.cuh's; a lane starts from a miss (t = BIG, g = 0) and keeps
// the (t, g) lexicographic minimum over the visits' hits, and pend is
// set when any visit left it pending. Output: seven rows (t, nx, ny, nz,
// mati, g, pend) of n float32; nx..mati are tric's row g + 0.0 when the
// lane found a hit, else 0.
//
// What bounds it on the H100: operations. Per (lane, triangle) test of a
// real visit 3 x 18 multiply-adds for E (the TPU ran them on its matrix
// unit; the bound charges them at the bf16 tensor-core rate) and about 26
// float32 operations more; this first kernel runs everything on the
// float32 cores. One CUDA block of 128 lanes lies in one tr-block and
// walks its list; dummy visits are skipped. The features come in as the
// (32, n) bf16 rows the caller built (plucker_feat).

#include "march_visit.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kMarchLanes)
march_kernel(const int* __restrict__ clist, const float* __restrict__ rays8,
             const uint16_t* __restrict__ feat,
             const uint16_t* __restrict__ trig,
             const float* __restrict__ tric, float* __restrict__ out, int n,
             int K, int tr, int cs) {
  __shared__ MarchShared sh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kMarchLanes + threadIdx.x;
  const int blk = static_cast<int>(i / tr);
  const MarchLane L = load_lane(rays8, feat, n, i);
  MarchBest b{kBig, 0.f, 0.f, false};
  for (int u = 0; u < K; ++u) {
    const int cid = clist[static_cast<size_t>(blk) * K + u];
    if (cid < 0) continue;
    if (march_visit(sh, trig, tric, cid, cs, L, b)) b.pend = 1.f;
  }
  store_rows(out, n, i, b, tric, 0.f, 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" int ptx_march(const int* clist, const float* rays8, const void* feat,
                         const void* trig, const float* tric, float* out,
                         int n, int K, int tr, int cs, void* stream) {
  if (n <= 0) return 0;
  if (tr <= 0 || tr % kMarchLanes || n % tr || K <= 0 || cs <= 0 ||
      cs % kMarchTile)
    return static_cast<int>(cudaErrorInvalidValue);
  march_kernel<<<n / kMarchLanes, kMarchLanes, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat),
      static_cast<const uint16_t*>(trig), tric, out, n, K, tr, cs);
  return static_cast<int>(cudaGetLastError());
}
