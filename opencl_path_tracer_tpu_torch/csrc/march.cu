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
// float32 operations more. The first kernel (march_simt_kernel below, over
// march_visit.cuh) ran everything on the float32 cores, about 125
// instructions per test. This one (march_mma.cuh) runs the E products
// on the tensor cores (mma.sync, bf16 in, float32 sums) and decides each
// edge test from them only outside a certified margin, recomputing the
// float32 chain inside it, so its outputs are the first kernel's bit for
// bit. One CUDA block of 128 lanes (4 warps of 32) lies in one tr-block
// and walks its list; dummy visits are skipped. The features come in as
// the (32, n) bf16 rows the caller built (plucker_feat). The block's
// set-up and the visit are march_mma.cuh's mma_prologue and mma_visit,
// which K19 (flat.cu) and K20 (lazy.cu) run too.
//
// Entry points: ptx_march (the kernel the wrapper launches);
// ptx_march_count (the same kernel, also adding to *counter the edge
// tests the margin sent to the chain); ptx_march_simt (the first kernel,
// kept to hold this one against whole launches and to time the two in
// turns; no wrapper on a render path reaches either of the last two).

#include "march_mma.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kMarchLanes)
march_simt_kernel(const int* __restrict__ clist,
                  const float* __restrict__ rays8,
                  const uint16_t* __restrict__ feat,
                  const uint16_t* __restrict__ trig,
                  const float* __restrict__ tric, float* __restrict__ out,
                  int n, int K, int tr, int cs) {
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

template <bool COUNT>
__global__ void __launch_bounds__(kMarchLanes, 3)
march_mma_kernel(const int* __restrict__ clist,
                 const float* __restrict__ rays8,
                 const uint16_t* __restrict__ feat,
                 const uint16_t* __restrict__ trig,
                 const float* __restrict__ tric, float* __restrict__ out,
                 int n, int K, int tr, int cs,
                 unsigned long long* __restrict__ counter) {
  __shared__ MmaShared sh;
  const size_t nn = n;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kMarchLanes;
  const int blk = static_cast<int>(b0 / tr);
  MmaBlock m;
  mma_prologue(sh, rays8, feat, nn, b0, m);
  MarchBest b{kBig, 0.f, 0.f, false};
  unsigned long long cnt = 0;
  for (int u = 0; u < K; ++u) {
    const int cid = clist[static_cast<size_t>(blk) * K + u];
    if (cid < 0) continue;
    if (mma_visit<COUNT>(sh, trig, tric, cid, cs, m, b, cnt)) b.pend = 1.f;
  }
  store_rows(out, nn, b0 + m.ol, b, tric, 0.f, 0.f, 0.f, 0.f);
  if (COUNT && cnt) atomicAdd(counter, cnt);
}

cudaError_t check_args(const void* trig, const float* tric, int n, int K,
                       int tr, int cs) {
  if (tr <= 0 || tr % kMarchLanes || n % tr || K <= 0 || cs <= 0 ||
      cs % kMarchTile || cs % kMmaTile)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(trig) % 16 ||
      reinterpret_cast<uintptr_t>(tric) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

extern "C" int ptx_march(const int* clist, const float* rays8, const void* feat,
                         const void* trig, const float* tric, float* out,
                         int n, int K, int tr, int cs, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n, K, tr, cs);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  march_mma_kernel<false><<<n / kMarchLanes, kMarchLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat),
      static_cast<const uint16_t*>(trig), tric, out, n, K, tr, cs, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptx_march_count(const int* clist, const float* rays8,
                               const void* feat, const void* trig,
                               const float* tric, float* out, int n, int K,
                               int tr, int cs, void* counter, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n, K, tr, cs);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  march_mma_kernel<true><<<n / kMarchLanes, kMarchLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat),
      static_cast<const uint16_t*>(trig), tric, out, n, K, tr, cs,
      static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptx_march_simt(const int* clist, const float* rays8,
                              const void* feat, const void* trig,
                              const float* tric, float* out, int n, int K,
                              int tr, int cs, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n, K, tr, cs);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  march_simt_kernel<<<n / kMarchLanes, kMarchLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat),
      static_cast<const uint16_t*>(trig), tric, out, n, K, tr, cs);
  return static_cast<int>(cudaGetLastError());
}
