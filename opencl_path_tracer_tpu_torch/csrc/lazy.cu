// K20: the lazy march of the lazy-certification wavefront.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// lazy_march.py::_lazy_kernel (launched by run_lazy_march).
//
// What it computes. K18's grid (block b of tr sorted lanes visits
// clist[b K .. b K + K - 1], -1 a dummy), started from the six rows the
// wavefront carries (t, nx, ny, nz, mati, g) with pend 0, merging each
// visit as K18 does (march_visit.cuh). It also keeps each lane's visited
// bitmask, cw uint32 words (bit c % 32 of word c / 32 for cluster c):
// a real visit that did not leave the lane pending sets cluster cid's
// bit. Output: the seven rows and the (cw, n) mask.
//
// What bounds it on the H100: operations, as K18. The first kernel
// (lazy_simt_kernel below, over march_visit.cuh) ran every product on
// the float32 cores, and its early-exit edge loop diverged on the lazy
// wavefront's mixed-bounce lanes. This one runs K18's tensor-core visit
// (march_mma.cuh, the same bits): each thread owns one lane at the end of
// a visit (its exact tests, its running best, started from rows0) and
// that lane's cw mask words (cw <= kMaxCw, so at most 1,024 clusters),
// kept in shared memory as [cw][128] beside the visit's staging (a
// register array indexed by cid would need an unrolled compare per word
// on top of the fragments). Only the owning thread loads, sets and
// writes back its lane's words, so the mask needs no barrier.
//
// Entry points: ptx_lazy (the kernel the wrapper launches); ptx_lazy_count
// (the same, also adding to *counter the edge tests the margin sent to
// the float32 chain); ptx_lazy_simt (the first kernel, kept to hold this
// one against whole launches and to time the two in turns; no wrapper on
// a render path reaches either of the last two).

#include "march_mma.cuh"

namespace {

using namespace ptx;

constexpr int kMaxCw = 32;

__global__ void __launch_bounds__(kMarchLanes)
lazy_simt_kernel(const int* __restrict__ clist,
                 const float* __restrict__ rays8,
                 const uint16_t* __restrict__ feat,
                 const float* __restrict__ rows0,
                 const uint32_t* __restrict__ vis,
                 const uint16_t* __restrict__ trig,
                 const float* __restrict__ tric, float* __restrict__ out,
                 uint32_t* __restrict__ vis_out, int n, int K, int tr, int cs,
                 int cw) {
  __shared__ MarchShared sh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kMarchLanes + threadIdx.x;
  const size_t nn = n;
  const int blk = static_cast<int>(i / tr);
  const MarchLane L = load_lane(rays8, feat, nn, i);
  MarchBest b{rows0[i], rows0[5 * nn + i], 0.f, false};
  uint32_t w[kMaxCw];
#pragma unroll
  for (int k = 0; k < kMaxCw; ++k) w[k] = k < cw ? vis[k * nn + i] : 0u;
  for (int u = 0; u < K; ++u) {
    const int cid = clist[static_cast<size_t>(blk) * K + u];
    if (cid < 0) continue;
    if (march_visit(sh, trig, tric, cid, cs, L, b)) {
      b.pend = 1.f;
    } else {
      const int word = cid >> 5;
      const uint32_t bit = 1u << (cid & 31);
#pragma unroll
      for (int k = 0; k < kMaxCw; ++k)
        if (k == word) w[k] |= bit;
    }
  }
  store_rows(out, nn, i, b, tric, rows0[nn + i], rows0[2 * nn + i],
             rows0[3 * nn + i], rows0[4 * nn + i]);
#pragma unroll
  for (int k = 0; k < kMaxCw; ++k)
    if (k < cw) vis_out[k * nn + i] = w[k];
}

template <bool COUNT>
__global__ void __launch_bounds__(kMarchLanes, 3)
lazy_mma_kernel(const int* __restrict__ clist, const float* __restrict__ rays8,
                const uint16_t* __restrict__ feat,
                const float* __restrict__ rows0,
                const uint32_t* __restrict__ vis,
                const uint16_t* __restrict__ trig,
                const float* __restrict__ tric, float* __restrict__ out,
                uint32_t* __restrict__ vis_out, int n, int K, int tr, int cs,
                int cw, unsigned long long* __restrict__ counter) {
  __shared__ MmaShared sh;
  extern __shared__ uint32_t words[];   // [cw][kMarchLanes]
  const size_t nn = n;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kMarchLanes;
  const int blk = static_cast<int>(b0 / tr);
  MmaBlock m;
  mma_prologue(sh, rays8, feat, nn, b0, m);
  const size_t i = b0 + m.ol;
  uint32_t* w = words + m.ol;
  for (int k = 0; k < cw; ++k) w[k * kMarchLanes] = vis[k * nn + i];
  MarchBest b{rows0[i], rows0[5 * nn + i], 0.f, false};
  unsigned long long cnt = 0;
  for (int u = 0; u < K; ++u) {
    const int cid = clist[static_cast<size_t>(blk) * K + u];
    if (cid < 0) continue;
    if (mma_visit<COUNT>(sh, trig, tric, cid, cs, m, b, cnt))
      b.pend = 1.f;
    else
      w[(cid >> 5) * kMarchLanes] |= 1u << (cid & 31);
  }
  store_rows(out, nn, i, b, tric, rows0[nn + i], rows0[2 * nn + i],
             rows0[3 * nn + i], rows0[4 * nn + i]);
  for (int k = 0; k < cw; ++k) vis_out[k * nn + i] = w[k * kMarchLanes];
  if (COUNT && cnt) atomicAdd(counter, cnt);
}

cudaError_t check_args(const void* trig, const float* tric, int n, int K,
                       int tr, int cs, int cw) {
  if (tr <= 0 || tr % kMarchLanes || n % tr || K <= 0 || cs <= 0 ||
      cs % kMmaTile || cw <= 0 || cw > kMaxCw)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(trig) % 16 ||
      reinterpret_cast<uintptr_t>(tric) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <bool COUNT>
int launch_mma(const int* clist, const float* rays8, const void* feat,
               const float* rows0, const void* vis, const void* trig,
               const float* tric, float* out, void* vis_out, int n, int K,
               int tr, int cs, int cw, void* counter, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n, K, tr, cs, cw);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  lazy_mma_kernel<COUNT><<<n / kMarchLanes, kMarchLanes,
                           cw * kMarchLanes * sizeof(uint32_t),
                           static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat), rows0,
      static_cast<const uint32_t*>(vis), static_cast<const uint16_t*>(trig),
      tric, out, static_cast<uint32_t*>(vis_out), n, K, tr, cs, cw,
      static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_lazy(const int* clist, const float* rays8, const void* feat,
                        const float* rows0, const void* vis, const void* trig,
                        const float* tric, float* out, void* vis_out, int n,
                        int K, int tr, int cs, int cw, void* stream) {
  return launch_mma<false>(clist, rays8, feat, rows0, vis, trig, tric, out,
                           vis_out, n, K, tr, cs, cw, nullptr, stream);
}

extern "C" int ptx_lazy_count(const int* clist, const float* rays8,
                              const void* feat, const float* rows0,
                              const void* vis, const void* trig,
                              const float* tric, float* out, void* vis_out,
                              int n, int K, int tr, int cs, int cw,
                              void* counter, void* stream) {
  return launch_mma<true>(clist, rays8, feat, rows0, vis, trig, tric, out,
                          vis_out, n, K, tr, cs, cw, counter, stream);
}

extern "C" int ptx_lazy_simt(const int* clist, const float* rays8,
                             const void* feat, const float* rows0,
                             const void* vis, const void* trig,
                             const float* tric, float* out, void* vis_out,
                             int n, int K, int tr, int cs, int cw,
                             void* stream) {
  if (n <= 0) return 0;
  if (tr <= 0 || tr % kMarchLanes || n % tr || K <= 0 || cs <= 0 ||
      cs % kMarchTile || cw <= 0 || cw > kMaxCw)
    return static_cast<int>(cudaErrorInvalidValue);
  lazy_simt_kernel<<<n / kMarchLanes, kMarchLanes, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      clist, rays8, static_cast<const uint16_t*>(feat), rows0,
      static_cast<const uint32_t*>(vis), static_cast<const uint16_t*>(trig),
      tric, out, static_cast<uint32_t*>(vis_out), n, K, tr, cs, cw);
  return static_cast<int>(cudaGetLastError());
}
