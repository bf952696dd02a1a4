// K19: the flat visit list of the 'flat' accel.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// flat_march.py::_flat_kernel (launched by _run_flat).
//
// What it computes. A flat list of V visits (vb, vc), vb non-decreasing:
// tr-block vb[v] visits cluster vc[v] (-1: a dummy, no work). Block b's
// visits are the segment [offs[b], offs[b + 1]) of the list (offs from a
// search of vb). A lane starts from its round-0 rows (t, nx, ny, nz,
// mati, g, pend of K18 round 0, pend included) and merges its segment's
// visits as K18 does (march_visit.cuh). Output: the seven rows. On the
// TPU a block that got no visit under the list's capacity is never
// written; here it keeps its round-0 rows.
//
// What bounds it on the H100: operations, as K18: per (lane, triangle)
// test of a real visit 3 x 18 bf16 multiply-adds and about 26 float32
// operations. The TPU held the list in scalar memory and could not
// compile it at 1080p; here it lives in global memory. The first kernel
// (flat_simt_kernel below: one CUDA block per 128 lanes walking its
// whole segment over march_visit.cuh) ran at 0.38x K18's rate: the
// float32-core visit, and segments from none to every cluster, so that
// the grid could end on a few long blocks. This one runs K18's
// tensor-core visit (march_mma.cuh, the same bits) over chunks of at most
// S real visits (flat_march.CHUNK) of one block's segment, one CUDA block
// of 128 lanes per (chunk, 128 lanes of the tr-block), the chunks of the
// longest segments first, so the long segments start early and no chunk
// runs long alone. The caller builds the work list on the device
// (flat_march.flat_chunks): the real visits in list order (vcr) and, per
// item, the tr-block (-1: a surplus item, which exits at once) and its
// range [first, end) of vcr.
//
// Visits merge by the (t, g) lexicographic minimum and pend by OR, so
// chunks merge in any order. Where a chunk's visits beat a lane's round-0
// (t, g), the chunk's best, a hit (t > 0, g >= 0), takes the 64-bit
// atomicMin of (bits(t) << 32) | bits(g) into best (all ones at the
// start): for such pairs the bits order as (t, g) does. The round-0 rows
// are never packed, so they may hold any floats. A pending visit sets
// pend. Then one pass per lane writes the seven rows: where best moved,
// its (t, g) and tric's row g (+ 0.0f), else the round-0 rows; pend 1
// where a chunk set it, else round 0's.
//
// Entry points: ptx_flat (the kernel the wrapper launches); ptx_flat_count
// (the same, also adding to *counter the edge tests the margin sent to
// the float32 chain); ptx_flat_simt (the first kernel, kept to hold this
// one against whole launches and to time the two in turns; no wrapper on
// a render path reaches either of the last two).

#include "march_mma.cuh"

namespace {

using namespace ptx;

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMarchLanes)
flat_simt_kernel(const int* __restrict__ offs, const int* __restrict__ vc,
                 const float* __restrict__ rays8,
                 const uint16_t* __restrict__ feat,
                 const float* __restrict__ rows0,
                 const uint16_t* __restrict__ trig,
                 const float* __restrict__ tric, float* __restrict__ out,
                 int n, int tr, int cs) {
  __shared__ MarchShared sh;
  const size_t i = static_cast<size_t>(blockIdx.x) * kMarchLanes + threadIdx.x;
  const size_t nn = n;
  const int blk = static_cast<int>(i / tr);
  const MarchLane L = load_lane(rays8, feat, nn, i);
  MarchBest b{rows0[i], rows0[5 * nn + i], rows0[6 * nn + i], false};
  for (int v = offs[blk]; v < offs[blk + 1]; ++v) {
    const int cid = vc[v];
    if (cid < 0) continue;
    if (march_visit(sh, trig, tric, cid, cs, L, b)) b.pend = 1.f;
  }
  store_rows(out, nn, i, b, tric, rows0[nn + i], rows0[2 * nn + i],
             rows0[3 * nn + i], rows0[4 * nn + i]);
}

__device__ __forceinline__ unsigned long long pack_tg(float t, float g) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         __float_as_uint(g);
}

// The counting entry, for the checks only, takes more registers (two
// blocks an SM) so that its counter does not spill.
template <bool COUNT>
__global__ void __launch_bounds__(kMarchLanes, COUNT ? 2 : 3)
flat_chunk_kernel(const int* __restrict__ items, int nitems,
                  const int* __restrict__ vcr, const float* __restrict__ rays8,
                  const uint16_t* __restrict__ feat,
                  const float* __restrict__ rows0,
                  const uint16_t* __restrict__ trig,
                  const float* __restrict__ tric,
                  unsigned long long* __restrict__ best,
                  int* __restrict__ pend, int n, int tr, int cs,
                  unsigned long long* __restrict__ counter) {
  __shared__ MmaShared sh;
  const int subs = tr / kMarchLanes;
  const int item = blockIdx.x / subs;
  const int blk = items[item];
  if (blk < 0) return;
  const int v0 = items[nitems + item], v1 = items[2 * nitems + item];
  const size_t nn = n;
  const size_t b0 = static_cast<size_t>(blk) * tr +
                    static_cast<size_t>(blockIdx.x % subs) * kMarchLanes;
  MmaBlock m;
  mma_prologue(sh, rays8, feat, nn, b0, m);
  const size_t i = b0 + m.ol;
  MarchBest b{rows0[i], rows0[5 * nn + i], 0.f, false};
  bool pd = false;
  unsigned long long cnt = 0;
  for (int v = v0; v < v1; ++v)
    pd |= mma_visit<COUNT>(sh, trig, tric, vcr[v], cs, m, b, cnt);
  if (b.got) atomicMin(&best[i], pack_tg(b.t, b.g));
  if (pd) pend[i] = 1;
  if (COUNT && cnt) atomicAdd(counter, cnt);
}

__global__ void __launch_bounds__(kMergeThreads)
flat_merge_kernel(const float* __restrict__ rows0,
                  const unsigned long long* __restrict__ best,
                  const int* __restrict__ pend,
                  const float* __restrict__ tric, float* __restrict__ out,
                  int n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  const size_t nn = n;
  if (i >= nn) return;
  const unsigned long long k = best[i];
  MarchBest b{rows0[i], rows0[5 * nn + i], pend[i] ? 1.f : rows0[6 * nn + i],
              k != ~0ull};
  if (b.got) {
    b.t = __uint_as_float(static_cast<uint32_t>(k >> 32));
    b.g = __uint_as_float(static_cast<uint32_t>(k));
  }
  store_rows(out, nn, i, b, tric, rows0[nn + i], rows0[2 * nn + i],
             rows0[3 * nn + i], rows0[4 * nn + i]);
}

cudaError_t check_args(const void* trig, const float* tric, int n, int tr,
                       int cs) {
  if (tr <= 0 || tr % kMarchLanes || n % tr || cs <= 0 || cs % kMarchTile ||
      cs % kMmaTile)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(trig) % 16 ||
      reinterpret_cast<uintptr_t>(tric) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <bool COUNT>
int launch_chunks(const int* items, int nitems, const int* vcr,
                  const float* rays8, const void* feat, const float* rows0,
                  const void* trig, const float* tric, void* best, void* pend,
                  float* out, int n, int tr, int cs, void* counter,
                  void* stream) {
  if (n <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n, tr, cs);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  if (nitems < 0 || static_cast<long long>(nitems) * (tr / kMarchLanes) >
                        0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nitems > 0) {
    flat_chunk_kernel<COUNT><<<nitems * (tr / kMarchLanes), kMarchLanes, 0,
                               s>>>(
        items, nitems, vcr, rays8, static_cast<const uint16_t*>(feat), rows0,
        static_cast<const uint16_t*>(trig), tric,
        static_cast<unsigned long long*>(best), static_cast<int*>(pend), n,
        tr, cs, static_cast<unsigned long long*>(counter));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flat_merge_kernel<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                      0, s>>>(rows0,
                              static_cast<const unsigned long long*>(best),
                              static_cast<const int*>(pend), tric, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_flat(const int* items, int nitems, const int* vcr,
                        const float* rays8, const void* feat,
                        const float* rows0, const void* trig,
                        const float* tric, void* best, void* pend, float* out,
                        int n, int tr, int cs, void* stream) {
  return launch_chunks<false>(items, nitems, vcr, rays8, feat, rows0, trig,
                              tric, best, pend, out, n, tr, cs, nullptr,
                              stream);
}

extern "C" int ptx_flat_count(const int* items, int nitems, const int* vcr,
                              const float* rays8, const void* feat,
                              const float* rows0, const void* trig,
                              const float* tric, void* best, void* pend,
                              float* out, int n, int tr, int cs,
                              void* counter, void* stream) {
  return launch_chunks<true>(items, nitems, vcr, rays8, feat, rows0, trig,
                             tric, best, pend, out, n, tr, cs, counter,
                             stream);
}

extern "C" int ptx_flat_simt(const int* offs, const int* vc, const float* rays8,
                             const void* feat, const float* rows0,
                             const void* trig, const float* tric, float* out,
                             int n, int tr, int cs, void* stream) {
  if (n <= 0) return 0;
  if (tr <= 0 || tr % kMarchLanes || n % tr || cs <= 0 || cs % kMarchTile)
    return static_cast<int>(cudaErrorInvalidValue);
  flat_simt_kernel<<<n / kMarchLanes, kMarchLanes, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      offs, vc, rays8, static_cast<const uint16_t*>(feat), rows0,
      static_cast<const uint16_t*>(trig), tric, out, n, tr, cs);
  return static_cast<int>(cudaGetLastError());
}
