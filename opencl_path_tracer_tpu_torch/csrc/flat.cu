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
// compile it at 1080p; here it lives in global memory.

#include "march_visit.cuh"

namespace {

using namespace ptx;

__global__ void __launch_bounds__(kMarchLanes)
flat_kernel(const int* __restrict__ offs, const int* __restrict__ vc,
            const float* __restrict__ rays8, const uint16_t* __restrict__ feat,
            const float* __restrict__ rows0, const uint16_t* __restrict__ trig,
            const float* __restrict__ tric, float* __restrict__ out, int n,
            int tr, int cs) {
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

}  // namespace

extern "C" int ptx_flat(const int* offs, const int* vc, const float* rays8,
                        const void* feat, const float* rows0, const void* trig,
                        const float* tric, float* out, int n, int tr, int cs,
                        void* stream) {
  if (n <= 0) return 0;
  if (tr <= 0 || tr % kMarchLanes || n % tr || cs <= 0 || cs % kMarchTile)
    return static_cast<int>(cudaErrorInvalidValue);
  flat_kernel<<<n / kMarchLanes, kMarchLanes, 0,
                static_cast<cudaStream_t>(stream)>>>(
      offs, vc, rays8, static_cast<const uint16_t*>(feat), rows0,
      static_cast<const uint16_t*>(trig), tric, out, n, tr, cs);
  return static_cast<int>(cudaGetLastError());
}
