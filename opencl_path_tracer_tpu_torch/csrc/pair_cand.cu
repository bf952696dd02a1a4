// K9: each ray's nearest passing clusters, rank by rank.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sorted_intersect.py::_cand_kernel (launched by _run_candidates).
//
// What it computes, per ray (P, D) and cluster j < c of the (Cp, 8) or
// (Cp, 16) box table: the slab test over the three axes and, with 16
// columns, the four diagonal DOP axes u = (1, sy, sz) (p_u = px + sy py +
// sz pz, likewise d_u); per axis inv = 1 / d (correctly rounded), t1 =
// (lo - p) inv, t2 = (hi - p) inv, and where d == 0 containment (-BIG,
// BIG when lo <= p <= hi, else BIG, -BIG); tmin, tmax the running max
// and min with XLA's semantics (NaN wins, +0 above -0). A cluster passes
// when tmax >= tmin and tmax >= 0; its entry is max(tmin, 0). The
// output is the l + 1 least (entry, cluster) pairs in order, the TPU
// kernel's l + 1 argmin passes (ties to the lower cluster): ids (l, R)
// int32 of the first l (c where fewer pass) and ent (l + 1, R) float32
// (BIG where fewer pass), whose row l is the certificate bound.
//
// What bounds it on the H100: operations, 8 float32 operations per
// (ray, cluster, axis) slab, 7 axes with the DOPs (about three times as
// many instructions here, with XLA's NaN-aware min and max). One thread
// per ray walks the clusters in id order, the box table staged through
// shared memory in chunks, and keeps its sorted top l + 1 (l <= 48) by
// insertion with a strict <, which is the argmin passes' tie rule; most
// clusters fail the slab test and never reach the insertion.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kChunk = 256;     // clusters per shared-memory chunk
constexpr int kMaxL = 49;       // l + 1 <= 49
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }

// XLA's maximum and minimum: NaN wins; +0.0 is above -0.0.
__device__ __forceinline__ float xmax(float a, float b) {
  if (a != a || b != b) return qnan();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

__device__ __forceinline__ float xmin(float a, float b) {
  if (a != a || b != b) return qnan();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ void slab(float& tmin, float& tmax, float bl,
                                     float bh, float p, float d) {
  float lo, hi;
  if (d == 0.0f) {
    const bool inside = p >= bl && p <= bh;
    lo = inside ? -kBig : kBig;
    hi = inside ? kBig : -kBig;
  } else {
    const float inv = __frcp_rn(d);
    const float t1 = __fmul_rn(__fsub_rn(bl, p), inv);
    const float t2 = __fmul_rn(__fsub_rn(bh, p), inv);
    lo = xmin(t1, t2);
    hi = xmax(t1, t2);
  }
  tmin = xmax(tmin, lo);
  tmax = xmin(tmax, hi);
}

__global__ void __launch_bounds__(kBlock)
pair_cand_kernel(const float* __restrict__ rays8,
                 const float* __restrict__ boxes, int* __restrict__ ids,
                 float* __restrict__ ent, int n_rays, int boxw, int c,
                 int l) {
  __shared__ float sb[kChunk * 16];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  const size_t n = static_cast<size_t>(n_rays);
  float p[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = rays8[k * n + i];
      d[k] = rays8[(3 + k) * n + i];
    }
  }
  // The diagonal axes (1, sy, sz) of the DOP columns, sy, sz = +-1.
  const float sy[4] = {1.f, -1.f, 1.f, -1.f};
  const float sz[4] = {1.f, 1.f, -1.f, -1.f};
  float pu[4], du[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pu[j] = __fadd_rn(__fadd_rn(p[0], sy[j] > 0.f ? p[1] : -p[1]),
                      sz[j] > 0.f ? p[2] : -p[2]);
    du[j] = __fadd_rn(__fadd_rn(d[0], sy[j] > 0.f ? d[1] : -d[1]),
                      sz[j] > 0.f ? d[2] : -d[2]);
  }
  const int nl = l + 1;
  float le[kMaxL];
  int li[kMaxL];
  for (int k = 0; k < nl; ++k) {
    le[k] = kBig;
    li[k] = c;
  }
  for (int base = 0; base < c; base += kChunk) {
    const int cnt = min(kChunk, c - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * boxw; k += kBlock) {
      sb[k] = boxes[static_cast<size_t>(base) * boxw + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* b = sb + j * boxw;
      float tmin = -kBig, tmax = kBig;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        slab(tmin, tmax, b[ax], b[ax + 3], p[ax], d[ax]);
      if (boxw == 16) {
#pragma unroll
        for (int ax = 0; ax < 4; ++ax)
          slab(tmin, tmax, b[8 + ax], b[12 + ax], pu[ax], du[ax]);
      }
      if (!(tmax >= tmin && tmax >= 0.f)) continue;
      const float e = tmin > 0.f ? tmin : 0.f;
      if (!(e < le[nl - 1])) continue;
      int pos = nl - 1;
      while (pos > 0 && le[pos - 1] > e) {
        le[pos] = le[pos - 1];
        li[pos] = li[pos - 1];
        --pos;
      }
      le[pos] = e;
      li[pos] = base + j;
    }
  }
  if (!live) return;
  for (int k = 0; k < l; ++k) ids[k * n + i] = li[k];
  for (int k = 0; k < nl; ++k) ent[k * n + i] = le[k];
}

}  // namespace

extern "C" int ptx_pair_cand(const float* rays8, const float* boxes, int* ids,
                             float* ent, int n_rays, int cp, int boxw, int c,
                             int l, void* stream) {
  if (n_rays <= 0) return 0;
  if ((boxw != 8 && boxw != 16) || c <= 0 || c > cp || l <= 0 ||
      l + 1 > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  pair_cand_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rays8, boxes, ids, ent, n_rays, boxw, c, l);
  return static_cast<int>(cudaGetLastError());
}
