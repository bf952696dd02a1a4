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
// What bounds it on the H100: the instruction rate. The arithmetic is 8
// float32 operations per (ray, cluster, axis), on up to 7 axes; a first
// kernel that recomputed the ray's reciprocals and zero tests per cluster
// and kept its list in local memory ran about 50 instructions per axis.
// The design:
//   * everything that belongs to the ray is computed once, before the
//     cluster loop: the 7 correctly rounded reciprocals (the same bits
//     wherever they are computed; the TPU kernel also takes them once per
//     ray), the DOP projections, and whether any d is 0. A ray with a zero
//     d takes a second body with the containment test; the other rays do
//     per (cluster, axis) two subtractions, two multiplies and four
//     NaN-propagating min/max (PTX min.NaN / max.NaN). Their rule for the
//     sign of zero is not read: a zero's sign never reaches an output
//     (the comparisons ignore it, and the entry is +0 for any zero tmin);
//   * once tmax < tmin or tmax < 0 after the three box axes (or a NaN), no
//     later axis can pass the cluster (later axes only raise tmin and
//     lower tmax, or give NaN), so a warp whose rays have all failed skips
//     the four DOP axes;
//   * the box row comes from shared memory as 16-byte loads (a broadcast:
//     every thread reads the same row);
//   * the sorted top list lives in registers for a compile-time capacity
//     of 3, 9 or 17 entries, inserted without a runtime index; l + 1 up to
//     49 keeps it in local memory. A capacity above l + 1 keeps the same
//     first l + 1 entries (the list is the exact lexicographic order).
// One thread per ray walks the clusters in id order, the table staged
// through shared memory in chunks; an insertion keeps a strict < on the
// entry, the argmin passes' tie rule, since clusters come in id order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kChunk = 256;     // clusters per shared-memory chunk
constexpr int kMaxL = 49;       // l + 1 <= 49
constexpr float kBig = 3.0e38f;

// XLA's maximum and minimum for NaN: a NaN operand gives NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One axis of the slab test: inv = 1 / d of the ray, d != 0 (or, with
// ZERO, the containment test where d == 0).
template <bool ZERO>
__device__ __forceinline__ void slab(float& tmin, float& tmax, float bl,
                                     float bh, float p, float inv, bool dz) {
  float lo, hi;
  if (ZERO && dz) {
    const bool inside = p >= bl && p <= bh;
    lo = inside ? -kBig : kBig;
    hi = inside ? kBig : -kBig;
  } else {
    const float t1 = __fmul_rn(__fsub_rn(bl, p), inv);
    const float t2 = __fmul_rn(__fsub_rn(bh, p), inv);
    lo = nmin(t1, t2);
    hi = nmax(t1, t2);
  }
  tmin = nmax(tmin, lo);
  tmax = nmin(tmax, hi);
}

// The sorted (entry, cluster) list of a ray; CAP <= 17 in registers.
template <int CAP>
struct TopList {
  float e[CAP];
  int i[CAP];

  __device__ __forceinline__ void init(int c) {
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      e[k] = kBig;
      i[k] = c;
    }
  }

  // Insert (x, j), x < e[CAP - 1], after every entry <= x.
  __device__ __forceinline__ void insert(float x, int j) {
    if constexpr (CAP <= 17) {
      // From the top down, slot k reads the old entries k - 1 and k.
#pragma unroll
      for (int k = CAP - 1; k > 0; --k) {
        const bool up = e[k - 1] > x, here = e[k] > x;
        e[k] = up ? e[k - 1] : (here ? x : e[k]);
        i[k] = up ? i[k - 1] : (here ? j : i[k]);
      }
      if (e[0] > x) {
        e[0] = x;
        i[0] = j;
      }
    } else {
      int pos = CAP - 1;
      while (pos > 0 && e[pos - 1] > x) {
        e[pos] = e[pos - 1];
        i[pos] = i[pos - 1];
        --pos;
      }
      e[pos] = x;
      i[pos] = j;
    }
  }
};

// The per-ray constants: origin and reciprocals on the 3 box axes and the
// 4 DOP axes, and which d are 0.
struct RayAxes {
  float p[7], inv[7];
  bool dz[7];
};

// Test clusters [0, cnt) of the staged chunk sb (cluster base + j).
template <int CAP, int BOXW, bool ZERO>
__device__ __forceinline__ void walk_chunk(const float4* sb, int cnt,
                                           int base, const RayAxes& R,
                                           TopList<CAP>& top) {
  constexpr int kRow = BOXW / 4;   // float4s per box row
  for (int j = 0; j < cnt; ++j) {
    const float4* b = sb + j * kRow;
    const float4 q0 = b[0], q1 = b[1];   // lo0 lo1 lo2 hi0 | hi1 hi2 - -
    float tmin = -kBig, tmax = kBig;
    slab<ZERO>(tmin, tmax, q0.x, q0.w, R.p[0], R.inv[0], R.dz[0]);
    slab<ZERO>(tmin, tmax, q0.y, q1.x, R.p[1], R.inv[1], R.dz[1]);
    slab<ZERO>(tmin, tmax, q0.z, q1.y, R.p[2], R.inv[2], R.dz[2]);
    bool pass = tmax >= tmin && tmax >= 0.f;
    if (BOXW == 16 && __any_sync(__activemask(), pass)) {
      const float4 lo = b[2], hi = b[3];
      slab<ZERO>(tmin, tmax, lo.x, hi.x, R.p[3], R.inv[3], R.dz[3]);
      slab<ZERO>(tmin, tmax, lo.y, hi.y, R.p[4], R.inv[4], R.dz[4]);
      slab<ZERO>(tmin, tmax, lo.z, hi.z, R.p[5], R.inv[5], R.dz[5]);
      slab<ZERO>(tmin, tmax, lo.w, hi.w, R.p[6], R.inv[6], R.dz[6]);
      pass = tmax >= tmin && tmax >= 0.f;
    }
    if (!pass) continue;
    const float x = tmin > 0.f ? tmin : 0.f;
    if (x < top.e[CAP - 1]) top.insert(x, base + j);
  }
}

// Register budgets, chosen by timing on the H100: capacities 3 and 49
// without a hint (a minimum of 0 blocks; 40-48 and 64-80 registers), 9
// and 17 at 4 blocks of 128 per SM (up to 128 registers: left to itself,
// ptxas held them to 64 and spilled a word of the cluster loop to the
// stack).
template <int CAP, int BOXW>
__global__ void __launch_bounds__(kBlock, CAP == 9 || CAP == 17 ? 4 : 0)
pair_cand_kernel(const float* __restrict__ rays8,
                 const float* __restrict__ boxes, int* __restrict__ ids,
                 float* __restrict__ ent, int n_rays, int c, int l) {
  __shared__ float4 sb[kChunk * BOXW / 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  const size_t n = static_cast<size_t>(n_rays);
  float p[3] = {0.f, 0.f, 0.f}, d[3] = {1.f, 1.f, 1.f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = rays8[k * n + i];
      d[k] = rays8[(3 + k) * n + i];
    }
  }
  RayAxes R;
  // The diagonal axes (1, sy, sz) of the DOP columns, sy, sz = +-1.
  const float sy[4] = {1.f, -1.f, 1.f, -1.f};
  const float sz[4] = {1.f, 1.f, -1.f, -1.f};
  bool anyz = false;
#pragma unroll
  for (int a = 0; a < 7; ++a) {
    float pa, da;
    if (a < 3) {
      pa = p[a];
      da = d[a];
    } else {
      const int j = a - 3;
      pa = __fadd_rn(__fadd_rn(p[0], sy[j] > 0.f ? p[1] : -p[1]),
                     sz[j] > 0.f ? p[2] : -p[2]);
      da = __fadd_rn(__fadd_rn(d[0], sy[j] > 0.f ? d[1] : -d[1]),
                     sz[j] > 0.f ? d[2] : -d[2]);
    }
    R.p[a] = pa;
    R.inv[a] = __frcp_rn(da);
    R.dz[a] = da == 0.0f;
    if (a < 3 || BOXW == 16) anyz |= R.dz[a];
  }
  TopList<CAP> top;
  top.init(c);
  for (int base = 0; base < c; base += kChunk) {
    const int cnt = min(kChunk, c - base);
    __syncthreads();
    const float4* src =
        reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(base) *
                                                     (BOXW / 4);
    for (int k = threadIdx.x; k < cnt * (BOXW / 4); k += kBlock) sb[k] = src[k];
    __syncthreads();
    if (!live) continue;
    if (anyz)
      walk_chunk<CAP, BOXW, true>(sb, cnt, base, R, top);
    else
      walk_chunk<CAP, BOXW, false>(sb, cnt, base, R, top);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < CAP; ++k) {
    if (k < l) ids[k * n + i] = top.i[k];
    if (k <= l) ent[k * n + i] = top.e[k];
  }
}

template <int CAP>
cudaError_t launch(const float* rays8, const float* boxes, int* ids,
                   float* ent, int n_rays, int boxw, int c, int l,
                   cudaStream_t stream) {
  const int grid = (n_rays + kBlock - 1) / kBlock;
  if (boxw == 16)
    pair_cand_kernel<CAP, 16><<<grid, kBlock, 0, stream>>>(rays8, boxes, ids,
                                                           ent, n_rays, c, l);
  else
    pair_cand_kernel<CAP, 8><<<grid, kBlock, 0, stream>>>(rays8, boxes, ids,
                                                          ent, n_rays, c, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptx_pair_cand(const float* rays8, const float* boxes, int* ids,
                             float* ent, int n_rays, int cp, int boxw, int c,
                             int l, void* stream) {
  if (n_rays <= 0) return 0;
  if ((boxw != 8 && boxw != 16) || c <= 0 || c > cp || l <= 0 ||
      l + 1 > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(boxes) % 16)   // read as float4 rows
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nl = l + 1;
  cudaError_t err;
  if (nl <= 3)
    err = launch<3>(rays8, boxes, ids, ent, n_rays, boxw, c, l, s);
  else if (nl <= 9)
    err = launch<9>(rays8, boxes, ids, ent, n_rays, boxw, c, l, s);
  else if (nl <= 17)
    err = launch<17>(rays8, boxes, ids, ent, n_rays, boxw, c, l, s);
  else
    err = launch<kMaxL>(rays8, boxes, ids, ent, n_rays, boxw, c, l, s);
  return static_cast<int>(err);
}
