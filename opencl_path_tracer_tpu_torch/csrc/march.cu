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
// the (32, n) bf16 rows the caller built (plucker_feat).
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

__device__ __forceinline__ uint32_t feat_pair(const uint16_t* __restrict__ feat,
                                              size_t n, int q, size_t i) {
  return static_cast<uint32_t>(feat[q * n + i]) |
         (static_cast<uint32_t>(feat[(q + 1) * n + i]) << 16);
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
  const int lid = threadIdx.x & 31, g = lid >> 2, tig = lid & 3;
  const int wl = threadIdx.x & ~31;   // the warp's first lane in the block
  const size_t nn = n;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kMarchLanes;
  const int blk = static_cast<int>(b0 / tr);
  // The four lanes of this thread's fragments, [m tile][g or g + 8], and
  // the warp's A fragments: features 0-15 (k16), 16-17 (k8, on tig 0;
  // zero elsewhere).
  MmaLane L[2][2];
  uint32_t A[2][4], A8[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t li = b0 + wl + 16 * mt + 8 * h + g;
      MmaLane& l = L[mt][h];
      const float px = rays8[li], py = rays8[nn + li], pz = rays8[2 * nn + li];
      l.dx = rays8[3 * nn + li];
      l.dy = rays8[4 * nn + li];
      l.dz = rays8[5 * nn + li];
      l.ml = fmaxf(fmaxf(fabsf(__fmaf_rn(py, l.dz, -__fmul_rn(pz, l.dy))),
                         fabsf(__fmaf_rn(pz, l.dx, -__fmul_rn(px, l.dz)))),
                   fabsf(__fmaf_rn(px, l.dy, -__fmul_rn(py, l.dx))));
      l.li = wl + 16 * mt + 8 * h + g;
      A[mt][h] = feat_pair(feat, nn, 2 * tig, li);
      A[mt][2 + h] = feat_pair(feat, nn, 2 * tig + 8, li);
      A8[mt][h] = tig == 0 ? feat_pair(feat, nn, 16, li) : 0u;
    }
  }
  // The block's features as float32 (for the chain), and its F_q: the
  // largest |feature q| of its lanes (infinite for a column where a
  // feature is subnormal or not finite).
  unsigned int* fq = reinterpret_cast<unsigned int*>(sh.fq);
  if (threadIdx.x < kMarchW) fq[threadIdx.x] = 0u;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 6; ++k)
    sh.ray[k][threadIdx.x] = rays8[k * nn + b0 + threadIdx.x];
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) {
    const uint16_t h = feat[q * nn + b0 + threadIdx.x];
    const float f = bf16_bits_to_float(h);
    sh.f[q][threadIdx.x] = f;
    atomicMax(&fq[q], bf16_outside(h) ? 0x7f800000u : __float_as_uint(fabsf(f)));
  }
  __syncthreads();
  // d0 = 2^-110 + 2^-126 sum_q F_q, rounded up (the margin's absolute
  // term, with the subnormal weights a tensor core may flush).
  float d0 = 0.f;
#pragma unroll
  for (int q = 0; q < kMarchW; ++q) d0 = __fadd_ru(d0, sh.fq[q]);
  d0 = __fmaf_ru(d0, 0x1p-126f, 0x1p-110f);
  // The lane this thread owns at the end of each visit: its exact tests,
  // its running best and its output (the quad's four lanes, one each).
  const int omt = tig >> 1, oh = tig & 1;
  const int ol = wl + 16 * omt + 8 * oh + g;

  MarchBest b{kBig, 0.f, 0.f, false};
  unsigned long long cnt = 0;
  for (int u = 0; u < K; ++u) {
    const int cid = clist[static_cast<size_t>(blk) * K + u];
    if (cid < 0) continue;
    const int cbase = cid * cs;
    Top2 tp[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) tp[mt][h] = Top2{kBig, kBig, 0, 0};
    for (int base = 0; base < cs; base += kMmaTile) {
      __syncthreads();
      mma_stage(sh, trig, tric, cbase, cs, base, d0);
      __syncthreads();
      for (int nt = 0; nt < kMmaTile / 8; ++nt) {
        const int jr = 8 * nt + g;   // this thread's B column (triangle)
        uint32_t bw[3][3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          bw[e][0] = sh.w[jr][e][tig];
          bw[e][1] = sh.w[jr][e][4 + tig];
          bw[e][2] = sh.w[jr][e][8 + tig];
        }
        // This thread's two triangles (C columns 2 tig and 2 tig + 1).
        const int j0 = 8 * nt + 2 * tig;
        float4 kc[2][3];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int q = 0; q < 3; ++q) kc[cc][q] = sh.k[j0 + cc][q];
        float C[2][3][4];
        __syncwarp();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            C[mt][e][0] = C[mt][e][1] = C[mt][e][2] = C[mt][e][3] = 0.f;
            mma_k16(C[mt][e], A[mt], bw[e][0], bw[e][1]);
            mma_k8(C[mt][e], A8[mt][0], A8[mt][1], bw[e][2]);
          }
        // The positions (lane, triangle) that no edge test certainly
        // fails; then those, decided exactly, in triangle order per lane.
        unsigned int maybe = 0u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int r = 2 * h + cc;
              if (mma_maybe(C[mt][0][r], C[mt][1][r], C[mt][2][r], kc[cc],
                            L[mt][h]))
                maybe |= 1u << (4 * mt + r);
            }
        if (!maybe) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int r = 2 * h + cc, j = j0 + cc;
              if (!(maybe >> (4 * mt + r) & 1u)) continue;
              const MmaLane& l = L[mt][h];
              const float vn = dot3(kc[cc][0], l.dx, l.dy, l.dz);
              const float E[3] = {C[mt][0][r], C[mt][1][r], C[mt][2][r]};
              if (!mma_edges<COUNT>(E, kc[cc], vn, l, sh.w[j],
                                    &sh.f[0][l.li], cnt))
                continue;
              const float t = (sh.k[j][3].x -
                               dot3(kc[cc][0], sh.ray[0][l.li],
                                    sh.ray[1][l.li], sh.ray[2][l.li])) /
                              vn;
              if (!(t > 0.f)) continue;
              Top2& x = tp[mt][h];
              const int lj = base + j;
              if (t < x.m1) {
                x.m2 = x.m1;
                x.a2 = x.a1;
                x.m1 = t;
                x.a1 = lj;
              } else if (t < x.m2) {
                x.m2 = t;
                x.a2 = lj;
              }
            }
      }
    }
    // The quad's lists merged; the owned lane's two candidates.
    Top2 o = tp[0][0];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        merge_top2(tp[mt][h], 1);
        merge_top2(tp[mt][h], 2);
        if (mt == omt && h == oh) o = tp[mt][h];
      }
    MarchLane Lo;
    Lo.px = sh.ray[0][ol];
    Lo.py = sh.ray[1][ol];
    Lo.pz = sh.ray[2][ol];
    Lo.dx = sh.ray[3][ol];
    Lo.dy = sh.ray[4][ol];
    Lo.dz = sh.ray[5][ol];
    const bool v1 = o.m1 < kBig && exact_row(tric, cbase + o.a1, Lo);
    const bool v2 = o.m2 < kBig && exact_row(tric, cbase + o.a2, Lo);
    if (v1 || v2) {
      const bool use2 = !v1;
      const float ct = use2 ? o.m2 : o.m1;
      const float cg = static_cast<float>(cbase + (use2 ? o.a2 : o.a1));
      if (ct < b.t || (ct == b.t && cg < b.g)) {
        b.t = ct;
        b.g = cg;
        b.got = true;
      }
    }
    if (!v1 && !v2 && o.m2 < kBig) b.pend = 1.f;
  }
  store_rows(out, nn, b0 + ol, b, tric, 0.f, 0.f, 0.f, 0.f);
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
