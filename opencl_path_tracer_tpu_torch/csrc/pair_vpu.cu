// K12: the VPU pairs round of the pair intersector (accel 'pair').
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// sorted_intersect.py::_pair_kernel (launched by _run_pairs).
//
// What it computes, per (ray, cluster) pair of a list sorted by cluster
// key: the nearest hit among that cluster's K triangles (nearest.cuh's
// exact test, the lowest index on ties) and the winner's normal and
// material; rows [t nx ny nz mati] of a (5, P) output. A pair of the dummy
// key C (or any key outside [0, C)) is no work and keeps (BIG, 0, 0, 0, 0).
// The TPU walks each tile's runs of equal keys in a while loop; a pair has
// one key, so its result does not depend on the tiling.
//
// What bounds it on the H100: operations, as K1 (12 float32 operations
// per (pair, triangle) test and 12 per edge test reached). The first
// kernel (pair_simt_kernel below, over cluster_block.cuh) ran every test:
// one IEEE divide and one to three edge tests per triangle. But most real
// pairs hit nothing in their cluster (78 % of round 1's camera pairs on
// the stress scene): the ray crossed the inflated cluster box and misses
// every triangle. This kernel skips, per pair, the sub-blocks of kSub = 32
// consecutive rows (the cluster is in Morton order, so a sub-block is
// compact) that the rule below proves cannot hold a row that the exact
// test accepts with t at or below the pair's running best, and runs
// exact_hit unchanged on every row of the others; a pair keeps the least
// (t, index), as the first kernel's scan in ascending index with a strict
// < does. So its outputs are the first kernel's bit for bit. On round 1 of
// the stress scene's camera pairs one box test in ten passes. K1's rules
// (a) and (b) before the divide (minarg.cu), tried in the passed
// sub-blocks, cut only an eighth of their divides and measured slower.
//
// The skip rule. u = 2^-24. Take a triangle row (n, c0, m_k, d_k) and a
// ray (P, D), all finite, with |P_i| <= 2^64, 2^-64 <= max |D_i| <= 2^40,
// |n_i|, |m_k,i| <= 2^32, |c0|, |d_k| <= 2^100 and |n|, |m_k| >= 2^-50
// (Euclidean norms), and let the exact test accept it with 0 < t <= best,
// t = RN(num / vn). Let X = P + t D, exactly. No product or sum of the
// test overflows in these ranges (the final fma may round to +inf; it then
// exceeds d_k all the same), each dot3 is off the exact dot by at most
// 3.01u sum |v_i x_i| <= 3.01u |v| |x| plus 3 2^-150 (underflow), and
// with sigma = |P| + t |D| one finds, by the usual error analysis of the
// roundings (num, the divide, the fma of each edge test):
//   |n.X - c0| / |n|           <= 6u sigma + 2.01u |c0| / |n|   + 2^-90,
//   (m_k.X - d_k) / |m_k|      >= -(6u sigma + 1.01u |d_k| / |m_k| + 2^-90)
// (the 2^-90 and part of the 6u take the underflow terms, using the
// ranges). So X lies within H = 6u sigma + Omega of the row's plane and of
// its three edge planes, Omega the row's constant term. Split m_k / |m_k|
// into mu_k, orthogonal to n^ = n / |n|, and nu_k n^: then mu_k.X >= beta_k
// - c_k H with beta_k = d_k / |m_k| - nu_k c0 / |n|, c_k = 1 + |nu_k|. When
// the three lines mu_k.x = beta_k bound a proper triangle in the plane
// (each pairwise crossing strictly inside the third half-plane: then the
// mu_k positively span the plane), every relaxation of them by c_k H >= 0
// bounds a triangle too, whose corners move affinely, by H w_ab; so X lies
// in the box of the three corners (at height c0 / |n|) widened by G H, G
// = max over corners and axes of |w_ab,i| + |n^_i|. The host builds these
// boxes in float64 (sorted_intersect.pair_sub_boxes), per sub-block the
// union of its rows' boxes (lo, hi), G and Omega their maxima, all widened
// by a margin for float64's own rounding and rounded outward to float32.
// Rows with n = 0 are left out: vn = +-0 or NaN, so t is +-inf or NaN and
// never below best (at most BIG). A sub-block with a row outside the
// ranges or not a proper triangle (degenerate slivers) gets an infinite
// box: it is never skipped.
//
// The box still depends on t through sigma. With B the largest norm of a
// corner of the sub-block's box, |X| <= B + sqrt(3) J and t |D| = |X - P|
// <= |X| + |P|, where J = g (|P| + t |D|) + a, g = 6u G, a = G Omega; for
// sqrt(3) g <= 1/2 (the host requires it) this gives t |D| <= 2B + 3|P| +
// 2 sqrt(3) a and so J <= I = A + Gp |P| with A = 2a + 2gB and Gp = 4g,
// which the table holds per sub-block (|P| <= |P|_1 here, rounded up).
// So: if the segment P + s D, 0 <= s <= best, misses the box [lo - I, hi +
// I], no row of the sub-block is accepted with t <= best, and the
// sub-block is skipped (in any order of the rows: a tie at best with a
// lower index cannot hide there either). The slab test rounds outward:
// the box and the numerators down or up, and each bound on s a product
// with the reciprocal of D_i rounded down or up (rlo, rhi), the one that
// makes the bound lower or higher; a NaN bound (0 times an infinite
// reciprocal) is dropped by fmaxf and fminf. A ray outside the ranges
// gets I = inf and skips nothing. A ray with a component that is not
// finite is never accepted at or below best (P: num is +-inf or NaN, so t
// is; D: vn is, so t is +-0 or NaN), so whatever the test decides for it
// is exact too. best only falls, so a sub-block skipped once stays right.
// The slab test (cull_ray, box_maybe) and the warp's run of a sub-block
// for a few rays (coop_sub_block) are in sub_cull.cuh, shared with K17
// (cluster.cu) and K7 (anyhit.cu), which read tables of the same rule.
//
// Layout: one thread per pair, blocks of kBlock consecutive pairs, and
// kRuns such runs of pairs per CUDA block. The block walks its runs of
// equal keys as the TPU kernel does (the key at a run's start read by
// every thread, the next run after the count of pairs with that key,
// __syncthreads_count); a cluster's rows (up to kStage of them, 32 KB)
// and its sub-blocks' boxes are staged once and kept while the following
// runs of the block's pairs have the same key. Per sub-block a warp
// takes the ballot of its pairs whose box test passed. With more than
// coop_max of them each lane tests its own pair's rows in order. With
// fewer, the warp tests them one pair at a time, each lane one row of the
// sub-block against that pair's ray, and the pair's lane merges the least
// (t, index) (two __reduce_min_sync over t's bits, which order as t for
// t > 0, then over the indices at that t) with a strict <: the lanes of a
// sparse ballot would otherwise idle through the whole sub-block
// (first-bounce pairs, whose warps mix directions, take this path in half
// their passes).
//
// Entry points: ptx_pair_vpu (the kernel the wrapper launches);
// ptx_pair_vpu_count (the same kernel, also adding to counter[0] the
// (pair, row) tests that reached the divide, to counter[1] the (pair,
// sub-block) box tests that passed, to counter[2] those of them run by
// the whole warp and to counter[3] the edge tests that exact_hit reached
// in the rows of counter[0]); ptx_pair_vpu_simt (the first kernel, kept
// to hold this one against whole launches and to time the two in turns;
// no wrapper on a render path reaches either of the last two).

#include <stdint.h>

#include "cluster_block.cuh"
#include "sub_cull.cuh"

namespace {

using namespace ptx;

constexpr int kStage = 512;   // cluster rows staged at a time
// Runs of kBlock pairs a CUDA block walks, keeping a cluster's staged rows
// while the next run has its key: 2 measured 4 % faster than 1 in turns
// on round 1 of the stress scene's camera and first-bounce pairs
// (runtime/pair_vpu_ab.py; PERF.md).
constexpr int kRuns = 2;

__global__ void __launch_bounds__(kBlock)
pair_simt_kernel(const int* __restrict__ keys, const float* __restrict__ rays8,
                 const float4* __restrict__ tri, float* __restrict__ out,
                 int n_pairs, int n_clusters, int k) {
  __shared__ float4 tile[kTile * 4];
  const int start = blockIdx.x * kBlock;
  const int i = start + threadIdx.x;
  const bool live = i < n_pairs;
  const size_t np = static_cast<size_t>(n_pairs);
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  int key = -1;
  if (live) {
    px = rays8[i];
    py = rays8[np + i];
    pz = rays8[2 * np + i];
    dx = rays8[3 * np + i];
    dy = rays8[4 * np + i];
    dz = rays8[5 * np + i];
    key = keys[i];
  }
  const int n_here = min(kBlock, n_pairs - start);
  Nearest best{kBig, 0};
  int pos = 0;
  while (pos < n_here) {
    const int ci = keys[start + pos];
    if (ci >= n_clusters) break;          // the dummy key sorts last
    const bool in_run = live && key == ci;
    if (ci >= 0) {
      merge_cluster(tile, tri, ci * k, k, in_run, px, py, pz, dx, dy, dz,
                    best);
    }
    pos += __syncthreads_count(in_run);
  }
  if (!live) return;
  float a[4];
  winner_attrs(tri, best, a);
  out[i] = best.t;
  out[np + i] = a[0];
  out[2 * np + i] = a[1];
  out[3 * np + i] = a[2];
  out[4 * np + i] = a[3];
}

// Five blocks an SM (48 registers): ptxas's own choice of 64 left four,
// which measured 4-5 % slower (PERF.md). The counting entry, for the
// checks only, keeps four so that its counters do not spill.
template <bool COUNT>
__global__ void __launch_bounds__(kBlock, COUNT ? 4 : 5)
pair_cull_kernel(const int* __restrict__ keys, const float* __restrict__ rays8,
                 const float4* __restrict__ tri,
                 const float4* __restrict__ sub, float* __restrict__ out,
                 int n_pairs, int n_clusters, int k, int coop_max,
                 unsigned long long* __restrict__ counter) {
  __shared__ float4 tile[kStage * 4];
  __shared__ float4 boxes[kStage / kSub * 2];
  const size_t np = static_cast<size_t>(n_pairs);
  const int nsb = (k + kSub - 1) / kSub;   // sub-blocks per cluster
  int staged = -1;   // the cluster in shared memory when k <= kStage
  unsigned long long n_div = 0, n_box = 0, n_coop = 0, n_edge = 0;
#pragma unroll 1
  for (int r = 0; r < kRuns; ++r) {
    const int start = (blockIdx.x * kRuns + r) * kBlock;
    if (start >= n_pairs) break;
    const int i = start + threadIdx.x;
    const bool live = i < n_pairs;
    float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    const int key = live ? keys[i] : -1;
    if (key >= 0 && key < n_clusters) {   // no ray is read for no work
      px = rays8[i];
      py = rays8[np + i];
      pz = rays8[2 * np + i];
      dx = rays8[3 * np + i];
      dy = rays8[4 * np + i];
      dz = rays8[5 * np + i];
    }
    const CullRay cr = cull_ray(px, py, pz, dx, dy, dz);
    const int n_here = min(kBlock, n_pairs - start);
    Nearest best{kBig, 0};
    int pos = 0;
    while (pos < n_here) {
      const int ci = keys[start + pos];
      if (ci >= n_clusters) break;          // the dummy key sorts last
      const bool in_run = live && key == ci;
      if (ci >= 0) {
        for (int tb = 0; tb < k; tb += kStage) {
          const int m = min(kStage, k - tb);
          if (k > kStage || ci != staged) {
            // The last reads of the staged rows were before this run's
            // or the previous tile's barrier.
            if (tb > 0) __syncthreads();
            const size_t base = static_cast<size_t>(ci) * k + tb;
            for (int q = threadIdx.x; q < 4 * m; q += kBlock)
              tile[q] = tri[(base + (q >> 2)) * (kTriCols / 4) + (q & 3)];
            const size_t sb0 = static_cast<size_t>(ci) * nsb + tb / kSub;
            for (int q = threadIdx.x; q < 2 * ((m + kSub - 1) / kSub);
                 q += kBlock)
              boxes[q] = sub[2 * sb0 + q];
            __syncthreads();
            staged = ci;
          }
          for (int s0 = 0; s0 < m; s0 += kSub) {
            const int sb = s0 / kSub;
            const bool go =
                in_run &&
                box_maybe(cr, boxes[2 * sb], boxes[2 * sb + 1], best.t);
            const unsigned bal = __ballot_sync(kFull, go);
            if (!bal) continue;
            const int s1 = min(m, s0 + kSub);
            if (COUNT && go) {
              ++n_box;
              n_div += s1 - s0;
            }
            if (__popc(bal) > coop_max) {
              // Many of the warp's pairs: each tests its own, in order.
              if (!go) continue;
              for (int j = s0; j < s1; ++j) {
                float t;
                if (exact_hit(&tile[4 * j], px, py, pz, dx, dy, dz, t) &&
                    t < best.t) {
                  best.t = t;
                  best.g = ci * k + tb + j;
                }
                if (COUNT)
                  n_edge +=
                      edges_reached(&tile[4 * j], px, py, pz, dx, dy, dz);
              }
            } else {
              if (COUNT) {
                if (go) ++n_coop;
                // Lane l's row s0 + l against each pair of the ballot.
                for (unsigned rest = bal; rest; rest &= rest - 1) {
                  const int src = __ffs(rest) - 1;
                  const float q[6] = {__shfl_sync(kFull, px, src),
                                      __shfl_sync(kFull, py, src),
                                      __shfl_sync(kFull, pz, src),
                                      __shfl_sync(kFull, dx, src),
                                      __shfl_sync(kFull, dy, src),
                                      __shfl_sync(kFull, dz, src)};
                  const int j = s0 + (threadIdx.x & 31);
                  if (j < s1)
                    n_edge += edges_reached(&tile[4 * j], q[0], q[1], q[2],
                                            q[3], q[4], q[5]);
                }
              }
              coop_sub_block<4>(tile, s0, s1, bal, px, py, pz, dx, dy, dz,
                                ci * k + tb, best);
            }
          }
        }
      }
      pos += __syncthreads_count(in_run);
    }
    if (live) {
      float a[4];
      winner_attrs(tri, best, a);
      out[i] = best.t;
      out[np + i] = a[0];
      out[2 * np + i] = a[1];
      out[3 * np + i] = a[2];
      out[4 * np + i] = a[3];
    }
  }
  if (COUNT) {
    atomicAdd(&counter[0], n_div);
    atomicAdd(&counter[1], n_box);
    atomicAdd(&counter[2], n_coop);
    atomicAdd(&counter[3], n_edge);
  }
}

template <bool COUNT>
int launch_cull(const int* keys, const float* rays8p, const float* rows,
                const float* sub, float* out, int n_pairs, int n_clusters,
                int k, int coop_max, void* counter, void* stream) {
  if (n_pairs <= 0) return 0;
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(sub) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int grid = (n_pairs + kBlock * kRuns - 1) / (kBlock * kRuns);
  pair_cull_kernel<COUNT>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          keys, rays8p, reinterpret_cast<const float4*>(rows),
          reinterpret_cast<const float4*>(sub), out, n_pairs, n_clusters, k,
          coop_max, static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_pair_vpu(const int* keys, const float* rays8p,
                            const float* rows, const float* sub, float* out,
                            int n_pairs, int n_clusters, int k, int coop_max,
                            void* stream) {
  return launch_cull<false>(keys, rays8p, rows, sub, out, n_pairs,
                            n_clusters, k, coop_max, nullptr, stream);
}

extern "C" int ptx_pair_vpu_count(const int* keys, const float* rays8p,
                                  const float* rows, const float* sub,
                                  float* out, int n_pairs, int n_clusters,
                                  int k, int coop_max, void* counter,
                                  void* stream) {
  return launch_cull<true>(keys, rays8p, rows, sub, out, n_pairs, n_clusters,
                           k, coop_max, counter, stream);
}

extern "C" int ptx_pair_vpu_simt(const int* keys, const float* rays8p,
                                 const float* rows, float* out, int n_pairs,
                                 int n_clusters, int k, void* stream) {
  if (n_pairs <= 0) return 0;
  const int grid = (n_pairs + kBlock - 1) / kBlock;
  pair_simt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, rays8p, reinterpret_cast<const float4*>(rows), out, n_pairs,
      n_clusters, k);
  return static_cast<int>(cudaGetLastError());
}
