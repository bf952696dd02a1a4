// The cluster-block test shared by K12 (pair_vpu.cu), K16 (group.cu) and
// K17 (cluster.cu): a ray against the K triangles of one Morton cluster.
//
// The cluster packs are (C K, 24) float32 rows, cluster c at rows
// [c K, (c + 1) K), each row the triangle pack's [n c0 m1 d1 m2 d2 m3 d3
// mati 0*7]. The test is nearest.cuh's exact test, unchanged (the
// interpret-mode Pallas kernels of all three round as K1's does). Across
// triangles and clusters the running (t, index) keeps the least accepted t
// with a strict <, so within a cluster the lowest lane wins a tie (the
// TPU's argmin) and across clusters the one tested first.

#pragma once

#include "nearest.cuh"

namespace ptx {

// Merges the triangles at rows [base, base + n) into best. Every thread of
// the block calls it (it synchronises and stages the rows through `tile`,
// kTile * 4 float4s); a thread with take == false only helps stage.
__device__ __forceinline__ void merge_cluster(
    float4* tile, const float4* __restrict__ tri, int base, int n, bool take,
    float px, float py, float pz, float dx, float dy, float dz,
    Nearest& best) {
  for (int off = 0; off < n; off += kTile) {
    const int m = min(kTile, n - off);
    __syncthreads();
    for (int q = threadIdx.x; q < 4 * m; q += blockDim.x) {
      tile[q] = tri[(size_t)(base + off + (q >> 2)) * (kTriCols / 4) + (q & 3)];
    }
    __syncthreads();
    if (!take) continue;
    for (int j = 0; j < m; ++j) {
      float t;
      if (exact_hit(&tile[4 * j], px, py, pz, dx, dy, dz, t) && t < best.t) {
        best.t = t;
        best.g = base + off + j;
      }
    }
  }
}

// The winner's normal and material, each + 0.0f (the TPU's one-hot sum
// turns -0.0 into +0.0), or zeros when nothing was hit.
__device__ __forceinline__ void winner_attrs(const float4* __restrict__ tri,
                                             const Nearest& best, float* a) {
  if (!(best.t < kBig)) {
    a[0] = a[1] = a[2] = a[3] = 0.0f;
    return;
  }
  const float* row =
      reinterpret_cast<const float*>(tri) + (size_t)best.g * kTriCols;
  a[0] = __fadd_rn(row[0], 0.0f);
  a[1] = __fadd_rn(row[1], 0.0f);
  a[2] = __fadd_rn(row[2], 0.0f);
  a[3] = __fadd_rn(row[16], 0.0f);
}

}  // namespace ptx
