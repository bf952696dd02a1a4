// K13a: the two nearest Plucker candidates per ray.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// plucker_kernel.py::_cand_kernel (launched by _run_candidates).
//
// What it computes, per ray: the features phi = [P x D, D] (each product
// and difference rounded separately) split into bf16 hi = RNE(phi) and
// lo = RNE(phi - hi) by integer bit arithmetic; per triangle and edge k
// the Plucker product E_k = sum of the 18 exact products of the packed
// bf16 weights [w_hi, w_hi, w_lo] with [phi_hi, phi_lo, phi_hi], in two
// float32 accumulators (even terms, odd terms, in order) that are then
// added, the order of XLA's CPU dot in the reference; acceptance is the
// eps-loosened sign test (a superset of K1/K4's accepts) with t > 0,
// and t is K1's exact expression. It keeps, per chunk of `chunk`
// triangles, the first (t, index) minimum and the next (BIG and the
// chunk's first index when fewer than two accept), and merges chunks in
// order, ties to the lower index: the TPU kernel's top-2 bit for bit.
//
// What bounds it on the H100: operations. The TPU runs the E products on
// its matrix unit; their count (3 x 18 multiply-adds per (ray, triangle)
// pair) is charged at the bf16 tensor-core rate in the bound. The first
// kernel (plucker_cand_simt_kernel below) ran them on the float32 cores,
// one ray per thread, about 170 instructions a test. This one runs them
// on the tensor cores with K18's certified margin (march_mma.cuh, whose
// header comment gives the argument): each warp owns 32 lanes (two m16
// tiles), and per n tile of 8 triangles and edge one mma.sync.m16n8k16
// (features 0-15) and one m16n8k8 (16-23) give E_0, E_1, E_2 at a
// thread's eight (lane, triangle) positions, bf16 in, float32 sums.
// delta_k = 2^-14 S_k + d0 with S_k = sum_q |w_kq| F_q (F_q the CUDA
// block's largest |feature q|, infinite for a subnormal or non-finite
// one) and d0 = 2^-110 + 2^-126 sum_q F_q, all rounded up, bounds the
// distance from the tensor cores' E to the float32 chain's.
//
// The filter. K13a's eps_k is per triangle, so T_k = eps_k + delta_k
// (rounded up) is staged with the triangle: E_k > T_k means the chain
// certainly fails edge k when vn <= 0 (it needs E_k <= eps_k), and
// E_k < -T_k that it certainly fails it when vn > 0. A position with one
// of each fails whatever the sign of vn, so the filter needs neither vn
// nor a sign (about 11 instructions a test, a position with an infinite
// E never certified). E_k = vn (edge value at the plane crossing), so
// the positions left are the lines through the triangle and the rare
// ones in the margin. Only they take the exact pass: vn and
// num = c0 - n.P, a position whose t = num / vn cannot be > 0 (num and vn
// not of one strict sign) dropped, each edge decided from u = s E + eps_k
// outside [-delta_k, delta_k] (s the sign of vn) or else by the chain
// itself, out of line, compared as the first kernel compares; then the
// divide, t > 0 and the top-two update. No t is computed where an edge
// fails: the reference's t there is BIG whatever the division gives.
//
// The scan's pair. A thread keeps, per lane, the top two of its own
// positions, visited in ascending triangle index with the strict < of
// the sequential scan, starting from (BIG, chunk's first index); at the
// end of a chunk the quad merges its lists in (t, index) order
// (march_mma.cuh's merge_top2), which gives the chunk's pair with the
// same fill, and each thread of the quad merges one lane's pair into its
// running pair as the first kernel does.
//
// The padding rows. build_plucker_packs pads the packs to whole chunks
// with rows of n = w = 0: their t = 0 / 0 fails t > 0, so they never
// enter a pair. The kernel is given the live triangle count and stops
// the scan there, at a whole n tile; a padding row in the last chunk
// scanned is a row not accepted beyond BIG (fix_fill). A chunk made only
// of padding gives (BIG, its first index) twice, which changes the
// running pair only where that pair holds an accepted t above BIG, and
// then only the first such chunk can (later ones carry higher indices):
// where the live count ends a chunk, that chunk's pair is merged once
// after the scan.
//
// Entry points: ptx_plucker_cand (the kernel the wrapper launches);
// ptx_plucker_cand_count (the same kernel, also adding to *counter the
// edge tests that took the float32 chain); ptx_plucker_cand_simt (the
// first kernel, kept to hold this one against whole launches and to time
// the two in turns; no wrapper on a render path reaches either of the
// last two).

#include <stdint.h>

#include "march_mma.cuh"

namespace {

using namespace ptx;

constexpr int kCandTile = 64;     // triangles per shared-memory tile
static_assert(kCandTile == kMmaTile, "both kernels take chunks of 64 tiles");
constexpr int kW = 18;            // used trig columns (of 32)
// Lanes per block of the tensor-core kernel (chain_edge's feature stride).
constexpr int kCandLanes = kMarchLanes;

__device__ __forceinline__ uint32_t rne_bf16(uint32_t u) {
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// Features of a ray: f[0..5] = phi_hi, f[6..11] = phi_lo, f[12..17] =
// phi_hi, each a bf16 value held as float32.
__device__ __forceinline__ void ray_features(float px, float py, float pz,
                                             float dx, float dy, float dz,
                                             float (&f)[kW]) {
  const float phi[6] = {__fsub_rn(__fmul_rn(py, dz), __fmul_rn(pz, dy)),
                        __fsub_rn(__fmul_rn(pz, dx), __fmul_rn(px, dz)),
                        __fsub_rn(__fmul_rn(px, dy), __fmul_rn(py, dx)),
                        dx, dy, dz};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float hi = __uint_as_float(rne_bf16(__float_as_uint(phi[q])));
    const float lo = __uint_as_float(
        rne_bf16(__float_as_uint(__fsub_rn(phi[q], hi))));
    f[q] = hi;
    f[6 + q] = lo;
    f[12 + q] = hi;
  }
}

constexpr int kNone = 0x7fffffff;   // no such row
constexpr float kFltMax = 3.402823466e38f;

// A chunk's pair as the reference takes it: (m1, a1) = argmin of tm over
// the chunk (tm = t where accepted, else BIG; first index on ties), then
// the argmin with a1 masked to BIG. The scan keeps the two least accepted
// t below BIG, filled with (BIG, first index of the chunk); an accepted t
// above BIG (a ray nearly parallel to the plane, t = inf) changes the
// fill: the BIG entries then carry fnb, the chunk's first row whose t is
// not accepted beyond BIG, and a chunk of such rows alone gives its least
// (cm, cg) and (BIG, cg).
__device__ __forceinline__ void fix_fill(float& m1, int& a1, float& m2,
                                         int& a2, int fnb, float cm, int cg) {
  if (fnb != kNone) {
    if (m1 >= kBig) a1 = fnb;
    if (m2 >= kBig) a2 = fnb;
  } else {
    m1 = cm;
    a1 = cg;
    m2 = kBig;
    a2 = cg;
  }
}

// Merge the running pair with a chunk's, ties to the lower index.
__device__ __forceinline__ void merge_chunk(Top2& run, const Top2& o) {
  const bool bet = lex_less(o.m1, o.a1, run.m1, run.a1);
  const float r = bet ? run.m1 : o.m1;
  const int rg = bet ? run.a1 : o.a1;
  const float s = bet ? o.m2 : run.m2;
  const int sg = bet ? o.a2 : run.a2;
  if (bet) {
    run.m1 = o.m1;
    run.a1 = o.a1;
  }
  const bool bet2 = lex_less(s, sg, r, rg);
  run.m2 = bet2 ? s : r;
  run.a2 = bet2 ? sg : rg;
}

// The first kernel's running pair (the tensor-core kernel uses
// march_mma.cuh's Top2).
struct Cand2 {
  float t1, t2;
  int g1, g2;
};

__global__ void __launch_bounds__(kBlock)
plucker_cand_simt_kernel(const float* __restrict__ rays8, int ray_stride,
                         const uint16_t* __restrict__ trig,
                         const float4* __restrict__ tric,
                         float* __restrict__ out, int n_rays, int n_tris,
                         int chunk) {
  __shared__ float tw[kCandTile][3][kW];
  __shared__ float4 tc[kCandTile][2];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n_rays;
  const size_t rs = static_cast<size_t>(ray_stride);
  float px = 0.f, py = 0.f, pz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    px = rays8[i];
    py = rays8[rs + i];
    pz = rays8[2 * rs + i];
    dx = rays8[3 * rs + i];
    dy = rays8[4 * rs + i];
    dz = rays8[5 * rs + i];
  }
  float f[kW];
  ray_features(px, py, pz, dx, dy, dz, f);
  Cand2 run{kBig, kBig, 0, 0};
  for (int cbase = 0; cbase < n_tris; cbase += chunk) {
    Cand2 loc{kBig, kBig, cbase, cbase};
    // The chunk's first row whose t is not accepted beyond BIG, and the
    // least accepted t beyond BIG (see fix_fill).
    int fnb = kNone, cg = kNone;
    float cm = kBig;
    for (int base = cbase; base < cbase + chunk; base += kCandTile) {
      __syncthreads();
      // trig is chunk-major: edge e of triangle cbase + c sits at row
      // 3 cbase + e chunk + c (a tile never spans two chunks).
      for (int k = threadIdx.x; k < kCandTile * 3 * kW; k += blockDim.x) {
        const int j = k / (3 * kW), e = (k / kW) % 3, q = k % kW;
        const int row = 3 * cbase + e * chunk + (base - cbase) + j;
        tw[j][e][q] = __uint_as_float(
            static_cast<uint32_t>(trig[(size_t)row * 32 + q]) << 16);
      }
      for (int k = threadIdx.x; k < kCandTile * 2; k += blockDim.x) {
        tc[k >> 1][k & 1] = tric[(size_t)base * 2 + k];
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < kCandTile; ++j) {
        const float4 nc = tc[j][0];       // n, c0
        const float4 eps = tc[j][1];      // eps1, eps2, eps3, 0
        const float vn = dot3(nc, dx, dy, dz);
        const bool pos = vn > 0.f;
        // The loosened sign tests, edge by edge, stopping at the first
        // that fails: E_k >= -eps_k for every k when vn > 0, else
        // E_k <= eps_k (an AND, so the early exit changes no result).
        bool valid = true;
#pragma unroll
        for (int k = 0; k < 3 && valid; ++k) {
          const float* w = tw[j][k];
          // The products of two bf16 values are exact in float32, so
          // fma(w, f, acc) rounds once, as acc + w * f does.
          float ae = w[0] * f[0];
          float ao = w[1] * f[1];
#pragma unroll
          for (int q = 2; q < kW; q += 2) {
            ae = __fmaf_rn(w[q], f[q], ae);
            ao = __fmaf_rn(w[q + 1], f[q + 1], ao);
          }
          const float e = ae + ao;
          const float ek = k == 0 ? eps.x : (k == 1 ? eps.y : eps.z);
          valid = pos ? e >= -ek : e <= ek;
        }
        // t only where the sign tests pass: K1's expression, t > 0.
        float tm = kBig;
        if (valid) {
          const float t = (nc.w - dot3(nc, px, py, pz)) / vn;
          if (t > 0.f) tm = t;
        }
        const int gj = base + j;
        if (tm > kBig) {
          if (cg == kNone || tm < cm) {
            cm = tm;
            cg = gj;
          }
        } else if (fnb == kNone) {
          fnb = gj;
        }
        if (tm < loc.t1) {
          loc.t2 = loc.t1;
          loc.g2 = loc.g1;
          loc.t1 = tm;
          loc.g1 = gj;
        } else if (tm < loc.t2) {
          loc.t2 = tm;
          loc.g2 = gj;
        }
      }
    }
    fix_fill(loc.t1, loc.g1, loc.t2, loc.g2, fnb, cm, cg);
    if (cbase == 0) {
      run = loc;
      continue;
    }
    // Merge the running top-2 with the chunk's, ties to the lower index.
    const bool bet = loc.t1 < run.t1 || (loc.t1 == run.t1 && loc.g1 < run.g1);
    const float r = bet ? run.t1 : loc.t1;
    const int rg = bet ? run.g1 : loc.g1;
    const float s = bet ? loc.t2 : run.t2;
    const int sg = bet ? loc.g2 : run.g2;
    if (bet) {
      run.t1 = loc.t1;
      run.g1 = loc.g1;
    }
    const bool bet2 = s < r || (s == r && sg < rg);
    run.t2 = bet2 ? s : r;
    run.g2 = bet2 ? sg : rg;
  }
  if (live) {
    const size_t n = static_cast<size_t>(n_rays);
    out[i] = run.t1;
    out[n + i] = (float)run.g1;
    out[2 * n + i] = run.t2;
    out[3 * n + i] = (float)run.g2;
  }
}

// The tensor-core kernel's shared memory: a tile of 64 triangles (weight
// rows as in march_mma.cuh; constants as float4 rows, conflict-free for
// the four triangle pairs of a warp) and the block's lanes.
struct CandShared {
  uint32_t w[kMmaTile][3][kWRow];
  float4 thr[kMmaTile];   // T_0, T_1, T_2 = RU(eps_k + delta_k), 0
  float4 nc[kMmaTile];    // n, c0
  float4 ep[kMmaTile];    // eps_0, eps_1, eps_2, 0
  float4 del[kMmaTile];   // delta_0, delta_1, delta_2, 0
  float f[kW][kCandLanes];   // the block's features
  float ray[6][kCandLanes];  // the block's lanes: P, D
  float fq[kW];              // the block's F_q
  unsigned long long cmin[kCandLanes];   // per lane: least (t, g) beyond BIG
};

// Stage triangles [base, base + 64) of the chunk at cbase: weight rows,
// delta_k from the block's F_q, T_k, and the constants. Every thread
// calls it.
__device__ __forceinline__ void cand_stage(CandShared& sh,
                                           const uint16_t* __restrict__ trig,
                                           const float* __restrict__ tric,
                                           int cbase, int chunk, int base,
                                           float d0) {
  for (int r = threadIdx.x; r < 3 * kMmaTile; r += kCandLanes) {
    const int e = r / kMmaTile, j = r % kMmaTile;
    const size_t row = 3 * static_cast<size_t>(cbase) + e * chunk +
                       (base - cbase) + j;
    const uint4* src = reinterpret_cast<const uint4*>(trig + row * 32);
    uint4 q[3] = {src[0], src[1], src[2]};
    q[2].y = q[2].z = q[2].w = 0u;   // columns 18-23
    const uint32_t wd[9] = {q[0].x, q[0].y, q[0].z, q[0].w, q[1].x,
                            q[1].y, q[1].z, q[1].w, q[2].x};
    // S_k = sum_q |w_kq| F_q rounded up; a weight that is not finite
    // makes it infinite or NaN, so no test of the row is certified.
    float sk = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      sk = __fmaf_ru(fabsf(__uint_as_float(wd[k] << 16)), sh.fq[2 * k], sk);
      sk = __fmaf_ru(fabsf(__uint_as_float(wd[k] & 0xffff0000u)),
                     sh.fq[2 * k + 1], sk);
    }
    uint4* dst = reinterpret_cast<uint4*>(sh.w[j][e]);
    dst[0] = q[0];
    dst[1] = q[1];
    dst[2] = q[2];
    const float del = __fmaf_ru(sk, 0x1p-14f, d0);
    const float eps = tric[static_cast<size_t>(base + j) * 8 + 4 + e];
    reinterpret_cast<float*>(&sh.del[j])[e] = del;
    reinterpret_cast<float*>(&sh.thr[j])[e] = __fadd_ru(eps, del);
  }
  for (int j = threadIdx.x; j < kMmaTile; j += kCandLanes) {
    const float4* r = reinterpret_cast<const float4*>(
        tric + static_cast<size_t>(base + j) * 8);
    sh.nc[j] = r[0];
    sh.ep[j] = r[1];
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// Four blocks an SM (124 registers) measured faster than ptxas's own
// choice (128 or 136) and than five to eight blocks (spills).
template <bool COUNT>
__global__ void __launch_bounds__(kCandLanes, 4)
plucker_cand_mma_kernel(const float* __restrict__ rays8, int ray_stride,
                        const uint16_t* __restrict__ trig,
                        const float* __restrict__ tric,
                        float* __restrict__ out, int n_rays, int n_tris,
                        int n_live, int chunk,
                        unsigned long long* __restrict__ counter) {
  __shared__ CandShared sh;
  const int lid = threadIdx.x & 31, g = lid >> 2, tig = lid & 3;
  const int wl = threadIdx.x & ~31;   // the warp's first lane in the block
  const int b0 = blockIdx.x * kCandLanes;
  const size_t rs = static_cast<size_t>(ray_stride);
  // The block's lanes (one per thread; zero rays past the end), their
  // features, and F_q: the largest |feature q| of the block (infinite for
  // a column where a feature is subnormal or not finite).
  unsigned int* fq = reinterpret_cast<unsigned int*>(sh.fq);
  if (threadIdx.x < kW) fq[threadIdx.x] = 0u;
  __syncthreads();
  {
    const int i = b0 + threadIdx.x;
    float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < n_rays) {
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = rays8[k * rs + i];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) sh.ray[k][threadIdx.x] = r[k];
    float f[kW];
    ray_features(r[0], r[1], r[2], r[3], r[4], r[5], f);
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const uint32_t u = __float_as_uint(f[q]);
      sh.f[q][threadIdx.x] = f[q];
      atomicMax(&fq[q], bf16_outside(u >> 16) ? 0x7f800000u : u & 0x7fffffffu);
    }
  }
  __syncthreads();
  // d0 = 2^-110 + 2^-126 sum_q F_q, rounded up.
  float d0 = 0.f;
#pragma unroll
  for (int q = 0; q < kW; ++q) d0 = __fadd_ru(d0, sh.fq[q]);
  d0 = __fmaf_ru(d0, 0x1p-126f, 0x1p-110f);
  // The warp's A fragments: features 0-15 (k16), 16-17 (k8, on tig 0;
  // zero elsewhere), lanes g and g + 8 of each m tile.
  uint32_t A[2][4], A8[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int li = wl + 16 * mt + 8 * h + g;
      A[mt][h] = bf16_pair(sh.f[2 * tig][li], sh.f[2 * tig + 1][li]);
      A[mt][2 + h] = bf16_pair(sh.f[2 * tig + 8][li], sh.f[2 * tig + 9][li]);
      A8[mt][h] = tig == 0 ? bf16_pair(sh.f[16][li], sh.f[17][li]) : 0u;
    }
  // The lane this thread owns at the end of each chunk: its running pair
  // and its output (the quad's four lanes, one each).
  const int omt = tig >> 1, oh = tig & 1;
  const int ol = wl + 16 * omt + 8 * oh + g;

  Top2 run{kBig, kBig, 0, 0};
  unsigned long long cnt = 0;
  for (int cbase = 0; cbase < n_live; cbase += chunk) {
    const int cend = min(cbase + chunk, n_live);
    // fn: per lane, this thread's first row not accepted beyond BIG
    // (fix_fill); the rows past the scanned n tiles are padding (BIG).
    const int send = cbase + ((cend - cbase + 7) & ~7);
    Top2 tp[2][2];
    int fn[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tp[mt][h] = Top2{kBig, kBig, cbase, cbase};
        fn[mt][h] = kNone;
      }
    bool fn_open = true;
    sh.cmin[threadIdx.x] = ~0ull;
    for (int base = cbase; base < cend; base += kMmaTile) {
      __syncthreads();
      cand_stage(sh, trig, tric, cbase, chunk, base, d0);
      __syncthreads();
      const int ntiles = min(kMmaTile / 8, (cend - base + 7) / 8);
      for (int nt = 0; nt < ntiles; ++nt) {
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
        const float4 th[2] = {sh.thr[j0], sh.thr[j0 + 1]};
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
        // The positions that no pair of edge values certainly fails.
        unsigned int maybe = 0u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 T = th[r & 1];
            const float E0 = C[mt][0][r], E1 = C[mt][1][r], E2 = C[mt][2][r];
            const bool below = E0 < -T.x || E1 < -T.y || E2 < -T.z;
            const bool above = E0 > T.x || E1 > T.y || E2 > T.z;
            const bool fin =
                fmaxf(fmaxf(fabsf(E0), fabsf(E1)), fabsf(E2)) <= kFltMax;
            if (!(below && above && fin)) maybe |= 1u << (4 * mt + r);
          }
        // Those positions decided exactly, in triangle order per lane;
        // beyond marks the accepted t above BIG.
        unsigned int beyond = 0u;
        if (maybe) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int r = 2 * h + cc, j = j0 + cc;
                if (!(maybe >> (4 * mt + r) & 1u)) continue;
                const int li = wl + 16 * mt + 8 * h + g;
                const float4 nc = sh.nc[j];
                const float vn =
                    dot3(nc, sh.ray[3][li], sh.ray[4][li], sh.ray[5][li]);
                const float num =
                    nc.w - dot3(nc, sh.ray[0][li], sh.ray[1][li],
                                sh.ray[2][li]);
                // t = num / vn > 0 needs num and vn of one strict sign
                // (minarg.cu's rule (a)): a line through the triangle
                // behind the ray is settled before its edges.
                const float sn = __int_as_float(
                    __float_as_int(num) ^ (__float_as_int(vn) & 0x80000000));
                if (!(sn > 0.f)) continue;
                const bool pos = vn > 0.f;
                const float sg = pos ? 1.f : -1.f;
                const float4 ep4 = sh.ep[j], de4 = sh.del[j];
                const float E[3] = {C[mt][0][r], C[mt][1][r], C[mt][2][r]};
                const float ep[3] = {ep4.x, ep4.y, ep4.z};
                const float del[3] = {de4.x, de4.y, de4.z};
                bool valid = true;
#pragma unroll
                for (int e = 0; e < 3; ++e) {
                  const float u = __fmaf_rn(sg, E[e], ep[e]);
                  const bool fin = fabsf(E[e]) <= kFltMax;
                  if (!valid || (fin && u > del[e])) continue;
                  if (fin && u < -del[e]) {
                    valid = false;
                    continue;
                  }
                  if (COUNT) ++cnt;
                  const float ek = chain_edge(sh.w[j][e], &sh.f[0][li]);
                  valid = pos ? ek >= -ep[e] : ek <= ep[e];
                }
                if (!valid) continue;
                const float t = num / vn;
                if (!(t > 0.f)) continue;
                Top2& x = tp[mt][h];
                const int gj = base + j;
                if (t > kBig) {
                  beyond |= 1u << (4 * mt + r);
                  atomicMin(&sh.cmin[li],
                            static_cast<unsigned long long>(__float_as_uint(t))
                                    << 32 |
                                static_cast<unsigned int>(gj));
                } else if (t < x.m1) {
                  x.m2 = x.m1;
                  x.a2 = x.a1;
                  x.m1 = t;
                  x.a1 = gj;
                } else if (t < x.m2) {
                  x.m2 = t;
                  x.a2 = gj;
                }
              }
        }
        if (fn_open) {
          fn_open = false;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned int b = beyond >> (4 * mt + 2 * h);
              if (fn[mt][h] == kNone && (b & 3u) != 3u)
                fn[mt][h] = base + j0 + ((b & 1u) ? 1 : 0);
              fn_open |= fn[mt][h] == kNone;
            }
        }
      }
    }
    // The quad's lists merged: the chunk's pair for the owned lane.
    Top2 o = tp[0][0];
    int fo = kNone;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        merge_top2(tp[mt][h], 1);
        merge_top2(tp[mt][h], 2);
        int f = fn[mt][h];
        f = min(f, __shfl_xor_sync(0xffffffffu, f, 1));
        f = min(f, __shfl_xor_sync(0xffffffffu, f, 2));
        if (mt == omt && h == oh) {
          o = tp[mt][h];
          fo = f;
        }
      }
    if (send < cbase + chunk) fo = min(fo, send);
    __syncwarp();
    const unsigned long long ck = sh.cmin[ol];
    __syncwarp();
    fix_fill(o.m1, o.a1, o.m2, o.a2, fo, __uint_as_float(ck >> 32),
             static_cast<int>(ck & 0xffffffffu));
    if (cbase == 0) {
      run = o;
    } else {
      merge_chunk(run, o);
    }
  }
  // The first chunk of padding alone, where the live count ends a chunk.
  if (n_live % chunk == 0 && n_live < n_tris)
    merge_chunk(run, Top2{kBig, kBig, n_live, n_live});
  const int i = b0 + ol;
  if (i < n_rays) {
    const size_t n = static_cast<size_t>(n_rays);
    out[i] = run.m1;
    out[n + i] = static_cast<float>(run.a1);
    out[2 * n + i] = run.m2;
    out[3 * n + i] = static_cast<float>(run.a2);
  }
  if (COUNT && cnt) atomicAdd(counter, cnt);
}

cudaError_t check_args(const void* trig, const float* tric, int n_tris,
                       int chunk) {
  if (n_tris <= 0 || chunk <= 0 || chunk % kCandTile || n_tris % chunk)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(trig) % 16 ||
      reinterpret_cast<uintptr_t>(tric) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <bool COUNT>
int launch_mma(const float* rays8, int ray_stride, const void* trig,
               const float* tric, float* out, int n_rays, int n_tris,
               int n_live, int chunk, void* counter, void* stream) {
  if (n_rays <= 0) return 0;
  const cudaError_t bad = check_args(trig, tric, n_tris, chunk);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  if (n_live < 0 || n_live > n_tris)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_rays + kCandLanes - 1) / kCandLanes;
  plucker_cand_mma_kernel<COUNT>
      <<<grid, kCandLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          rays8, ray_stride, static_cast<const uint16_t*>(trig), tric, out,
          n_rays, n_tris, n_live, chunk,
          static_cast<unsigned long long*>(counter));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptx_plucker_cand(const float* rays8, int ray_stride,
                                const void* trig, const float* tric,
                                float* out, int n_rays, int n_tris,
                                int n_live, int chunk, void* stream) {
  return launch_mma<false>(rays8, ray_stride, trig, tric, out, n_rays,
                           n_tris, n_live, chunk, nullptr, stream);
}

extern "C" int ptx_plucker_cand_count(const float* rays8, int ray_stride,
                                      const void* trig, const float* tric,
                                      float* out, int n_rays, int n_tris,
                                      int n_live, int chunk, void* counter,
                                      void* stream) {
  return launch_mma<true>(rays8, ray_stride, trig, tric, out, n_rays, n_tris,
                          n_live, chunk, counter, stream);
}

extern "C" int ptx_plucker_cand_simt(const float* rays8, int ray_stride,
                                     const void* trig, const float* tric,
                                     float* out, int n_rays, int n_tris,
                                     int chunk, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_tris <= 0 || chunk <= 0 || chunk % kCandTile || n_tris % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_rays + kBlock - 1) / kBlock;
  plucker_cand_simt_kernel<<<grid, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      rays8, ray_stride, static_cast<const uint16_t*>(trig),
      reinterpret_cast<const float4*>(tric), out, n_rays, n_tris, chunk);
  return static_cast<int>(cudaGetLastError());
}
