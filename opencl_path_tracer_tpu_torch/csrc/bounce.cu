// K21: the megakernel's fast-mode bounce in one pass, and its raygen.
//
// Replaces no TPU kernel: the JAX megakernel's shading
// (opencl_path_tracer_tpu/models/megakernel.py::trace_sample with shade
// and apply_factors) is plain XLA, which fuses the elementwise chain of a
// bounce into a few passes. The port ran the same chain as plain PyTorch
// over V3 tuples, one launch per vector component and operation: about
// 2,500 launches and 21 device ms a 1080p sample. This source does it
// in two entry points (models/bounce.py wraps both):
//
//   * raygen, one launch a sample: the two salt-0 fast-hash draws, the
//     pinhole camera ray (ops/raygen.py::camera_rays) and the path
//     state's start (factors 1, colour 0, alive, outside);
//   * bounce, one launch a bounce, from the intersector's hit rows and
//     the path state: the material fetch (an index outside [0, M)
//     selects material 0), the salt b + 1 draws, the four BSDF branches
//     selected per lane (models/megakernel.py::shade), the factor
//     updates and the emitter pickup (apply_factors), the miss kill and
//     the next ray; it adds the lanes that were live to a device
//     counter (the exact rays_traced), and on the last bounce it folds
//     the sample into the running average instead of writing the state.
//
// Every expression is the plain version's (models/bounce.py::
// bounce_plain, which composes shade and apply_factors), operation for
// operation and in its association, built with --fmad=false and the
// IEEE sqrtf, sinf, cosf and powf (no fast math). The camera and the
// materials sit in a small device table (K5's fused_table layout: 16
// camera floats, 16 per material), so a new scene needs no new build.
//
// What bounds it on the H100: bytes. A bounce reads the hit rows (t, p,
// n, mati: 32 bytes), the state (21 floats: the ray, the four factor
// triples and the colour, 84 bytes) and the flags (4 bytes), and writes
// the state and the flags again (88 bytes): 208 bytes a lane, about
// 0.13 ms for 2,073,600 lanes at 3.35 TB/s, with a few hundred float32
// operations between. One thread per lane, every row read and written
// coalesced; the counter takes one atomic add per block.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kCamCols = 16;
constexpr int kMatCols = 16;
constexpr float kEps = 0.001f;
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;

// State rows (models/bounce.py).
enum { RAYP = 0, RAYD = 3, FL = 6, FB = 9, FS = 12, FR = 15, COL = 18,
       S_ROWS = 21 };
// Flag bits.
enum { ALIVE = 1, INSIDE = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// rng.fast_uniforms(key, sample, salt, n, 2) at this lane.
__device__ __forceinline__ void draws(uint32_t lane, uint32_t sample,
                                      uint32_t salt, uint32_t k0,
                                      uint32_t k1, float& u0, float& u1) {
  uint32_t base = lane * kGold + k0;
  base ^= sample * kM1;
  base += salt * kM2;
  const uint32_t h0 = fmix32(fmix32(base ^ k1));
  const uint32_t h1 = fmix32(fmix32(base ^ kGold ^ k1));
  u0 = (float)(h0 >> 8) * (1.0f / 16777216.0f);
  u1 = (float)(h1 >> 8) * (1.0f / 16777216.0f);
}

// max(x, 0) that passes NaN through, as torch.clamp_min.
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

// vdot: (a0 b0 + a1 b1) + a2 b2.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// vnormalize: v * (1 / sqrt(dot(v, v))).
__device__ __forceinline__ void norm3(float* v) {
  const float r = 1.0f / sqrtf(dot3(v, v));
  v[0] = v[0] * r;
  v[1] = v[1] * r;
  v[2] = v[2] * r;
}

__global__ void __launch_bounds__(kBlock)
raygen_kernel(const float* __restrict__ table, float* __restrict__ S,
              int* __restrict__ flags, int n, int first_id, int x_dim,
              float xm, float ym, uint32_t sample, uint32_t k0,
              uint32_t k1) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t N = static_cast<size_t>(n);
  const float* eye = table;
  const float* lookat = table + 3;
  const float* right = table + 6;
  const float* up = table + 9;
  float r1, r2;
  draws(static_cast<uint32_t>(i), sample, 0u, k0, k1, r1, r2);
  const int id = first_id + i;
  const float x = static_cast<float>(id % x_dim) + r1;
  const float y = static_cast<float>(id / x_dim) + r2;
  const float sx = (2.0f * x) / xm - 1.0f;
  const float sy = (2.0f * y) / ym - 1.0f;
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = lookat[k] + right[k] * sx + up[k] * sy - eye[k];
  }
  norm3(d);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S[(RAYP + k) * N + i] = eye[k];
    S[(RAYD + k) * N + i] = d[k];
    S[(COL + k) * N + i] = 0.0f;
  }
#pragma unroll
  for (int r = FL; r < COL; ++r) S[r * N + i] = 1.0f;
  flags[i] = ALIVE;
}

__global__ void __launch_bounds__(kBlock)
bounce_kernel(const float* __restrict__ S, const int* __restrict__ flags,
              const float* __restrict__ ht, const float* __restrict__ hpx,
              const float* __restrict__ hpy, const float* __restrict__ hpz,
              const float* __restrict__ hnx, const float* __restrict__ hny,
              const float* __restrict__ hnz, const int* __restrict__ hmati,
              const float* __restrict__ ksx, const float* __restrict__ ksy,
              const float* __restrict__ ksz,
              const float* __restrict__ table, int n_mats,
              float* __restrict__ So, int* __restrict__ flags_o,
              const float* __restrict__ c0, const float* __restrict__ c1,
              const float* __restrict__ c2, float* __restrict__ colors,
              unsigned long long* __restrict__ counter, int n,
              uint32_t sample, uint32_t salt, uint32_t k0, uint32_t k1,
              float s_f, float inv) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int fl_in = i < n ? flags[i] : 0;
  if (counter != nullptr) {
    // The lanes live at the bounce's start, once per block.
    const int live = __syncthreads_count(fl_in & ALIVE);
    if (threadIdx.x == 0 && live > 0) {
      atomicAdd(counter, static_cast<unsigned long long>(live));
    }
  }
  if (i >= n) return;
  const size_t N = static_cast<size_t>(n);
#define SR_(r) S[(size_t)(r) * N + i]

  const bool alive = (fl_in & ALIVE) != 0;
  const bool inside = (fl_in & INSIDE) != 0;
  const float t = ht[i];
  const bool has_hit = t > 0.0f && alive;
  int mati = hmati[i];
  if (mati < 0 || mati >= n_mats) mati = 0;
  const float* mat = table + kCamCols + (size_t)mati * kMatCols;
  const float* eye = table;

  float r1, r2;
  draws(static_cast<uint32_t>(i), sample, salt, k0, k1, r1, r2);

  const float p[3] = {hpx[i], hpy[i], hpz[i]};
  const float n0[3] = {hnx[i], hny[i], hnz[i]};
  const float rp[3] = {SR_(RAYP), SR_(RAYP + 1), SR_(RAYP + 2)};
  const float d[3] = {SR_(RAYD), SR_(RAYD + 1), SR_(RAYD + 2)};
  const float nd[3] = {-d[0], -d[1], -d[2]};

  const int mtype = static_cast<int>(mat[0]);
  const bool is_diff = has_hit && mtype == 0;
  const bool is_spec = has_hit && mtype == 1;
  const bool is_refr = has_hit && mtype == 2;
  const bool is_emit = has_hit && mtype == 3;

  // The normal flipped toward the ray (prog.cl:326-328).
  const bool flip = dot3(d, n0) > 0.0f;
  float nv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nv[k] = flip ? -n0[k] : n0[k];

  // Diffuse bounce: orthonormal_base, then the cosine-weighted
  // direction (prog.cl:186-218).
  const bool near_y = fabsf(nv[0]) <= kEps && fabsf(nv[2]) <= kEps;
  const float rl_a = 1.0f / sqrtf(nv[1] * nv[1] + nv[2] * nv[2]);
  const float rl_b = 1.0f / sqrtf(nv[0] * nv[0] + nv[2] * nv[2]);
  const float za[3] = {near_y ? 0.0f : -nv[2] * rl_b,
                       near_y ? -nv[2] * rl_a : 0.0f,
                       near_y ? nv[1] * rl_a : nv[0] * rl_b};
  const float xa[3] = {nv[1] * za[2] - nv[2] * za[1],
                       nv[2] * za[0] - nv[0] * za[2],
                       nv[0] * za[1] - nv[1] * za[0]};
  const float rr = sqrtf(r1);
  const float theta = kTwoPi * r2;
  const float cx = rr * cosf(theta);
  const float cy = rr * sinf(theta);
  const float cz = sqrtf(1.0f - r1);
  float dd[3], dp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dd[k] = xa[k] * cx + nv[k] * cz + za[k] * cy;
    dp[k] = p[k] + nv[k] * kEps;
  }
  norm3(dd);

  // Specular bounce (prog.cl:223-227); its origin is the diffuse one.
  const float cosa_s = dot3(nv, d);
  float sd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sd[k] = d[k] - nv[k] * (cosa_s * 2.0f);
  norm3(sd);

  // Fresnel (prog.cl:219-222).
  const float om = 1.0f - fabsf(dot3(nv, d));
  const float p2 = om * om;
  const float p5 = p2 * p2 * om;
  float fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) fr[k] = mat[12 + k] + (1.0f - mat[12 + k]) * p5;

  // Refractive bounce (prog.cl:228-245, 346-357).
  const float mat_n = mat[1];
  const float n_eff = inside ? 1.0f / mat_n : mat_n;
  const float cosa_r = dot3(nd, nv);
  const float disc = 1.0f - (1.0f - cosa_r * cosa_r) / n_eff / n_eff;
  const float prob = (fr[0] + fr[1] + fr[2]) / 3.0f;
  const bool refracted = disc > 0.0f && r1 > prob;
  const float inv_n = 1.0f / n_eff;
  const float sq = sqrtf(max0(disc));
  float rd[3], rpo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rd[k] = d[k] * inv_n + nv[k] * (cosa_r * inv_n - sq);
    rpo[k] = p[k] - nv[k] * kEps;
  }
  norm3(rd);
  const bool new_inside = refracted ? !inside : inside;
  const float inv_1mp = 1.0f / (1.0f - prob);
  const float inv_p = 1.0f / prob;
  float rf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rf[k] = refracted ? (1.0f - fr[k]) * inv_1mp : fr[k] * inv_p;
  }

  // Lambert and Blinn with the camera view direction (prog.cl:79-81,
  // :335).
  const float intens_d = max0(dot3(dd, nv));
  float ed[3], hw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ed[k] = eye[k] - p[k];
  norm3(ed);
#pragma unroll
  for (int k = 0; k < 3; ++k) hw[k] = ed[k] + dd[k];
  norm3(hw);
  const float intens_s = powf(max0(dot3(nv, hw)), mat[2]);
  const float emit_cos = max0(dot3(nd, nv));

  // Factor updates and the emitter pickup (prog.cl:329-366).
  const bool use_diff = is_diff || is_emit;
  const float* kds[3] = {ksx, ksy, ksz};
  float col[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float kd = mat[3 + k];
    if (kds[k] != nullptr) kd = kd * kds[k][i];
    const float ks = mat[6 + k], em = mat[9 + k];
    float fl = SR_(FL + k), fb = SR_(FB + k), fs = SR_(FS + k),
          fq = SR_(FR + k);
    fl = is_diff ? fl * (kd * intens_d) : fl;
    fb = is_diff ? fb * (ks * intens_s) : fb;
    fs = is_spec ? fs * fr[k] : fs;
    fq = is_refr ? fq * rf[k] : fq;
    const float c = SR_(COL + k);
    col[k] = is_emit ? c + em * ((fl + fb) * (fs * fq)) * emit_cos : c;
    if (colors == nullptr) {
      // The next ray; a lane that missed or was dead keeps its ray.
      const float vp = is_refr ? (refracted ? rpo[k] : dp[k]) : dp[k];
      const float vd = is_refr ? (refracted ? rd[k] : sd[k]) : sd[k];
      So[(size_t)(RAYP + k) * N + i] = has_hit ? (use_diff ? dp[k] : vp)
                                               : rp[k];
      So[(size_t)(RAYD + k) * N + i] = has_hit ? (use_diff ? dd[k] : vd)
                                               : d[k];
      So[(size_t)(FL + k) * N + i] = fl;
      So[(size_t)(FB + k) * N + i] = fb;
      So[(size_t)(FS + k) * N + i] = fs;
      So[(size_t)(FR + k) * N + i] = fq;
      So[(size_t)(COL + k) * N + i] = col[k];
    }
  }
  if (colors != nullptr) {
    // The last bounce: the progressive average (prog.cl:379).
    colors[i] = (c0[i] * s_f + col[0]) * inv;
    colors[N + i] = (c1[i] * s_f + col[1]) * inv;
    colors[2 * N + i] = (c2[i] * s_f + col[2]) * inv;
  } else {
    const bool ins = is_refr ? new_inside : inside;
    flags_o[i] = (has_hit ? ALIVE : 0) | (ins ? INSIDE : 0);
  }
#undef SR_
}

}  // namespace

extern "C" int ptx_bounce_raygen(const float* table, float* S, int* flags,
                                 int n, int first_id, int x_dim, float xm,
                                 float ym, unsigned sample, unsigned k0,
                                 unsigned k1, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  raygen_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      table, S, flags, n, first_id, x_dim, xm, ym, sample, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptx_bounce(const float* S, const int* flags, const float* ht,
                          const float* hpx, const float* hpy,
                          const float* hpz, const float* hnx,
                          const float* hny, const float* hnz,
                          const int* hmati, const float* ksx,
                          const float* ksy, const float* ksz,
                          const float* table, int n_mats, float* So,
                          int* flags_o, const float* c0, const float* c1,
                          const float* c2, float* colors,
                          unsigned long long* counter, int n,
                          unsigned sample, unsigned salt, unsigned k0,
                          unsigned k1, float s_f, float inv, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bounce_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      S, flags, ht, hpx, hpy, hpz, hnx, hny, hnz, hmati, ksx, ksy, ksz,
      table, n_mats, So, flags_o, c0, c1, c2, colors, counter, n, sample,
      salt, k0, k1, s_f, inv);
  return static_cast<int>(cudaGetLastError());
}
