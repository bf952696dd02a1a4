// K5: one fused fast-mode wavefront step (everything but the intersect).
//
// Replaces the TPU kernel opencl_path_tracer_tpu/models/fused_step.py::
// _step_kernel (launched by make_fused_step's step).
//
// What it computes, per lane, from the packed state F (32, N) float32,
// I (8, N) int32 and the hit rows H [t, nx, ny, nz, mati, pending]:
// the material fetch (an index outside [0, M) selects material 0, the
// TPU's where-chain), the fast murmur3 counter-hash draws keyed by
// (step, lane), the four BSDF branches selected per lane, the factor
// updates and the emitter pickup, termination, the fold into the running
// average and the regenerated camera ray; a PENDING lane is frozen (no
// draws consumed, no factor update, no bounce, ray unchanged). It writes
// new F and I packs. Every expression is the plain version's
// (models/fused_step.py::step_plain), operation for operation, built
// with --fmad=false and the IEEE sqrtf, sinf, cosf and powf (no fast
// math). The TPU bakes the camera and materials as kernel literals; here
// they are a small device table (16 camera floats, 16 per material), so
// a new scene needs no new build.
//
// What bounds it on the H100: bytes. It reads 128 + 32 + 24 bytes and
// writes 128 + 32 bytes per lane, with a few hundred float32 operations
// between; one thread per lane, rows read and written coalesced.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kCamCols = 16;
constexpr int kMatCols = 16;
constexpr float kEps = 0.001f;
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u, kGold = 0x9E3779B9u;

enum { COL = 0, RAYP = 3, RAYD = 6, FL = 9, FB = 12, FS = 15, FR = 18,
       CUR = 21, CX = 24, CY = 25, F_ROWS = 32 };
enum { SAMP = 0, PIX = 1, RNG = 2, INSIDE = 3, BOUNCE = 4, I_ROWS = 8 };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// rng.fast_uniforms: two draws for (step, slot) of this lane.
__device__ __forceinline__ void draws(uint32_t lane, uint32_t step,
                                      uint32_t slot, uint32_t k0,
                                      uint32_t k1, float& u0, float& u1) {
  uint32_t base = lane * kGold + k0;
  base ^= step * kM1;
  base += slot * kM2;
  const uint32_t h0 = fmix32(fmix32(base ^ k1));
  const uint32_t h1 = fmix32(fmix32(base ^ kGold ^ k1));
  u0 = (float)(h0 >> 8) * (1.0f / 16777216.0f);
  u1 = (float)(h1 >> 8) * (1.0f / 16777216.0f);
}

// max(x, 0) that passes NaN through, as torch.clamp_min and jnp.maximum.
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float r = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * r;
  y = y * r;
  z = z * r;
}

__global__ void __launch_bounds__(kBlock)
fused_step_kernel(const float* __restrict__ F, const int* __restrict__ I,
                  const float* __restrict__ H,
                  const float* __restrict__ table, int n_mats,
                  float* __restrict__ Fo, int* __restrict__ Io, int n,
                  uint32_t step, uint32_t k0, uint32_t k1, int iters) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t N = static_cast<size_t>(n);
#define FR_(r) F[(size_t)(r) * N + i]
#define IR_(r) I[(size_t)(r) * N + i]
  const float* cam = table;
  const float t = H[i];
  const float nx0 = H[N + i], ny0 = H[2 * N + i], nz0 = H[3 * N + i];
  int mati = static_cast<int>(H[4 * N + i]);
  const bool pending = H[5 * N + i] > 0.0f;
  if (mati < 0 || mati >= n_mats) mati = 0;
  const float* mat = table + kCamCols + (size_t)mati * kMatCols;

  const float px = FR_(RAYP), py = FR_(RAYP + 1), pz = FR_(RAYP + 2);
  const float dx = FR_(RAYD), dy = FR_(RAYD + 1), dz = FR_(RAYD + 2);
  const bool has_hit = t > 0.0f && !pending;
  const float safe_t = has_hit ? t : 0.0f;
  const float hx = px + dx * safe_t, hy = py + dy * safe_t,
              hz = pz + dz * safe_t;

  float r1, r2;
  draws(static_cast<uint32_t>(i), step, 0u, k0, k1, r1, r2);

  const int mtype = static_cast<int>(mat[0]);
  const bool is_diff = has_hit && mtype == 0;
  const bool is_spec = has_hit && mtype == 1;
  const bool is_refr = has_hit && mtype == 2;
  const bool is_emit = has_hit && mtype == 3;

  // Normal flipped toward the ray (prog.cl:326-328).
  const bool flip = (dx * nx0 + dy * ny0 + dz * nz0) > 0.0f;
  const float nx = flip ? -nx0 : nx0, ny = flip ? -ny0 : ny0,
              nz = flip ? -nz0 : nz0;

  // Diffuse bounce (prog.cl:186-218).
  const bool near_y = fabsf(nx) <= kEps && fabsf(nz) <= kEps;
  const float rl_a = 1.0f / sqrtf(ny * ny + nz * nz);
  const float rl_b = 1.0f / sqrtf(nx * nx + nz * nz);
  const float zx = near_y ? 0.0f : -nz * rl_b;
  const float zy = near_y ? -nz * rl_a : 0.0f;
  const float zz = near_y ? ny * rl_a : nx * rl_b;
  const float xx = ny * zz - nz * zy;
  const float xy = nz * zx - nx * zz;
  const float xz = nx * zy - ny * zx;
  const float rr = sqrtf(r1);
  const float theta = kTwoPi * r2;
  const float sx = rr * cosf(theta);
  const float sy = rr * sinf(theta);
  const float sz = sqrtf(1.0f - r1);
  float ddx = xx * sx + nx * sz + zx * sy;
  float ddy = xy * sx + ny * sz + zy * sy;
  float ddz = xz * sx + nz * sz + zz * sy;
  norm3(ddx, ddy, ddz);
  const float dpx = hx + nx * kEps, dpy = hy + ny * kEps,
              dpz = hz + nz * kEps;

  // Specular bounce (prog.cl:223-227); its origin is the diffuse one.
  const float cosa_s = nx * dx + ny * dy + nz * dz;
  float sdx = dx - nx * cosa_s * 2.0f, sdy = dy - ny * cosa_s * 2.0f,
        sdz = dz - nz * cosa_s * 2.0f;
  norm3(sdx, sdy, sdz);

  // Fresnel (prog.cl:219-222).
  const float om = 1.0f - fabsf(nx * dx + ny * dy + nz * dz);
  const float p2 = om * om;
  const float p5 = p2 * p2 * om;
  const float frx = mat[12] + (1.0f - mat[12]) * p5;
  const float fry = mat[13] + (1.0f - mat[13]) * p5;
  const float frz = mat[14] + (1.0f - mat[14]) * p5;

  // Refractive bounce (prog.cl:228-245, 346-357).
  const int inside_i = IR_(INSIDE);
  const float mat_n = mat[1];
  const float n_eff = inside_i != 0 ? 1.0f / mat_n : mat_n;
  const float cosa_r = -(dx * nx + dy * ny + dz * nz);
  const float disc = 1.0f - (1.0f - cosa_r * cosa_r) / n_eff / n_eff;
  const float prob = (frx + fry + frz) / 3.0f;
  const bool refracted = disc > 0.0f && r1 > prob;
  const float inv_n = 1.0f / n_eff;
  const float sq = sqrtf(max0(disc));
  float rdx = dx * inv_n + nx * (cosa_r * inv_n - sq);
  float rdy = dy * inv_n + ny * (cosa_r * inv_n - sq);
  float rdz = dz * inv_n + nz * (cosa_r * inv_n - sq);
  norm3(rdx, rdy, rdz);
  const float rpx = hx - nx * kEps, rpy = hy - ny * kEps,
              rpz = hz - nz * kEps;
  const int new_inside = (is_refr && refracted) ? 1 - inside_i : inside_i;
  const float inv_1mp = 1.0f / (1.0f - prob);
  const float inv_p = 1.0f / prob;
  const float fr3[3] = {frx, fry, frz};
  float rf3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rf3[k] = refracted ? (1.0f - fr3[k]) * inv_1mp : fr3[k] * inv_p;
  }

  // Blinn term with the camera view direction (prog.cl:329-340).
  float ex = cam[0] - hx, ey = cam[1] - hy, ez = cam[2] - hz;
  norm3(ex, ey, ez);
  float hwx = ex + ddx, hwy = ey + ddy, hwz = ez + ddz;
  norm3(hwx, hwy, hwz);
  const float ndh = max0(nx * hwx + ny * hwy + nz * hwz);
  const float intens_s = powf(ndh, mat[2]);
  const float intens_d = max0(ddx * nx + ddy * ny + ddz * nz);

  // The new ray (the emitter shares the diffuse bounce).
  const bool use_diff = is_diff || is_emit;
  const float newp[3] = {dpx, dpy, dpz}, newr[3] = {rpx, rpy, rpz},
              oldp[3] = {px, py, pz};
  const float newd[3] = {ddx, ddy, ddz}, refd[3] = {rdx, rdy, rdz},
              spd[3] = {sdx, sdy, sdz}, oldd[3] = {dx, dy, dz};
  float np_[3], nd_[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float vp = is_refr && refracted ? newr[k] : newp[k];
    const float vd = is_refr ? (refracted ? refd[k] : spd[k]) : spd[k];
    np_[k] = has_hit ? (use_diff ? newp[k] : vp) : oldp[k];
    nd_[k] = has_hit ? (use_diff ? newd[k] : vd) : oldd[k];
  }

  // Factor updates and the emitter pickup (prog.cl:329-366).
  const float emit_cos = max0(-(dx * nx + dy * ny + dz * nz));
  float fl[3], fb[3], fs[3], fr[3], cur[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float kd = mat[3 + k], ks = mat[6 + k], em = mat[9 + k];
    fl[k] = is_diff ? FR_(FL + k) * kd * intens_d : FR_(FL + k);
    fb[k] = is_diff ? FR_(FB + k) * ks * intens_s : FR_(FB + k);
    fs[k] = is_spec ? FR_(FS + k) * fr3[k] : FR_(FS + k);
    fr[k] = is_refr ? FR_(FR + k) * rf3[k] : FR_(FR + k);
    cur[k] = FR_(CUR + k);
    if (iters == 1 && has_hit) cur[k] = kd + em;   // preview
    if (is_emit) {
      cur[k] = cur[k] + em * (fl[k] + fb[k]) * fs[k] * fr[k] * emit_cos;
    }
  }

  // Terminate, fold, regenerate (models/wavefront.py).
  const bool active = !pending;
  const int bounce = active ? IR_(BOUNCE) + 1 : IR_(BOUNCE);
  const bool terminated = active && (!(t > 0.0f) || bounce >= iters);
  const int samp = IR_(SAMP);
  const float s_f = (float)samp;
  const float inv = 1.0f / (s_f + 1.0f);
  float g1, g2;
  draws(static_cast<uint32_t>(i), step, 1u, k0, k1, g1, g2);
  const float ndcx = (2.0f * (FR_(CX) + g1)) / cam[12] - 1.0f;
  const float ndcy = (2.0f * (FR_(CY) + g2)) / cam[13] - 1.0f;
  float gd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gd[k] = cam[3 + k] + cam[6 + k] * ndcx + cam[9 + k] * ndcy - cam[k];
  }
  norm3(gd[0], gd[1], gd[2]);

#define FO_(r) Fo[(size_t)(r) * N + i]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = FR_(COL + k);
    FO_(COL + k) = terminated ? (c * s_f + cur[k]) * inv : c;
    FO_(RAYP + k) = terminated ? cam[k] : np_[k];
    FO_(RAYD + k) = terminated ? gd[k] : nd_[k];
    FO_(FL + k) = terminated ? 1.0f : fl[k];
    FO_(FB + k) = terminated ? 1.0f : fb[k];
    FO_(FS + k) = terminated ? 1.0f : fs[k];
    FO_(FR + k) = terminated ? 1.0f : fr[k];
    FO_(CUR + k) = terminated ? 0.0f : cur[k];
  }
#pragma unroll
  for (int r = CX; r < F_ROWS; ++r) FO_(r) = FR_(r);
  Io[SAMP * N + i] = terminated ? samp + 1 : samp;
  Io[PIX * N + i] = IR_(PIX);
  Io[RNG * N + i] = IR_(RNG);
  Io[INSIDE * N + i] = terminated ? 0 : new_inside;
  Io[BOUNCE * N + i] = terminated ? 0 : bounce;
#pragma unroll
  for (int r = BOUNCE + 1; r < I_ROWS; ++r) Io[(size_t)r * N + i] = IR_(r);
#undef FO_
#undef FR_
#undef IR_
}

}  // namespace

extern "C" int ptx_fused_step(const float* F, const int* I, const float* H,
                              const float* table, int n_mats, float* Fo,
                              int* Io, int n, unsigned step, unsigned k0,
                              unsigned k1, int iters, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  fused_step_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      F, I, H, table, n_mats, Fo, Io, n, step, k0, k1, iters);
  return static_cast<int>(cudaGetLastError());
}
