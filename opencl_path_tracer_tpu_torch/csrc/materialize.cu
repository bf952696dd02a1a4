// K18m: the operand copy before each block-march launch.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// march_kernel.py::_pallas_materialize's copy3 (an identity pallas_call
// that makes XLA materialize the march kernel's operands with standard
// layouts).
//
// What it computes. Copies of the visit list (L int32), the sorted rays
// (8 n float32) and their features (32 n bf16), byte for byte.
//
// What bounds it on the H100: bytes, each input read once and each output
// written once. What the design does about it: each buffer has its own
// range of blocks (from prefix counts taken on the host), so no thread
// asks which buffer a word belongs to; a thread moves kVec 16-byte
// vectors, all loads issued before the stores, with 32-bit indices inside
// a block. The vectors start where the destination is 16-byte aligned; the
// first block of each range copies the head before that point and the
// tail after the last whole vector in 2-byte units (an odd L, a view with
// a storage offset). A source whose vectors are not 16-byte aligned where
// the destination's are is read in 4-byte (or 2-byte) pieces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyBlock = 256;
constexpr int kVec = 4;   // 16-byte vectors per thread

struct Span {
  const unsigned char* src;
  unsigned char* dst;
  size_t head;      // bytes before the first vector (dst 16-byte aligned)
  size_t nvec;      // whole 16-byte vectors after the head
  unsigned tail;    // bytes after the last vector
  unsigned blocks;  // blocks of this buffer's range
  int src_align;    // 16, 4 or 2: the source's alignment at the vectors
};

struct Spans {
  Span s[3];
};

template <int kAlign>
__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  if constexpr (kAlign == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else if constexpr (kAlign == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
    uint4 v;
    uint16_t* o = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = h[k];
    return v;
  }
}

template <int kAlign>
__device__ __forceinline__ void copy_vectors(const Span& s, unsigned b) {
  const unsigned char* src = s.src + s.head;
  uint4* dst = reinterpret_cast<uint4*>(s.dst + s.head);
  const size_t base = (size_t)b * (kCopyBlock * kVec);
  const size_t left = s.nvec - base;
  const unsigned n = left < kCopyBlock * kVec ? static_cast<unsigned>(left)
                                              : kCopyBlock * kVec;
  uint4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const unsigned k = threadIdx.x + j * kCopyBlock;
    if (k < n) v[j] = load16<kAlign>(src + 16 * (base + k));
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const unsigned k = threadIdx.x + j * kCopyBlock;
    if (k < n) dst[base + k] = v[j];
  }
}

__global__ void __launch_bounds__(kCopyBlock) copy3_kernel(Spans sp) {
  // This block's buffer, chosen without indexing the parameter array.
  unsigned b = blockIdx.x;
  Span s = sp.s[0];
  if (b >= sp.s[0].blocks) {
    b -= sp.s[0].blocks;
    s = sp.s[1];
    if (b >= sp.s[1].blocks) {
      b -= sp.s[1].blocks;
      s = sp.s[2];
    }
  }
  if (b == 0) {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(s.src);
    uint16_t* dst = reinterpret_cast<uint16_t*>(s.dst);
    const size_t tail0 = (s.head + 16 * s.nvec) / 2;
    const unsigned nh = static_cast<unsigned>(s.head / 2);
    const unsigned k = threadIdx.x;
    if (k < nh) dst[k] = src[k];
    else if (k < nh + s.tail / 2) dst[tail0 + k - nh] = src[tail0 + k - nh];
  }
  if (s.src_align == 16) {
    copy_vectors<16>(s, b);
  } else if (s.src_align == 4) {
    copy_vectors<4>(s, b);
  } else {
    copy_vectors<2>(s, b);
  }
}

Span make_span(const void* src, void* dst, size_t nbytes) {
  Span s;
  s.src = static_cast<const unsigned char*>(src);
  s.dst = static_cast<unsigned char*>(dst);
  const size_t to16 = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  s.head = to16 < nbytes ? to16 : nbytes;
  s.nvec = (nbytes - s.head) / 16;
  s.tail = static_cast<unsigned>(nbytes - s.head - 16 * s.nvec);
  const size_t per_block = (size_t)kCopyBlock * kVec;
  s.blocks = nbytes ? static_cast<unsigned>(
                          s.nvec ? (s.nvec + per_block - 1) / per_block : 1)
                    : 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(s.src) + s.head;
  s.src_align = at % 16 == 0 ? 16 : at % 4 == 0 ? 4 : 2;
  return s;
}

}  // namespace

// Counts are elements: n_clist int32, n_rays float32, n_feat bf16. Every
// pointer is aligned to its element.
extern "C" int ptx_materialize(const void* clist, const void* rays8,
                               const void* feat, void* clist_out,
                               void* rays8_out, void* feat_out, int n_clist,
                               int n_rays, int n_feat, void* stream) {
  if (n_clist < 0 || n_rays < 0 || n_feat < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Spans sp;
  sp.s[0] = make_span(clist, clist_out, 4 * (size_t)n_clist);
  sp.s[1] = make_span(rays8, rays8_out, 4 * (size_t)n_rays);
  sp.s[2] = make_span(feat, feat_out, 2 * (size_t)n_feat);
  const size_t blocks =
      (size_t)sp.s[0].blocks + sp.s[1].blocks + sp.s[2].blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  copy3_kernel<<<static_cast<unsigned>(blocks), kCopyBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(sp);
  return static_cast<int>(cudaGetLastError());
}
