// K18m: the operand copy before each block-march launch.
//
// Replaces the TPU kernel opencl_path_tracer_tpu/ops/pallas/
// march_kernel.py::_pallas_materialize's copy3 (an identity pallas_call
// that makes XLA materialize the march kernel's operands with standard
// layouts).
//
// What it computes. Copies of the visit list (L int32), the sorted rays
// (8 n float32) and their features (32 n bf16), word for word.
//
// What bounds it on the H100: bytes, each input read once and each output
// written once. One grid-stride loop over the three buffers' 32-bit
// words (the bf16 rows hold an even count).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyBlock = 256;

__global__ void __launch_bounds__(kCopyBlock)
copy3_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             const uint32_t* __restrict__ c, uint32_t* __restrict__ ao,
             uint32_t* __restrict__ bo, uint32_t* __restrict__ co, size_t na,
             size_t nb, size_t nc) {
  const size_t total = na + nb + nc;
  for (size_t k = static_cast<size_t>(blockIdx.x) * kCopyBlock + threadIdx.x;
       k < total; k += static_cast<size_t>(gridDim.x) * kCopyBlock) {
    if (k < na) {
      ao[k] = a[k];
    } else if (k < na + nb) {
      bo[k - na] = b[k - na];
    } else {
      co[k - na - nb] = c[k - na - nb];
    }
  }
}

}  // namespace

extern "C" int ptx_materialize(const void* clist, const void* rays8,
                               const void* feat, void* clist_out,
                               void* rays8_out, void* feat_out, int n_clist,
                               int n_rays, int n_feat, void* stream) {
  if (n_clist < 0 || n_rays < 0 || n_feat < 0 || n_feat % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(n_clist) + n_rays + n_feat / 2;
  if (total == 0) return 0;
  const size_t blocks = (total + kCopyBlock - 1) / kCopyBlock;
  copy3_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                 kCopyBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(clist), static_cast<const uint32_t*>(rays8),
      static_cast<const uint32_t*>(feat), static_cast<uint32_t*>(clist_out),
      static_cast<uint32_t*>(rays8_out), static_cast<uint32_t*>(feat_out),
      n_clist, n_rays, n_feat / 2);
  return static_cast<int>(cudaGetLastError());
}
