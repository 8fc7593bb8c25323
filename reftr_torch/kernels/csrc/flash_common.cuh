// Pieces shared by the flash-attention kernels (flash_attn_fwd_dec.cu,
// flash_attn_bwd_dec.cu and the tensor-core kernels, bf16 and 3xTF32):
// dtype conversion, the logit of one (query, key) pair, and the
// attention-dropout parameters and random numbers.
//
// The logit. x = (s * scale) + bias, rounded at each step as the plain
// PyTorch version rounds it (no contraction into an fma), with bias 0 for a
// valid key and -1e9 for a masked one. In a batch row whose keys are all
// masked every logit is about -1e9, where a float32 ulp is 64, so
// exp(x - lse) would lose every digit: there the kernels add 1e9 back
// (exact), which leaves the softmax unchanged and keeps lse (and so the
// backward's p = exp(x - lse)) exact. The row is then the uniform average
// of the eager path (reftr_tpu/nn/attention.py:139-155), and so is its
// gradient.
//
// Dropout. Philox4x32-10 (Salmon et al., SC'11), keyed by the call's 64-bit
// seed and counted by the element's absolute offset
// n = ((b * H + h) * Sq + i) * Sk + j: the counter is n / 4 and the element
// takes word n % 4 of the four the generator returns. The keep decision,
// (word >> 8) >= threshold with threshold = ceil(rate * 2^24), is then a
// pure function of (seed, b, h, i, j): it does not depend on block sizes or
// on how threads map to keys, so the forward, both backward kernels and the
// plain version (kernels/attention.py::philox_keep_plain) draw one mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskBias = -1e9f;

// A call's dropout: threshold = ceil(rate * 2^24) (0 = no dropout) and
// inv_keep = 1 / (1 - rate), from the wrapper.
struct Dropout {
  uint64_t seed;
  uint32_t threshold;
  float inv_keep;
};

// 1 if the element whose Philox word is `word` is kept, else 0.
__device__ __forceinline__ uint32_t kept(uint32_t word, const Dropout& dr) {
  return (word >> 8) >= dr.threshold;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the nearest bf16 (ties to even), as a float: a dot operand
// of the mxu_bf16 mode (reftr_tpu/kernels/attention.py::_mxu), whose
// products take bf16 operands and sum in f32; the product of two such
// operands is exact in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 1e9 when every key of batch row b is masked, else 0. Every thread of the
// block must call it (it ends in a block-wide vote).
__device__ __forceinline__ float masked_row_shift(const uint8_t* valid, int b,
                                                  int Sk) {
  int any = valid == nullptr;
  if (valid != nullptr)
    for (int j = threadIdx.x; j < Sk && !any; j += blockDim.x)
      any = valid[(long)b * Sk + j] != 0;
  return __syncthreads_or(any) ? 0.f : 1e9f;
}

__device__ __forceinline__ float logit(float dot, float scale, float bias,
                                       float shift) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), bias), shift);
}

// The four words of Philox4x32-10 at counter (ctr, 0, 0) under key `seed`.
__device__ __forceinline__ uint4 philox4(uint64_t seed, uint64_t ctr) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t pick_word(uint4 r, uint64_t n) {
  const uint32_t w = n & 3;
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// Word n % 4 of Philox4x32-10 at counter (n / 4, 0, 0) under key `seed`.
__device__ __forceinline__ uint32_t philox_word(uint64_t seed, uint64_t n) {
  return pick_word(philox4(seed, n >> 2), n);
}

// The dropout multiplier of element n: inv_keep where kept, 0 where dropped.
__device__ __forceinline__ float keep_scale(uint64_t seed, uint64_t n,
                                            uint32_t threshold,
                                            float inv_keep) {
  return (philox_word(seed, n) >> 8) >= threshold ? inv_keep : 0.f;
}

}  // namespace flash
