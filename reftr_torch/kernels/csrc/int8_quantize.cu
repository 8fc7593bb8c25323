// The int8 quantize pass of the int8 serving path (nn/quant.py):
//
//   q = clip(rint(x * (1 / in_scale)), -127, 127) as int8
//
// over a contiguous float32 or bf16 tensor of any layout (NHWC activations
// before a QuantConv, [M, K] rows before a QuantDense). It replaces no
// Pallas kernel: the JAX package leaves this chain to XLA, which fuses it
// into the int8 conv or dot that reads it (reftr_tpu/nn/quant.py:74-76,
// 115-117). On the H100 the int8 product (int8_conv.cu) reads int8, so the
// pass stands alone.
//
// Bit-exact with the plain version (kernels/quant.py::quantize_plain):
// inv = 1 / in_scale is the IEEE float32 division (__fdiv_rn), as torch's
// and JAX's `1.0 / in_scale` on a float32 scalar, read from device memory
// so the host never waits; the product is __fmul_rn (no contraction);
// rounding is half to even (rintf), as torch.round and jnp.round, not
// roundf's half away from zero.
//
// Bound: bytes. It reads 2 or 4 bytes and writes 1 per element, one
// multiply and a round a byte; each thread moves 8 elements with one
// 16- or 32-byte load and one 8-byte store where the tensors are aligned
// and the count a multiple of 8 (the model's tensors: every width is a
// multiple of 64), element by element otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t quantize(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(r, -kQmax), kQmax)));
}

// 8 elements of x as floats, from one aligned vector load.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_quantize_kernel(const T* __restrict__ x,
                         const float* __restrict__ in_scale,
                         int8_t* __restrict__ q, long long n) {
  const float inv = __fdiv_rn(1.f, *in_scale);
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {
    for (; i < n / 8; i += step) {
      float v[8];
      load8(x + i * 8, v);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= (uint32_t)(uint8_t)quantize(v[j], inv) << (8 * j);
        hi |= (uint32_t)(uint8_t)quantize(v[j + 4], inv) << (8 * j);
      }
      reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
    }
  } else {
    for (; i < n; i += step) q[i] = quantize(to_f32(x[i]), inv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* in_scale, int8_t* q,
                   long long n, int vec, cudaStream_t stream) {
  const long long work = vec ? n / 8 : n;
  const long long blocks_needed = (work + kThreads - 1) / kThreads;
  // a grid-stride loop: at most 132 SMs x 16 blocks in flight
  const int blocks = (int)(blocks_needed < 132 * 16 ? blocks_needed
                                                     : 132 * 16);
  if (vec)
    int8_quantize_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), in_scale, q, n);
  else
    int8_quantize_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), in_scale, q, n);
  return cudaGetLastError();
}

}  // namespace

// x: n elements, float32 (dtype 0) or bf16 (dtype 1); in_scale: one
// float32 on the device; q: n int8. vec: x 16-byte and q 8-byte aligned
// and n a multiple of 8 (the wrapper decides). Returns the launch's
// cudaError_t.
extern "C" int int8_quantize(const void* x, const void* in_scale, void* q,
                             long long n, int dtype, int vec, void* stream) {
  if (n <= 0 || (vec && n % 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scale = static_cast<const float*>(in_scale);
  int8_t* out = static_cast<int8_t*>(q);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, scale, out, n, vec, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, scale, out, n, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
