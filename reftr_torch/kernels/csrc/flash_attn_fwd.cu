// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_kernel` of reftr_tpu/kernels/attention.py
// (driven by `_fwd`, pallas_call at :210): out = softmax(q k^T / sqrt(D) +
// bias) v per (batch, head), with an f32 running max, denominator and
// accumulator, q/k/v in f32 or bf16 upcast on load, out in the input dtype
// and an optional row logsumexp. Attention dropout (the TPU kernel's
// in-kernel PRNG) is a training feature and is not part of this kernel.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], all
// contiguous (the layout the projections produce, so no transposes);
// valid [B, Sk] bool (True = keep, nullable; a masked key gets the additive
// -1e9 of the TPU kernel's bias row); lse [B, H, Sq] f32 (nullable).
// Keys past Sk are left out of the sum entirely (the TPU kernel pads them
// with -1e9 instead), so a row whose keys are all masked gives the same
// finite uniform average as the eager path.
//
// Design (simple first): one block of 128 threads per (batch*head, q tile).
// G threads share one query row (G a power of two up to 32, chosen by the
// caller: large G for the decoder's single query, 4 for long rows), so a
// block covers 128 / G rows. Each thread holds its row's q and an f32
// accumulator in registers and walks its share of keys (key j goes to the
// thread j mod G) in tiles of 64 keys staged in shared memory as f32, with
// an online softmax per chunk of 8 keys. At the end the G partial
// (max, denominator, accumulator) triples are merged with warp shuffles.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit, from the data
// sheet's rates: at the VL encoder's shape (B=8, H=8, S=440, D=32) the two
// products are 1.59 GFLOP, 23.7 us at the 67 TFLOP/s f32 SIMT rate, against
// 14.4 MB of q/k/v/out (4.3 us at 3.35 TB/s) in f32 (7.2 MB, 2.2 us in
// bf16): without tensor cores the kernel is bound by operations. Its
// measured times are in PERF.md. What this design leaves on the table:
// tensor cores (mma.sync / wgmma on bf16 tiles would lift the operation
// bound some 15x), TMA or cp.async double-buffering of the k/v tiles (the
// block waits on every tile load), vectorised 16-byte loads, and the
// redundant exp of the per-chunk rescale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTileK = 64;     // keys staged in shared memory per step
constexpr int kChunk = 8;      // keys per online-softmax rescale

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ valid,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int G, int n_qt, float scale) {
  // rows padded to D + 1 floats: the G threads of a row read G different
  // keys at the same d, which would otherwise share one bank
  __shared__ float ks[kTileK][D + 1];
  __shared__ float vs[kTileK][D + 1];
  __shared__ float bs[kTileK];

  const int rows = kThreads / G;
  const int bh = blockIdx.x / n_qt;  // b * H + h
  const int qt = blockIdx.x % n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int sub = tid % G;  // this thread's share of the keys
  const int row = qt * rows + tid / G;
  const bool live = row < Sq;
  const long row_stride = (long)H * D;  // elements between tokens

  float qr[D];
  float acc[D];
  {
    const T* qp = q + ((long)b * Sq + (live ? row : 0)) * row_stride + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f32(qp[d]);
      acc[d] = 0.f;
    }
  }
  float m = -INFINITY;  // running max over this thread's keys
  float l = 0.f;        // running denominator

  const T* kb = k + (long)b * Sk * row_stride + h * D;
  const T* vb = v + (long)b * Sk * row_stride + h * D;
  for (int k0 = 0; k0 < Sk; k0 += kTileK) {
    const int nk = min(kTileK, Sk - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const long off = (long)(k0 + j) * row_stride + d;
      ks[j][d] = to_f32(kb[off]);
      vs[j][d] = to_f32(vb[off]);
    }
    for (int j = tid; j < nk; j += kThreads)
      bs[j] = (valid == nullptr || valid[(long)b * Sk + k0 + j]) ? 0.f : -1e9f;
    __syncthreads();

    // this thread's keys in the tile: j = sub, sub + G, ...
    for (int j0 = sub; j0 < nk; j0 += G * kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c * G;
        float x = -INFINITY;
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
          x = dot * scale + bs[j];
        }
        s[c] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);  // finite: j0 < nk
      const float corr = expf(m - m_new);  // 0 on the first chunk
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c * G;
        if (j < nk) {
          const float p = expf(s[c] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  // merge the G partial softmax states of this row (lanes sub = 0..G-1 are
  // adjacent in one warp; every lane of the warp takes part)
  float m_row = m;
  for (int o = G / 2; o > 0; o /= 2)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, o));
  const float f = (m == -INFINITY) ? 0.f : expf(m - m_row);
  l *= f;
  for (int o = G / 2; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float inv_l = 1.f / l;
  T* op = out + ((long)b * Sq + (live ? row : 0)) * row_stride + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * f;
    for (int o = G / 2; o > 0; o /= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (live && (d % G) == sub) op[d] = from_f32<T>(a * inv_l);
  }
  if (lse != nullptr && live && sub == 0)
    lse[(long)bh * Sq + row] = m_row + logf(l);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, void* out, float* lse, int B, int H,
                   int Sq, int Sk, int G, cudaStream_t stream) {
  const int rows = kThreads / G;
  const int n_qt = (Sq + rows - 1) / rows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), lse, H, Sq, Sk,
      G, n_qt, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, void* out, float* lse, int B,
                       int H, int Sq, int Sk, int D, int G,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, stream);
    case 32:
      return launch<T, 32>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. G: threads per query row, a power of two
// in [1, 32]. Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const uint8_t* valid, void* out, float* lse, int B,
                              int H, int Sq, int Sk, int D, int dtype, int G,
                              void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || G < 1 || G > 32 ||
      (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, valid, out, lse, B, H, Sq, Sk, D, G,
                                  s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, valid, out, lse, B, H, Sq,
                                          Sk, D, G, s);
  return (int)cudaErrorInvalidValue;
}
