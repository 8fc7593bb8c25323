// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes:
// the SIMT variant of K1.
//
// What it serves: no call of the dispatch rule
// (kernels/attention.py::fwd_variant). Calls with 16 or more queries take
// the tensor-core kernels, flash_attn_fwd_tc.cu in bf16 and
// flash_attn_fwd_f32tc.cu in float32 (3xTF32), and every call with fewer,
// the decoder's single query, takes flash_attn_fwd_dec.cu. It stays built
// as the variant the others are timed against in chip_smoke.py.
//
// Replaces the TPU kernel `_flash_kernel` of reftr_tpu/kernels/attention.py
// (driven by `_fwd`, pallas_call at :210): out = softmax(q k^T / sqrt(D) +
// bias) v per (batch, head), with an f32 running max, denominator and
// accumulator, q/k/v in f32 or bf16 upcast on load, out in the input dtype
// and an optional row logsumexp (always written in training, for the
// backward kernels of flash_attn_bwd.cu).
//
// Attention dropout, in the TPU kernel's order (`_flash_kernel` :106-125):
// the denominator sums the un-dropped p, and only the numerator p v is
// dropped and scaled by 1 / (1 - rate). The mask is Philox keyed by the
// call's seed and counted by the element's absolute offset
// (flash_common.cuh), so it does not depend on the tiling; the TPU kernel
// keys its PRNG by tile and must run its forward at the backward's tiles
// (:476-480), which this kernel need not.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], all
// contiguous (the layout the projections produce, so no transposes);
// valid [B, Sk] bool (True = keep, nullable; a masked key gets the additive
// -1e9 of the TPU kernel's bias row); lse [B, H, Sq] f32 (nullable).
// Keys past Sk are left out of the sum entirely (the TPU kernel pads them
// with -1e9 instead), so a row whose keys are all masked gives the same
// finite uniform average as the eager path (see flash_common.cuh for the
// lse of such a row).
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
// block waits on every tile load), vectorised 16-byte loads, the
// redundant exp of the per-chunk rescale, and one Philox call per element
// with dropout where one call gives four elements' words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Dropout;
using flash::from_f32;
using flash::to_f32;

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 8;      // keys per online-softmax rescale
// keys staged in shared memory per step: 64, or 32 at D = 128, where 64
// rows of K and V would pass the 48 KB of static shared memory
template <int D>
constexpr int kTileK = D <= 64 ? 64 : 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ valid,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, int G, int n_qt, float scale, uint64_t seed,
                 uint32_t threshold, float inv_keep) {
  // rows padded to D + 1 floats: the G threads of a row read G different
  // keys at the same d, which would otherwise share one bank
  constexpr int kTile = kTileK<D>;
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];
  __shared__ float bs[kTile];

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
  const float shift = flash::masked_row_shift(valid, b, Sk);
  // dropout offset of (b, h, row, key 0)
  const uint64_t n_row = ((uint64_t)bh * Sq + (live ? row : 0)) * Sk;

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
  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    const int nk = min(kTile, Sk - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const long off = (long)(k0 + j) * row_stride + d;
      ks[j][d] = to_f32(kb[off]);
      vs[j][d] = to_f32(vb[off]);
    }
    for (int j = tid; j < nk; j += kThreads)
      bs[j] = (valid == nullptr || valid[(long)b * Sk + k0 + j])
                  ? 0.f
                  : flash::kMaskBias;
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
          x = flash::logit(dot, scale, bs[j], shift);
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
          l += p;  // the denominator sums the un-dropped p
          const float pv =
              threshold == 0u
                  ? p
                  : p * flash::keep_scale(seed, n_row + k0 + j, threshold,
                                          inv_keep);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(pv, vs[j][d], acc[d]);
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
                   int Sq, int Sk, int G, float scale, Dropout dr,
                   cudaStream_t stream) {
  const int rows = kThreads / G;
  const int n_qt = (Sq + rows - 1) / rows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), lse, H, Sq, Sk,
      G, n_qt, scale, dr.seed, dr.threshold, dr.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, void* out, float* lse, int B,
                       int H, int Sq, int Sk, int D, int G, float scale,
                       Dropout dr, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, scale,
                           dr, stream);
    case 32:
      return launch<T, 32>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, scale,
                           dr, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, scale,
                           dr, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, out, lse, B, H, Sq, Sk, G, scale,
                            dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128}; scale = 1 /
// sqrt(the caller's head dim), which is below D where the caller zero-pads
// the head dim up to D. G: threads per query row, a power of two in
// [1, 32]. Dropout: threshold = ceil(rate * 2^24) (0 = none), inv_keep =
// 1 / (1 - rate). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const uint8_t* valid, void* out, float* lse, int B,
                              int H, int Sq, int Sk, int D, float scale,
                              int dtype, int G, uint64_t seed,
                              uint32_t threshold, float inv_keep,
                              void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || G < 1 || G > 32 ||
      (G & (G - 1)) != 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, valid, out, lse, B, H, Sq, Sk, D, G,
                                  scale, dr, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, valid, out, lse, B, H, Sq,
                                          Sk, D, G, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
