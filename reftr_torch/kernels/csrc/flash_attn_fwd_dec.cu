// Flash-attention forward for short query sides on Hopper (sm_90a), plain C
// interface for ctypes: K1-dec.
//
// What it serves: every call with fewer than 16 queries, in float32 and
// bf16 (kernels/attention.py::fwd_variant): the decoder's single query,
// whose self-attention sees 1 key and whose cross-attention sees the 440
// tokens of the VL memory. Calls with 16 or more queries take
// flash_attn_fwd_tc.cu (bf16) or flash_attn_fwd_f32tc.cu (float32).
//
// Replaces, for those calls, the TPU kernel `_flash_kernel` of
// reftr_tpu/kernels/attention.py (:86-132, driven by `_fwd` :135-228,
// pallas_call at :210). The contract is flash_attn_fwd_tc.cu's: out =
// softmax(q k^T / sqrt(D) + bias) v per (batch, head) with an f32 running
// max, denominator and accumulator (q, k, v upcast on load), the logit and
// the fully masked row's shift of flash_common.cuh, attention dropout after
// the denominator with the same Philox mask, output rounded once to the
// input dtype, and the row logsumexp on request (training needs it).
// Layout q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], contiguous
// and 16-byte aligned, float32 or bf16; valid [B, Sk] bool (nullable); lse
// [B, H, Sq] f32 (nullable); D in {16, 32, 64, 128} (at D = 128 a
// thread's q, accumulator and key rows pass the 255 registers and spill).
//
// mxu_bf16 (dtype 2, T = float, kMxu): the TPU kernel's `_mxu` mode
// (:69-83) for float32 callers: q, each key row and each value row are
// rounded to bf16 as they are loaded, and so is p * keep before it
// multiplies v; the sums, the softmax and the output stay float32.
//
// Design. A short query side is bound by reading K and V once, and a
// 64-row tile would be mostly empty rows, so:
// - One block of 4 warps per (batch * head, query row). The warps split the
//   keys into contiguous quarters (a multiple of 4 keys each), and each lane
//   owns 4 consecutive keys per step of 128, whose K and V rows it reads
//   with 16-byte vector loads straight from global memory: no shared-memory
//   staging and no __syncthreads in the key loop. Where Sk % 4 == 0 one
//   Philox call gives exactly the lane's 4 keep words, with no shuffle;
//   elsewhere one call per element.
// - Online softmax per lane: its (max, denominator, accumulator) triple is
//   rescaled once per step of 4 keys. At the end the 32 lanes' triples are
//   merged by shuffles, then the 4 warps' through shared memory.
// - 64 blocks at the decoder's B=8, H=8 on 132 SMs: the keys are not split
//   across blocks, since one block per (b, h) already reads its 56 KB of K
//   and V with every load in flight at once, and a split would need a
//   second pass to merge the blocks' triples.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the decoder's cross-attention (B=8, Sq=1, Sk=440, H=8, D=32) the call
// reads 3.6 MB of K and V in bf16 (7.2 MB in float32): 1.08 us (2.15 us)
// at 3.35 TB/s, against 3.6 MFLOP, well under a microsecond at the 67
// TFLOP/s f32 SIMT rate: bound by bytes. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Dropout;
using flash::from_f32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 4;                 // consecutive keys a lane owns
constexpr int kStep = 32 * kPerLane;        // keys a warp takes per step

// One row of D elements as f32, by 16-byte vector loads (the row must be
// 16-byte aligned).
template <int D>
__device__ __forceinline__ void load_row(float (&x)[D], const float* p) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 f = __ldg(v + i);
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

template <int D>
__device__ __forceinline__ void load_row(float (&x)[D],
                                         const __nv_bfloat16* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 u = __ldg(v + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of its f32
      x[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      x[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// x's D elements rounded to bf16 where the call takes bf16 products.
template <bool kMxu, int D>
__device__ __forceinline__ void operand(float (&x)[D]) {
  if constexpr (kMxu) {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = flash::round_bf16(x[d]);
  }
}

template <typename T, int D, bool kMxu>
__global__ void __launch_bounds__(kThreads)
flash_fwd_dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ valid, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int quarter, float scale, Dropout dr) {
  __shared__ float wm[kWarps], wl[kWarps], wacc[kWarps][D];

  const int row = blockIdx.x;  // (b * H + h) * Sq + i
  const int bh = row / Sq, i = row % Sq;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long row_stride = (long)H * D;
  const long q_off = ((long)b * Sq + i) * row_stride + h * D;
  const T* kb = k + (long)b * Sk * row_stride + h * D;
  const T* vb = v + (long)b * Sk * row_stride + h * D;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + (long)b * Sk;
  const uint64_t n_row = (uint64_t)row * Sk;  // dropout offset of key 0
  const float shift = flash::masked_row_shift(valid, b, Sk);

  float qr[D], acc[D];
  load_row<D>(qr, q + q_off);
  operand<kMxu>(qr);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max over this lane's keys
  float l = 0.f;        // running denominator

  const int end = min((warp + 1) * quarter, Sk);
  for (int j0 = warp * quarter + lane * kPerLane; j0 < end; j0 += kStep) {
    // logits of keys j0..j0+3; those at or past `end` get -inf (their
    // loads read key Sk - 1, a valid address, and are not used)
    float x[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int j = min(j0 + e, Sk - 1);
      float kr[D];
      load_row<D>(kr, kb + j * row_stride);
      operand<kMxu>(kr);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float bias =
          (vrow == nullptr || vrow[j]) ? 0.f : flash::kMaskBias;
      x[e] = j0 + e < end ? flash::logit(dot, scale, bias, shift) : -INFINITY;
    }
    float mx = m;  // finite: key j0 < end
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) mx = fmaxf(mx, x[e]);
    const float corr = expf(m - mx);  // 0 on the lane's first step
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    m = mx;

    // the dropout multipliers of the 4 keys
    float kp[kPerLane] = {1.f, 1.f, 1.f, 1.f};
    if (dr.threshold != 0u) {
      if ((Sk & 3) == 0) {  // element offsets n_row + j0.. start a counter
        const uint4 w = flash::philox4(dr.seed, (n_row + j0) >> 2);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          kp[e] = flash::kept(words[e], dr) ? dr.inv_keep : 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          kp[e] = flash::keep_scale(dr.seed, n_row + j0 + e, dr.threshold,
                                    dr.inv_keep);
      }
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const float p = expf(x[e] - m);  // 0 past `end`
      l += p;  // the denominator sums the un-dropped p
      const float pv = kMxu ? flash::round_bf16(p * kp[e]) : p * kp[e];
      float vr[D];
      load_row<D>(vr, vb + min(j0 + e, Sk - 1) * row_stride);
      operand<kMxu>(vr);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pv, vr[d], acc[d]);
    }
  }

  // merge the warp's 32 triples (a lane without keys has m = -inf, l = 0)
  float mw = m;
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float f = m == -INFINITY ? 0.f : expf(m - mw);
  l *= f;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * f;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
    if ((d & 31) == lane) wacc[warp][d] = a;
  }
  if (lane == 0) {
    wm[warp] = mw;
    wl[warp] = l;
  }
  __syncthreads();

  // merge the 4 warps' triples (a warp without keys has max -inf)
  if (tid < D) {
    float mr = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mr = fmaxf(mr, wm[w]);
    float lr = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float fw = wm[w] == -INFINITY ? 0.f : expf(wm[w] - mr);
      lr += wl[w] * fw;
      a += wacc[w][tid] * fw;
    }
    out[q_off + tid] = from_f32<T>(a * (1.f / lr));
    if (lse != nullptr && tid == 0) lse[row] = mr + logf(lr);
  }
}

template <typename T, int D, bool kMxu>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, void* out, float* lse, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  const long blocks = (long)B * H * Sq;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  // each warp's share of the keys, a multiple of 4 so that a lane's 4 keys
  // start a Philox counter where Sk % 4 == 0
  const int quarter = ((Sk + kWarps - 1) / kWarps + kPerLane - 1) /
                      kPerLane * kPerLane;
  flash_fwd_dec_kernel<T, D, kMxu><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), lse, H, Sq, Sk,
      quarter, scale, dr);
  return cudaGetLastError();
}

template <typename T, bool kMxu = false>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, void* out, float* lse, int B,
                       int H, int Sq, int Sk, int D, float scale, Dropout dr,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16, kMxu>(q, k, v, valid, out, lse, B, H, Sq, Sk,
                                 scale, dr, stream);
    case 32:
      return launch<T, 32, kMxu>(q, k, v, valid, out, lse, B, H, Sq, Sk,
                                 scale, dr, stream);
    case 64:
      return launch<T, 64, kMxu>(q, k, v, valid, out, lse, B, H, Sq, Sk,
                                 scale, dr, stream);
    case 128:
      return launch<T, 128, kMxu>(q, k, v, valid, out, lse, B, H, Sq, Sk,
                                 scale, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float32 with bf16 products
// (mxu_bf16); q, k, v, out 16-byte aligned; scale =
// 1 / sqrt(the caller's head dim), which is below D where the caller
// zero-pads the head dim up to D. Dropout as in flash_attn_fwd: threshold =
// ceil(rate * 2^24) (0 = none), inv_keep = 1 / (1 - rate). Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attn_fwd_dec(const void* q, const void* k, const void* v,
                                  const uint8_t* valid, void* out, float* lse,
                                  int B, int H, int Sq, int Sk, int D,
                                  float scale, int dtype, uint64_t seed,
                                  uint32_t threshold, float inv_keep,
                                  void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, valid, out, lse, B, H, Sq, Sk, D,
                                  scale, dr, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, valid, out, lse, B, H, Sq,
                                          Sk, D, scale, dr, s);
  if (dtype == 2)
    return (int)dispatch_d<float, true>(q, k, v, valid, out, lse, B, H, Sq,
                                        Sk, D, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
