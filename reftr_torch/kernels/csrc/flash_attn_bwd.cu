// Flash-attention dk/dv backward on SIMT for Hopper (sm_90a), plain C
// interface for ctypes, p recomputed from the forward's row logsumexp
// (flash-attention 2).
//
// What it serves (kernels/attention.py::dkv_variant): dk/dv calls with 16
// or more queries and fewer than 16 keys, in float32 and bf16, where each
// 64-key tile of a tensor-core kernel would be mostly empty. Calls with 16
// or more keys take the tensor-core kernels (flash_attn_bwd_dkv_tc.cu,
// flash_attn_bwd_dkv_wg.cu in bf16, the 3xTF32 flash_attn_bwd_dkv_f32tc.cu
// in float32), and calls with fewer than 16 queries the decode backward,
// flash_attn_bwd_dec.cu.
//
// Replaces the TPU kernel of reftr_tpu/kernels/attention.py driven by
// `_bwd` (:342-457):
//   flash_attn_bwd_dkv <- `_bwd_dkv_kernel` (:287-339, pallas_call at :434)
//     p = exp(x - lse), dp = (dO v^T) o keep, di = rowsum(dO o O),
//     ds = p o (dp - di), dv = sum_i (p o keep)^T dO,
//     dk = scale * sum_i ds^T q
// where keep is the forward's dropout multiplier (0 or 1 / (1 - rate)),
// drawn again from the same Philox stream (flash_common.cuh), and
// x = q k^T * scale + bias is the logit exactly as the forward rounds it.
//
// Layout as the forward's: q, O, dO [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, H, D], all contiguous, f32 or bf16 (upcast on load, gradients
// written in the input dtype); valid [B, Sk] bool (nullable); lse
// [B, H, Sq] f32 from the forward. Keys past Sk are out of every sum, as in
// the forward; a row whose keys are all masked takes the eager path's
// gradient through the uniform average (flash_common.cuh).
//
// Design (simple first):
// - One block of 128 threads per (batch*head, tile of 32 keys). The
//   4 threads of a key row split its D dims between them (d = e * 4 + sub),
//   so a thread holds 4 * D / 4 = D floats of k, v, dk and dv in registers
//   whatever D is. Queries are staged 64 at a time in shared memory; for
//   each query the 4 partial dot products (q k and dO v) are summed with two
//   warp shuffles, after which every thread of the row holds the same p and
//   ds. dk and dv accumulate in f32 registers over the whole q sweep: no
//   atomics, no second pass. The decoder's single query does not idle this
//   kernel: its parallelism is over the keys (440 per head at the decoder's
//   cross-attention), and each key row does one query.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at B=8, H=8, Sq=440, Sk=8, D=32 (chip_smoke.py phase 3c) it does 4
// products over 2.3e5 (query, key) pairs, against q, O and dO of 1.8 MB
// each in bf16 at 3.35 TB/s: bound by bytes. It redoes the softmax's exp
// per (query, key) pair, and with dropout one Philox call per pair.
// Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::from_f32;
using flash::to_f32;

constexpr int kThreads = 128;  // threads per block
constexpr int kSplit = 4;      // threads per key row in the dk/dv kernel
// queries staged per step: 64, or 32 at D = 128, where 64 rows of two f32
// tiles would pass the 48 KB of static shared memory
template <int D>
constexpr int kTileRows = D <= 64 ? 64 : 32;

using flash::Dropout;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int n_kt,
                     float scale, Dropout dr) {
  constexpr int E = D / kSplit;  // dims per thread
  constexpr int kTileQ = kTileRows<D>;
  __shared__ float qs[kTileQ][D + 1];
  __shared__ float dos[kTileQ][D + 1];
  __shared__ float ls[kTileQ];   // lse of the staged queries
  __shared__ float dis[kTileQ];  // rowsum(dO o O) of the staged queries

  const int rows = kThreads / kSplit;  // keys per block
  const int bh = blockIdx.x / n_kt;
  const int kt = blockIdx.x % n_kt;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int sub = tid % kSplit;  // this thread's dims: d = e * kSplit + sub
  const int key = kt * rows + tid / kSplit;
  const bool live = key < Sk;
  const int kc = live ? key : 0;  // a dead key computes key 0, writes nothing
  const long row_stride = (long)H * D;
  const float shift = flash::masked_row_shift(valid, b, Sk);
  const float bias =
      (valid == nullptr || valid[(long)b * Sk + kc]) ? 0.f : flash::kMaskBias;

  float kr[E], vr[E], dk_acc[E], dv_acc[E];
  const long koff = ((long)b * Sk + kc) * row_stride + h * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = e * kSplit + sub;
    kr[e] = to_f32(k[koff + d]);
    vr[e] = to_f32(v[koff + d]);
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  const T* qb = q + (long)b * Sq * row_stride + h * D;
  const T* ob = o + (long)b * Sq * row_stride + h * D;
  const T* dob = dout + (long)b * Sq * row_stride + h * D;
  for (int q0 = 0; q0 < Sq; q0 += kTileQ) {
    const int nq = min(kTileQ, Sq - q0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < nq * D; i += kThreads) {
      const int qi = i / D, d = i % D;
      const long off = (long)(q0 + qi) * row_stride + d;
      qs[qi][d] = to_f32(qb[off]);
      dos[qi][d] = to_f32(dob[off]);
    }
    __syncthreads();
    for (int qi = tid; qi < nq; qi += kThreads) {
      const long off = (long)(q0 + qi) * row_stride;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(dos[qi][d], to_f32(ob[off + d]), s);
      dis[qi] = s;
      ls[qi] = lse[(long)bh * Sq + q0 + qi];
    }
    __syncthreads();

    for (int qi = 0; qi < nq; ++qi) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = e * kSplit + sub;
        dot = fmaf(qs[qi][d], kr[e], dot);
        dp = fmaf(dos[qi][d], vr[e], dp);
      }
      // the 4 threads of this key end with the same sums (xor butterfly)
      for (int s = kSplit / 2; s > 0; s /= 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, s);
        dp += __shfl_xor_sync(0xffffffffu, dp, s);
      }
      const float p = expf(flash::logit(dot, scale, bias, shift) - ls[qi]);
      float pk = p;
      if (dr.threshold != 0u) {
        const float m = flash::keep_scale(
            dr.seed, ((uint64_t)bh * Sq + q0 + qi) * Sk + kc, dr.threshold,
            dr.inv_keep);
        pk = p * m;
        dp *= m;
      }
      const float ds = p * (dp - dis[qi]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = e * kSplit + sub;
        dv_acc[e] = fmaf(pk, dos[qi][d], dv_acc[e]);
        dk_acc[e] = fmaf(ds, qs[qi][d], dk_acc[e]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = e * kSplit + sub;
      dk[koff + d] = from_f32<T>(dk_acc[e] * scale);
      dv[koff + d] = from_f32<T>(dv_acc[e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const uint8_t* valid, const void* o, const void* dout,
                       const float* lse, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, float scale, Dropout dr,
                       cudaStream_t stream) {
  const int rows = kThreads / kSplit;
  const int n_kt = (Sk + rows - 1) / rows;
  const long blocks = (long)B * H * n_kt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  flash_bwd_dkv_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, n_kt, scale, dr);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk, uint32_t threshold) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128}; scale = 1 /
// sqrt(the caller's head dim), which is below D where the caller zero-pads
// the head dim up to D. Dropout as in the forward kernels: threshold =
// ceil(rate * 2^24) (0 = none), inv_keep = 1 / (1 - rate), the forward's
// seed. Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const uint8_t* valid, const void* o,
                                  const void* dout, const float* lse, void* dk,
                                  void* dv, int B, int H, int Sq, int Sk, int D,
                                  float scale, int dtype, uint64_t seed,
                                  uint32_t threshold, float inv_keep,
                                  void* stream) {
  if (bad_shape(B, H, Sq, Sk, threshold)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
#define DKV_CASE(T, DIM)                                                    \
  case DIM:                                                                 \
    return (int)launch_dkv<T, DIM>(q, k, v, valid, o, dout, lse, dk, dv, B, H, \
                                   Sq, Sk, scale, dr, s);
  if (dtype == 0) {
    switch (D) {
      DKV_CASE(float, 16)
      DKV_CASE(float, 32)
      DKV_CASE(float, 64)
      DKV_CASE(float, 128)
    }
  } else if (dtype == 1) {
    switch (D) {
      DKV_CASE(__nv_bfloat16, 16)
      DKV_CASE(__nv_bfloat16, 32)
      DKV_CASE(__nv_bfloat16, 64)
      DKV_CASE(__nv_bfloat16, 128)
    }
  }
#undef DKV_CASE
  return (int)cudaErrorInvalidValue;
}
