// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes:
// dq in one kernel, dk and dv in another, p recomputed from the forward's
// row logsumexp (flash-attention 2).
//
// What they serve (kernels/attention.py::dq_variant, dkv_variant): dk/dv
// calls with 16 or more queries and fewer than 16 keys, in float32 and
// bf16. dq has no route left: calls with 16 or more queries take the
// tensor-core kernels, flash_attn_bwd_dq_tc.cu in bf16 and the 3xTF32
// flash_attn_bwd_dq_f32tc.cu in float32 (dk/dv likewise, with 16 or more
// keys: flash_attn_bwd_dkv_tc.cu, flash_attn_bwd_dkv_f32tc.cu), and calls
// with fewer than 16 queries the decode backward, flash_attn_bwd_dec.cu.
// The dq kernel stays as the same-run "before" that chip_smoke.py times
// beside its successors.
//
// Replaces the TPU kernels of reftr_tpu/kernels/attention.py driven by
// `_bwd` (:342-457):
//   flash_attn_bwd_dq  <- `_bwd_dq_kernel` (:242-284, pallas_call at :420)
//     di = rowsum(dO o O), p = exp(x - lse), dp = (dO v^T) o keep,
//     ds = p o (dp - di), dq = scale * sum_j ds k
//   flash_attn_bwd_dkv <- `_bwd_dkv_kernel` (:287-339, pallas_call at :434)
//     dv = sum_i (p o keep)^T dO, dk = scale * sum_i ds^T q
// where keep is the forward's dropout multiplier (0 or 1 / (1 - rate)),
// drawn again from the same Philox stream (flash_common.cuh), and
// x = q k^T * scale + bias is the logit exactly as the forward rounds it.
//
// Layout as the forward's: q, O, dO, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, H, D], all contiguous, f32 or bf16 (upcast on load, gradients
// written in the input dtype); valid [B, Sk] bool (nullable); lse
// [B, H, Sq] f32 from the forward. Keys past Sk are out of every sum, as in
// the forward; a row whose keys are all masked takes the eager path's
// gradient through the uniform average (flash_common.cuh).
//
// Design (simple first; tensor cores, TMA and wgmma are later work):
// - dq: the forward's mapping. One block of 128 threads per (batch*head,
//   q tile), G threads per query row (G from the caller, as for the
//   forward: 32 for the decoder's single query, 4 for long rows), each
//   walking every G-th key of 64-key tiles staged in shared memory. A
//   thread holds its row's q, dO and dq accumulator in registers (3 D
//   floats); the G partial dq rows are summed with warp shuffles at the end.
// - dk/dv: one block of 128 threads per (batch*head, tile of 32 keys). The
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
// at the VL encoder's shape (B=8, H=8, S=440, D=32) with all keys valid, dq
// does 3 products (2.38 GFLOP, 35.5 us at the 67 TFLOP/s f32 SIMT rate) and
// dk/dv 4 products (3.17 GFLOP, 47.3 us), against 3.6 MB per f32 tensor
// (1.8 MB in bf16) at 3.35 TB/s: without tensor cores both are bound by
// operations. Each also redoes the softmax's exp per (query, key) pair,
// and with dropout one Philox call per pair. Measured times are in PERF.md.

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
// keys (dq) or queries (dk/dv) staged per step: 64, or 32 at D = 128, where
// 64 rows of two f32 tiles would pass the 48 KB of static shared memory
template <int D>
constexpr int kTileRows = D <= 64 ? 64 : 32;

using flash::Dropout;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, int H,
                    int Sq, int Sk, int G, int n_qt, float scale, Dropout dr) {
  // rows padded to D + 1 floats: the G threads of a row read G different
  // keys at the same d
  constexpr int kTileK = kTileRows<D>;
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
  const int r = live ? row : 0;  // a dead row computes row 0, writes nothing
  const long row_stride = (long)H * D;
  const float shift = flash::masked_row_shift(valid, b, Sk);
  const uint64_t n_row = ((uint64_t)bh * Sq + r) * Sk;

  float qr[D], dor[D], acc[D];
  float di = 0.f;  // rowsum(dO o O)
  {
    const long off = ((long)b * Sq + r) * row_stride + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = to_f32(q[off + d]);
      dor[d] = to_f32(dout[off + d]);
      di = fmaf(dor[d], to_f32(o[off + d]), di);
      acc[d] = 0.f;
    }
  }
  const float lse_r = lse[(long)bh * Sq + r];

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
      bs[j] = (valid == nullptr || valid[(long)b * Sk + k0 + j])
                  ? 0.f
                  : flash::kMaskBias;
    __syncthreads();

    for (int j = sub; j < nk; j += G) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      const float p = expf(flash::logit(dot, scale, bs[j], shift) - lse_r);
      if (dr.threshold != 0u)
        dp *= flash::keep_scale(dr.seed, n_row + k0 + j, dr.threshold,
                                dr.inv_keep);
      const float ds = p * (dp - di);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  // sum the G partial dq rows (lanes sub = 0..G-1 are adjacent in one warp)
  T* dqp = dq + ((long)b * Sq + r) * row_stride + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d];
    for (int s = G / 2; s > 0; s /= 2) a += __shfl_xor_sync(0xffffffffu, a, s);
    if (live && (d % G) == sub) dqp[d] = from_f32<T>(a * scale);
  }
}

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
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const uint8_t* valid, const void* o, const void* dout,
                      const float* lse, void* dq, int B, int H, int Sq, int Sk,
                      int G, float scale, Dropout dr, cudaStream_t stream) {
  const int rows = kThreads / G;
  const int n_qt = (Sq + rows - 1) / rows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  flash_bwd_dq_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), H, Sq, Sk, G,
      n_qt, scale, dr);
  return cudaGetLastError();
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
// the head dim up to D. G: threads per query row, a power of two in
// [1, 32]. Dropout as in flash_attn_fwd: threshold = ceil(rate * 2^24)
// (0 = none), inv_keep = 1 / (1 - rate), the forward's seed. Each returns a
// cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const uint8_t* valid, const void* o,
                                 const void* dout, const float* lse, void* dq,
                                 int B, int H, int Sq, int Sk, int D,
                                 float scale, int dtype, int G, uint64_t seed,
                                 uint32_t threshold, float inv_keep,
                                 void* stream) {
  if (bad_shape(B, H, Sq, Sk, threshold) || G < 1 || G > 32 ||
      (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
#define DQ_CASE(T, DIM)                                                     \
  case DIM:                                                                 \
    return (int)launch_dq<T, DIM>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, \
                                  Sk, G, scale, dr, s);
  if (dtype == 0) {
    switch (D) {
      DQ_CASE(float, 16)
      DQ_CASE(float, 32)
      DQ_CASE(float, 64)
      DQ_CASE(float, 128)
    }
  } else if (dtype == 1) {
    switch (D) {
      DQ_CASE(__nv_bfloat16, 16)
      DQ_CASE(__nv_bfloat16, 32)
      DQ_CASE(__nv_bfloat16, 64)
      DQ_CASE(__nv_bfloat16, 128)
    }
  }
#undef DQ_CASE
  return (int)cudaErrorInvalidValue;
}

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
