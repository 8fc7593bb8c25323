// Flash-attention backward for short query sides on Hopper (sm_90a), plain C
// interface for ctypes: K2-dec and K3-dec, dq, dk and dv in one kernel.
//
// What it serves: every backward call with fewer than 16 queries, in float32
// and bf16 (kernels/attention.py::dq_variant, dkv_variant): the decoder's
// single query, whose self-attention sees 1 key and whose cross-attention
// sees the 440 tokens of the VL memory. Calls with 16 or more queries take
// the tensor-core kernels: flash_attn_bwd_dq_tc.cu and
// flash_attn_bwd_dkv_tc.cu in bf16, the 3xTF32 flash_attn_bwd_dq_f32tc.cu
// and flash_attn_bwd_dkv_f32tc.cu in float32.
//
// Replaces, for those calls, the TPU kernels of
// reftr_tpu/kernels/attention.py driven by `_bwd` (:342-457):
// `_bwd_dq_kernel` (:242-284, pallas_call at :420) and `_bwd_dkv_kernel`
// (:287-339, pallas_call at :434). It computes what
// kernels/attention.py::attention_bwd_plain computes, from the forward's O
// and lse:
//   p = exp(x - lse), dp = (dO v^T) o keep, di = rowsum(dO o O),
//   ds = p o (dp - di), dq = scale * ds k, dk = scale * ds^T q,
//   dv = (p o keep)^T dO
// with x the logit exactly as flash_common.cuh rounds it (the fully masked
// row's shift included) and keep the forward's dropout multiplier, drawn
// again from the same Philox stream. Sums in f32; each gradient is rounded
// once to the input dtype. Layout q, O, dO, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, H, D], contiguous and 16-byte aligned, float32 or bf16; valid
// [B, Sk] bool (nullable); lse [B, H, Sq] f32; D in {16, 32, 64, 128};
// Sq <= 15.
//
// mxu_bf16 (dtype 2, T = float, kMxu): the TPU kernels' `_mxu` mode
// (:69-83) for float32 callers: q and dO are staged rounded to bf16, each
// key and value row is rounded as it is loaded, and ds and p * keep are
// rounded before they multiply q, k and dO; di is summed from the
// unrounded dO and O (:251-253, :323-325), and the sums and gradients stay
// float32.
//
// Design. A short query side is bound by reading K and V and writing dK and
// dV once each, so one launch does all three gradients and reads K and V
// once (the SIMT pair reads them twice, in two launches):
// - One block of 8 warps per (batch, head). It stages the Sq rows of q and
//   dO in shared memory as f32 with each query's lse and di, and walks all
//   Sk keys itself, so dq is summed inside the block: no atomics, no
//   scratch, no second pass, and the same bits on every call.
// - A key belongs to a group of 4 lanes, each holding a quarter of the
//   key's D dims. A group takes U consecutive keys per step (U = 4 where a
//   lane's quarter of a row is at most 16 bytes, fewer for wider rows, so
//   the K, V, dK and dV registers stay within 4 * 32 floats), read with 8-
//   or 16-byte vector loads straight from global memory; a warp takes 8 * U
//   keys, the block 64 * U (256 at the decoder's D = 32 in bf16: two steps
//   for 440 keys). The key loop has no __syncthreads and every shuffle in it
//   is taken by the whole warp: the step count depends on the warp, never
//   on the lane.
// - Per query, the group's two quarter dot products (q k and dO v) are
//   summed by two shuffles, so the 4 lanes share p and ds; dk and dv of the
//   group's keys accumulate in f32 registers over the queries and are
//   written once. q_i and dO_i are shared-memory broadcasts.
// - dq: each lane adds ds * k over its keys for its quarter of the dims,
//   the warp's 8 groups are summed by a shuffle butterfly, and one group
//   adds the sum to the warp's own dq row in shared memory. After the key
//   loop the 8 warps' rows are summed in a fixed order, scaled and written.
// - Dropout: element ((b * H + h) * Sq + i) * Sk + j of flash_common.cuh.
//   Where Sk % 4 == 0 a group's U keys share one Philox counter (U divides
//   4 and the group's first key is a multiple of U), so one call gives their
//   words; elsewhere one call per element. The 4 lanes of a group draw the
//   same words; no branch depends on the lane.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the decoder's cross-attention (B=8, Sq=1, Sk=440, H=8, D=32, bf16) the
// call reads K and V (3.6 MB) and writes dK and dV (3.6 MB): 2.15 us at
// 3.35 TB/s, against 9 MFLOP of products (0.13 us at the 67 TFLOP/s f32
// SIMT rate): bound by bytes. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Dropout;
using flash::from_f32;
using flash::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 4;               // lanes per key
constexpr int kGroupsPerWarp = 32 / kSplit;
constexpr int kMaxQ = 15;               // queries a call may have

// Bytes of shared memory: q and dO as f32, each warp's dq rows, lse, di
// (77 KB at D = 128, which a block gets only by opting in above 48 KB).
template <int D>
constexpr int kSmemBytes = ((2 + kWarps) * kMaxQ * D + 2 * kMaxQ) * 4;

// Keys a group takes per step: a lane's quarter of U rows of K (and of V)
// holds at most 64 bytes.
template <typename T, int D>
constexpr int kKeysPerGroup = D / kSplit * (int)sizeof(T) >= 64   ? 1
                              : D / kSplit * (int)sizeof(T) >= 32 ? 2
                                                                  : 4;

// E consecutive elements as f32, by 16-byte vector loads (the address must
// be 16-byte aligned).
template <int E>
__device__ __forceinline__ void load_part(float (&x)[E], const float* p) {
  const float4* s = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 f = __ldg(s + i);
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

// E consecutive bf16 as f32, by 16-byte vector loads (8-byte for E = 4; the
// address must be aligned to the load).
template <int E>
__device__ __forceinline__ void load_part(float (&x)[E],
                                          const __nv_bfloat16* p) {
  uint32_t w[E / 2];
  if constexpr (E % 8 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 u = __ldg(s + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
    static_assert(E == 4, "a lane's share is 4, 8 or 16 elements");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  }
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {  // a bf16 is the top half of its f32
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <int E>
__device__ __forceinline__ void store_part(float* p, const float (&x)[E]) {
  float4* d = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    d[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// Rounded to bf16 (to nearest even, as from_f32), two to a 32-bit word.
template <int E>
__device__ __forceinline__ void store_part(__nv_bfloat16* p,
                                           const float (&x)[E]) {
  uint32_t w[E / 2];
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&t);
  }
  if constexpr (E % 8 == 0) {
    uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < E / 8; ++i)
      d[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// x rounded to bf16 where the call takes bf16 products.
template <bool kMxu>
__device__ __forceinline__ float operand(float x) {
  return kMxu ? flash::round_bf16(x) : x;
}

template <typename T, int D, bool kMxu>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ valid,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq,
                     int Sk, float scale, Dropout dr) {
  constexpr int E = D / kSplit;  // dims per lane
  constexpr int U = kKeysPerGroup<T, D>;
  constexpr int kWarpKeys = kGroupsPerWarp * U;  // keys per warp and step
  constexpr int kBlockKeys = kWarps * kWarpKeys;
  extern __shared__ __align__(16) float smem[];
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*dos)[D] = reinterpret_cast<float(*)[D]>(smem + kMaxQ * D);
  // each warp's share of dq / scale
  float(*wdq)[kMaxQ][D] =
      reinterpret_cast<float(*)[kMaxQ][D]>(smem + 2 * kMaxQ * D);
  float* ls = smem + (2 + kWarps) * kMaxQ * D;
  float* dis = ls + kMaxQ;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int sub = lane % kSplit;           // this lane's dims sub*E..+E-1
  const int group = lane / kSplit;         // its key group within the warp
  const long row_stride = (long)H * D;
  const long q_base = (long)b * Sq * row_stride + h * D;
  const T* kb = k + (long)b * Sk * row_stride + h * D + sub * E;
  const T* vb = v + (long)b * Sk * row_stride + h * D + sub * E;
  T* dkb = dk + (long)b * Sk * row_stride + h * D + sub * E;
  T* dvb = dv + (long)b * Sk * row_stride + h * D + sub * E;
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + (long)b * Sk;

  // stage q and dO as f32, each query's lse and di = rowsum(dO o O): one
  // warp per query
  for (int i = warp; i < Sq; i += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const long off = q_base + i * row_stride + d;
      const float g = to_f32(dout[off]);
      qs[i][d] = operand<kMxu>(to_f32(q[off]));
      dos[i][d] = operand<kMxu>(g);
      s = fmaf(g, to_f32(o[off]), s);
    }
#pragma unroll
    for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) {
      dis[i] = s;
      ls[i] = lse[(long)bh * Sq + i];
    }
  }
  for (int idx = tid; idx < kWarps * Sq * D; idx += kThreads) {
    const int w = idx / (Sq * D), r = idx % (Sq * D);
    wdq[w][r / D][r % D] = 0.f;
  }
  // also the barrier after the staging
  const float shift = flash::masked_row_shift(valid, b, Sk);
  const bool one_counter = (Sk & 3) == 0;  // U keys from j0 share a counter

  for (int c0 = warp * kWarpKeys; c0 < Sk; c0 += kBlockKeys) {
    const int j0 = c0 + group * U;  // this group's keys j0..j0+U-1
    float kr[U][E], vr[U][E], dkr[U][E], dvr[U][E], bias[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = min(j0 + u, Sk - 1);  // keys past Sk: valid address
      load_part<E>(kr[u], kb + j * row_stride);
      load_part<E>(vr[u], vb + j * row_stride);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[u][e] = operand<kMxu>(kr[u][e]);
        vr[u][e] = operand<kMxu>(vr[u][e]);
      }
      bias[u] = (vrow == nullptr || vrow[j]) ? 0.f : flash::kMaskBias;
#pragma unroll
      for (int e = 0; e < E; ++e) dkr[u][e] = dvr[u][e] = 0.f;
    }
    for (int i = 0; i < Sq; ++i) {
      float kp[U];  // dropout multipliers of the group's keys
#pragma unroll
      for (int u = 0; u < U; ++u) kp[u] = 1.f;
      if (dr.threshold != 0u) {
        const uint64_t n0 = ((uint64_t)bh * Sq + i) * Sk + j0;
        if (one_counter) {
          const uint4 w = flash::philox4(dr.seed, n0 >> 2);
#pragma unroll
          for (int u = 0; u < U; ++u)
            kp[u] = flash::kept(flash::pick_word(w, n0 + u), dr) ? dr.inv_keep
                                                                 : 0.f;
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u)
            kp[u] = flash::keep_scale(dr.seed, n0 + u, dr.threshold,
                                      dr.inv_keep);
        }
      }
      float qi[E], doi[E];
      {
        const float4* qp = reinterpret_cast<const float4*>(&qs[i][sub * E]);
        const float4* dp = reinterpret_cast<const float4*>(&dos[i][sub * E]);
#pragma unroll
        for (int t = 0; t < E / 4; ++t) {
          const float4 a = qp[t], g = dp[t];
          qi[4 * t] = a.x;
          qi[4 * t + 1] = a.y;
          qi[4 * t + 2] = a.z;
          qi[4 * t + 3] = a.w;
          doi[4 * t] = g.x;
          doi[4 * t + 1] = g.y;
          doi[4 * t + 2] = g.z;
          doi[4 * t + 3] = g.w;
        }
      }
      const float lse_i = ls[i], di_i = dis[i];
      float c[E];  // this lane's quarter of sum_u ds_u k_u
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dot = fmaf(qi[e], kr[u][e], dot);
          dp = fmaf(doi[e], vr[u][e], dp);
        }
#pragma unroll
        for (int m = 1; m < kSplit; m *= 2) {  // the group's 4 lanes agree
          dot += __shfl_xor_sync(0xffffffffu, dot, m);
          dp += __shfl_xor_sync(0xffffffffu, dp, m);
        }
        // a key past Sk gets p = 0, so ds = 0 and p * keep = 0
        const float x = j0 + u < Sk
                            ? flash::logit(dot, scale, bias[u], shift)
                            : -INFINITY;
        const float p = expf(x - lse_i);
        const float ds = operand<kMxu>(p * (dp * kp[u] - di_i));
        const float pk = operand<kMxu>(p * kp[u]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dkr[u][e] = fmaf(ds, qi[e], dkr[u][e]);
          dvr[u][e] = fmaf(pk, doi[e], dvr[u][e]);
          c[e] = fmaf(ds, kr[u][e], c[e]);
        }
      }
      // sum over the warp's groups (lanes of one `sub` are kSplit apart)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int m = kSplit; m < 32; m *= 2)
          c[e] += __shfl_xor_sync(0xffffffffu, c[e], m);
      if (group == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) wdq[warp][i][sub * E + e] += c[e];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < Sk) {
#pragma unroll
        for (int e = 0; e < E; ++e) dkr[u][e] *= scale;
        store_part<E>(dkb + (j0 + u) * row_stride, dkr[u]);
        store_part<E>(dvb + (j0 + u) * row_stride, dvr[u]);
      }
    }
  }

  // dq: the warps' rows summed in a fixed order
  __syncthreads();
  for (int idx = tid; idx < Sq * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wdq[w][i][d];
    dq[q_base + i * row_stride + d] = from_f32<T>(s * scale);
  }
}

template <typename T, int D, bool kMxu>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  const long blocks = (long)B * H;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = kSmemBytes<D>;
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dec_kernel<T, D, kMxu>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dec_kernel<T, D, kMxu>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), valid, static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, static_cast<T*>(dq),
          static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float32 with bf16 products
// (mxu_bf16); 1 <= Sq <= 15; q, k, v, O, dO and the
// gradients 16-byte aligned; scale = 1 / sqrt(the caller's head dim), which
// is below D where the caller zero-pads the head dim up to D. Dropout as in
// flash_attn_fwd: threshold = ceil(rate * 2^24) (0 = none), inv_keep =
// 1 / (1 - rate), the forward's seed. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attn_bwd_dec(const void* q, const void* k, const void* v,
                                  const uint8_t* valid, const void* o,
                                  const void* dout, const float* lse, void* dq,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, float scale, int dtype,
                                  uint64_t seed, uint32_t threshold,
                                  float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sq > kMaxQ || Sk <= 0 ||
      threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
#define DEC_CASE(T, DIM, MXU)                                            \
  case DIM:                                                              \
    return (int)launch<T, DIM, MXU>(q, k, v, valid, o, dout, lse, dq, dk, \
                                    dv, B, H, Sq, Sk, scale, dr, s);
  if (dtype == 0) {
    switch (D) {
      DEC_CASE(float, 16, false)
      DEC_CASE(float, 32, false)
      DEC_CASE(float, 64, false)
      DEC_CASE(float, 128, false)
    }
  } else if (dtype == 1) {
    switch (D) {
      DEC_CASE(__nv_bfloat16, 16, false)
      DEC_CASE(__nv_bfloat16, 32, false)
      DEC_CASE(__nv_bfloat16, 64, false)
      DEC_CASE(__nv_bfloat16, 128, false)
    }
  } else if (dtype == 2) {
    switch (D) {
      DEC_CASE(float, 16, true)
      DEC_CASE(float, 32, true)
      DEC_CASE(float, 64, true)
      DEC_CASE(float, 128, true)
    }
  }
#undef DEC_CASE
  return (int)cudaErrorInvalidValue;
}
