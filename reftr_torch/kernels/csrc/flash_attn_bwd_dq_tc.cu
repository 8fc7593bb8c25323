// Flash-attention dq backward on Hopper's tensor cores, bf16 (sm_90a), plain
// C interface for ctypes: K2-TC.
//
// Replaces, for bf16 inputs with at least 16 queries, and for float32
// inputs in the mxu_bf16 mode (below), the TPU kernel
// `_bwd_dq_kernel` of reftr_tpu/kernels/attention.py (:242-284, driven by
// `_bwd` :342-457, pallas_call at :420). The same function and contract as
// dq of kernels/attention.py::attention_bwd_plain:
//   di = rowsum(dO o O), p = exp(q k^T * scale + bias + shift - lse),
//   ds = p o (dO v^T o keep - di), dq = scale * ds k,
// with keep the forward's dropout multiplier from the same Philox stream
// (flash_common.cuh) and the logit rounded as the forward rounds it,
// including a fully masked row's +1e9 shift. Layout q, O, dO, dq
// [B, Sq, H, D]; k, v [B, Sk, H, D], bf16, contiguous and 16-byte aligned;
// valid [B, Sk] bool (nullable); lse [B, H, Sq] f32; D in {16, 32, 64,
// 128}.
// Keys past Sk get p = 0; query rows past Sq are computed (on zeros) and
// not written.
//
// Design. K1-TC's structure (flash_attn_fwd_tc.cu) with its S product done
// twice and its P V product applied to K. One block of one warpgroup (4
// warps, 128 threads) per (batch * head, tile of 64 queries); each warp owns
// 16 query rows.
// - Once per block: Q, dO and O of the tile come in by cp.async with the
//   first key tile; Q's and dO's A fragments are loaded by ldmatrix and kept
//   in registers; each row's di = rowsum(dO o O) is summed by the row's quad
//   of lanes from the staged tiles, and its lse is read into registers.
// - Per 64-key tile: K, V and the key bias row come in by cp.async (the
//   bias a tile ahead, through a register, as in K1-TC), double-buffered,
//   rows padded to D + 8 for conflict-free ldmatrix. The tile is taken in
//   two halves of 32 keys, so S and dP hold 16 registers each: for each
//   half, S = Q K^T and dP = dO V^T by mma.sync m16n8k16 (bf16 -> f32),
//   then p = exp(logit - lse) and dS = p o (dP o keep - di) in f32, rounded
//   to bf16 in registers and used directly as the A fragment of
//   dQ += dS K, with K's B fragments from ldmatrix.trans (as K1-TC takes V
//   for P V).
// - dq accumulates in f32 registers over the whole key sweep and is scaled
//   once at the end: no atomics, no fusion into K3, so dq is deterministic,
//   as the TPU kernel's is.
// - Dropout: the accumulator layout is K1-TC's (queries as M, keys as N),
//   so the decisions of a key tile come from flash_tc::keep_bits, drawn at
//   the top of the tile with no lane-dependent branch: one Philox call per
//   4 elements at any Sk (the launcher picks the instance of Sk's path).
// - Occupancy: at D <= 32 the kernel is held to 128 registers, so 4 blocks
//   fit an SM and the VL encoder's 448 blocks run in one wave on 132 SMs.
// - Precision: dS enters the dQ product rounded to bf16 (relative 2^-9 per
//   term), as K3-TC's dS^T does; the tolerance is 1e-2 of the largest plain
//   gradient.
// - mxu_bf16 (T = float): the TPU kernel's `_mxu` mode (:69-83) for
//   float32 callers. Q, dO, K and V are rounded to bf16 in registers as
//   they are staged (flash_attn_fwd_tc.cu says why there), dS as it
//   already is; di = rowsum(dO o O) is summed from the float32 dO and O in
//   global memory, as the TPU kernel sums it from its unrounded tiles
//   (:251-253), so O is not staged; dq is stored as float32.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) the three products are
// 2.38 GFLOP, 2.4 us at 989 TFLOP/s bf16, against q, k, v, O, dO, dq in
// bf16 and lse, 10.9 MB, 3.3 us at 3.35 TB/s: bound by bytes. Measured
// times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Dropout;
using flash_tc::Tile;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kTileK = 64;     // keys per staged tile
constexpr int kHalf = 32;      // keys per S / dP product

template <int D>
constexpr int smem_bytes() {
  // Q, dO, O, then two stages of K and V (bf16), then two of the key bias
  return (3 * kRows + 4 * kTileK) * Tile<D>::kStride * 2 + 2 * kTileK * 4;
}

template <typename T, int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ valid,
                       const T* __restrict__ o,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse, T* __restrict__ dq,
                       int H, int Sq, int Sk,
                       int n_qt, float scale, Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kTile = kTileK * kS;  // elements of one staged key tile
  constexpr int kK = D / 16;          // k-steps of S and dP
  constexpr int kN = D / 8;           // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * kS;
  bf16* os = dos + kRows * kS;
  bf16* ks = os + kRows * kS;  // [2][kTile]
  bf16* vs = ks + 2 * kTile;   // [2][kTile]
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile);  // [2][kTileK]

  const int bh = blockIdx.x / n_qt;  // b * H + h
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;  // this lane's first key in an n-tile
  const long row_stride = (long)H * D;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const T* kb = k + (long)b * Sk * row_stride + h * D;
  const T* vb = v + (long)b * Sk * row_stride + h * D;
  const int n_kt = (Sk + kTileK - 1) / kTileK;

  auto stage = [&](int t) {
    const int buf = t & 1, k0 = t * kTileK, nk = min(kTileK, Sk - k0);
    flash_tc::load_tile<D, kTileK, kThreads>(ks + buf * kTile,
                                             kb + k0 * row_stride, row_stride,
                                             nk);
    flash_tc::load_tile<D, kTileK, kThreads>(vs + buf * kTile,
                                             vb + k0 * row_stride, row_stride,
                                             nk);
  };
  // the bias of key tile t's key tid (threads below kTileK), read a tile
  // ahead into a register as in K1-TC
  auto key_bias = [&](int t) {
    const int j = t * kTileK + tid;
    return j >= Sk ? -INFINITY
           : (valid == nullptr || valid[(long)b * Sk + j]) ? 0.f
                                                           : flash::kMaskBias;
  };
  {
    const long off = ((long)b * Sq + q0) * row_stride + h * D;
    const int nq = min(kRows, Sq - q0);
    flash_tc::load_tile<D, kRows, kThreads>(qs, q + off, row_stride, nq);
    flash_tc::load_tile<D, kRows, kThreads>(dos, dout + off, row_stride, nq);
    if constexpr (!kF32)
      flash_tc::load_tile<D, kRows, kThreads>(os, o + off, row_stride, nq);
  }
  stage(0);
  flash_tc::cp_async_commit();
  // with the first tiles in flight: the masked-row shift, tile 0's bias and
  // this lane's two rows (warp * 16 + lane / 4 and 8 below it) and their lse
  const float shift = flash::masked_row_shift(valid, b, Sk);
  if (tid < kTileK) bs[tid] = key_bias(0);
  int rows[2];
  uint64_t n_row[2];  // dropout offset of (b, h, row, key 0)
  float lse_r[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + warp * 16 + lane / 4 + r * 8;
    n_row[r] = ((uint64_t)bh * Sq + rows[r]) * Sk;
    lse_r[r] = rows[r] < Sq ? lse[(long)bh * Sq + rows[r]] : 0.f;
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qa[kK][4], da[kK][4];

  for (int t = 0; t < n_kt; ++t) {
    const bool next = t + 1 < n_kt;
    const float next_bias = next && tid < kTileK ? key_bias(t + 1) : 0.f;
    if (next) stage(t + 1);
    flash_tc::cp_async_commit();  // (possibly empty) group of tile t + 1
    const uint32_t keep =
        dr.threshold != 0u
            ? flash_tc::keep_bits<kTileK / 8, kAligned>(n_row, t * kTileK,
                                                        c, dr)
            : 0u;
    flash_tc::cp_async_wait<1>();  // tile t (and Q, dO, O) arrived
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        flash_tc::load_a<D>(qa[kk], qs, warp * 16, kk * 16);
        flash_tc::load_a<D>(da[kk], dos, warp * 16, kk * 16);
      }
      // di of this lane's rows: each lane of the quad sums D / 4 columns,
      // of the staged tiles or, in float32, of dO and O in global memory
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = 0.f;
        if constexpr (kF32) {
          const long off = ((long)b * Sq + rows[r]) * row_stride + h * D +
                           (lane % 4) * (D / 4);
          if (rows[r] < Sq) {
#pragma unroll
            for (int d = 0; d < D / 4; ++d)
              sum = fmaf(dout[off + d], o[off + d], sum);
          }
        } else {
          const int off =
              (warp * 16 + lane / 4 + r * 8) * kS + (lane % 4) * (D / 4);
#pragma unroll
          for (int d = 0; d < D / 4; ++d)
            sum = fmaf(__bfloat162float(dos[off + d]),
                       __bfloat162float(os[off + d]), sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        di[r] = sum;
      }
    }
    const int buf = t & 1;
    const bf16* kt_s = ks + buf * kTile;
    const bf16* vt_s = vs + buf * kTile;
    const float* bt = bs + buf * kTileK;

#pragma unroll
    for (int half = 0; half < kTileK / kHalf; ++half) {
      const int j0 = half * kHalf;  // the half's first key in the tile
      float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < kHalf / 16; ++n2) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          uint32_t bk[4], bv[4];
          flash_tc::load_b_rows<D>(bk, kt_s, j0 + n2 * 16, kk * 16);
          flash_tc::mma_bf16(s[2 * n2], qa[kk], bk[0], bk[1]);
          flash_tc::mma_bf16(s[2 * n2 + 1], qa[kk], bk[2], bk[3]);
          flash_tc::load_b_rows<D>(bv, vt_s, j0 + n2 * 16, kk * 16);
          flash_tc::mma_bf16(dp[2 * n2], da[kk], bv[0], bv[1]);
          flash_tc::mma_bf16(dp[2 * n2 + 1], da[kk], bv[2], bv[3]);
        }
      }
      // dS into s: element e of n-tile n is row rows[e / 2] and key
      // j0 + n * 8 + c + e % 2 of the tile; its keep decision is bit
      // (half * 4 + n) * 4 + e of the tile's mask
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = flash::logit(s[n][e], scale,
                                       bt[j0 + n * 8 + c + (e & 1)], shift);
          const float p = expf(x - lse_r[e >> 1]);
          float dpk = dp[n][e];
          if (dr.threshold != 0u)
            dpk = (keep >> ((half * 4 + n) * 4 + e)) & 1u ? dpk * dr.inv_keep
                                                          : 0.f;
          s[n][e] = p * (dpk - di[e >> 1]);
        }
      }
      // dQ += dS K: dS's accumulators are the A fragments, 16 keys a k-step
#pragma unroll
      for (int kt = 0; kt < kHalf / 16; ++kt) {
        const uint32_t sa[4] = {
            flash_tc::pack_bf16(s[2 * kt][0], s[2 * kt][1]),
            flash_tc::pack_bf16(s[2 * kt][2], s[2 * kt][3]),
            flash_tc::pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
            flash_tc::pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < kN / 2; ++n2) {
          uint32_t bk[4];
          flash_tc::load_b_cols<D>(bk, kt_s, j0 + kt * 16, n2 * 16);
          flash_tc::mma_bf16(acc[2 * n2], sa, bk[0], bk[1]);
          flash_tc::mma_bf16(acc[2 * n2 + 1], sa, bk[2], bk[3]);
        }
      }
    }
    if (next && tid < kTileK) bs[((t + 1) & 1) * kTileK + tid] = next_bias;
    __syncthreads();  // every warp is done with buffer t & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    T* out = dq + ((long)b * Sq + rows[r]) * row_stride + h * D + c;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      flash_tc::store2(out + n * 8, acc[n][2 * r] * scale,
                       acc[n][2 * r + 1] * scale);
  }
}

template <typename T, int D, bool kAligned>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const uint8_t* valid, const void* o, const void* dout,
                      const float* lse, void* dq, int B, int H,
                      int Sq, int Sk, float scale, Dropout dr,
                      cudaStream_t stream) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<T, D, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_tc_kernel<T, D, kAligned>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), valid, static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, static_cast<T*>(dq),
          H, Sq, Sk, n_qt, scale, dr);
  return cudaGetLastError();
}

// the instance of the kernel whose dropout draw takes Sk % 4 == 0's
// path or the general one (flash_tc::keep_bits)
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* o, const void* dout,
                   const float* lse, void* dq, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  if ((Sk & 3) == 0)
    return launch_as<T, D, true>(q, k, v, valid, o, dout, lse, dq, B, H,
                                 Sq, Sk, scale, dr, stream);
  return launch_as<T, D, false>(q, k, v, valid, o, dout, lse, dq, B, H,
                                Sq, Sk, scale, dr, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, const void* o, const void* dout,
                       const float* lse, void* dq, int B, int H, int Sq,
                       int Sk, int D, float scale, Dropout dr,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                           scale, dr, stream);
    case 32:
      return launch<T, 32>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                           scale, dr, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                           scale, dr, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                            scale, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float32 with bf16 products (mxu_bf16: q, k,
// v, dO rounded to bf16 as they are staged, di from the float32 O and dO,
// dq float32); q, k, v, O, dO, dq 16-byte aligned; D in {16, 32, 64, 128};
// scale = 1 / sqrt(the caller's head dim), which is below D where the
// caller zero-pads the head dim up to D. Dropout as in flash_attn_fwd_tc,
// with the forward's seed. Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dq_tc(const void* q, const void* k,
                                    const void* v, const uint8_t* valid,
                                    const void* o, const void* dout,
                                    const float* lse, void* dq,
                                    int B, int H,
                                    int Sq, int Sk, int D, float scale,
                                    int dtype, uint64_t seed,
                                    uint32_t threshold, float inv_keep,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (dtype == 1)
    return (int)dispatch_d<bf16>(q, k, v, valid, o, dout, lse, dq, B, H, Sq,
                                 Sk, D, scale, dr, s);
  if (dtype == 2)
    return (int)dispatch_d<float>(q, k, v, valid, o, dout, lse, dq, B, H, Sq,
                                  Sk, D, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
