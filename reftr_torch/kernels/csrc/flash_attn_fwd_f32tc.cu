// Flash-attention forward on Hopper's tensor cores in float32 by 3xTF32
// (sm_90a), plain C interface for ctypes: K1-f32tc.
//
// Replaces, for float32 inputs with at least 16 queries, the TPU kernel
// `_flash_kernel` of reftr_tpu/kernels/attention.py (:86-132, driven by
// `_fwd` :135-228, pallas_call at :210). The same function and contract as
// the bf16 flash_attn_fwd_tc.cu:
// out = softmax(q k^T * scale + bias) v per (batch, head) with an f32
// running max, denominator and accumulator, attention dropout after the
// denominator (the denominator sums the un-dropped p, the numerator takes
// p * keep), and the row logsumexp lse = m + log l on request. Layout q, out
// [B, Sq, H, D]; k, v [B, Sk, H, D], float32, contiguous and 16-byte
// aligned; valid [B, Sk] bool (nullable); lse [B, H, Sq] f32 (nullable); D
// in {16, 32, 64, 128}. The logit, a fully masked row's +1e9 shift and the
// Philox dropout mask are flash_common.cuh's, so lse is the one the 3xTF32
// backward kernels (flash_attn_bwd_dq_f32tc.cu, flash_attn_bwd_dkv_f32tc.cu)
// recompute p from, and the mask is philox_keep_plain's bit for bit. Keys
// past Sk leave the sum; query rows past Sq are computed (on zeros) and not
// written.
//
// Design. K1-TC's structure (flash_attn_fwd_tc.cu) with its products in
// 3xTF32 (flash_tf32.cuh), as K2-f32tc took K2-TC's: the output stays
// within float32's 1e-5 of the plain version, where plain TF32 (10
// mantissa bits) would not. One block of one warpgroup (4 warps, 128
// threads) per (batch * head, tile of 64 queries); each warp owns 16 query
// rows.
// - Staging: Q once, then K and V in 64-key tiles by cp.async,
//   double-buffered (tile t + 1 loads while tile t computes), rows padded
//   to D + 4 floats so every fragment read is conflict-free; the key bias
//   row (0, -1e9, or -inf past Sk) is read a tile ahead into a register as
//   in K1-TC. Shared memory: 45.5 KB at D = 32 (4 blocks an SM), 85.5 KB
//   at D = 64 (2), 165.5 KB at D = 128 (1).
// - Products: S = Q K^T and O += P V by mma.sync m16n8k8 (tf32 -> f32),
//   three per product on operands split once where their fragment is read
//   (big = x truncated to tf32 by one AND, small = x - big). The tile is
//   taken in four parts of 16 keys; a part wholly past Sk is skipped, a
//   warp-uniform branch (BERT's 40 keys fill three). S accumulates each
//   n-tile over the k-steps in the order K2-f32tc does, so both kernels
//   round S alike. The softmax runs once per 64-key tile in the
//   accumulators, which are then directly the A fragments of P V, one
//   8-key k-step per n-tile, with V read at the permuted rows of
//   flash_tf32.cuh: no shuffle.
// - Q's fragments: at D <= 32 split once at the first tile and held in
//   registers (D / 8 fragments of 8 registers); at D = 64 and 128 that
//   would take 64 or 128 registers, so each part re-reads and re-splits
//   them from the staged tile, as K2-f32tc does.
// - Dropout: the accumulator of m16n8k8 has m16n8k16's layout (queries as
//   M, keys as N), so flash_tc::keep_bits draws a tile's decisions at the
//   top of the tile with no lane-dependent branch: one Philox call per 4
//   elements at any Sk (the launcher picks the instance of Sk's path).
// - No atomics: each output row is summed by one warp in a fixed order, so
//   a repeated call gives the same bits.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) with every key valid
// the two products are 1.59 GFLOP, 9.6 us at the 165 TFLOP/s of
// float32-accurate products that 3xTF32 gets from the 495 TFLOP/s of TF32
// (23.7 us at the 67 TFLOP/s f32 FMA rate), against q, k, v, out in f32,
// 14.4 MB, 4.3 us at 3.35 TB/s: bound by operations. Measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

using flash::Dropout;
using flash_tf32::FragA;
using flash_tf32::FragB;
using flash_tf32::Tile;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kTileK = 64;     // keys per staged tile
constexpr int kPart = 16;      // keys per part of the S product

template <int D>
constexpr int smem_bytes() {
  // Q, then two stages of K and V (f32), then two of the key bias
  return (kRows + 4 * kTileK) * Tile<D>::kStride * 4 + 2 * kTileK * 4;
}

// blocks an SM by shared memory, which sets the registers a thread may
// take: 128 at D <= 32
template <int D>
constexpr int kMinBlocks = D <= 32 ? 4 : D <= 64 ? 2 : 1;

// Q's split fragments live in registers up to this head dim
template <int D>
constexpr bool kQInRegs = D <= 32;

template <int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_fwd_f32tc_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, float* __restrict__ lse,
                       int H, int Sq, int Sk, int n_qt, float scale,
                       Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kTile = kTileK * kS;  // floats of one staged key tile
  constexpr int kK = D / 8;           // k-steps of S
  constexpr int kN = D / 8;           // n-tiles of O
  constexpr int kNT = kPart / 8;      // n-tiles of S per part
  constexpr int kParts = kTileK / kPart;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kRows * kS;  // [2][kTile]
  float* vs = ks + 2 * kTile;   // [2][kTile]
  float* bs = vs + 2 * kTile;   // [2][kTileK]

  const int bh = blockIdx.x / n_qt;  // b * H + h
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;  // this lane's first key in an n-tile
  const long row_stride = (long)H * D;
  const float* kb = k + (long)b * Sk * row_stride + h * D;
  const float* vb = v + (long)b * Sk * row_stride + h * D;
  const int n_kt = (Sk + kTileK - 1) / kTileK;

  auto stage = [&](int t) {
    const int buf = t & 1, k0 = t * kTileK, nk = min(kTileK, Sk - k0);
    flash_tf32::load_tile<D, kTileK, kThreads>(
        ks + buf * kTile, kb + k0 * row_stride, row_stride, nk);
    flash_tf32::load_tile<D, kTileK, kThreads>(
        vs + buf * kTile, vb + k0 * row_stride, row_stride, nk);
  };
  // the bias of key tile t's key tid (threads below kTileK), read a tile
  // ahead into a register as in K1-TC
  auto key_bias = [&](int t) {
    const int j = t * kTileK + tid;
    return j >= Sk ? -INFINITY
           : (valid == nullptr || valid[(long)b * Sk + j]) ? 0.f
                                                           : flash::kMaskBias;
  };
  flash_tf32::load_tile<D, kRows, kThreads>(
      qs, q + ((long)b * Sq + q0) * row_stride + h * D, row_stride,
      min(kRows, Sq - q0));
  stage(0);
  flash_tc::cp_async_commit();
  // with the first tiles in flight: the masked-row shift and tile 0's bias
  const float shift = flash::masked_row_shift(valid, b, Sk);
  if (tid < kTileK) bs[tid] = key_bias(0);

  // this lane's two rows: warp * 16 + lane / 4 and 8 below it
  int rows[2];
  uint64_t n_row[2];  // dropout offset of (b, h, row, key 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + warp * 16 + lane / 4 + r * 8;
    n_row[r] = ((uint64_t)bh * Sq + rows[r]) * Sk;
  }
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, per row
  float l[2] = {0.f, 0.f};              // this lane's share of the sum
  FragA qa[kQInRegs<D> ? kK : 1];

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
    flash_tc::cp_async_wait<1>();  // tile t (and Q) arrived
    __syncthreads();
    if constexpr (kQInRegs<D>) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk)
          qa[kk] = flash_tf32::load_a<D>(qs, warp * 16, kk * 8);
      }
    }
    const int buf = t & 1;
    const float* kt_s = ks + buf * kTile;
    const float* vt_s = vs + buf * kTile;
    const float* bt = bs + buf * kTileK;

    // S = Q K^T over the tile's live parts; a part past Sk keeps s = 0,
    // whose bias of -inf gives p = 0 below
    float s[kTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int j0 = part * kPart;  // the part's first key in the tile
      if (t * kTileK + j0 >= Sk) continue;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        FragA qf;
        if constexpr (kQInRegs<D>)
          qf = qa[kk];
        else
          qf = flash_tf32::load_a<D>(qs, warp * 16, kk * 8);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bk =
              flash_tf32::load_b_rows<D>(kt_s, j0 + n * 8, kk * 8);
          flash_tf32::mma3(s[part * kNT + n], qf, bk);
        }
      }
    }

    // logits, and the running max over this tile (finite: key t * kTileK
    // is below Sk); element e of n-tile n is row rows[e / 2] and key
    // n * 8 + c + e % 2 of the tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            flash::logit(s[n][e], scale, bt[n * 8 + c + (e & 1)], shift);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);  // 0 on the first tile
      l[r] *= corr[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // p (the denominator sums it un-dropped), then p * keep in place
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
    if (dr.threshold != 0u) {
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (keep >> (n * 4 + e)) & 1u ? s[n][e] * dr.inv_keep : 0.f;
    }

    // O += P V: each n-tile of P is the A fragment of one 8-key k-step;
    // each part's 16 keys are summed from zero and added to O in f32
    // (flash_tf32.cuh, "Accumulation")
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int j0 = part * kPart;
      if (t * kTileK + j0 >= Sk) continue;  // p = 0 on every key
      FragA pa[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        pa[n] = flash_tf32::acc_as_a(s[part * kNT + n]);
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
        float po[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bv =
              flash_tf32::load_b_cols<D>(vt_s, j0 + n * 8, nd * 8);
          flash_tf32::mma3(po, pa[n], bv);
        }
        flash_tf32::add(o[nd], po);
      }
    }
    if (next && tid < kTileK) bs[((t + 1) & 1) * kTileK + tid] = next_bias;
    __syncthreads();  // every warp is done with buffer t & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= Sq) continue;
    const float inv_l = 1.f / l[r];
    float* op = out + ((long)b * Sq + rows[r]) * row_stride + h * D + c;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * r] * inv_l, o[n][2 * r + 1] * inv_l);
    if (lse != nullptr && lane % 4 == 0)
      lse[(long)bh * Sq + rows[r]] = m[r] + logf(l[r]);
  }
}

template <int D, bool kAligned>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const uint8_t* valid, void* out, float* lse, int B, int H,
                      int Sq, int Sk, float scale, Dropout dr,
                      cudaStream_t stream) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32tc_kernel<D, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_fwd_f32tc_kernel<D, kAligned>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), valid, static_cast<float*>(out), lse, H,
          Sq, Sk, n_qt, scale, dr);
  return cudaGetLastError();
}

// the instance of the kernel whose dropout draw takes Sk % 4 == 0's
// path or the general one (flash_tc::keep_bits)
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, void* out, float* lse, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  if ((Sk & 3) == 0)
    return launch_as<D, true>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                              dr, stream);
  return launch_as<D, false>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr,
                             stream);
}

}  // namespace

// float32 only; q, k, v, out 16-byte aligned; D in {16, 32, 64, 128};
// scale = 1 / sqrt(the caller's head dim), which is below D where the
// caller zero-pads the head dim up to D. Dropout as in flash_attn_fwd:
// threshold = ceil(rate * 2^24) (0 = none), inv_keep = 1 / (1 - rate).
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd_f32tc(const void* q, const void* k,
                                    const void* v, const uint8_t* valid,
                                    void* out, float* lse, int B, int H,
                                    int Sq, int Sk, int D, float scale,
                                    uint64_t seed, uint32_t threshold,
                                    float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  switch (D) {
    case 16:
      return (int)launch<16>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                             dr, s);
    case 32:
      return (int)launch<32>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                             dr, s);
    case 64:
      return (int)launch<64>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                             dr, s);
    case 128:
      return (int)launch<128>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                              dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
