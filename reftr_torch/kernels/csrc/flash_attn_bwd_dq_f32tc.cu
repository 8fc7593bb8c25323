// Flash-attention dq backward on Hopper's tensor cores in float32 by
// 3xTF32 (sm_90a), plain C interface for ctypes: K2-f32tc.
//
// Replaces, for float32 inputs with at least 16 queries, the TPU kernel
// `_bwd_dq_kernel` of reftr_tpu/kernels/attention.py (:242-284, driven by
// `_bwd` :342-457, pallas_call at :420). The same function and contract as
// dq of kernels/attention.py::attention_bwd_plain:
//   di = rowsum(dO o O), p = exp(q k^T * scale + bias + shift - lse),
//   ds = p o (dO v^T o keep - di), dq = scale * ds k,
// with keep the forward's dropout multiplier from the same Philox stream
// (flash_common.cuh) and the logit rounded as the forward rounds it,
// including a fully masked row's +1e9 shift. Layout q, O, dO, dq
// [B, Sq, H, D]; k, v [B, Sk, H, D], float32, contiguous and 16-byte
// aligned; valid [B, Sk] bool (nullable); lse [B, H, Sq] f32; D in {16, 32,
// 64, 128}. Keys past Sk get p = 0; query rows past Sq are computed (on
// zeros) and not written.
//
// Design. K2-TC's structure (flash_attn_bwd_dq_tc.cu) with its products in
// 3xTF32 (flash_tf32.cuh), which keeps float32's accuracy: the gradients
// stay within 1e-4 of the largest plain gradient, as the SIMT kernel's do.
// One block of one warpgroup (4 warps, 128 threads) per (batch * head, tile
// of 64 queries); each warp owns 16 query rows.
// - Staging: Q and dO of the tile come in once by cp.async with the first
//   key tile; K, V and the key bias row come in 64-key tiles (the bias a
//   tile ahead, through a register, as in K1-TC), double-buffered, rows
//   padded to D + 4 floats, so every fragment read below is conflict-free.
//   An f32 tile is twice a bf16 tile's bytes, so O is not staged: di =
//   rowsum(dO o O) is summed once per block from the staged dO and O read
//   from global memory, D / 4 lanes per row by 16-byte loads (coalesced),
//   and kept in registers with each row's lse. Shared memory: 55 KB at
//   D = 32 (4 blocks an SM), 103 KB at D = 64, 199 KB at D = 128.
// - Products: the tile is taken in four parts of 16 keys (a part wholly
//   past Sk is skipped: BERT's 40 keys fill three). For each part,
//   S = Q K^T and dP = dO V^T by mma.sync m16n8k8 (tf32 -> f32), three per
//   product; then p = exp(logit - lse) and dS = p o (dP o keep - di) in f32
//   in the accumulators, which are directly the A fragments of
//   dQ += dS K, one 8-key k-step per n-tile, with K read at the permuted
//   rows of flash_tf32.cuh: no shuffle.
// - Splits: each fragment is split into its big and small tf32 halves
//   once, where it is read, and serves the three products (dS once per
//   k-step, for every n-tile of dQ). Splitting the staged tiles once in
//   shared memory instead would hold both halves there: twice the bytes,
//   which at D = 64 would leave one block an SM and at D = 128 not fit.
// - dq accumulates in f32 registers over the whole key sweep and is scaled
//   once at the end: no atomics, so a repeated call gives the same bits.
// - Dropout: the accumulator layout is m16n8k16's (queries as M, keys as
//   N), so the decisions of a key tile come from flash_tc::keep_bits, drawn
//   at the top of the tile with no lane-dependent branch: one Philox call
//   per 4 elements at any Sk (the launcher picks the instance of Sk's
//   path); the mask is philox_keep_plain's bit for bit.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) with every key valid the
// three products are 2.38 GFLOP, 14.4 us at the 165 TFLOP/s of
// float32-accurate products that 3xTF32 gets from the 495 TFLOP/s of TF32
// (35.5 us at the 67 TFLOP/s f32 FMA rate), against q, k, v, O, dO, dq in
// f32 and lse, 21.7 MB, 6.5 us at 3.35 TB/s: bound by operations. Measured
// times are in PERF.md.

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
constexpr int kPart = 16;      // keys per S / dP product

template <int D>
constexpr int smem_bytes() {
  // Q, dO, then two stages of K and V (f32), then two of the key bias, then
  // di of the block's rows
  return (2 * kRows + 4 * kTileK) * Tile<D>::kStride * 4 + 2 * kTileK * 4 +
         kRows * 4;
}

// blocks an SM by shared memory, which sets the registers a thread may
// take: 128 at D <= 32
template <int D>
constexpr int kMinBlocks = D <= 32 ? 4 : D <= 64 ? 2 : 1;

template <int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_bwd_dq_f32tc_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ dq, int H, int Sq, int Sk,
                          int n_qt, float scale, Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kTile = kTileK * kS;  // floats of one staged key tile
  constexpr int kK = D / 8;           // k-steps of S and dP
  constexpr int kN = D / 8;           // n-tiles of dQ
  constexpr int kNT = kPart / 8;      // n-tiles of S and dP
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * kS;
  float* ks = dos + kRows * kS;  // [2][kTile]
  float* vs = ks + 2 * kTile;    // [2][kTile]
  float* bs = vs + 2 * kTile;    // [2][kTileK]
  float* dis = bs + 2 * kTileK;  // [kRows]

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
  const long off = ((long)b * Sq + q0) * row_stride + h * D;
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
  {
    const int nq = min(kRows, Sq - q0);
    flash_tf32::load_tile<D, kRows, kThreads>(qs, q + off, row_stride, nq);
    flash_tf32::load_tile<D, kRows, kThreads>(dos, dout + off, row_stride,
                                              nq);
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
    flash_tc::cp_async_wait<1>();  // tile t (and Q, dO) arrived
    __syncthreads();
    if (t == 0) {
      // di of the warp's 16 rows, then of this lane's two
      flash_tf32::row_dots<D>(dis + warp * 16, dos + warp * 16 * kS,
                              o + off + warp * 16 * row_stride, row_stride,
                              Sq - q0 - warp * 16);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) di[r] = dis[warp * 16 + lane / 4 + r * 8];
    }
    const int buf = t & 1;
    const float* kt_s = ks + buf * kTile;
    const float* vt_s = vs + buf * kTile;
    const float* bt = bs + buf * kTileK;

#pragma unroll
    for (int part = 0; part < kTileK / kPart; ++part) {
      const int j0 = part * kPart;  // the part's first key in the tile
      if (t * kTileK + j0 >= Sk) continue;  // keys past Sk: p = 0
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const FragA qa = flash_tf32::load_a<D>(qs, warp * 16, kk * 8);
        const FragA da = flash_tf32::load_a<D>(dos, warp * 16, kk * 8);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bk =
              flash_tf32::load_b_rows<D>(kt_s, j0 + n * 8, kk * 8);
          flash_tf32::mma3(s[n], qa, bk);
          const FragB bv =
              flash_tf32::load_b_rows<D>(vt_s, j0 + n * 8, kk * 8);
          flash_tf32::mma3(dp[n], da, bv);
        }
      }
      // dS into s: element e of n-tile n is row rows[e / 2] and key
      // j0 + n * 8 + c + e % 2 of the tile; its keep decision is bit
      // (part * kNT + n) * 4 + e of the tile's mask
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = flash::logit(s[n][e], scale,
                                       bt[j0 + n * 8 + c + (e & 1)], shift);
          const float p = expf(x - lse_r[e >> 1]);
          float dpk = dp[n][e];
          if (dr.threshold != 0u)
            dpk = (keep >> ((part * kNT + n) * 4 + e)) & 1u
                      ? dpk * dr.inv_keep
                      : 0.f;
          s[n][e] = p * (dpk - di[e >> 1]);
        }
      }
      // dQ += dS K: each n-tile of dS is the A fragment of one 8-key
      // k-step; the part's 16 keys are summed from zero and added to dQ in
      // f32 (flash_tf32.cuh, "Accumulation")
      FragA sa[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n) sa[n] = flash_tf32::acc_as_a(s[n]);
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
        float pq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bk =
              flash_tf32::load_b_cols<D>(kt_s, j0 + n * 8, nd * 8);
          flash_tf32::mma3(pq, sa[n], bk);
        }
        flash_tf32::add(acc[nd], pq);
      }
    }
    if (next && tid < kTileK) bs[((t + 1) & 1) * kTileK + tid] = next_bias;
    __syncthreads();  // every warp is done with buffer t & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    float* out = dq + ((long)b * Sq + rows[r]) * row_stride + h * D + c;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D, bool kAligned>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const uint8_t* valid, const void* o, const void* dout,
                      const float* lse, void* dq, int B, int H, int Sq, int Sk,
                      float scale, Dropout dr, cudaStream_t stream) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  const long blocks = (long)B * H * n_qt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32tc_kernel<D, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_f32tc_kernel<D, kAligned>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), valid, static_cast<const float*>(o),
          static_cast<const float*>(dout), lse, static_cast<float*>(dq), H, Sq,
          Sk, n_qt, scale, dr);
  return cudaGetLastError();
}

// the instance of the kernel whose dropout draw takes Sk % 4 == 0's
// path or the general one (flash_tc::keep_bits)
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* o, const void* dout,
                   const float* lse, void* dq, int B, int H, int Sq, int Sk,
                   float scale, Dropout dr, cudaStream_t stream) {
  if ((Sk & 3) == 0)
    return launch_as<D, true>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                              scale, dr, stream);
  return launch_as<D, false>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                             scale, dr, stream);
}

}  // namespace

// float32 only; q, k, v, O, dO, dq 16-byte aligned; D in {16, 32, 64, 128};
// scale = 1 / sqrt(the caller's head dim), which is below D where the
// caller zero-pads the head dim up to D. Dropout as in flash_attn_fwd, with
// the forward's seed. Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dq_f32tc(const void* q, const void* k,
                                       const void* v, const uint8_t* valid,
                                       const void* o, const void* dout,
                                       const float* lse, void* dq, int B,
                                       int H, int Sq, int Sk, int D,
                                       float scale, uint64_t seed,
                                       uint32_t threshold, float inv_keep,
                                       void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  switch (D) {
    case 16:
      return (int)launch<16>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                             scale, dr, s);
    case 32:
      return (int)launch<32>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                             scale, dr, s);
    case 64:
      return (int)launch<64>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                             scale, dr, s);
    case 128:
      return (int)launch<128>(q, k, v, valid, o, dout, lse, dq, B, H, Sq, Sk,
                              scale, dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
