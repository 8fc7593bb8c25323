// Flash-attention dk/dv backward on Hopper's tensor cores in float32 by
// 3xTF32 (sm_90a), plain C interface for ctypes: K3-f32tc.
//
// Replaces, for float32 inputs with at least 16 queries and 16 keys, the
// TPU kernel `_bwd_dkv_kernel` of reftr_tpu/kernels/attention.py
// (:287-339, pallas_call at :434). The same function and contract as
// flash_attn_bwd.cu's flash_attn_bwd_dkv, in the transposed form the
// tensor cores take, with keys as the M side and queries as N:
//   S^T = K Q^T, P^T = exp(S^T * scale + bias + shift - lse),
//   dP^T = V dO^T, dS^T = P^T o (dP^T o keep - di), di = rowsum(dO o O),
//   dV = sum over queries of (P^T o keep) dO, dK = scale * dS^T Q,
// with keep the forward's dropout multiplier from the same Philox stream
// (flash_common.cuh) and the logit rounded as the forward rounds it. Layout
// q, O, dO [B, Sq, H, D]; k, v, dk, dv [B, Sk, H, D], float32, contiguous
// and 16-byte aligned; valid [B, Sk] bool (nullable); lse [B, H, Sq] f32;
// D in {16, 32, 64, 128}.
//
// Design. K3-TC's structure (flash_attn_bwd_dkv_tc.cu) with its products
// in 3xTF32 (flash_tf32.cuh), which keeps float32's accuracy. One block of
// one warpgroup (4 warps, 128 threads) per (batch * head, tile of 64 keys);
// each warp owns 16 keys, whose dK and dV accumulate in f32 registers over
// the whole query sweep: no atomics, no second pass, so a repeated call
// gives the same bits.
// - Staging: the block's K and V once, then Q, dO and lse in 64-query
//   tiles by cp.async, double-buffered, rows padded to D + 4 floats, so
//   every fragment read below is conflict-free. An f32 tile is twice a bf16
//   tile's bytes, so O is not staged: di = rowsum(dO o O) of each staged
//   tile is summed from its dO in shared memory and O read from global
//   memory, D / 4 lanes per query by 16-byte loads (coalesced), one warp
//   per 16 queries; the SIMT kernel read O with one thread per query. Shared
//   memory: 55 KB at D = 32 (4 blocks an SM), 103 KB at D = 64, 199 KB at
//   D = 128. Queries past Sq are zero-filled and get p = 0.
// - Products: per chunk of 16 queries (a chunk wholly past Sq is
//   skipped), S^T and dP^T are two 8-query n-tiles each over D / 8
//   k-steps of mma.sync m16n8k8 (tf32 -> f32), three per product, with K's and V's A fragments read from the staged
//   tiles; then P^T o keep and dS^T in f32 in the accumulators are directly
//   the A fragments of dV += (P^T o keep) dO and dK += dS^T Q, one 8-query
//   k-step per n-tile, with dO and Q read at the permuted rows of
//   flash_tf32.cuh: no shuffle.
// - Splits: each fragment is split into its big and small tf32 halves
//   once, where it is read, and serves the three products; K's and V's A
//   fragments are read and split once per 16-query chunk. Neither the
//   registers (at D >= 64) nor shared memory (at D = 128, beside the
//   query tiles) can hold them split for the whole sweep.
// - Redundancy: each (query, key) pair lives on exactly one lane, so its
//   exp, ds and Philox word are computed once. Dropout decisions come from
//   flash_tc::chunk_keep, K3-TC's: the accumulator of m16n8k8 has
//   m16n8k16's layout. One Philox call per 4 elements where Sk % 4 == 0,
//   drawn at the top of the tile with no lane-dependent branch; the mask is
//   philox_keep_plain's bit for bit.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) with every key valid
// the four products are 3.17 GFLOP, 19.2 us at the 165 TFLOP/s of
// float32-accurate products that 3xTF32 gets from the 495 TFLOP/s of TF32
// (47.3 us at the 67 TFLOP/s f32 FMA rate), against q, k, v, O, dO, dk, dv
// in f32 and lse, 25.3 MB, 7.6 us at 3.35 TB/s: bound by operations.
// Measured times are in PERF.md.

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
constexpr int kKeys = 64;      // keys per block, 16 per warp
constexpr int kTileQ = 64;     // queries per staged tile
constexpr int kChunk = 16;     // queries per S^T / dP^T product

template <int D>
constexpr int smem_bytes() {
  // K, V, and two stages of Q and dO (f32), then two stages of lse, di
  return (2 * kKeys + 4 * kTileQ) * Tile<D>::kStride * 4 + 4 * kTileQ * 4;
}

// blocks an SM by shared memory, which sets the registers a thread may
// take: 128 at D <= 32
template <int D>
constexpr int kMinBlocks = D <= 32 ? 4 : D <= 64 ? 2 : 1;

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_bwd_dkv_f32tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int Sq, int Sk, int n_kt, float scale,
                           Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kTile = kTileQ * kS;  // floats of one staged tile
  constexpr int kK = D / 8;           // k-steps of S^T and dP^T
  constexpr int kN = D / 8;           // n-tiles of dK and dV
  constexpr int kNT = kChunk / 8;     // n-tiles of S^T and dP^T
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kKeys * kS;
  float* qs = vs + kKeys * kS;   // [2][kTile]
  float* dos = qs + 2 * kTile;   // [2][kTile]
  float* ls = dos + 2 * kTile;   // [2][kTileQ]
  float* dis = ls + 2 * kTileQ;  // [2][kTileQ]

  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kKeys;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;  // this lane's first query in an n-tile
  const long row_stride = (long)H * D;
  const long head = h * D;
  const float* qb = q + (long)b * Sq * row_stride + head;
  const float* ob = o + (long)b * Sq * row_stride + head;
  const float* dob = dout + (long)b * Sq * row_stride + head;
  const int n_qt = (Sq + kTileQ - 1) / kTileQ;

  auto stage = [&](int t) {
    const int buf = t & 1, q0 = t * kTileQ, nq = min(kTileQ, Sq - q0);
    const long off = q0 * row_stride;
    flash_tf32::load_tile<D, kTileQ, kThreads>(qs + buf * kTile, qb + off,
                                               row_stride, nq);
    flash_tf32::load_tile<D, kTileQ, kThreads>(dos + buf * kTile, dob + off,
                                               row_stride, nq);
    if (tid < kTileQ)
      flash_tc::cp_async4(ls + buf * kTileQ + tid,
                          lse + (long)bh * Sq + q0 + (tid < nq ? tid : 0),
                          tid < nq ? 4 : 0);
  };
  const long koff = ((long)b * Sk + k0) * row_stride + head;
  flash_tf32::load_tile<D, kKeys, kThreads>(ks, k + koff, row_stride,
                                            min(kKeys, Sk - k0));
  flash_tf32::load_tile<D, kKeys, kThreads>(vs, v + koff, row_stride,
                                            min(kKeys, Sk - k0));
  stage(0);
  flash_tc::cp_async_commit();
  // with the first tiles in flight
  const float shift = flash::masked_row_shift(valid, b, Sk);

  // this lane's two keys: warp * 16 + lane / 4 and 8 below it
  int keys[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    keys[r] = k0 + warp * 16 + lane / 4 + r * 8;
    // a key past Sk gets p = 0 (its rows are computed, never written)
    bias[r] = keys[r] >= Sk ? -INFINITY
              : (valid == nullptr || valid[(long)b * Sk + keys[r]])
                  ? 0.f
                  : flash::kMaskBias;
  }
  float dka[kN][4], dva[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < n_qt; ++t) {
    if (t + 1 < n_qt) stage(t + 1);
    flash_tc::cp_async_commit();  // (possibly empty) group of tile t + 1
    // the tile's keep decisions, bit cq * 8 + n * 4 + e for 16-query chunk
    // cq: they need no data, so the integer work overlaps the copies
    uint32_t keep = 0u;
    if (dr.threshold != 0u) {
#pragma unroll
      for (int cq = 0; cq < kTileQ / 16; ++cq)
        keep |= flash_tc::chunk_keep(
                    dr, (uint64_t)bh * Sq + t * kTileQ + cq * 16 + c, Sk,
                    keys)
                << (cq * 8);
    }
    flash_tc::cp_async_wait<1>();  // tile t (and K, V) arrived
    __syncthreads();
    const int buf = t & 1, q0 = t * kTileQ;
    const float* qt = qs + buf * kTile;
    const float* dot = dos + buf * kTile;
    // di of the tile's queries, warp w the 16 from w * 16
    flash_tf32::row_dots<D>(dis + buf * kTileQ + warp * 16,
                            dot + warp * 16 * kS,
                            ob + (q0 + warp * 16) * row_stride, row_stride,
                            Sq - q0 - warp * 16);
    __syncthreads();
    const float* lst = ls + buf * kTileQ;
    const float* dit = dis + buf * kTileQ;

#pragma unroll
    for (int ch = 0; ch < kTileQ / kChunk; ++ch) {
      const int c0 = ch * kChunk;  // the chunk's first query in the tile
      if (q0 + c0 >= Sq) continue;  // queries past Sq: p = 0
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const FragA ka = flash_tf32::load_a<D>(ks, warp * 16, kk * 8);
        const FragA va = flash_tf32::load_a<D>(vs, warp * 16, kk * 8);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bq = flash_tf32::load_b_rows<D>(qt, c0 + n * 8, kk * 8);
          flash_tf32::mma3(st[n], ka, bq);
          const FragB bd =
              flash_tf32::load_b_rows<D>(dot, c0 + n * 8, kk * 8);
          flash_tf32::mma3(dpt[n], va, bd);
        }
      }
      // P^T o keep into st, dS^T into dpt: element e of n-tile n is key
      // keys[e / 2] and query c0 + n * 8 + c + e % 2 of the tile, whose
      // keep decision is bit (ch * kNT + n) * 4 + e; a query past Sq
      // (zero-filled) gets p = 0
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c0 + n * 8 + c + (e & 1);
          const float p =
              q0 + qi < Sq
                  ? expf(flash::logit(st[n][e], scale, bias[e >> 1], shift) -
                         lst[qi])
                  : 0.f;
          float dp = dpt[n][e], pk = p;
          if (dr.threshold != 0u) {
            const float kp =
                (keep >> ((ch * kNT + n) * 4 + e)) & 1u ? dr.inv_keep : 0.f;
            pk = p * kp;
            dp *= kp;
          }
          st[n][e] = pk;
          dpt[n][e] = p * (dp - dit[qi]);
        }
      }
      // dV += (P^T o keep) dO and dK += dS^T Q: each n-tile is the A
      // fragment of one 8-query k-step; the chunk's 16 queries are summed
      // from zero and added to dV and dK in f32 (flash_tf32.cuh,
      // "Accumulation")
      FragA pa[kNT], sa[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        pa[n] = flash_tf32::acc_as_a(st[n]);
        sa[n] = flash_tf32::acc_as_a(dpt[n]);
      }
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f}, pk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const FragB bo =
              flash_tf32::load_b_cols<D>(dot, c0 + n * 8, nd * 8);
          flash_tf32::mma3(pv, pa[n], bo);
          const FragB bq = flash_tf32::load_b_cols<D>(qt, c0 + n * 8, nd * 8);
          flash_tf32::mma3(pk, sa[n], bq);
        }
        flash_tf32::add(dva[nd], pv);
        flash_tf32::add(dka[nd], pk);
      }
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    const long off = ((long)b * Sk + keys[r]) * row_stride + head + c;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      *reinterpret_cast<float2*>(dk + off + n * 8) =
          make_float2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + n * 8) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* o, const void* dout,
                   const float* lse, void* dk, void* dv, int B, int H, int Sq,
                   int Sk, float scale, Dropout dr, cudaStream_t stream) {
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  const long blocks = (long)B * H * n_kt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_f32tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dkv_f32tc_kernel<D>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), valid, static_cast<const float*>(o),
          static_cast<const float*>(dout), lse, static_cast<float*>(dk),
          static_cast<float*>(dv), H, Sq, Sk, n_kt, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// float32 only; q, k, v, O, dO, dk, dv 16-byte aligned; D in {16, 32, 64,
// 128}; scale = 1 / sqrt(the caller's head dim), which is below D where
// the caller zero-pads the head dim up to D. Dropout as in flash_attn_fwd,
// with the forward's seed. Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dkv_f32tc(const void* q, const void* k,
                                        const void* v, const uint8_t* valid,
                                        const void* o, const void* dout,
                                        const float* lse, void* dk, void* dv,
                                        int B, int H, int Sq, int Sk, int D,
                                        float scale, uint64_t seed,
                                        uint32_t threshold, float inv_keep,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  switch (D) {
    case 16:
      return (int)launch<16>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq,
                             Sk, scale, dr, s);
    case 32:
      return (int)launch<32>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq,
                             Sk, scale, dr, s);
    case 64:
      return (int)launch<64>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq,
                             Sk, scale, dr, s);
    case 128:
      return (int)launch<128>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq,
                              Sk, scale, dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
