// Flash-attention dk/dv backward on Hopper's warpgroup tensor-core
// products, bf16 (sm_90a), plain C interface for ctypes: K3-wg.
//
// Replaces, for bf16 inputs at the shapes where the dispatch rule
// (kernels/attention.py::dkv_variant) sends them here, the TPU kernel
// `_bwd_dkv_kernel` of reftr_tpu/kernels/attention.py (:287-339,
// pallas_call at :434). The same function as flash_attn_bwd_dkv_tc.cu
// (K3-TC), keys as the M side and queries as N:
//   S^T = K Q^T, P^T = exp(S^T * scale + bias + shift - lse),
//   dP^T = V dO^T, dS^T = P^T o (dP^T o keep - di),
//   dV = sum over queries of (P^T o keep) dO, dK = scale * dS^T Q,
// with keep the forward's dropout multiplier and di = rowsum(dO o O)
// given by the caller ([B, H, Sq] f32: K2-wg writes it where it computes
// it, so this kernel never reads O). Layout q, dO [B, Sq, H, D]; k, v, dk,
// dv [B, Sk, H, D], bf16, contiguous and 16-byte aligned; valid [B, Sk]
// bool (nullable); lse, di [B, H, Sq] f32; D = 32. A key of a batch row
// whose keys are all masked has the logit 0 (the plain version's -1e9 +
// 1e9), so p = exp(-lse) there.
//
// The keep bits. This kernel draws no random number: with dropout it
// reads the forward's mask as K2-wg (flash_attn_bwd_dq_wg.cu) wrote it,
// keep_bits uint32 [B, H, Sq, W], W = 4 * ceil(Sk / 128): bit j % 32 of
// word j / 32 of row (b, h, i) is the keep decision of element
// ((b * H + h) * Sq + i) * Sk + j (kernels/attention.py::keep_bits_plain),
// masked keys and fully masked rows included, bits past Sk 0; keep is
// then inv_keep = 1 / (1 - rate) where the bit is set and 0 where not.
// keep_bits null: no dropout. A block's 128 keys are 4 words of each
// row, one 16-byte piece: a query tile's 64 rows of it are one TMA box.
//
// What bounds it. At the four-level encoder (B=8, H=8, 8540^2, D=32) the
// four products are 1.2 ms at 989 TFLOP/s, the bytes 0.05 ms and, with
// dropout, the keep bits 586 MB more, 0.17 ms at 3.35 TB/s; per score it
// takes one exponential on the special-function unit (1.11 ms) and the
// dP and dS arithmetic. When this kernel drew the mask again from the
// seed (flash_tc::chunk_keep, a quarter of a Philox call a score, 1.32 ms
// of integer multiplies at best) it ran 11.00 ms a call with dropout 0.1
// against 3.51 without (PERF.md §6). K3-TC stages Q, dO and O per query
// tile and recomputes di = rowsum(dO o O) for every query in every one of
// its key blocks (134 at 8540 keys), and runs its four products and its
// arithmetic in turn in one warpgroup.
//
// Design.
// - One block per (batch * head, 128 keys): a producer warpgroup (one
//   warp works; the warpgroup gives its registers to the consumers,
//   setmaxnreg 40 and 232: with no draw the producer needs no more) and
//   two consumer warpgroups of 64 keys (384 threads, one block an SM).
//   Each warpgroup holds dK and dV of its keys in f32 registers over the
//   whole query sweep: no atomics, and dq stays in K2.
// - The producer warp loads K and V once by TMA and keeps a ring of
//   kStages query tiles (64 queries of Q and dO by TMA through rank-4
//   tensor maps, zero past Sq; with dropout the tile's 64 x 16 bytes of
//   keep bits through a rank-3 map over [B * H, Sq, W]) in flight, with
//   the tile's lse * log2 e and di, which its 32 lanes copy (lse = +inf and
//   di = 0 past Sq, so p = 0 there); the stage's mbarrier completes on the
//   32 lanes' arrivals and the TMA bytes.
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16 with A (K, V) and B
//   (Q, dO) K-major in shared memory, issued together; while they run the
//   warpgroup reads its keep bits from the stage: a lane's two keys lie in
//   one word of a query's row (keys kl and kl + 8, kl % 16 < 8), so one
//   load and one shift a query give both, and each accumulator element
//   picks its bit with a shift.
// - P^T = 2^(s * scale * log2 e - lse * log2 e): one FFMA and one MUFU.EX2
//   (ex2.approx); the key bias is per accumulator row (the key), so a
//   masked or out-of-range key is p = 0 and a fully masked row's key takes
//   scale 0 (logit 0): no per-element bias.
// - dV += (P^T o keep) dO and dK += dS^T Q: wgmma m64nDk16 with A from
//   registers (the accumulators packed to bf16, the RS form) and B (dO, Q)
//   MN-major in shared memory. Each tile's products go into fresh
//   accumulators folded into dV and dK with a rounded add, so no
//   accumulator is carried through the tensor cores over the sweep.
//
// Bound: PERF.md §6 holds the measured times beside chip_smoke.py's bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wg.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                    // warpgroups of 64 keys
constexpr int kKeys = 64 * kConsumers;           // keys per block
constexpr int kTileQ = 64;                       // queries per tile
constexpr int kStages = 4;                       // query tiles in flight
// + the producer warpgroup, which hands its registers to the consumers
// (register allocation is per warpgroup; flash_attn_fwd_wg.cu)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int D = flash_wg::kHeadDim;

struct Layout {
  static constexpr int kTile = kTileQ * D * 2;  // bytes of a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKeys * D * 2;
  static constexpr int kQ = 2 * kKeys * D * 2;
  static constexpr int kDo = kQ + kStages * kTile;
  // per stage, the tile's keep bits: kTileQ rows of the block's 4 words
  static constexpr int kKeep = kDo + kStages * kTile;
  // [kStages][kTileQ] each
  static constexpr int kLse = kKeep + kStages * kTileQ * 16;
  static constexpr int kDi = kLse + kStages * kTileQ * 4;
  static constexpr int kBars = kDi + kStages * kTileQ * 4;
  // full_kv, then full and empty per stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_keep,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int Sq, int Sk,
                        float scale, bool drop, float inv_keep) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* di_s = reinterpret_cast<float*>(smem + L::kDi);
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(smem + L::kKeep);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kKeys;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int n_qt = (Sq + kTileQ - 1) / kTileQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    flash_wg::bar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      flash_wg::bar_init(full + s, 32);               // the producer's lanes
      flash_wg::bar_init(empty + s, 4 * kConsumers);  // one per warp
    }
    flash_wg::bar_fence_init();
  }
  // a batch row whose keys are all masked (every thread votes; the vote
  // ends in a block-wide barrier, which also publishes the barriers)
  const bool masked_row = flash::masked_row_shift(valid, b, Sk) != 0.f;

  if (warp >= 4 * kConsumers) {  // the producer warpgroup
    flash_wg::regs_release<kProducerRegs>();
    if (warp > 4 * kConsumers) return;
    if (lane == 0) {
      flash_wg::prefetch_map(&map_q);
      flash_wg::prefetch_map(&map_do);
      if (drop) flash_wg::prefetch_map(&map_keep);
      flash_wg::bar_arrive_tx(full_kv, 2 * kKeys * D * 2);
      flash_wg::tma_load_4d(smem + L::kK, &map_k, full_kv, 0, h, k0, b);
      flash_wg::tma_load_4d(smem + L::kV, &map_v, full_kv, 0, h, k0, b);
    }
    for (int t = 0; t < n_qt; ++t) {
      const int s = t % kStages;
      if (t >= kStages)  // the consumers gave back tile t - kStages
        flash_wg::bar_wait(empty + s, ((t / kStages) & 1) ^ 1);
#pragma unroll
      for (int i = lane; i < kTileQ; i += 32) {
        const int qi = t * kTileQ + i;
        const long at = (long)bh * Sq + qi;
        lse_s[s * kTileQ + i] = qi < Sq ? lse[at] * kLog2e : INFINITY;
        di_s[s * kTileQ + i] = qi < Sq ? di[at] : 0.f;
      }
      if (lane == 0) {
        flash_wg::bar_arrive_tx(full + s,
                                2 * L::kTile + (drop ? kTileQ * 16 : 0));
        flash_wg::tma_load_4d(smem + L::kQ + s * L::kTile, &map_q, full + s,
                              0, h, t * kTileQ, b);
        flash_wg::tma_load_4d(smem + L::kDo + s * L::kTile, &map_do,
                              full + s, 0, h, t * kTileQ, b);
        if (drop)  // words 4 * blockIdx.x .. + 3 of the tile's query rows
          flash_wg::tma_load_3d(smem + L::kKeep + s * kTileQ * 16,
                                &map_keep, full + s, 4 * blockIdx.x,
                                t * kTileQ, bh);
      } else {
        flash_wg::bar_arrive(full + s);
      }
    }
    return;
  }

  flash_wg::regs_take<kConsumerRegs>();
  // a consumer: warpgroup wg owns keys k0 + wg * 64 .. + 63, and this lane
  // keys[0] = .. + (warp % 4) * 16 + lane / 4 and keys[1] 8 below it
  const int wg = warp / 4;
  const int c = (lane % 4) * 2;  // this lane's first query in a chunk
  // keys[0]'s place in the block's keep words: word kw, bit kb (keys[1]
  // at kb + 8 in the same word)
  const int kl = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int kw = kl / 32, kb = kl % 32;
  int keys[2];
  bool live[2];  // in range, and valid or in a fully masked row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    keys[r] = k0 + wg * 64 + (warp % 4) * 16 + lane / 4 + r * 8;
    live[r] = keys[r] < Sk &&
              (masked_row || valid == nullptr ||
               valid[(long)b * Sk + keys[r]] != 0);
  }
  // a fully masked row's logits are 0: the scores get scale 0
  const float scale_log2 = masked_row ? 0.f : scale * kLog2e;
  const uint64_t desc_k =
      flash_wg::make_desc(smem + L::kK + wg * 64 * D * 2);
  const uint64_t desc_v =
      flash_wg::make_desc(smem + L::kV + wg * 64 * D * 2);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  flash_wg::bar_wait(full_kv, 0);
  for (int t = 0; t < n_qt; ++t) {
    const int s = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const uint64_t desc_q =
        flash_wg::make_desc(smem + L::kQ + s * L::kTile);
    const uint64_t desc_do =
        flash_wg::make_desc(smem + L::kDo + s * L::kTile);

    // S^T and dP^T: chunk n (8 queries) of the tile at [4n..4n+3]
    float st[kTileQ / 2], dpt[kTileQ / 2];
    flash_wg::bar_wait(full + s, phase);
    flash_wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      flash_wg::mma_ss_n64(st, flash_wg::desc_add(desc_k, kk * 32),
                           flash_wg::desc_add(desc_q, kk * 32), kk > 0);
      flash_wg::mma_ss_n64(dpt, flash_wg::desc_add(desc_v, kk * 32),
                           flash_wg::desc_add(desc_do, kk * 32), kk > 0);
    }
    flash_wg::wg_commit();
    // with the products in flight: the keep bits of this lane's keys at
    // query n * 8 + c + s of the tile, keys[r]'s at bit 8 r of keep[n][s]
    uint32_t keep[kTileQ / 8][2];
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        keep[n][q] =
            drop ? keep_s[(s * kTileQ + n * 8 + c + q) * 4 + kw] >> kb : 0u;
    float lse2[kTileQ / 4], dit[kTileQ / 4];  // query n * 8 + c + (i % 2)
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(
          lse_s + s * kTileQ + n * 8 + c);
      const float2 d2 = *reinterpret_cast<const float2*>(
          di_s + s * kTileQ + n * 8 + c);
      lse2[2 * n] = l2.x;
      lse2[2 * n + 1] = l2.y;
      dit[2 * n] = d2.x;
      dit[2 * n + 1] = d2.y;
    }
    flash_wg::wg_wait<0>();
    flash_wg::fence_operands(st);
    flash_wg::fence_operands(dpt);

    // P^T o keep into st, dS^T into dpt: element e of chunk n is key
    // keys[e / 2] and query n * 8 + c + e % 2 of the tile
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n * 4 + e, qi = 2 * n + (e & 1);
        const float p =
            live[e >> 1]
                ? flash_wg::exp2_approx(fmaf(st[i], scale_log2, -lse2[qi]))
                : 0.f;
        float dp = dpt[i], pk = p;
        if (drop) {
          const float kp =
              (keep[n][e & 1] >> (8 * (e >> 1))) & 1u ? inv_keep : 0.f;
          pk = p * kp;
          dp *= kp;
        }
        st[i] = pk;
        dpt[i] = p * (dp - dit[qi]);
      }
    }
    uint32_t pa[kTileQ / 16][4], da[kTileQ / 16][4];
#pragma unroll
    for (int kt = 0; kt < kTileQ / 16; ++kt) {
      flash_wg::pack_a(pa[kt], st, kt);
      flash_wg::pack_a(da[kt], dpt, kt);
    }
    float dv_part[D / 2], dk_part[D / 2];
    flash_wg::wg_fence();
#pragma unroll
    for (int kt = 0; kt < kTileQ / 16; ++kt) {
      flash_wg::mma_rs_n32(dv_part, pa[kt],
                           flash_wg::desc_add(desc_do, kt * 16 * D * 2),
                           kt > 0);
      flash_wg::mma_rs_n32(dk_part, da[kt],
                           flash_wg::desc_add(desc_q, kt * 16 * D * 2),
                           kt > 0);
    }
    flash_wg::wg_commit();
    flash_wg::wg_wait<0>();
    flash_wg::fence_operands(dv_part);
    flash_wg::fence_operands(dk_part);
    if (lane == 0) flash_wg::bar_arrive(empty + s);  // Q and dO read
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dva[i] += dv_part[i];
      dka[i] += dk_part[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    const long off = ((long)b * Sk + keys[r]) * H * D + h * D + c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n * 4 + 2 * r] * scale,
                                dka[n * 4 + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n * 4 + 2 * r], dva[n * 4 + 2 * r + 1]);
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* dout, const float* lse,
                   const float* di, const uint32_t* keep_bits, void* dk,
                   void* dv, int B, int H, int Sq, int Sk, float scale,
                   float inv_keep, cudaStream_t stream) {
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  if ((long)B * H > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t bound = flash_wg::bind_device(q);
  if (bound != cudaSuccess) return bound;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!flash_wg::make_map(&map_q, q, B, Sq, H, kTileQ) ||
      !flash_wg::make_map(&map_k, k, B, Sk, H, kKeys) ||
      !flash_wg::make_map(&map_v, v, B, Sk, H, kKeys) ||
      !flash_wg::make_map(&map_do, dout, B, Sq, H, kTileQ))
    return cudaErrorInvalidValue;
  // with no keep bits the map is not read: it stays zeroed
  CUtensorMap map_keep = {};
  if (keep_bits != nullptr &&
      !flash_wg::make_keep_map(&map_keep, keep_bits, B * H, Sq,
                               4 * ((Sk + 127) / 128), kTileQ))
    return cudaErrorInvalidValue;
  constexpr int bytes = Layout::kAlloc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wg_kernel<<<dim3(n_kt, B * H), kThreads, bytes, stream>>>(
      map_q, map_k, map_v, map_do, map_keep, valid, lse, di,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, scale,
      keep_bits != nullptr, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; q, k, v, dO, dk, dv 16-byte aligned; head_dim = 32; scale =
// 1 / sqrt(the caller's head dim); di = rowsum(dO o O) [B, H, Sq] f32;
// keep_bits [B, H, Sq, 4 * ceil(Sk / 128)] uint32, 16-byte aligned, or
// null for no dropout; inv_keep = 1 / (1 - rate). Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attn_bwd_dkv_wg(const void* q, const void* k,
                                     const void* v, const uint8_t* valid,
                                     const void* dout, const float* lse,
                                     const float* di,
                                     const uint32_t* keep_bits, void* dk,
                                     void* dv, int B, int H, int Sq, int Sk,
                                     int head_dim, float scale,
                                     float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || di == nullptr ||
      lse == nullptr || reinterpret_cast<uintptr_t>(keep_bits) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, valid, dout, lse, di, keep_bits, dk, dv, B, H,
                     Sq, Sk, scale, inv_keep, s);
}
