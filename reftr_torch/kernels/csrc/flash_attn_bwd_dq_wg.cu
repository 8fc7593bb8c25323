// Flash-attention dq backward on Hopper's warpgroup tensor-core products,
// bf16 (sm_90a), plain C interface for ctypes: K2-wg.
//
// Replaces, for bf16 inputs at the shapes where the dispatch rule
// (kernels/attention.py::dq_variant) sends them here, the TPU kernel
// `_bwd_dq_kernel` of reftr_tpu/kernels/attention.py (:242-284, driven by
// `_bwd` :342-457, pallas_call at :420). The same function and contract as
// flash_attn_bwd_dq_tc.cu (K2-TC):
//   di = rowsum(dO o O), p = exp(q k^T * scale + bias + shift - lse),
//   ds = p o (dO v^T o keep - di), dq = scale * ds k,
// with keep the forward's Philox dropout multiplier (flash_common.cuh) and
// a fully masked row's logits 0 (the plain version's -1e9 + 1e9). Layout
// q, O, dO, dq [B, Sq, H, D]; k, v [B, Sk, H, D], bf16, contiguous and
// 16-byte aligned; valid [B, Sk] bool (nullable); lse [B, H, Sq] f32; D =
// 32. With di_out (nullable, [B, H, Sq] f32) each query's di is also
// stored there, for K3-wg (flash_attn_bwd_dkv_wg.cu), which reads it
// instead of O.
//
// What bounds it. At the four-level encoder (B=8, H=8, 8540^2, D=32) the
// three products are 0.91 ms at 989 TFLOP/s and the bytes 0.04 ms; per
// score it takes one exponential on the special-function unit (1.1 ms at
// 16 a clock per SM and 1.98 GHz), a few FP32 instructions for ds and,
// with dropout, a quarter of a Philox call. K2-TC runs its three products
// by mma.sync and its arithmetic in turn in one warpgroup per 64 queries,
// and keeps dq in one f32 accumulator over the whole key sweep.
//
// Design (K1-wg's, flash_attn_fwd_wg.cu, with flash_wg.cuh's pieces).
// - One block per (batch * head, 128 queries): a producer warpgroup
//   (setmaxnreg 40) and two consumer warpgroups of 64 query rows
//   (setmaxnreg 232), 384 threads, one block an SM.
// - The producer warp loads Q and dO once by TMA (they stay resident) and
//   keeps a ring of kStages K and V tiles of 64 keys in flight through the
//   rank-4 tensor maps over [B, S, H, D] (zeros past Sk), one mbarrier a
//   stage; the consumers give a stage back on an "empty" mbarrier. Its 32
//   lanes ballot the tile's live keys (valid and in range; in a fully
//   masked row every key in range) into 64 bits beside the stage.
// - di = rowsum(dO o O) once per row: dO from the resident tile, O read
//   once from device memory, the row's quad of lanes summing 8 columns
//   each.
// - Per tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 from shared
//   memory, issued together; while they run the warpgroup draws the
//   tile's dropout decisions (flash_tc::keep_bits: the accumulator's
//   per-warp layout is mma.sync's). p = 2^(s * scale * log2 e - lse *
//   log2 e) is one FFMA and one MUFU.EX2 (ex2.approx); a dead key's p is
//   0, selected only in a tile whose bits show one. dS = p o (dP o keep -
//   di) is rounded to bf16 in registers as the A fragments of dq_part =
//   dS K, wgmma m64n32k16 in the RS form with K as the MN-major B operand
//   (as K1-wg takes V for P V).
// - dq_part goes into a fresh accumulator and is folded into dq with a
//   rounded add once its product is done (mma.sync's truncating
//   accumulation leaned the 3xTF32 kernels' long sums one way; PERF.md),
//   so no accumulator runs through the tensor cores over the sweep. The
//   fold of tile t waits at the top of tile t + 1, after S and dP of t + 1
//   are issued: dq_part_t, S_{t+1} and dP_{t+1} run while the decisions of
//   t + 1 are drawn, and the two consumer warpgroups' arithmetic
//   interleaves with each other's products.
// - No atomics and no fusion into K3: dq is deterministic, as the TPU
//   kernel's is.
//
// Bound: PERF.md §6 holds the measured times beside chip_smoke.py's bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "flash_wg.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Dropout;

constexpr int kConsumers = 2;           // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;  // query rows per block
constexpr int kTileK = 64;              // keys per tile
constexpr int kStages = 6;              // K/V tiles in flight
// + the producer warpgroup, which hands its registers to the consumers
// (register allocation is per warpgroup; flash_attn_fwd_wg.cu)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int D = flash_wg::kHeadDim;

struct Layout {
  static constexpr int kTile = kTileK * D * 2;  // bytes of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kRows * D * 2;
  static constexpr int kK = 2 * kRows * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  // per stage, the tile's 64 live-key bits (2 words, key 32w + i at bit i
  // of word w)
  static constexpr int kLive = kV + kStages * kTile;
  static constexpr int kBars = kLive + kStages * 8;
  // full_q, then full and empty per stage
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// A consumer warpgroup's state over the key sweep and its steps. Every
// member function is inlined and every array index is a constant after
// inlining, so the state stays in registers. kAligned (Sk % 4 == 0) picks
// the dropout draw's path (flash_tc::keep_bits).
template <bool kAligned>
struct Consumer {
  using L = Layout;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  const uint32_t* live_bits;
  int c, lane;
  float scale_log2;
  uint64_t desc_q, desc_do;
  uint64_t n_row[2];  // dropout offset of (b, h, row, key 0)
  Dropout dr;
  float lse2[2];  // lse * log2 e; +inf past Sq (p = 0)
  float di[2];
  float dq[D / 2];
  float part[D / 2];
  float sc[kTileK / 2];  // S, then P: chunk n (8 keys) at sc[4n..4n+3]
  float dp[kTileK / 2];  // dP, the same layout
  uint32_t pa[kTileK / 16][4];  // dS as A fragments
  uint32_t keep;

  // S = Q K_t^T and dP = dO V_t^T (asynchronous)
  __device__ __forceinline__ void issue_sdp(int t) {
    const int st = t % kStages;
    const uint64_t desc_k =
        flash_wg::make_desc(smem + L::kK + st * L::kTile);
    const uint64_t desc_v =
        flash_wg::make_desc(smem + L::kV + st * L::kTile);
    flash_wg::bar_wait(full + st, (t / kStages) & 1);
    flash_wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      flash_wg::mma_ss_n64(sc, flash_wg::desc_add(desc_q, kk * 32),
                           flash_wg::desc_add(desc_k, kk * 32), kk > 0);
      flash_wg::mma_ss_n64(dp, flash_wg::desc_add(desc_do, kk * 32),
                           flash_wg::desc_add(desc_v, kk * 32), kk > 0);
    }
    flash_wg::wg_commit();
  }

  // part = dS_t K_t, the tile's 4 k-steps of 16 keys (asynchronous)
  __device__ __forceinline__ void issue_dq(int t) {
    const uint64_t desc_k =
        flash_wg::make_desc(smem + L::kK + (t % kStages) * L::kTile);
    flash_wg::wg_fence();
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt)
      flash_wg::mma_rs_n32(part, pa[kt],
                           flash_wg::desc_add(desc_k, kt * 16 * D * 2),
                           kt > 0);
    flash_wg::wg_commit();
  }

  // tile t's dropout decisions: bit n * 4 + e for element e of chunk n
  // (they need no data)
  __device__ __forceinline__ void keep_of(int t) {
    keep = dr.threshold != 0u ? flash_tc::keep_bits<kTileK / 8, kAligned>(
                                    n_row, t * kTileK, c, dr)
                              : 0u;
  }

  // every product issued so far is done: fold part into dq and give back
  // the stage of tile t - 1, whose K the last dS K read
  __device__ __forceinline__ void settle(int t) {
    flash_wg::wg_wait<0>();
    flash_wg::fence_operands(sc);
    flash_wg::fence_operands(dp);
    flash_wg::fence_operands(part);
    flash_wg::fence_operands(pa);
    if (t > 0 && lane == 0) flash_wg::bar_arrive(empty + (t - 1) % kStages);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] += part[i];
  }

  // dS of tile t from sc and dp into the A fragments pa
  __device__ __forceinline__ void ds(int t) {
    const uint2 live =
        *reinterpret_cast<const uint2*>(live_bits + (t % kStages) * 2);
    const bool dead = (live.x & live.y) != ~0u;  // a masked or padded key
    const uint32_t words[2] = {live.x, live.y};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n * 4 + e, key = n * 8 + c + (e & 1);
        float p = flash_wg::exp2_approx(
            fmaf(sc[i], scale_log2, -lse2[e >> 1]));
        if (dead) p = (words[key / 32] >> (key % 32)) & 1u ? p : 0.f;
        float dpk = dp[i];
        if (dr.threshold != 0u)
          dpk = (keep >> i) & 1u ? dpk * dr.inv_keep : 0.f;
        sc[i] = p * (dpk - di[e >> 1]);
      }
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt) flash_wg::pack_a(pa[kt], sc, kt);
  }
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const uint8_t* __restrict__ valid,
                       const bf16* __restrict__ o,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       float* __restrict__ di_out, int H, int Sq, int Sk,
                       float scale, Dropout dr) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(smem + L::kLive);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int n_kt = (Sk + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    flash_wg::bar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      flash_wg::bar_init(full + s, 1);
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
      flash_wg::prefetch_map(&map_k);
      flash_wg::prefetch_map(&map_v);
      flash_wg::bar_arrive_tx(full_q, 2 * kRows * D * 2);
      flash_wg::tma_load_4d(smem + L::kQ, &map_q, full_q, 0, h, q0, b);
      flash_wg::tma_load_4d(smem + L::kDo, &map_do, full_q, 0, h, q0, b);
    }
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      if (t >= kStages)  // the consumers gave back tile t - kStages
        flash_wg::bar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      // the tile's live keys as 2 words of bits, one ballot of 32
      // neighbouring keys each: in range, and valid or in a fully masked
      // row (whose logits are all 0)
      uint32_t words[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int j = t * kTileK + w * 32 + lane;
        words[w] = __ballot_sync(
            0xffffffffu, j < Sk && (masked_row || valid == nullptr ||
                                    valid[(long)b * Sk + j] != 0));
      }
      if (lane == 0) {
        *reinterpret_cast<uint2*>(live_bits + s * 2) =
            make_uint2(words[0], words[1]);
        flash_wg::bar_arrive_tx(full + s, 2 * L::kTile);
        flash_wg::tma_load_4d(smem + L::kK + s * L::kTile, &map_k, full + s,
                              0, h, t * kTileK, b);
        flash_wg::tma_load_4d(smem + L::kV + s * L::kTile, &map_v, full + s,
                              0, h, t * kTileK, b);
      }
    }
    return;
  }

  flash_wg::regs_take<kConsumerRegs>();
  // a consumer: warpgroup wg owns query rows q0 + wg * 64 .. + 63, and
  // this lane rows[0] = .. + (warp % 4) * 16 + lane / 4 and rows[1] 8 below
  const int wg = warp / 4;
  Consumer<kAligned> w;
  w.smem = smem;
  w.full = full;
  w.empty = empty;
  w.live_bits = live_bits;
  w.c = (lane % 4) * 2;  // this lane's first column in a chunk
  w.lane = lane;
  // a fully masked row's logits are 0: the scores get scale 0
  w.scale_log2 = masked_row ? 0.f : scale * kLog2e;
  w.desc_q = flash_wg::make_desc(smem + L::kQ + wg * 64 * D * 2);
  w.desc_do = flash_wg::make_desc(smem + L::kDo + wg * 64 * D * 2);
  w.dr = dr;
  w.keep = 0u;
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + wg * 64 + (warp % 4) * 16 + lane / 4 + r * 8;
    w.n_row[r] = ((uint64_t)bh * Sq + rows[r]) * Sk;
    w.lse2[r] =
        rows[r] < Sq ? lse[(long)bh * Sq + rows[r]] * kLog2e : INFINITY;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.dq[i] = w.part[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kTileK / 16; ++kt)
    w.pa[kt][0] = w.pa[kt][1] = w.pa[kt][2] = w.pa[kt][3] = 0u;

  flash_wg::bar_wait(full_q, 0);
  // di of this lane's rows: lane q of the row's quad sums columns 8q..8q+7
  // of dO (the resident tile, 16-byte chunk q of the row swizzled by the
  // row's bits 1-2) and of O (device memory, read once)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r] - q0;  // in the block's tile
    const int q = lane % 4;
    const uint4 dv = *reinterpret_cast<const uint4*>(
        smem + L::kDo + row * D * 2 + ((q ^ ((row >> 1) & 3)) * 16));
    uint4 ov = make_uint4(0u, 0u, 0u, 0u);
    if (rows[r] < Sq)
      ov = *reinterpret_cast<const uint4*>(
          o + ((long)b * Sq + rows[r]) * H * D + h * D + q * 8);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(d2[j]);
      const float2 x = __bfloat1622float2(o2[j]);
      sum = fmaf(a.x, x.x, sum);
      sum = fmaf(a.y, x.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    w.di[r] = sum;
    if (di_out != nullptr && q == 0 && rows[r] < Sq)
      di_out[(long)bh * Sq + rows[r]] = sum;
  }

  // the same step every tile, no branch around the products: tile t's S
  // and dP go out while dq_part of t - 1 may still run
  for (int t = 0; t < n_kt; ++t) {
    w.issue_sdp(t);
    w.keep_of(t);
    w.settle(t);
    w.ds(t);
    w.issue_dq(t);
  }
  w.settle(n_kt);

  const int c = w.c;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    bf16* op = dq + ((long)b * Sq + rows[r]) * H * D + h * D + c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          w.dq[n * 4 + 2 * r] * scale, w.dq[n * 4 + 2 * r + 1] * scale);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, const void* o, const void* dout,
                   const float* lse, void* dq, float* di_out, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  if ((long)B * H > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t bound = flash_wg::bind_device(q);
  if (bound != cudaSuccess) return bound;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!flash_wg::make_map(&map_q, q, B, Sq, H, kRows) ||
      !flash_wg::make_map(&map_do, dout, B, Sq, H, kRows) ||
      !flash_wg::make_map(&map_k, k, B, Sk, H, kTileK) ||
      !flash_wg::make_map(&map_v, v, B, Sk, H, kTileK))
    return cudaErrorInvalidValue;
  constexpr int bytes = Layout::kAlloc;
  // the instance whose dropout draw takes Sk % 4 == 0's path or the
  // general one (flash_tc::keep_bits)
  auto kernel = (Sk & 3) == 0 ? flash_bwd_dq_wg_kernel<true>
                              : flash_bwd_dq_wg_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, B * H), kThreads, bytes, stream>>>(
      map_q, map_k, map_v, map_do, valid, static_cast<const bf16*>(o), lse,
      static_cast<bf16*>(dq), di_out, H, Sq, Sk, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; q, k, v, O, dO, dq 16-byte aligned; head_dim = 32; di_out
// nullable; scale = 1 / sqrt(the caller's head dim). Dropout as in
// flash_attn_fwd, with the forward's seed. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attn_bwd_dq_wg(const void* q, const void* k,
                                    const void* v, const uint8_t* valid,
                                    const void* o, const void* dout,
                                    const float* lse, void* dq,
                                    float* di_out, int B, int H, int Sq,
                                    int Sk, int head_dim, float scale,
                                    uint64_t seed, uint32_t threshold,
                                    float inv_keep, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24) ||
      lse == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, valid, o, dout, lse, dq, di_out, B, H, Sq, Sk,
                     scale, dr, s);
}
