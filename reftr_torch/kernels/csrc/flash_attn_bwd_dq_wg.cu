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
// The keep bits. With dropout and bits_out (nullable) the kernel also
// writes the mask it drew, for K3-wg, which then draws nothing:
// keep_bits uint32 [B, H, Sq, W], W = 4 * ceil(Sk / 128), so a row is a
// whole number of 16-byte pieces; bit j % 32 of word j / 32 of row
// (b, h, i) is the keep decision of element ((b * H + h) * Sq + i) * Sk +
// j (kernels/attention.py::keep_bits_plain), masked keys and fully masked
// rows included; bits past Sk are 0. Each row's 16-byte piece of two key
// tiles is one store from the lane that holds the row (a warp's 16 rows
// lie W * 4 bytes apart). Measured at 8540^2, B=8 (PERF.md §6): the
// stores cost 0.06 ms (8.91 ms against 8.85 without bits_out); a TMA
// store of each consumer warpgroup's 64 rows through a shared-memory tile
// cost 1.2 ms, for the warpgroup barrier it needs every two tiles.
//
// What bounds it. At the four-level encoder (B=8, H=8, 8540^2, D=32) the
// three products are 0.91 ms at 989 TFLOP/s and the bytes 0.04 ms, with
// dropout 0.22 ms with the keep bits (586 MB); per score it takes one
// exponential on the special-function unit (1.11 ms at 16 a clock per SM
// and 1.98 GHz), a few FP32 instructions for ds and, with dropout, a
// quarter of a Philox call (1.17e9 calls: 1.32 ms of multiplies at 64 a
// clock per SM, chip_smoke.py's bound). Measured on an H100 (PERF.md §6)
// the draw is what bounds it with dropout, at about a quarter of that
// rate (IMAD.WIDE's issue rate, 19 a call, the likely limit).
//
// Where the draw runs, by measurement (time_keep_ab.py, this kernel and
// the alternative in turns on one H100; device ms with dropout 0.1,
// 8540^2 B=8 / 2090^2 B=16 / 440^2 B=16 / 440^2 B=8):
// - in the consumer warpgroups while S and dP run, then gathered into
//   each row's words by three shuffles in the quad (this design): 8.91 /
//   1.322 / 0.0700 / 0.0375;
// - in the producer warpgroups, off the consumers' path, into a ring of
//   bit tiles beside the K/V stages (two drawing warpgroups, 512 threads,
//   producers at setmaxnreg 64, consumers 192, 4 Philox chains a thread):
//   9.27 / 1.297 / 0.0682 / 0.0359; one drawing warpgroup spilled at
//   setmaxnreg 40 and ran slower still. The producers' draw is the
//   consumers' critical path once it is slower than they are, since each
//   stage waits for its bits; in the consumers it fills the issue slots
//   their waits on the products leave. Where the time goes (8540^2, six
//   calls a four-level step) the consumers' draw is the faster, and it
//   shares flash_tc::keep_bits, bit for bit, with K1 and K2-TC.
// Without dropout both read 3.08 ms at 8540^2.
//
// Design (K1-wg's, flash_attn_fwd_wg.cu, with flash_wg.cuh's pieces).
// - One block per (batch * head, 128 queries): a producer warpgroup
//   (setmaxnreg 40) and two consumer warpgroups of 64 query rows
//   (setmaxnreg 232; the consumer's state is 112 registers of
//   accumulators and fragments, and the draw's Philox calls take the
//   rest), 384 threads, one block an SM.
// - The producer warp loads Q and dO once by TMA (they stay resident) and
//   keeps a ring of kStages K and V tiles of 64 keys in flight through the
//   rank-4 tensor maps over [B, S, H, D] (zeros past Sk), one mbarrier a
//   stage; the consumers give a stage back on an "empty" mbarrier. Its 32
//   lanes ballot the tile's live keys (valid and in range; in a fully
//   masked row every key in range), read a tile ahead, into 64 bits beside
//   the stage.
// - The kernel has an instance without dropout and two with (the draw's
//   path for Sk % 4 == 0 and the general one): a branch on the rate inside
//   the element loop cost about a tenth of the time without dropout.
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
//   (as K1-wg takes V for P V). While dq_part runs, three shuffles in each
//   quad turn the tile's decisions into its rows' words of keep bits, and
//   every two tiles two more and one 16-byte store a row write them out.
// - dq_part goes into a fresh accumulator and is folded into dq with a
//   rounded add once its product is done (mma.sync's truncating
//   accumulation leaned the 3xTF32 kernels' long sums one way; PERF.md),
//   so no accumulator runs through the tensor cores over the sweep. The
//   fold of tile t waits at the top of tile t + 1, after S and dP of t + 1
//   are issued: dq_part_t, S_{t+1} and dP_{t+1} run while the decisions of
//   t + 1 are drawn, and the two consumer warpgroups' arithmetic
//   interleaves with each other's products.
// - No atomics and no fusion into K3: dq and the keep bits are
//   deterministic, as the TPU kernel's dq is.
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
// inlining, so the state stays in registers. kDrop: with dropout (one
// instance each: a branch on the rate inside the element loop cost the
// kernel about a tenth of its time without dropout); kAligned (Sk % 4 ==
// 0) picks the draw's path (flash_tc::keep_bits).
template <bool kDrop, bool kAligned>
struct Consumer {
  using L = Layout;
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  const uint32_t* live_bits;
  // this lane's keep-bits row (that of rows[q / 2] for quad lane q), or
  // null: no bits out, or past Sq, or an odd lane of the quad
  uint4* bits_row;
  int c, lane, Sk, n_kt;
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
  uint32_t keep;  // the tile's keep decisions: bit n * 4 + e of sc[4n + e]
  uint32_t held;  // this lane's word of the keep bits of the last even tile

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

  // tile t's dropout decisions (they need no data: drawn while S and dP
  // run)
  __device__ __forceinline__ void keep_of(int t) {
    if constexpr (kDrop)
      keep = flash_tc::keep_bits<kTileK / 8, kAligned>(n_row, t * kTileK, c,
                                                       dr);
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
        if constexpr (kDrop) dpk = (keep >> i) & 1u ? dpk * dr.inv_keep : 0.f;
        sc[i] = p * (dpk - di[e >> 1]);
      }
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt) flash_wg::pack_a(pa[kt], sc, kt);
  }

  // tile t's keep bits out to bits_out: the quad's decisions of its two
  // rows gathered into words (lane q of a quad holds word q % 2 of row
  // q / 2: key 32 (q % 2) + i at bit i, none from Sk on), and after an
  // odd tile or the last one lanes 0 and 2 of the quad store their row's
  // 16-byte piece of the two tiles (words 2 (t % 2) .. + 1 the tile's)
  __device__ __forceinline__ void store_bits(int t) {
    if constexpr (kDrop) {
      // this lane's part of word w of row r: keys 32w + 8m + c + e at bit
      // 8m + c + e, from bit (4w + m) * 4 + 2r + e of keep (the pairs of
      // the row at every fourth bit, spread to every eighth)
      uint32_t mine[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t x = (keep >> (2 * r)) & 0x33333333u;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          uint32_t y = (x >> (16 * w)) & 0x3333u;  // pair m at bit 4m
          y = (y & 0x33u) | ((y & 0x3300u) << 8);   // 2, 3 at 16, 20
          y = (y & 0x30003u) | ((y & 0x300030u) << 4);  // 1, 3 at 8, 24
          mine[r][w] = y << c;
        }
      }
      // the quad's parts are disjoint: lanes q and q ^ 2 swap the row the
      // other keeps (q / 2), then q and q ^ 1 the word (q % 2)
      const int q = lane & 3;
      const bool hi_row = q & 2, hi_word = q & 1;
      uint32_t row[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t give = hi_row ? mine[0][w] : mine[1][w];
        row[w] = (hi_row ? mine[1][w] : mine[0][w]) |
                 __shfl_xor_sync(0xffffffffu, give, 2);
      }
      uint32_t word = (hi_word ? row[1] : row[0]) |
                      __shfl_xor_sync(0xffffffffu, hi_word ? row[0] : row[1],
                                      1);
      const int n = Sk - t * kTileK - 32 * (q & 1);  // its keys in range
      if (n < 32) word &= n <= 0 ? 0u : (1u << n) - 1u;
      const bool last = t == n_kt - 1;
      if (t & 1) {
        // the row's word 1 of both tiles from lane q + 1
        const uint32_t prev1 = __shfl_xor_sync(0xffffffffu, held, 1);
        const uint32_t cur1 = __shfl_xor_sync(0xffffffffu, word, 1);
        if (bits_row != nullptr)
          bits_row[t >> 1] = make_uint4(held, prev1, word, cur1);
      } else if (last) {
        const uint32_t cur1 = __shfl_xor_sync(0xffffffffu, word, 1);
        if (bits_row != nullptr)
          bits_row[t >> 1] = make_uint4(word, cur1, 0u, 0u);
      }
      held = word;
    }
  }
};

template <bool kDrop, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const uint8_t* __restrict__ valid,
                       const bf16* __restrict__ o,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       float* __restrict__ di_out,
                       uint32_t* __restrict__ bits_out, int H, int Sq,
                       int Sk, float scale, Dropout dr) {
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
    // the lanes' live keys of tile t (keys 32 w + lane): in range, and
    // valid or in a fully masked row (whose logits are all 0), read a tile
    // ahead so the loads run under the wait for a free stage
    auto live_of = [&](int t, int w) {
      const int j = t * kTileK + w * 32 + lane;
      return j < Sk && (masked_row || valid == nullptr ||
                        valid[(long)b * Sk + j] != 0);
    };
    bool live[2] = {live_of(0, 0), live_of(0, 1)};
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      if (t >= kStages)  // the consumers gave back tile t - kStages
        flash_wg::bar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      // the tile's live keys as 2 words of bits, one ballot of 32
      // neighbouring keys each
      uint32_t words[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        words[w] = __ballot_sync(0xffffffffu, live[w]);
        live[w] = t + 1 < n_kt && live_of(t + 1, w);
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
  Consumer<kDrop, kAligned> w;
  w.smem = smem;
  w.full = full;
  w.empty = empty;
  w.live_bits = live_bits;
  w.c = (lane % 4) * 2;  // this lane's first column in a chunk
  w.lane = lane;
  w.Sk = Sk;
  w.n_kt = n_kt;
  // a fully masked row's logits are 0: the scores get scale 0
  w.scale_log2 = masked_row ? 0.f : scale * kLog2e;
  w.desc_q = flash_wg::make_desc(smem + L::kQ + wg * 64 * D * 2);
  w.desc_do = flash_wg::make_desc(smem + L::kDo + wg * 64 * D * 2);
  w.dr = dr;
  w.keep = w.held = 0u;
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
  {
    const int mine = rows[(lane & 2) >> 1];
    w.bits_row = bits_out != nullptr && (lane & 1) == 0 && mine < Sq
                     ? reinterpret_cast<uint4*>(
                           bits_out + ((long)bh * Sq + mine) * 4 *
                                          ((Sk + 127) / 128))
                     : nullptr;
  }

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
  // and dP go out while dq_part of t - 1 may still run and tile t's
  // decisions are drawn; its keep bits go out while dq_part of t runs
  for (int t = 0; t < n_kt; ++t) {
    w.issue_sdp(t);
    w.keep_of(t);
    w.settle(t);
    w.ds(t);
    w.issue_dq(t);
    w.store_bits(t);
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
                   const float* lse, void* dq, float* di_out,
                   uint32_t* bits_out, int B, int H, int Sq, int Sk,
                   float scale, Dropout dr, cudaStream_t stream) {
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
  // the instance without dropout, or the one whose draw takes Sk % 4 ==
  // 0's path or the general one (flash_tc::keep_bits)
  auto kernel = dr.threshold == 0u ? flash_bwd_dq_wg_kernel<false, true>
                : (Sk & 3) == 0    ? flash_bwd_dq_wg_kernel<true, true>
                                   : flash_bwd_dq_wg_kernel<true, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, B * H), kThreads, bytes, stream>>>(
      map_q, map_k, map_v, map_do, valid, static_cast<const bf16*>(o), lse,
      static_cast<bf16*>(dq), di_out, bits_out, H, Sq, Sk, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; q, k, v, O, dO, dq 16-byte aligned; head_dim = 32; di_out
// nullable; bits_out nullable, 16-byte aligned, [B, H, Sq, 4 * ceil(Sk /
// 128)] uint32, and only with dropout; scale = 1 / sqrt(the caller's head
// dim). Dropout as in the forward kernels, with the forward's seed.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd_dq_wg(const void* q, const void* k,
                                    const void* v, const uint8_t* valid,
                                    const void* o, const void* dout,
                                    const float* lse, void* dq,
                                    float* di_out, uint32_t* bits_out, int B,
                                    int H, int Sq, int Sk, int head_dim,
                                    float scale, uint64_t seed,
                                    uint32_t threshold, float inv_keep,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24) ||
      lse == nullptr || (bits_out != nullptr && threshold == 0u) ||
      reinterpret_cast<uintptr_t>(bits_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, valid, o, dout, lse, dq, di_out, bits_out, B,
                     H, Sq, Sk, scale, dr, s);
}
