// Flash-attention forward on Hopper's warpgroup tensor-core products, bf16
// (sm_90a), plain C interface for ctypes: K1-wg.
//
// Replaces, for bf16 inputs at the shapes where the dispatch rule
// (kernels/attention.py::fwd_variant) sends them here, the TPU kernel
// `_flash_kernel` of reftr_tpu/kernels/attention.py (:86-132, driven by
// `_fwd`, pallas_call at :210). The same function and contract as
// flash_attn_fwd_tc.cu (K1-TC): out = softmax(q k^T * scale + bias) v per
// (batch, head), attention dropout after the denominator, the row
// logsumexp (natural log, as K2 reads it) on request; layout q [B, Sq, H,
// D], k/v [B, Sk, H, D], out [B, Sq, H, D] bf16 and contiguous; valid
// [B, Sk] bool (nullable); lse [B, H, Sq] f32 (nullable); D = 32.
// The dropout mask is flash_common.cuh's Philox mask, bit for bit
// philox_keep_plain's; a batch row whose keys are all masked is the
// uniform average (every logit 0, as the plain version's -1e9 + 1e9).
//
// What bounds it. At the four-level encoder (B=8, H=8, 8540^2, D=32) the
// bytes are 0.04 ms and the two products 0.60 ms at 989 TFLOP/s; what binds
// is the work on each of the 4.67e9 scores: one exponential on the
// special-function unit at 16 a clock per SM (1.1 ms at 1.98 GHz), and the
// FP32 instructions around it; with dropout, Philox's integer work (a
// quarter of a Philox4x32-10 call per score). K1-TC spends about 15 FP32
// instructions per score (three rounded ops for the logit, expf's range
// reduction, the max, the sum, the pack) in one warpgroup that runs its
// products, its softmax and its products again in turn.
//
// Design.
// - One block per (batch * head, 128 queries): a producer warpgroup and
//   two consumer warpgroups of 64 query rows (384 threads, one block an
//   SM). The producer gives back registers (setmaxnreg 40) and the
//   consumers take them (232): registers are allocated per warpgroup, and
//   at ptxas' even share (168) the pipeline below spilled.
// - One producer warp loads Q once and keeps a ring of kStages K and V
//   tiles of 128 keys in flight by TMA through rank-4 tensor maps over
//   [B, S, H, D] (a tile past Sk, or Q past Sq, is zero-filled by the
//   hardware and never reads the next batch row), K and V each on their
//   own mbarrier; the consumers give a stage back on an "empty" mbarrier.
//   Its 32 lanes also ballot the tile's live keys (valid and in range)
//   into 128 bits beside the stage.
// - S = Q K^T: wgmma m64n64k16, twice a k-step (128 keys), Q and K from
//   shared memory in the swizzle the tensor map writes.
// - Softmax on the raw scores: the running max is taken on s (scale > 0),
//   and p = 2^(s * scale * log2 e - m * scale * log2 e) is one FFMA and
//   one MUFU.EX2 (ex2.approx). The key bias is applied only in a tile
//   whose bits show a dead key, as -inf before the max (the plain
//   version's p there, exp(-1e9 - m), is 0 too), or in a fully masked
//   batch row as 0 for every in-range key. The dropout decisions come from
//   flash_tc::keep_bits (the accumulator's per-warp layout is mma.sync's),
//   drawn while the products run.
// - O: each tile's P V (P from registers, the RS form; V an MN-major B
//   operand) goes into a fresh accumulator and is folded in with one
//   rounded FFMA, o = o * corr + part: no accumulator is carried through
//   the tensor cores over the sweep (mma.sync's truncating accumulation
//   leaned the 3xTF32 kernels' sums one way; PERF.md), at the count of
//   K1-TC's o *= corr.
// - Overlap, as FlashAttention-3 does within a warpgroup: S_{t+1} and
//   P_t V_t are issued together, and the softmax of tile t + 1 runs while
//   P_t V_t is in flight; P alternates between two fragment sets. Across
//   the two consumer warpgroups the SM's schedulers interleave one's
//   softmax with the other's products.

// Bound: PERF.md §6 holds the measured times beside chip_smoke.py's bound
// (bytes, tensor FLOPs and one MUFU.EX2 a score at 16 a clock per SM).

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

constexpr int kConsumers = 2;               // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;      // query rows per block
constexpr int kTileK = 128;                 // keys per tile
constexpr int kStages = 4;                  // K/V tiles in flight
// + the producer warpgroup: one warp issues the loads, and the warpgroup
// hands its registers to the consumers (register allocation is per
// warpgroup, so a lone producer warp would hold a warpgroup's share)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int D = flash_wg::kHeadDim;

struct Layout {
  static constexpr int kTile = kTileK * D * 2;  // bytes of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kRows * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  // per stage, the tile's 128 live-key bits (4 words, key 32w + i at bit i
  // of word w)
  static constexpr int kLive = kV + kStages * kTile;
  static constexpr int kBars = kLive + kStages * 16;
  // full_q, then full_k, full_v and empty per stage
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// 1 where key j of batch row b takes part: in range and valid
__device__ __forceinline__ bool key_live(const uint8_t* valid, int b, int Sk,
                                         int j) {
  return j < Sk && (valid == nullptr || valid[(long)b * Sk + j] != 0);
}

// A consumer warpgroup's state over the key sweep and its steps. Every
// member function is inlined and every array index is a constant after
// inlining, so the state stays in registers. kAligned (Sk % 4 == 0) picks
// the dropout draw's path (flash_tc::keep_bits).
template <bool kAligned>
struct Consumer {
  using L = Layout;
  unsigned char* smem;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty;
  const uint32_t* live_bits;
  int Sk, c, lane;
  bool masked_row;
  float scale_log2;
  uint64_t desc_q;
  uint64_t n_row[2];  // dropout offset of (b, h, row, key 0)
  Dropout dr;
  float o[D / 2];
  float m[2];  // running max of the raw scores
  float l[2];  // this lane's share of the sum
  float sc[kTileK / 2];  // S: chunk n (8 keys) at sc[4n..4n+3]
  float part[D / 2];
  float corr[2][2];
  uint32_t pa[2][kTileK / 16][4];  // P as A fragments, two sets
  uint32_t keep[2];

  // S = Q K_t^T into sc (asynchronous)
  __device__ __forceinline__ void issue_s(int t) {
    const int st = t % kStages;
    const uint64_t desc_k =
        flash_wg::make_desc(smem + L::kK + st * L::kTile);
    flash_wg::bar_wait(full_k + st, (t / kStages) & 1);
    flash_wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        flash_wg::mma_ss_n64(
            *reinterpret_cast<float(*)[32]>(sc + half * 32),
            flash_wg::desc_add(desc_q, kk * 32),
            flash_wg::desc_add(desc_k, half * 64 * D * 2 + kk * 32), kk > 0);
    }
    flash_wg::wg_commit();
  }

  // part = P_t V_t from fragment set P, the tile's 8 k-steps of 16 keys
  // (asynchronous)
  template <int P>
  __device__ __forceinline__ void issue_pv(int t) {
    const int st = t % kStages;
    const uint64_t desc_v =
        flash_wg::make_desc(smem + L::kV + st * L::kTile);
    flash_wg::bar_wait(full_v + st, (t / kStages) & 1);
    flash_wg::wg_fence();
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt)
      flash_wg::mma_rs_n32(part, pa[P][kt],
                           flash_wg::desc_add(desc_v, kt * 16 * D * 2),
                           kt > 0);
    flash_wg::wg_commit();
  }

  // tile t's dropout decisions: bit (n % 8) * 4 + e of keep[n / 8] for
  // element e of chunk n (they need no data)
  __device__ __forceinline__ void keep_of(int t) {
    keep[0] = keep[1] = 0u;
    if (dr.threshold != 0u) {
      keep[0] = flash_tc::keep_bits<8, kAligned>(n_row, t * kTileK, c, dr);
      keep[1] =
          flash_tc::keep_bits<8, kAligned>(n_row, t * kTileK + 64, c, dr);
    }
  }

  // the softmax of tile t's scores sc: the running max, the sum, the
  // rescale corr[P] of what came before, and P (p * keep) as fragment set P
  template <int P>
  __device__ __forceinline__ void softmax(int t) {
    const int k0 = t * kTileK;
    const uint4 live =
        *reinterpret_cast<const uint4*>(live_bits + (t % kStages) * 4);
    if (masked_row || (live.x & live.y & live.z & live.w) != ~0u) {
      // a tile with a masked or out-of-range key: the language tokens,
      // an image's padding, the last tile; or a fully masked row
      const uint32_t words[4] = {live.x, live.y, live.z, live.w};
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 8 + c + (e & 1);  // the key in the tile
          sc[n * 4 + e] = masked_row ? (k0 + i < Sk ? 0.f : -INFINITY)
                          : (words[n / 4] >> (i % 32)) & 1u ? sc[n * 4 + e]
                                                           : -INFINITY;
        }
    }
    float m_sl2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[n * 4 + 2 * r], sc[n * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row without a live key so far keeps m = -inf; its p are 0
      m_sl2[r] = mx == -INFINITY ? 0.f : mx * scale_log2;
      corr[P][r] = flash_wg::exp2_approx(m[r] * scale_log2 - m_sl2[r]);
      m[r] = mx;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = flash_wg::exp2_approx(
            fmaf(sc[n * 4 + e], scale_log2, -m_sl2[e >> 1]));
        sum[e >> 1] += p;
        sc[n * 4 + e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[P][r], sum[r]);
    if (dr.threshold != 0u) {  // the numerator takes p * keep
      // (a dropped p is 0; 1 / (1 - rate) scales o once at the end)
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n * 4 + e] = (keep[n / 8] >> ((n % 8) * 4 + e)) & 1u
                              ? sc[n * 4 + e]
                              : 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt)
      flash_wg::pack_a(pa[P][kt], sc, kt);
  }

  // o = o * corr + part once P_t V_t is done, and K_t, V_t given back
  template <int P>
  __device__ __forceinline__ void fold(int t) {
    flash_wg::wg_wait<0>();
    flash_wg::fence_operands(part);
    flash_wg::fence_operands(pa[P]);
    if (lane == 0) flash_wg::bar_arrive(empty + t % kStages);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[i] = fmaf(o[i], corr[P][(i >> 1) & 1], part[i]);
  }

  // tile t, whose softmax has run into fragment set P, and a tile t + 1
  // after it: while S_{t+1} and P_t V_t run, the softmax of tile t + 1
  // fills set P ^ 1. No branch around the products: a value of sc merged
  // from two paths would make the compiler copy the accumulator while
  // the product that writes it runs.
  template <int P>
  __device__ __forceinline__ void step(int t) {
    issue_s(t + 1);
    issue_pv<P>(t);
    keep_of(t + 1);
    flash_wg::wg_wait<1>();  // S_{t+1}; P_t V_t may still run
    flash_wg::fence_operands(sc);
    softmax<P ^ 1>(t + 1);
    fold<P>(t);
  }

  // the last tile t, whose softmax has run into fragment set P
  template <int P>
  __device__ __forceinline__ void last(int t) {
    issue_pv<P>(t);
    fold<P>(t);
  }
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Sk,
                    float scale, Dropout dr) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(smem + L::kLive);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int n_kt = (Sk + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    flash_wg::bar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      flash_wg::bar_init(full_k + s, 1);
      flash_wg::bar_init(full_v + s, 1);
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
      flash_wg::prefetch_map(&map_k);
      flash_wg::prefetch_map(&map_v);
      flash_wg::bar_arrive_tx(full_q, kRows * D * 2);
      flash_wg::tma_load_4d(smem + L::kQ, &map_q, full_q, 0, h, q0, b);
    }
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      if (t >= kStages)  // the consumers gave back tile t - kStages
        flash_wg::bar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      // the tile's live keys (valid and in range) as 4 words of bits,
      // one ballot of 32 neighbouring keys each, for the consumers
      uint32_t words[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        words[w] = __ballot_sync(
            0xffffffffu, key_live(valid, b, Sk, t * kTileK + w * 32 + lane));
      if (lane == 0) {
        *reinterpret_cast<uint4*>(live_bits + s * 4) =
            make_uint4(words[0], words[1], words[2], words[3]);
        flash_wg::bar_arrive_tx(full_k + s, L::kTile);
        flash_wg::tma_load_4d(smem + L::kK + s * L::kTile, &map_k, full_k + s,
                              0, h, t * kTileK, b);
        flash_wg::bar_arrive_tx(full_v + s, L::kTile);
        flash_wg::tma_load_4d(smem + L::kV + s * L::kTile, &map_v, full_v + s,
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
  w.full_k = full_k;
  w.full_v = full_v;
  w.empty = empty;
  w.live_bits = live_bits;
  w.Sk = Sk;
  w.c = (lane % 4) * 2;  // this lane's first column in a chunk
  w.lane = lane;
  w.masked_row = masked_row;
  w.scale_log2 = scale * kLog2e;
  w.desc_q = flash_wg::make_desc(smem + L::kQ + wg * 64 * D * 2);
  w.dr = dr;
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = q0 + wg * 64 + (warp % 4) * 16 + lane / 4 + r * 8;
    w.n_row[r] = ((uint64_t)bh * Sq + rows[r]) * Sk;
    w.m[r] = -INFINITY;
    w.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.o[i] = 0.f;

  flash_wg::bar_wait(full_q, 0);
  w.issue_s(0);
  w.keep_of(0);
  flash_wg::wg_wait<0>();
  flash_wg::fence_operands(w.sc);
  w.template softmax<0>(0);
  // two tiles a turn, so the fragment set of each step is a constant
  int t = 0;
  for (; t + 2 < n_kt; t += 2) {
    w.template step<0>(t);
    w.template step<1>(t + 1);
  }
  if (t + 1 < n_kt) {
    w.template step<0>(t);
    w.template last<1>(t + 1);
  } else {
    w.template last<0>(t);
  }
  float* o = w.o;
  float* m = w.m;
  float* l = w.l;
  const int c = w.c;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= Sq) continue;
    // the dropout's 1 / (1 - rate) on every kept p, once
    const float inv_l = (dr.threshold != 0u ? dr.inv_keep : 1.f) / l[r];
    bf16* op = out + ((long)b * Sq + rows[r]) * H * D + h * D + c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          o[n * 4 + 2 * r] * inv_l, o[n * 4 + 2 * r + 1] * inv_l);
    if (lse != nullptr && lane % 4 == 0)
      lse[(long)bh * Sq + rows[r]] = m[r] * scale + logf(l[r]);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, void* out, float* lse, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  if ((long)B * H > 65535) return cudaErrorInvalidConfiguration;
  const cudaError_t bound = flash_wg::bind_device(q);
  if (bound != cudaSuccess) return bound;
  CUtensorMap map_q, map_k, map_v;
  if (!flash_wg::make_map(&map_q, q, B, Sq, H, kRows) ||
      !flash_wg::make_map(&map_k, k, B, Sk, H, kTileK) ||
      !flash_wg::make_map(&map_v, v, B, Sk, H, kTileK))
    return cudaErrorInvalidValue;
  constexpr int bytes = Layout::kAlloc;
  // the instance whose dropout draw takes Sk % 4 == 0's path or the
  // general one (flash_tc::keep_bits)
  auto kernel = (Sk & 3) == 0 ? flash_fwd_wg_kernel<true>
                              : flash_fwd_wg_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_qt, B * H), kThreads, bytes, stream>>>(
      map_q, map_k, map_v, valid, static_cast<bf16*>(out), lse, H, Sq, Sk,
      scale, dr);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; q, k, v, out 16-byte aligned; head_dim = 32; scale = 1 /
// sqrt(the caller's head dim). Dropout as in flash_attn_fwd:
// threshold = ceil(rate * 2^24) (0 = none), inv_keep = 1 / (1 - rate).
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd_wg(const void* q, const void* k, const void* v,
                                 const uint8_t* valid, void* out, float* lse,
                                 int B, int H, int Sq, int Sk, int head_dim,
                                 float scale, uint64_t seed,
                                 uint32_t threshold, float inv_keep,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr, s);
}
