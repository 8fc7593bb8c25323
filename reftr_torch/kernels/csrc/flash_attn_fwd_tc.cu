// Flash-attention forward on Hopper's tensor cores, bf16 (sm_90a), plain C
// interface for ctypes: K1-TC.
//
// Replaces, for bf16 inputs with at least 16 queries, and for float32
// inputs in the mxu_bf16 mode (below), the TPU kernel
// `_flash_kernel` of reftr_tpu/kernels/attention.py (:86-132, driven by
// `_fwd`, pallas_call at :210). The same function and contract as
// kernels/attention.py::attention_plain: out = softmax(q k^T / sqrt(D) +
// bias) v per (batch, head) with an f32 running max, denominator and
// accumulator, attention dropout after the denominator, the row
// logsumexp on request; layout q
// [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D] bf16 and contiguous;
// valid [B, Sk] bool (nullable); lse [B, H, Sq] f32 (nullable); D in
// {16, 32, 64, 128}. The logit, the masked-row shift and the Philox
// dropout mask are flash_common.cuh's, so the mask is bit for bit the SIMT
// kernel's and philox_keep_plain's. Keys past Sk leave the sum; query rows
// past Sq are computed (on zeros) and not written.
//
// Design. One block of one warpgroup (4 warps, 128 threads) per
// (batch * head, tile of 64 queries); each warp owns 16 query rows.
// - Products: mma.sync m16n8k16 bf16 -> f32. Q's A fragments are loaded
//   once by ldmatrix and kept in registers; S = Q K^T takes D / 16 k-steps
//   per 8-key n-tile, with K's B fragments by ldmatrix from the staged tile.
//   P is rounded to bf16 in registers and is directly the A fragment of
//   P V (flash_tc.cuh), with V's B fragments from ldmatrix.trans.
//   Why mma.sync and not wgmma: a block does about 3.6 MFLOP at the VL
//   encoder's shape (64 x 440 x 32, two products), and the whole call's
//   bytes bound is 2.15 us on an H100, so latency and occupancy set the
//   time, not the peak rate. wgmma would need B (K, V) in its swizzled
//   shared-memory layout and A (P) in its 64-row register layout across the
//   warpgroup, for tiles of n = 64 keys and k = D = 32 where it issues a
//   handful of instructions per tile; mma.sync keeps the softmax per warp
//   and needs no warpgroup fences.
// - Staging: K and V tiles of 64 keys come in by cp.async (16 bytes a
//   thread; a key's D bf16 are D * 2 contiguous bytes at an H * D * 2 byte
//   stride), double-buffered: tile t + 1 loads while tile t computes.
//   Rows are padded to D + 8 elements, so ldmatrix has no bank conflicts;
//   keys past Sk are zero-filled and their bias is -inf.
// - Softmax: a row lives on a quad of lanes (shfl_xor 1 and 2); the running
//   max, the rescale of the accumulator and the denominator go once per
//   64-key tile. The denominator sums the un-dropped p in f32; the
//   numerator takes p * keep. One Philox call gives the words of 4
//   neighbouring keys of a row, and the lanes of a quad share each call
//   through shuffles (flash_tc::keep_bits): one call per 4 elements at any
//   Sk, the path for Sk % 4 == 0 or the general one instantiated apart and
//   picked by the launcher. The decisions need no data, so they are drawn
//   as a bit mask at the top of each tile, with no branch that depends on
//   the lane: mma.sync and ldmatrix are .aligned, and a per-lane branch
//   there (one Philox call or two, by counter) gave wrong masks on the
//   card.
// - Occupancy: at D <= 32 the kernel is held to 128 registers, so 4 blocks
//   fit an SM and the VL encoder's 448 blocks run in one wave on 132 SMs.
// - The key bias row (0 or -1e9) is read a tile ahead into a register and
//   stored beside the tile, so no warp waits on that global load; the
//   masked-row vote runs while the first tiles are in flight.
// - The tiles live in dynamic shared memory: 87 KB at D = 128, which a
//   block gets only by opting in above 48 KB.
// - mxu_bf16 (T = float): the TPU kernel's `_mxu` mode (:69-83) for
//   float32 callers, bf16 dot operands with f32 accumulation and softmax.
//   The kernel is this one with float32 q, k, v and out: each Q, K and V
//   element is rounded to bf16 (to nearest even, as JAX's astype) in
//   registers as its tile is staged (flash_tc::load_tile's float32
//   overload: plain loads in place of cp.async, so a tile's copy does not
//   overlap the products before it), P is rounded as it already is, and O
//   is stored as float32 without a bf16 round. Rounding in the kernel and
//   not in the wrapper keeps the call one launch that reads q, k and v
//   once, with no bf16 copies of them in global memory.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) the two products are
// 1.59 GFLOP, 1.6 us at 989 TFLOP/s bf16, against 7.2 MB of q/k/v/out in
// bf16, 2.15 us at 3.35 TB/s: bound by bytes. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Dropout;
using flash_tc::Tile;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kTileK = 64;     // keys per staged tile

template <int D>
constexpr int smem_bytes() {
  // Q, then two stages of K and V (bf16), then two of the key bias
  return (kRows + 4 * kTileK) * Tile<D>::kStride * 2 + 2 * kTileK * 4;
}

template <typename T, int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ valid, T* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Sk, int n_qt,
                    float scale, Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kK = D / 16;  // k-steps of S = Q K^T
  constexpr int kN = D / 8;   // n-tiles of O
  constexpr int kTile = kTileK * kS;  // elements of one staged key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * kS;  // [2][kTile]
  bf16* vs = ks + 2 * kTile;   // [2][kTile]
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile);  // [2][kTileK]

  const int bh = blockIdx.x / n_qt;  // b * H + h
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;  // this lane's first column in an n-tile
  const long row_stride = (long)H * D;
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
  // the bias of key tile t's key tid (threads below kTileK): read into a
  // register a tile ahead and stored at the end of the tile before, so no
  // warp waits on the global load
  auto key_bias = [&](int t) {
    const int j = t * kTileK + tid;
    return j >= Sk ? -INFINITY
           : (valid == nullptr || valid[(long)b * Sk + j]) ? 0.f
                                                           : flash::kMaskBias;
  };
  flash_tc::load_tile<D, kRows, kThreads>(
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
  uint32_t qa[kK][4];

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
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        flash_tc::load_a<D>(qa[kk], qs, warp * 16, kk * 16);
    }
    const int buf = t & 1;

    float s[kTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < kTileK / 16; ++n2) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t bk[4];
        flash_tc::load_b_rows<D>(bk, ks + buf * kTile, n2 * 16, kk * 16);
        flash_tc::mma_bf16(s[2 * n2], qa[kk], bk[0], bk[1]);
        flash_tc::mma_bf16(s[2 * n2 + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // logits, and the running max over this tile (finite: key k0 < Sk)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = flash::logit(
            s[n][e], scale, bs[buf * kTileK + n * 8 + c + (e & 1)], shift);
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

    // O += P V: P's accumulators are the A fragments, 16 keys a k-step
#pragma unroll
    for (int kt = 0; kt < kTileK / 16; ++kt) {
      const uint32_t pa[4] = {
          flash_tc::pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          flash_tc::pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          flash_tc::pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          flash_tc::pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kN / 2; ++n2) {
        uint32_t bv[4];
        flash_tc::load_b_cols<D>(bv, vs + buf * kTile, kt * 16, n2 * 16);
        flash_tc::mma_bf16(o[2 * n2], pa, bv[0], bv[1]);
        flash_tc::mma_bf16(o[2 * n2 + 1], pa, bv[2], bv[3]);
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
    T* op = out + ((long)b * Sq + rows[r]) * row_stride + h * D + c;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      flash_tc::store2(op + n * 8, o[n][2 * r] * inv_l,
                       o[n][2 * r + 1] * inv_l);
    if (lse != nullptr && lane % 4 == 0)
      lse[(long)bh * Sq + rows[r]] = m[r] + logf(l[r]);
  }
}

template <typename T, int D, bool kAligned>
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
        flash_fwd_tc_kernel<T, D, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_fwd_tc_kernel<T, D, kAligned>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), valid, static_cast<T*>(out), lse, H, Sq,
          Sk, n_qt, scale, dr);
  return cudaGetLastError();
}

// the instance of the kernel whose dropout draw takes Sk % 4 == 0's
// path or the general one (flash_tc::keep_bits)
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* valid, void* out, float* lse, int B, int H,
                   int Sq, int Sk, float scale, Dropout dr,
                   cudaStream_t stream) {
  if ((Sk & 3) == 0)
    return launch_as<T, D, true>(q, k, v, valid, out, lse, B, H, Sq, Sk,
                                 scale, dr, stream);
  return launch_as<T, D, false>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale,
                                dr, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, void* out, float* lse, int B,
                       int H, int Sq, int Sk, int D, float scale, Dropout dr,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, out, lse, B, H, Sq, Sk, scale, dr,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float32 with bf16 products (mxu_bf16: q, k, v
// rounded to bf16 as they are staged, out float32); q, k, v, out 16-byte
// aligned; scale = 1 / sqrt(the caller's head dim), which is below D where
// the caller zero-pads the head dim up to D. Dropout as in
// flash_attn_fwd_dec: threshold = ceil(rate * 2^24) (0 = none), inv_keep =
// 1 / (1 - rate). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                 const uint8_t* valid, void* out, float* lse,
                                 int B, int H, int Sq, int Sk, int D,
                                 float scale, int dtype, uint64_t seed,
                                 uint32_t threshold, float inv_keep,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (dtype == 1)
    return (int)dispatch_d<bf16>(q, k, v, valid, out, lse, B, H, Sq, Sk, D,
                                 scale, dr, s);
  if (dtype == 2)
    return (int)dispatch_d<float>(q, k, v, valid, out, lse, B, H, Sq, Sk, D,
                                  scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
