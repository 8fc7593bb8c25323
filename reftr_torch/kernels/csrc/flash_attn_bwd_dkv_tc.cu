// Flash-attention dk/dv backward on Hopper's tensor cores, bf16 (sm_90a),
// plain C interface for ctypes: K3-TC.
//
// Replaces, for bf16 inputs with at least 16 queries and any number of
// keys, and for float32 inputs in the mxu_bf16 mode (below), the TPU
// kernel `_bwd_dkv_kernel` of reftr_tpu/kernels/attention.py
// (:287-339, pallas_call at :434). The same function and contract as dk
// and dv of kernels/attention.py::attention_bwd_plain, in the transposed
// form the tensor cores take, with keys as the M side and queries as N:
//   S^T = K Q^T, P^T = exp(S^T * scale + bias + shift - lse),
//   dP^T = V dO^T, dS^T = P^T o (dP^T o keep - di), di = rowsum(dO o O),
//   dV = sum over queries of (P^T o keep) dO, dK = scale * dS^T Q,
// with keep the forward's dropout multiplier from the same Philox stream
// (flash_common.cuh) and the logit rounded as the forward rounds it. Layout
// q, O, dO [B, Sq, H, D]; k, v, dk, dv [B, Sk, H, D], bf16, contiguous and
// 16-byte aligned; valid [B, Sk] bool (nullable); lse [B, H, Sq] f32.
//
// Design. One block of one warpgroup (4 warps, 128 threads) per
// (batch * head, tile of 64 keys); each warp owns 16 keys, whose K and V A
// fragments it loads once by ldmatrix and keeps in registers, and whose dK
// and dV accumulate in f32 registers over the whole query sweep: no
// atomics, no second pass.
// - Staging: Q, dO and O come in 64-query tiles by cp.async,
//   double-buffered (tile t + 1 loads while tile t computes), rows padded
//   to D + 8 elements for conflict-free ldmatrix; lse of the tile comes
//   beside them (4-byte cp.async). Queries past Sq are zero-filled and
//   get p = 0, so their ds is 0 too. di = rowsum(dO o O) is computed per
//   tile from the staged O and dO (two threads a query), as the SIMT
//   kernel reads O.
// - Products: per chunk of 16 queries, S^T and dP^T are two 8-query
//   n-tiles each over D / 16 k-steps (B fragments of Q and dO by
//   ldmatrix); then P^T o keep and dS^T are rounded to bf16 in registers
//   and are directly the A fragments of dV += (P^T o keep) dO and
//   dK += dS^T Q, whose B fragments come from dO and Q by ldmatrix.trans.
//   mma.sync m16n8k16 bf16 -> f32 throughout (why not wgmma: see
//   flash_attn_fwd_tc.cu; the same sizes apply).
// - Redundancy: each (query, key) pair lives on exactly one lane, so its
//   exp, ds and Philox word are computed once. One Philox call gives the
//   words of 4 neighbouring keys of one query, which sit on 4 lanes: where
//   Sk % 4 == 0 the 4 lanes share each call through shuffles
//   (chunk_keep), one call per 4 elements.
// - Occupancy: at D <= 32 the kernel is held to 128 registers, so 4 blocks
//   fit an SM and the VL encoder's 448 blocks run in one wave on 132 SMs.
// - Fewer than 64 keys (down to one): a warp whose 16 keys all lie past
//   Sk skips its draw and its products and only helps stage the tiles and
//   di; below 16 keys one warp a block computes. It measured 3.1x / 4.0x
//   faster than the SIMT kernel that took fewer than 16 keys before (8
//   keys, bf16, without / with dropout; kernels/attention.py::
//   dkv_variant).
// - Precision: dS^T enters the dK product rounded to bf16 (relative
//   2^-9 per term), as P does in the forward; the tolerance, 1e-2 of the
//   largest plain gradient, holds with that (PERF.md).
// - mxu_bf16 (T = float): the TPU kernel's `_mxu` mode (:69-83) for
//   float32 callers. K, V, Q and dO are rounded to bf16 in registers as
//   they are staged (flash_attn_fwd_tc.cu says why there), P^T o keep and
//   dS^T as they already are; di = rowsum(dO o O) is summed from the
//   float32 dO and O in global memory (two threads a query), as the TPU
//   kernel sums it from its unrounded tiles (:323-325), so O is not
//   staged; dk and dv are stored as float32.
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W power limit (data sheet):
// at the VL encoder's shape (B=8, H=8, S=440, D=32) the four products are
// 3.17 GFLOP, 3.2 us at 989 TFLOP/s bf16, against q, k, v, O, dO, dk, dv
// in bf16 and lse, 12.7 MB, 3.8 us at 3.35 TB/s: bound by bytes. Measured
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
using flash_tc::Tile;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kKeys = 64;      // keys per block, 16 per warp
constexpr int kTileQ = 64;     // queries per staged tile

using flash::Dropout;

template <int D>
constexpr int smem_bytes() {
  // K, V, and two stages of Q, dO, O (bf16), then two stages of lse, di
  return (2 * kKeys + 6 * kTileQ) * Tile<D>::kStride * 2 + 4 * kTileQ * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ valid,
                        const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Sq, int Sk,
                        int n_kt, float scale, Dropout dr) {
  constexpr int kS = Tile<D>::kStride;
  constexpr int kTile = kTileQ * kS;  // elements of one staged tile
  constexpr int kK = D / 16;          // k-steps of S^T and dP^T
  constexpr int kN = D / 8;           // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kKeys * kS;
  bf16* qs = vs + kKeys * kS;  // [2][kTile]
  bf16* dos = qs + 2 * kTile;  // [2][kTile]
  bf16* os = dos + 2 * kTile;  // [2][kTile]
  float* ls = reinterpret_cast<float*>(os + 2 * kTile);  // [2][kTileQ]
  float* dis = ls + 2 * kTileQ;                           // [2][kTileQ]

  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kKeys;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = (lane % 4) * 2;  // this lane's first query in an n-tile
  const long row_stride = (long)H * D;
  const long head = h * D;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const T* qb = q + (long)b * Sq * row_stride + head;
  const T* ob = o + (long)b * Sq * row_stride + head;
  const T* dob = dout + (long)b * Sq * row_stride + head;
  const int n_qt = (Sq + kTileQ - 1) / kTileQ;

  auto stage = [&](int t) {
    const int buf = t & 1, q0 = t * kTileQ, nq = min(kTileQ, Sq - q0);
    const long off = q0 * row_stride;
    flash_tc::load_tile<D, kTileQ, kThreads>(qs + buf * kTile, qb + off,
                                             row_stride, nq);
    flash_tc::load_tile<D, kTileQ, kThreads>(dos + buf * kTile, dob + off,
                                             row_stride, nq);
    if constexpr (!kF32)
      flash_tc::load_tile<D, kTileQ, kThreads>(os + buf * kTile, ob + off,
                                               row_stride, nq);
    if (tid < kTileQ)
      flash_tc::cp_async4(ls + buf * kTileQ + tid,
                          lse + (long)bh * Sq + q0 + (tid < nq ? tid : 0),
                          tid < nq ? 4 : 0);
  };
  const long koff = ((long)b * Sk + k0) * row_stride + head;
  flash_tc::load_tile<D, kKeys, kThreads>(ks, k + koff, row_stride,
                                          min(kKeys, Sk - k0));
  flash_tc::load_tile<D, kKeys, kThreads>(vs, v + koff, row_stride,
                                          min(kKeys, Sk - k0));
  stage(0);
  flash_tc::cp_async_commit();
  // with the first tiles in flight
  const float shift = flash::masked_row_shift(valid, b, Sk);

  // this lane's two keys: warp * 16 + lane / 4 and 8 below it; a warp
  // whose 16 keys all lie past Sk (fewer than 64 keys, down to one) skips
  // its draw and its products, and only helps stage the tiles and di
  const bool live = k0 + warp * 16 < Sk;
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
  uint32_t ka[kK][4], va[kK][4];

  for (int t = 0; t < n_qt; ++t) {
    if (t + 1 < n_qt) stage(t + 1);
    flash_tc::cp_async_commit();  // (possibly empty) group of tile t + 1
    // the tile's keep decisions, bit cq * 8 + n * 4 + e: they need no data,
    // so the integer work overlaps the copies and the products
    uint32_t keep = 0u;
    if (dr.threshold != 0u && live) {
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
    const bf16* qt = qs + buf * kTile;
    const bf16* dot = dos + buf * kTile;
    if (t == 0 && live) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        flash_tc::load_a<D>(ka[kk], ks, warp * 16, kk * 16);
        flash_tc::load_a<D>(va[kk], vs, warp * 16, kk * 16);
      }
    }
    {  // di of the tile's queries, two threads a query: of the staged
       // tiles or, in float32, of dO and O in global memory
      const int row = tid / 2, half = tid % 2;
      float sum = 0.f;
      if constexpr (kF32) {
        const long off = (long)(q0 + row) * row_stride + half * (D / 2);
        if (q0 + row < Sq) {
#pragma unroll
          for (int d = 0; d < D / 2; ++d)
            sum = fmaf(dob[off + d], ob[off + d], sum);
        }
      } else {
        const bf16* drow = dot + row * kS + half * (D / 2);
        const bf16* orow = os + buf * kTile + row * kS + half * (D / 2);
#pragma unroll
        for (int d = 0; d < D / 2; ++d)
          sum = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]),
                     sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) dis[buf * kTileQ + row] = sum;
    }
    __syncthreads();
    const float* lst = ls + buf * kTileQ;
    const float* dit = dis + buf * kTileQ;

#pragma unroll
    for (int cq = 0; cq < kTileQ / 16; ++cq) {
      if (!live) break;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t bq[4], bd[4];
        flash_tc::load_b_rows<D>(bq, qt, cq * 16, kk * 16);
        flash_tc::mma_bf16(st[0], ka[kk], bq[0], bq[1]);
        flash_tc::mma_bf16(st[1], ka[kk], bq[2], bq[3]);
        flash_tc::load_b_rows<D>(bd, dot, cq * 16, kk * 16);
        flash_tc::mma_bf16(dpt[0], va[kk], bd[0], bd[1]);
        flash_tc::mma_bf16(dpt[1], va[kk], bd[2], bd[3]);
      }
      // P^T o keep into st, dS^T into dpt: element e of n-tile n is key
      // keys[e / 2] and query cq * 16 + n * 8 + c + e % 2 of the tile; a
      // query past Sq (zero-filled) gets p = 0
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = cq * 16 + n * 8 + c + (e & 1);
          const float p =
              q0 + qi < Sq
                  ? expf(flash::logit(st[n][e], scale, bias[e >> 1], shift) -
                         lst[qi])
                  : 0.f;
          float dp = dpt[n][e], pk = p;
          if (dr.threshold != 0u) {
            const float kp =
                (keep >> (cq * 8 + n * 4 + e)) & 1u ? dr.inv_keep : 0.f;
            pk = p * kp;
            dp *= kp;
          }
          st[n][e] = pk;
          dpt[n][e] = p * (dp - dit[qi]);
        }
      }
      const uint32_t pa[4] = {flash_tc::pack_bf16(st[0][0], st[0][1]),
                              flash_tc::pack_bf16(st[0][2], st[0][3]),
                              flash_tc::pack_bf16(st[1][0], st[1][1]),
                              flash_tc::pack_bf16(st[1][2], st[1][3])};
      const uint32_t da[4] = {flash_tc::pack_bf16(dpt[0][0], dpt[0][1]),
                              flash_tc::pack_bf16(dpt[0][2], dpt[0][3]),
                              flash_tc::pack_bf16(dpt[1][0], dpt[1][1]),
                              flash_tc::pack_bf16(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kN / 2; ++n2) {
        uint32_t bo[4], bq[4];
        flash_tc::load_b_cols<D>(bo, dot, cq * 16, n2 * 16);
        flash_tc::mma_bf16(dva[2 * n2], pa, bo[0], bo[1]);
        flash_tc::mma_bf16(dva[2 * n2 + 1], pa, bo[2], bo[3]);
        flash_tc::load_b_cols<D>(bq, qt, cq * 16, n2 * 16);
        flash_tc::mma_bf16(dka[2 * n2], da, bq[0], bq[1]);
        flash_tc::mma_bf16(dka[2 * n2 + 1], da, bq[2], bq[3]);
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
      flash_tc::store2(dk + off + n * 8, dka[n][2 * r] * scale,
                       dka[n][2 * r + 1] * scale);
      flash_tc::store2(dv + off + n * 8, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
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
        flash_bwd_dkv_tc_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dkv_tc_kernel<T, D>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), valid, static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, static_cast<T*>(dk),
          static_cast<T*>(dv), H, Sq, Sk, n_kt, scale, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const uint8_t* valid, const void* o, const void* dout,
                       const float* lse, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, float scale, Dropout dr,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq, Sk,
                           scale, dr, stream);
    case 32:
      return launch<T, 32>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq, Sk,
                           scale, dr, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq, Sk,
                           scale, dr, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, o, dout, lse, dk, dv, B, H, Sq,
                            Sk, scale, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float32 with bf16 products (mxu_bf16: q, k,
// v, dO rounded to bf16 as they are staged, di from the float32 O and dO,
// dk and dv float32); q, k, v, O, dO, dk, dv 16-byte aligned; D in {16,
// 32, 64, 128}; scale = 1 / sqrt(the caller's head dim), which is below D
// where the caller zero-pads the head dim up to D. Dropout as in
// flash_attn_fwd_tc, with the forward's seed. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attn_bwd_dkv_tc(const void* q, const void* k,
                                     const void* v, const uint8_t* valid,
                                     const void* o, const void* dout,
                                     const float* lse, void* dk, void* dv,
                                     int B, int H, int Sq, int Sk, int D,
                                     float scale, int dtype, uint64_t seed,
                                     uint32_t threshold, float inv_keep,
                                     void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || threshold > (1u << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{seed, threshold, inv_keep};
  if (dtype == 1)
    return (int)dispatch_d<bf16>(q, k, v, valid, o, dout, lse, dk, dv, B, H,
                                 Sq, Sk, D, scale, dr, s);
  if (dtype == 2)
    return (int)dispatch_d<float>(q, k, v, valid, o, dout, lse, dk, dv, B, H,
                                  Sq, Sk, D, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
