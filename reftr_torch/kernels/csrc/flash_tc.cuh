// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attn_fwd_tc.cu, flash_attn_bwd_dq_tc.cu, flash_attn_bwd_dkv_tc.cu,
// which also serve float32 callers in the mxu_bf16 mode): asynchronous
// tile copies, float32 tiles rounded to bf16 on the way in, ldmatrix, the
// warp-level bf16 product mma.sync m16n8k16 with f32 accumulation (sm_80 and later, so sm_90a too), and the
// dropout decisions of a tile in the accumulator layout with queries as M
// (keep_bits) or keys as M (chunk_keep). The float32 kernels' 3xTF32
// pieces (flash_tf32.cuh) use the copies and the dropout decisions: the
// accumulator of m16n8k8 has m16n8k16's layout.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane l of a warp, g = l / 4 and c = (l % 4) * 2:
//   A (16 x 16, row-major): a[0] = rows g, cols c..c+1; a[1] = rows g + 8,
//     cols c..c+1; a[2] = rows g, cols c+8..c+9; a[3] = rows g + 8,
//     cols c+8..c+9 (two bf16 per 32-bit register, the lower column low).
//   B (16 x 8, "col"): b[0] = k c..c+1 of column g; b[1] = k c+8..c+9.
//   C/D (16 x 8, f32): d[0..1] = row g, cols c..c+1; d[2..3] = row g + 8.
// So the accumulators of two neighbouring n-tiles of a product are, packed
// to bf16 pairs, the A fragment of one 16-deep k-step of the next product:
// the flash-attention trick that keeps P (and dS) in registers.
//
// Shared-memory tiles are row-major [row][D] bf16 with rows padded to
// D + 8 elements (D * 2 + 16 bytes: 48, 80, 144 for D = 16, 32, 64). The 8
// row addresses of one 8 x 8 ldmatrix matrix then start 12, 20 or 36 words
// apart, which puts the 8 rows' 16 bytes in 8 disjoint groups of 4 banks:
// no bank conflicts, with or without .trans. Every row start stays
// 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace flash_tc {

template <int D>
struct Tile {
  static constexpr int kStride = D + 8;  // padded row, in bf16 elements
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `bytes` = 0 fills zeros (the
// source address must still be a valid one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, asynchronous, for rows of per-query floats that
// need not be 16-byte aligned; `bytes` = 0 fills zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` (<= R) rows of D bf16 from global, one row every
// `row_stride` elements, into a padded shared tile of R rows; rows past
// `rows` are zero-filled. Every thread of the block calls it.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long row_stride, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = r < rows;
    cp_async16(tile + r * Tile<D>::kStride + c * 8,
               live ? src + r * row_stride + c * 8 : src, live ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b, bf16 inputs, f32 accumulators. Volatile, so the compiler keeps
// it where the source puts it: mma.sync is .aligned, and a copy moved into a
// branch where the warp's lanes diverge (as the dropout's Philox branches
// do) would give undefined results.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` (<= R) rows of D float32 into a padded bf16 tile of R rows,
// each element rounded to the nearest bf16 (ties to even) in registers on
// the way: the operand tiles of a float32 call whose products take bf16
// operands (mxu_bf16, reftr_tpu/kernels/attention.py::_mxu, which rounds
// the same way). Rows past `rows` are zero-filled. Plain loads and
// stores, not cp.async, so the copy is done when the call returns; the
// caller's barrier publishes it as it publishes the asynchronous copies.
// Every thread of the block calls it; rows 16-byte aligned.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const float* src, long row_stride,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const float4* p =
          reinterpret_cast<const float4*>(src + r * row_stride + c * 8);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      w = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                     pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(tile + r * Tile<D>::kStride + c * 8) = w;
  }
}

// Two neighbouring outputs of a lane (8-byte aligned), in the caller's
// dtype: rounded once to bf16, or stored as the float32 they are.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The A fragment of rows row0..row0+15, cols col0..col0+15 of a padded
// tile (ldmatrix.x4: lanes 0-15 give rows at col0, lanes 16-31 at col0+8).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int col0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, tile + (row0 + l % 16) * Tile<D>::kStride + col0 + (l / 16) * 8);
}

// B fragments of a product with the tile's rows as the n side (X^T as B:
// B[k][n] = tile[n][k]): n-tiles of rows row0..row0+7 and row0+8..row0+15,
// k = col0..col0+15. b[0], b[1] belong to the first n-tile, b[2], b[3] to
// the second.
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int row0, int col0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, tile + (row0 + (l / 16) * 8 + l % 8) * Tile<D>::kStride + col0 +
                 ((l / 8) % 2) * 8);
}

// B fragments of a product with the tile's rows as the k side (X as B:
// B[k][n] = tile[k][n]): k = row0..row0+15, n-tiles of cols col0..col0+7
// and col0+8..col0+15 (ldmatrix.trans). b[0], b[1] belong to the first
// n-tile, b[2], b[3] to the second.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int row0, int col0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (row0 + ((l / 8) % 2) * 8 + l % 8) *
                              Tile<D>::kStride +
                          col0 + (l / 16) * 8);
}

// The keep decisions of this lane's elements of one tile of NT * 8 keys in
// the layout of an accumulator with queries as M and keys as N (K1-TC's S,
// K2-TC's S and dP, K1-wg's per warp): bit n * 4 + e for
// element e of n-tile n, which is row n_row[e / 2] (the dropout offset of
// (b, h, query, key 0)) and key k0 + n * 8 + c + e % 2, c = (lane % 4) * 2.
// They depend on no data, so a kernel draws them at the top of the tile,
// where the integer work overlaps the copies and the products. One Philox
// call per 4 elements at any Sk:
// - Sk % 4 == 0: keys 4a..4a+3 of a row share one Philox counter, and
//   lanes l and l ^ 1 of a quad hold them as two pairs: each lane draws
//   the counters of every other n-tile and one shuffle of their decisions
//   hands its partner the partner's pairs (NT calls a lane).
// - Elsewhere a row's offset base_r = n_row[r] + k0 has a phase
//   ph_r = base_r % 4, and the quad's NT * 8 keys of the row span the
//   counters base_r / 4 + j, j = 0..2NT (the last only where ph_r > 0).
//   Lane q of the quad draws for row q / 2 the counters of parity q % 2,
//   j = 2i + q % 2 for i = 0..NT (NT + 1 calls on every lane), their four
//   decisions at nibble i of `own`. The element at position
//   P = ph_r + t of its row (t its key in the tile) takes word P % 4 of
//   counter P / 4, which lane 2r + (P / 4) % 2 of the quad holds at bit
//   4 (P / 8) + P % 4; with u = ph_r + c + e % 2, P = u + 8n, so one
//   shuffle from that lane and one shift by 4 (u / 8) + u % 4 give the
//   element's bits of all NT n-tiles at every fourth bit (4 shuffles).
// kAligned (Sk % 4 == 0) picks the path at compile time: a kernel is
// instantiated for both and its launcher picks one by Sk, so each instance
// holds one path (with both behind a branch on Sk, K1-wg ran 6 % slower
// with dropout at Sk % 4 == 0; PERF.md). No branch depends on the lane:
// every lane makes the same Philox calls and shuffles, and picks rows and
// words by select. mma.sync and ldmatrix are .aligned, and a per-lane
// branch near them (one Philox call or two, by counter) gave wrong masks
// on the card.
template <int NT, bool kAligned>
__device__ __forceinline__ uint32_t keep_bits(const uint64_t (&n_row)[2],
                                              int k0, int c,
                                              const flash::Dropout& dr) {
  uint32_t bits = 0u;
  // the seed through an empty asm: Philox's 20 round keys derive from it,
  // and without this the compiler kept them in registers over a kernel's
  // whole key loop, which made K2-TC spill (PERF.md)
  uint64_t seed = dr.seed;
  asm volatile("" : "+l"(seed));
  if constexpr (kAligned) {
    const int odd = threadIdx.x & 1;  // this lane holds words 2 and 3
    // this lane's counters, of n-tiles 2t + odd: their 4 decisions at bit
    // (t * 2 + r) * 4 + word of `own`; one shuffle gives the partner's
    uint32_t own = 0u;
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint64_t n = n_row[r] + k0 + (2 * t + odd) * 8 + (c & ~3);
        const uint4 w = flash::philox4(seed, n >> 2);
        own |= (flash::kept(w.x, dr) | flash::kept(w.y, dr) << 1 |
                flash::kept(w.z, dr) << 2 | flash::kept(w.w, dr) << 3)
               << ((t * 2 + r) * 4);
      }
    }
    const uint32_t partner = __shfl_xor_sync(0xffffffffu, own, 1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint32_t from = (n & 1) == odd ? own : partner;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bits |= ((from >> (((n / 2) * 2 + r) * 4 + 2 * odd)) & 3u)
                << (n * 4 + 2 * r);
    }
  } else {
    // the decisions of nibble i in a word of 4 (NT + 1) bits
    using Word = typename std::conditional<(4 * (NT + 1) > 32), uint64_t,
                                           uint32_t>::type;
    constexpr uint32_t kEvery4 =
        (uint32_t)(((uint64_t{1} << (4 * NT)) - 1) / 15);  // bits 0, 4, ..
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const uint64_t first = ((q & 2) ? n_row[1] : n_row[0]) + k0;
    Word own = 0;
#pragma unroll
    for (int i = 0; i <= NT; ++i) {
      const uint4 w = flash::philox4(seed, (first >> 2) + 2 * i + (q & 1));
      own |= (Word)(flash::kept(w.x, dr) | flash::kept(w.y, dr) << 1 |
                    flash::kept(w.z, dr) << 2 | flash::kept(w.w, dr) << 3)
             << (4 * i);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ph = (int)(((uint32_t)n_row[r] + (uint32_t)k0) & 3u);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = ph + c + e;  // 0..10
        const int src = (lane & ~3) | (2 * r) | ((u >> 2) & 1);
        Word got;
        if constexpr (sizeof(Word) == 8) {
          const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)own, src);
          const uint32_t hi =
              __shfl_sync(0xffffffffu, (uint32_t)(own >> 32), src);
          got = (uint64_t)hi << 32 | lo;
        } else {
          got = __shfl_sync(0xffffffffu, own, src);
        }
        bits |= ((uint32_t)(got >> (4 * (u >> 3) + (u & 3))) & kEvery4)
                << (2 * r + e);
      }
    }
  }
  return bits;
}

// The keep decisions of this lane's 8 elements of a 16-query chunk in the
// layout of an accumulator with keys as M and queries as N (K3-TC's and
// K3-f32tc's S^T and dP^T): bit n * 4 + e for key keys[e / 2] and query
// row0 - bh * Sq + n * 8 + e % 2 (row0 = bh * Sq + the lane's first query
// of the chunk). Where Sk % 4 == 0, the four keys 4a..4a+3 of one query
// share one Philox counter, and they sit on four lanes (lane / 4 = 4a' + p,
// p = 0..3, same lane % 4): each of the four draws two of the group's eight
// counters, and four shuffles of the decisions hand every lane those of its
// key p: one Philox call per 4 elements. Elsewhere one call per element.
__device__ __forceinline__ uint32_t chunk_keep(const flash::Dropout& dr,
                                               uint64_t row0, int Sk,
                                               const int (&keys)[2]) {
  auto kept = [&](uint32_t word) { return flash::kept(word, dr); };
  // combo m = r * 4 + n * 2 + s: key row r, query row0 + n * 8 + s, bit
  // n * 4 + r * 2 + s
  auto element = [&](int m, int key) {
    return (row0 + ((m >> 1) & 1) * 8 + (m & 1)) * (uint64_t)Sk + key;
  };
  auto bit = [](int m) { return ((m >> 1) & 1) * 4 + (m >> 2) * 2 + (m & 1); };
  uint32_t bits = 0u;
  if ((Sk & 3) == 0) {
    const int lane = threadIdx.x % 32;
    const int p = (lane / 4) & 3;  // this lane's key within its four
    // the 4 decisions of each of this lane's counters (combos 2p, 2p + 1)
    // at bit s * 4 + word of `own`; lane q of the group holds combos 2q
    // and 2q + 1, and this lane takes word p of each
    uint32_t own = 0u;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int m = 2 * p + s;
      const int key4 = (keys[0] & ~3) + 8 * (m >> 2);  // no dynamic index
      const uint4 w = flash::philox4(dr.seed, element(m, key4) >> 2);
      own |= (kept(w.x) | kept(w.y) << 1 | kept(w.z) << 2 | kept(w.w) << 3)
             << (4 * s);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t got = __shfl_sync(0xffffffffu, own, lane + 4 * (q - p));
#pragma unroll
      for (int s = 0; s < 2; ++s)
        bits |= ((got >> (4 * s + p)) & 1u) << bit(2 * q + s);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      bits |= kept(flash::philox_word(dr.seed, element(m, keys[m >> 2])))
              << bit(m);
  }
  return bits;
}

}  // namespace flash_tc
