// 3xTF32 building blocks of the float32 tensor-core kernels
// (flash_attn_fwd_f32tc.cu, flash_attn_bwd_dq_f32tc.cu,
// flash_attn_bwd_dkv_f32tc.cu): padded f32
// tiles in shared memory, fragment loads for mma.sync m16n8k8 with tf32
// inputs and f32 accumulators (sm_80 and later, so sm_90a too), the split
// of each operand into a big and a small tf32 half, and the three products
// that give a float32-accurate result on the tensor cores.
//
// 3xTF32. tf32 keeps 10 mantissa bits. x = big + small with big = x
// truncated to tf32 (its low 13 bits cleared, one AND) and small = x - big,
// exact in f32 and below one tf32 ulp of x; the tensor core reads the top
// 19 bits of a .tf32 operand, so small enters truncated to tf32 too, and
// the pair keeps some 20 of float32's 23 bits. a b = big_a big_b + big_a
// small_b + small_a big_b + small_a small_b, where the last term, 2^-20 of
// the product, is dropped: three tf32 products per f32 product (CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's float32 memory-efficient attention
// runs on sm_80 and later). Rounding both halves with cvt.rna.tf32.f32
// instead keeps a bit more and cost the kernels 34-90 % more time on the
// H100 (PERF.md): the conversion is several instructions, issued for every
// fragment element. The card does 495 / 3 = 165 TFLOP/s of such products,
// against 67 TFLOP/s of float32 FMA outside the tensor cores.
//
// Fragment layouts of mma.m16n8k8 .tf32 (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), for lane l, g = l / 4 and t = l % 4:
//   A (16 x 8, row): a0 = (row g, col t), a1 = (g + 8, t), a2 = (g, t + 4),
//     a3 = (g + 8, t + 4).
//   B (8 x 8, col): b0 = (k t, n g), b1 = (k t + 4, n g).
//   C/D (16 x 8, f32): c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t),
//     c3 = (g + 8, 2t + 1): m16n8k16's accumulator layout.
// An accumulator holds columns 2t and 2t + 1 where the next product's A
// fragment wants columns t and t + 4. Taking logical k index t as column
// 2t and t + 4 as column 2t + 1 within each 8-column step makes the
// accumulator {c0, c2, c1, c3} that A fragment with no shuffle
// (acc_as_a), provided the B operand's rows are read at the same
// permutation (load_b_cols): the flash-attention trick that keeps P and dS
// in registers, in the m16n8k8 layout.
//
// Shared-memory tiles are row-major [row][D] f32 with rows padded to D + 4
// floats. D + 4 is 4 modulo 32 words for D = 32, 64, 128 (20 for D = 16),
// so the 32 lanes' 32-bit reads of every fragment below fall in 32 distinct
// banks; every row start stays 16-byte aligned for cp.async. ldmatrix moves
// 16-bit elements and has no use here: the fragments are plain 32-bit
// shared loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace flash_tf32 {

template <int D>
struct Tile {
  static constexpr int kStride = D + 4;  // padded row, in floats
};

// Stage `rows` (<= R) rows of D floats from global, one row every
// `row_stride` elements, into a padded shared tile of R rows; rows past
// `rows` are zero-filled. Every thread of the block calls it.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long row_stride, int rows) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = r < rows;
    flash_tc::cp_async16(tile + r * Tile<D>::kStride + c * 4,
                         live ? src + r * row_stride + c * 4 : src,
                         live ? 16 : 0);
  }
}

// The big and small tf32 halves of x (bit patterns for the mma's .tf32
// operands; the mma truncates small's to tf32).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));  // exact in f32
}

// An operand fragment split once, for the three products of mma3.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA make_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// d += a b, tf32 inputs, f32 accumulators. Volatile, so the compiler keeps
// it where the source puts it: mma.sync is .aligned (see flash_tc.cuh).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to float32 accuracy: the two cross terms, then big by big.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// The A fragment of rows row0..row0+15, cols col0..col0+7 of a padded
// tile.
template <int D>
__device__ __forceinline__ FragA load_a(const float* tile, int row0,
                                        int col0) {
  constexpr int kS = Tile<D>::kStride;
  const int l = threadIdx.x % 32;
  const float* p = tile + (row0 + l / 4) * kS + col0 + l % 4;
  return make_a(p[0], p[8 * kS], p[4], p[8 * kS + 4]);
}

// The B fragment of a product with the tile's rows as the n side (X^T as
// B: B[k][n] = tile[n][k]): n = rows row0..row0+7, k = cols col0..col0+7.
template <int D>
__device__ __forceinline__ FragB load_b_rows(const float* tile, int row0,
                                             int col0) {
  constexpr int kS = Tile<D>::kStride;
  const int l = threadIdx.x % 32;
  const float* p = tile + (row0 + l / 4) * kS + col0 + l % 4;
  return make_b(p[0], p[4]);
}

// The B fragment of a product with the tile's rows as the k side (X as B:
// B[k][n] = tile[k][n]), k = rows row0..row0+7 in the permuted order of
// acc_as_a (logical t is row row0 + 2t, t + 4 is row row0 + 2t + 1),
// n = cols col0..col0+7.
template <int D>
__device__ __forceinline__ FragB load_b_cols(const float* tile, int row0,
                                             int col0) {
  constexpr int kS = Tile<D>::kStride;
  const int l = threadIdx.x % 32;
  const float* p = tile + (row0 + 2 * (l % 4)) * kS + col0 + l / 4;
  return make_b(p[0], p[kS]);
}

// One n-tile's accumulator (rows of this warp, 8 columns) as the A
// fragment of one 8-deep k-step of the next product, in the permuted k
// order that load_b_cols reads B at.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return make_a(c[0], c[2], c[1], c[3]);
}

// di = rowsum(dO o O) of 16 rows, one warp: dO from its staged tile (row
// r at dot + r * kStride), O from global memory (row r at o + r *
// row_stride). A row's D floats are read by D / 4 neighbouring lanes, one
// 16-byte load each, so every load instruction reads whole rows (coalesced)
// and the row's sum takes log2(D / 4) shuffles. Rows at or past `rows`
// get 0. Writes di of row r to out[r]; every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void row_dots(float* out, const float* dot,
                                         const float* o, long row_stride,
                                         int rows) {
  constexpr int kLanes = D / 4 < 32 ? D / 4 : 32;  // lanes per row
  constexpr int kPerPass = 32 / kLanes;            // rows per pass
  static_assert(D / 4 <= 32, "a row is read in one pass of its lanes");
  const int l = threadIdx.x % 32;
  const int sub = l % kLanes;
#pragma unroll
  for (int r0 = 0; r0 < 16; r0 += kPerPass) {
    const int r = r0 + l / kLanes;
    float s = 0.f;
    if (r < rows) {
      const float4 a = *reinterpret_cast<const float4*>(
          dot + r * Tile<D>::kStride + sub * 4);
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(o + r * row_stride) + sub);
      s = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
    }
#pragma unroll
    for (int m = kLanes / 2; m > 0; m /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, m);
    if (sub == 0) out[r] = s;
  }
}

}  // namespace flash_tf32
