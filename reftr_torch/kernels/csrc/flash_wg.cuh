// Hopper building blocks of the warpgroup flash-attention kernels
// (flash_attn_fwd_wg.cu, flash_attn_bwd_dq_wg.cu, flash_attn_bwd_dkv_wg.cu):
// TMA tile loads through a tensor map, mbarriers, and the warpgroup product
// wgmma (bf16 -> f32), all as inline PTX for sm_90a, so a build stays a
// few seconds.
//
// Head dim. The kernels are written for D = kHeadDim = 32, the four-level
// encoder's (the dispatch rule sends no other head dim here).
//
// Tiles. A tile is `rows` rows of D bf16 (2D = 64 bytes a row) written by
// TMA with the tensor map's 64-byte swizzle: the 16-byte chunk index of a
// row, shared-memory address bits 4-5, is XORed with address bits 7-8.
// Every tile starts on a 1024-byte boundary, so the pattern follows the
// tile's own rows.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address >> 4
// (bits 0-13), leading byte offset >> 4 (16-29), stride byte offset >> 4
// (32-45), swizzle mode (62-63: 2 = 64 B). In such a
// tile:
// - as a K-major operand (the tile's rows are M or N, its D columns the
//   k side: Q and K in S = Q K^T, K and V as A in K3's S^T and dP^T, Q and
//   dO as B there), 8-row groups lie 8 * 2D bytes apart (the stride byte
//   offset); the leading byte offset is unused. The k-step kk of 16
//   columns starts 32 * kk bytes into the row.
// - as an MN-major B operand (the tile's rows are the k side, its D columns
//   N: V in P V, dO in dV += P^T dO, Q in dK += dS^T Q), the 2D-byte rows
//   are one swizzle atom along N, and 8-row groups along k lie 8 * 2D bytes
//   apart (the stride byte offset); the leading byte offset (the next atom
//   along N) is unused, as N = D fits one atom. The k-step of 16 rows
//   starts 16 * 2D bytes further.
//
// Register fragments. A wgmma m64nNk16 accumulator gives warp w of the
// warpgroup rows 16w..16w+15, and each of its N / 8 column chunks in
// mma.sync m16n8k16's C layout (flash_tc.cuh): d[4n + e] is row
// 16w + lane / 4 + 8 (e / 2), column 8n + (lane % 4) * 2 + e % 2. Its A
// operand from registers takes mma.sync's A layout per warp. So two column
// chunks of an accumulator, packed to bf16 pairs, are the A fragment of one
// 16-deep k-step of the next product (pack_a), and flash_tc::keep_bits
// gives K1-wg's and K2-wg's dropout decisions in this layout.
//
// Asynchrony. wgmma.mma_async runs after the instruction issues; its
// accumulator registers may be read only after wgmma.wait_group, and its A
// registers must keep their values until then. fence_operands pins either
// after the wait (as CUTLASS's warpgroup_fence_operand), so the compiler
// neither reads an accumulator early nor reuses an A fragment's registers
// while the product runs (ptxas then serialises the products: C7514).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_wg {

constexpr int kHeadDim = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (the labels are
// local to the braces, so every inlined copy has its own)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- registers ------------------------------------------------------------

// hand registers back (the producer warpgroup) or take them (the
// consumers); every warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst; completion is counted on `bar` in bytes. Elements
// past the tensor's extent are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box of `map` at coordinates (c0, c1, c2), innermost first: as
// tma_load_4d for a rank-3 map
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// a descriptor of the tile at `tile` (1024-byte aligned) with 2D-byte rows
// in the 64-byte swizzle
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{(8 * kHeadDim * 2) >> 4} << 32) | (uint64_t{2} << 62);
}

// the descriptor moved by `bytes` (a multiple of 16) along the tile
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers: after the wait, so the compiler
// keeps them (and does not reuse their registers) while the product that
// reads them runs
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FLASH_WG_R8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B, m64n64k16: A (64 x 16) and B (16 x 64) K-major in shared
// memory; `acc` = 0 ignores d's old value.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FLASH_WG_R8(0), FLASH_WG_R8(8), FLASH_WG_R8(16), FLASH_WG_R8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, m64n32k16: A (64 x 16) from registers in mma.sync's A
// layout, B (16 x 32) MN-major in shared memory.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : FLASH_WG_R8(0), FLASH_WG_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef FLASH_WG_R8

// Two floats as one bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-step kt (16 columns) from accumulator chunks 2kt and
// 2kt + 1 of `s`.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[N],
                                       int kt) {
  const int i = kt * 8;
  a[0] = pack_bf16(s[i], s[i + 1]);
  a[1] = pack_bf16(s[i + 2], s[i + 3]);
  a[2] = pack_bf16(s[i + 4], s[i + 5]);
  a[3] = pack_bf16(s[i + 6], s[i + 7]);
}

// 2^x on the special-function unit (ex2.approx, flushing denormals): one
// MUFU.EX2; 2^-inf = +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda); null where it is not found.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Makes the primary context of the device that holds `p` current on the
// calling thread. cuTensorMapEncodeTiled needs a current context, and a
// thread that has made no CUDA call yet (autograd's device thread, whose
// first call of a backward may be K2-wg's) has none: there every encoding
// was refused.
inline cudaError_t bind_device(const void* p) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, p);
  return err != cudaSuccess ? err : cudaSetDevice(attr.device);
}

// The tensor map of a contiguous bf16 [B, S, H, kHeadDim] tensor whose box
// is `rows` rows of one (batch, head): dims innermost first (D, H, S, B),
// the 64-byte swizzle of its 64-byte rows, zeros past S (so a tile never
// reads the next batch row). Returns false where the encoding is refused.
inline bool make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int rows) {
  constexpr int D = kHeadDim;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of the keep bits, uint32 [BH, S, W] (W a multiple of 4),
// whose box is `rows` rows of 4 words (16 bytes) of one (batch * head):
// dims innermost first (W, S, BH), no swizzle, zeros past S. Returns false
// where the encoding is refused.
inline bool make_keep_map(CUtensorMap* map, const void* base, int BH, int S,
                          int W, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {4u, (cuuint32_t)rows, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash_wg
