// The int8 product of the int8 serving path (nn/quant.py) on Hopper's
// warpgroup tensor-core products (sm_90a), plain C interface for ctypes:
// int8_conv's "wg" variant. The same function and contract as
// int8_conv.cu ("tc"):
//
//   out[m, n] = (float(sum_k A[m, k] * W[n, k]) * (w_scale[n] * in_scale)
//                [+ bias[n]]) as the output dtype
//
// with M = N * Ho * Wo output pixels (NHWC order), N = Cout and
// K = KS * KS * Cin in (r, s, c) order; A[m, k] is the input pixel under
// tap (r, s) of output pixel m (0 in the padding), W the weight [Cout, K].
// It replaces no Pallas kernel: the JAX package computes QuantConv and
// QuantDense with XLA's int8 conv_general_dilated and dot_general
// (reftr_tpu/nn/quant.py:79, 118).
//
// What bounds it. At the model's shapes the denses and layer1's 1x1
// convolutions are bound by their output's bytes (the VL encoder's FFN
// dense at B=64, 28160 x 256 -> 2048: 115 of the 123 MB the bound counts
// are the bf16 output), layer3's and layer4's 3x3 convolutions and BERT's
// denses by the int8 operations (1979 TOP/s dense). mma.sync reaches a
// fraction of that rate on Hopper, and int8_conv.cu's epilogue stores
// 4-byte pairs straight from the fragments, strided by Cout, while nothing
// else runs; this kernel attacks both.
//
// Design.
// - Products: wgmma.mma_async m64nNk32 .s32.s8.s8, both operands K-major
//   from shared memory in the swizzle the tensor maps write (8-bit wgmma
//   takes no transpose; NHWC activations and the [Cout, K] weight are
//   K-major already). A tile is 128 output pixels (two consumer
//   warpgroups of 64 rows) by BN = 64 or 128 columns (the caller picks by
//   shape: kernels/quant.py::int8_conv_tile; 256 columns, one stage fewer
//   in shared memory, was nowhere more than 5 % faster at the model's
//   shapes and up to 20 % slower: PERF.md §6); int32 sums stay exact,
//   with no split over K, so every call gives the same bits.
// - Loads: a ring of K tiles fed by one thread of the producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg
//   40 / 232, as the attention "wg" kernels). A K tile stays inside one
//   tap: BK = 128 bytes (the 128-byte swizzle) where Cin % 128 == 0, else
//   64 (the 64-byte swizzle; Cin % 64 == 0). The weight tile comes by 2-D
//   TMA; so does a dense's (a 1x1 convolution at stride 1) activation
//   tile. A convolution's comes by TMA's im2col mode: one load gives the
//   tile's 128 output pixels, in NHWC order across rows and images, each
//   the BK channels under the tap, whose offsets the load gives; the map's
//   bounding box walks the tap-(0, 0) input pixels from -pad by the stride,
//   and the hardware zero-fills the padding and the rows past M. (A
//   gather of the rows by the producer warpgroup's 128 threads with
//   cp.async ran 1.3-1.6x slower at the model's 3x3 shapes on the H100:
//   PERF.md §6.)
//   The shapes the im2col map cannot describe (padding above 128, tap
//   offsets above 255) take "tc".
// - Persistent blocks: one block an SM walks the output tiles (column
//   tiles of one row tile in turn, so neighbouring blocks share the
//   activations in L2). The producer runs ahead through the ring across
//   tiles, so tile t + 1's loads run under tile t's epilogue.
// - Epilogue: int8_conv.cu's chain bit for bit (__int2float_rn of the
//   sum, __fmul_rn by __fmul_rn(w_scale, in_scale), __fadd_rn of the bias,
//   then round to nearest even into bf16), written into a staging tile in
//   shared memory (the 128-byte swizzle: conflict-free 4-byte stores) and
//   sent out by TMA stores of 64 rows x 128 bytes, clipped at M and Cout by
//   the tensor map. The stores run while the warpgroup goes on to the next
//   tile's products; it waits for their reads of the staging tile only
//   before it writes it again. The output's rows must be a multiple of 16
//   bytes (Cout % 8 == 0 in bf16, % 4 in float32; the wrapper checks);
//   the other shapes take "tc" (kernels/quant.py::int8_conv_variant).
//
// Bound and measured times: PERF.md §6 (chip_smoke.py phase 14a).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wg.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // output rows (pixels) a tile
constexpr int kConsumers = 2;   // warpgroups of 64 rows
// + the producer warpgroup (register allocation is per warpgroup)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemMax = 227 * 1024;  // a block's dynamic shared memory
constexpr int kMaxStages = 6;

struct Params {
  const float* w_scale;   // [Cout]
  const float* in_scale;  // [1]
  const float* bias;      // [Cout] or nullptr
  int h, w_in, c, cout, ks, stride, dil, pad, ho, wo, m, k;
  int tiles_n, tiles;  // column tiles, all tiles
  // A's tiles: a dense's (a 1x1 convolution at stride 1) [M, K] rows by
  // 2-D TMA (0); a convolution's by TMA's im2col mode (1): a tap's 128
  // output pixels, the tap's offsets given at each load
  int im2col;
};

// Shared memory of one instance: the ring's A and B tiles, each
// consumer warpgroup's output staging tile, the mbarriers.
template <int BK, int BN, typename T>
struct Cfg {
  static constexpr int kA = kBM * BK;                   // an A stage
  static constexpr int kB = BN * BK;                    // a B stage
  static constexpr int kBox = 128 / (int)sizeof(T);     // columns a box
  static constexpr int kBoxes = BN / kBox;              // boxes a row tile
  static constexpr int kOut = 64 * BN * (int)sizeof(T); // a warpgroup's
  static constexpr int kFree = kSmemMax - kConsumers * kOut - 1024 - 256;
  static constexpr int kStages =
      kFree / (kA + kB) < kMaxStages ? kFree / (kA + kB) : kMaxStages;
  static constexpr int kOffB = kStages * kA;
  static constexpr int kOffOut = kOffB + kStages * kB;
  static constexpr int kOffBars = kOffOut + kConsumers * kOut;
  static constexpr int kBytes = kOffBars + 2 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kA % 1024 == 0 && kB % 1024 == 0 && kOut % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
};

// A wgmma descriptor of a K-major tile of BK-byte rows at `tile`
// (1024-byte aligned): 8-row groups 8 * BK bytes apart (the stride byte
// offset), the leading byte offset unused, the BK-byte swizzle (mode 1 =
// 128 B, 2 = 64 B). The k-step of 32 bytes starts 32 bytes further.
template <int BK>
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint64_t addr = flash_wg::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{(8 * BK) >> 4} << 32) |
         (uint64_t{BK == 128 ? 1u : 2u} << 62);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(flash_wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(flash_wg::smem_u32(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// pixelsPerColumn pixels of `map` (an im2col map over NHWC) from the
// output pixel whose tap (0, 0) input pixel is (w, h) of image n, the
// channels from c, each at the tap's offsets (dw, dh) from it, into
// shared memory at dst; completion counted on `bar` in bytes. Pixels in
// the padding (or past the last image) are written as zeros.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, int dw, int dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(flash_wg::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(flash_wg::smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(static_cast<uint16_t>(dw)), "h"(static_cast<uint16_t>(dh))
      : "memory");
}

// the box of `map` at (c0, c1) from shared memory at src, in the bulk
// group of the issuing thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(flash_wg::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's generic-proxy shared-memory writes (the staging
// tile) before the async proxy's reads (the TMA store)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup barrier `id` (1 + the consumer warpgroup)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define I8_R8(i)                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A B, m64nNk32 s8 x s8 -> s32: A (64 x 32) and B (32 x N) K-major
// in shared memory; `acc` = 0 ignores d's old value. The accumulator's
// layout is the f32 one's (flash_wg.cuh): d[4n + e] is row
// 16 * warp + lane / 4 + 8 (e / 2), column 8n + (lane % 4) * 2 + e % 2.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n"
        "}\n"
        : I8_R8(0), I8_R8(8), I8_R8(16), I8_R8(24)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n"
        "}\n"
        : I8_R8(0), I8_R8(8), I8_R8(16), I8_R8(24), I8_R8(32), I8_R8(40),
          I8_R8(48), I8_R8(56)
        : "l"(da), "l"(db), "r"(acc));
  }
};

#undef I8_R8

// Two outputs of row `row` (of a warpgroup's 64), columns 8n + (lane % 4)
// * 2 and the next, into the staging tile: kBoxes boxes of 64 rows x 128
// bytes, each in the 128-byte swizzle.
__device__ __forceinline__ void stage_pair(unsigned char* out, int row, int n,
                                           int lane, float v0, float v1,
                                           bf16*) {
  const int chunk = n % 8;
  const int off = (n / 8) * 8192 + row * 128 + ((chunk ^ (row & 7)) << 4) +
                  (lane % 4) * 4;
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(out + off) = v;
}
__device__ __forceinline__ void stage_pair(unsigned char* out, int row, int n,
                                           int lane, float v0, float v1,
                                           float*) {
  const int chunk = 2 * (n % 4) + (lane % 4) / 2;
  const int off = (n / 4) * 8192 + row * 128 + ((chunk ^ (row & 7)) << 4) +
                  (lane % 2) * 8;
  *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
}

template <int BK, int BN, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_wg_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_out,
                        const Params p) {
  using L = Cfg<BK, BN, T>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kt_count = p.k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      flash_wg::bar_init(full + s, 1);  // the producer's, with the bytes
      flash_wg::bar_init(empty + s, 4 * kConsumers);  // one per warp
    }
    flash_wg::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one thread
    flash_wg::regs_release<kProducerRegs>();
    if (threadIdx.x != 128 * kConsumers) return;
    flash_wg::prefetch_map(&map_w);
    flash_wg::prefetch_map(&map_a);
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.tiles_n) * kBM, n0 = (tile % p.tiles_n) * BN;
      // a convolution's: the tile's first output pixel, its image and the
      // input pixel under its tap (0, 0)
      int n = 0, h0 = 0, w0 = 0;
      if (p.im2col) {
        const int t = m0 / p.wo;
        n = t / p.ho;
        h0 = (t % p.ho) * p.stride - p.pad;
        w0 = (m0 % p.wo) * p.stride - p.pad;
      }
      for (int kt = 0; kt < kt_count; ++kt, ++it) {
        const int s = it % S;
        if (it >= S)  // the consumers gave back the stage's last tile
          flash_wg::bar_wait(empty + s, ((it / S) & 1) ^ 1);
        unsigned char* sa = smem + s * L::kA;
        const int k0 = kt * BK;
        flash_wg::bar_arrive_tx(full + s, L::kA + L::kB);
        tma_load_2d(smem + L::kOffB + s * L::kB, &map_w, full + s, k0, n0);
        if (p.im2col) {
          const int tap = k0 / p.c;
          tma_load_im2col(sa, &map_a, full + s, k0 - tap * p.c, w0, h0, n,
                          (tap % p.ks) * p.dil, (tap / p.ks) * p.dil);
        } else {
          tma_load_2d(sa, &map_a, full + s, k0, m0);
        }
      }
    }
    return;
  }

  flash_wg::regs_take<kConsumerRegs>();
  // a consumer: warpgroup wg owns rows wg * 64 .. + 63 of each tile, this
  // lane rows r0 and r0 + 8 of those
  const int wg = warp / 4, ct = threadIdx.x % 128;
  const int r0 = (warp % 4) * 16 + lane / 4;
  unsigned char* staging = smem + L::kOffOut + wg * L::kOut;
  const float in_scale = *p.in_scale;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * kBM, n0 = (tile % p.tiles_n) * BN;
    for (int kt = 0; kt < kt_count; ++kt, ++it) {
      const int s = it % S;
      flash_wg::bar_wait(full + s, (it / S) & 1);
      const uint64_t da = make_desc<BK>(smem + s * L::kA + wg * 64 * BK);
      const uint64_t db = make_desc<BK>(smem + L::kOffB + s * L::kB);
      flash_wg::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Mma<BN>::run(acc, flash_wg::desc_add(da, kk * 32),
                     flash_wg::desc_add(db, kk * 32), kt > 0 || kk > 0);
      flash_wg::wg_commit();
      if (kt > 0) {  // the previous K tile's products are done: give it back
        flash_wg::wg_wait<1>();
        if (lane == 0) flash_wg::bar_arrive(empty + (it - 1) % S);
      }
    }
    flash_wg::wg_wait<0>();
    fence_operands(acc);
    if (lane == 0) flash_wg::bar_arrive(empty + (it - 1) % S);

    // the epilogue: the staging tile is free once the last tile's stores
    // have read it
    if (ct == 0) bulk_wait_read();
    wg_sync(1 + wg);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + n * 8 + (lane % 4) * 2;
      float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (col < p.cout) {
        const float2 ws =
            __ldg(reinterpret_cast<const float2*>(p.w_scale + col));
        s0 = __fmul_rn(ws.x, in_scale);
        s1 = __fmul_rn(ws.y, in_scale);
        if (p.bias != nullptr) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(p.bias + col));
          b0 = bb.x;
          b1 = bb.y;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = __fmul_rn(__int2float_rn(acc[4 * n + 2 * half]), s0);
        float v1 = __fmul_rn(__int2float_rn(acc[4 * n + 2 * half + 1]), s1);
        if (p.bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        stage_pair(staging, r0 + 8 * half, n, lane, v0, v1,
                   static_cast<T*>(nullptr));
      }
    }
    fence_async_shared();
    wg_sync(1 + wg);
    if (ct == 0 && m0 + wg * 64 < p.m) {
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx)
        if (n0 + bx * L::kBox < p.cout)
          tma_store_2d(&map_out, staging + bx * 8192, n0 + bx * L::kBox,
                       m0 + wg * 64);
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait();
}

// The tensor map of a contiguous row-major [rows, cols] matrix of `type`
// (`bytes` a element) whose box is box_rows x box_cols, in the 128-byte
// swizzle (box_cols * bytes = 128) or the 64-byte one (64), zeros past
// the edges. Returns false where the encoding is refused.
bool make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                 int bytes, long long rows, int cols, int box_rows,
                 int box_cols) {
  const flash_wg::EncodeTiled encode = flash_wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  const CUtensorMapSwizzle swizzle = box_cols * bytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col, looked up as flash_wg::encode_tiled looks up
// its tiled twin; null where it is not found.
EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeIm2col", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeIm2col>(f)
               : nullptr;
  }();
  return fn;
}

// The im2col map of the int8 NHWC input of a square KS x KS convolution:
// each load gives 128 output pixels (rows) of BK channels, whose tap-(0, 0)
// input pixels run over the bounding box [-pad, (Ho - 1) * stride - pad]
// in both directions by `stride` (its corners: -pad from the top left,
// (Ho - 1) * stride - pad - (H - 1) from the bottom right), in the BK-byte
// swizzle. Returns false where the encoding is refused.
bool make_im2col_map(CUtensorMap* map, const void* x, const Params& p,
                     int n, int bk) {
  const EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)p.c, (cuuint64_t)p.w_in,
                              (cuuint64_t)p.h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)p.c,
                                 (cuuint64_t)p.w_in * p.c,
                                 (cuuint64_t)p.h * p.w_in * p.c};
  const int lower[2] = {-p.pad, -p.pad};
  const int upper[2] = {(p.wo - 1) * p.stride - p.pad - (p.w_in - 1),
                        (p.ho - 1) * p.stride - p.pad - (p.h - 1)};
  const cuuint32_t unit[4] = {1u, (cuuint32_t)p.stride, (cuuint32_t)p.stride,
                              1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
                dims, strides, lower, upper, (cuuint32_t)bk, (cuuint32_t)kBM,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// whether the im2col map takes the convolution: its box corners and the
// taps' offsets within their 8-bit ranges (rank 4)
bool im2col_takes(const Params& p) {
  const int upper_w = (p.wo - 1) * p.stride - p.pad - (p.w_in - 1);
  const int upper_h = (p.ho - 1) * p.stride - p.pad - (p.h - 1);
  return p.pad <= 128 && upper_w >= -128 && upper_w <= 127 &&
         upper_h >= -128 && upper_h <= 127 && p.dil * (p.ks - 1) <= 255 &&
         p.stride <= 8;
}

int sm_count(const void* p) {
  cudaPointerAttributes attr;
  int n = 0;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                             attr.device) != cudaSuccess)
    return 0;
  return n;
}

template <int BK, int BN, typename T>
cudaError_t launch(const void* x, const void* w, void* out, Params p, int n,
                   cudaStream_t stream) {
  using L = Cfg<BK, BN, T>;
  const cudaError_t bound = flash_wg::bind_device(x);
  if (bound != cudaSuccess) return bound;
  const CUtensorMapDataType out_type = sizeof(T) == 2
                                           ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map_w, map_a, map_out;
  if (!make_map_2d(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.cout, p.k,
                   BN, BK) ||
      !make_map_2d(&map_out, out, out_type, sizeof(T), p.m, p.cout, 64,
                   L::kBox))
    return cudaErrorInvalidValue;
  // a dense's activations [M, K] by 2-D TMA, a convolution's by im2col
  if (!(p.im2col ? make_im2col_map(&map_a, x, p, n, BK)
                 : make_map_2d(&map_a, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                               p.m, p.k, kBM, BK)))
    return cudaErrorInvalidValue;
  const int sms = sm_count(x);
  if (sms <= 0) return cudaErrorInvalidDevice;
  auto kernel = int8_conv_wg_kernel<BK, BN, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, kThreads, L::kAlloc, stream>>>(map_w, map_a, map_out, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(int bk, int bn, const void* x, const void* w, void* out,
                      const Params& p, int n, cudaStream_t s) {
  if (bn != 64 && bn != 128) return cudaErrorInvalidValue;
  if (bk == 128)
    return bn == 64 ? launch<128, 64, T>(x, w, out, p, n, s)
                    : launch<128, 128, T>(x, w, out, p, n, s);
  return bn == 64 ? launch<64, 64, T>(x, w, out, p, n, s)
                  : launch<64, 128, T>(x, w, out, p, n, s);
}

}  // namespace

// x int8 [N, H, W, C]; w int8 [Cout, KS * KS * C]; w_scale float32 [Cout];
// in_scale float32 [1]; bias float32 [Cout] or null; out [N, Ho, Wo, Cout]
// float32 (out_dtype 0) or bf16 (1); bn the tile's columns: 64 or 128.
// C % 64 == 0; Cout * the output's bytes a multiple of 16;
// x, w, w_scale, bias and out 16-byte aligned (the wrapper checks). The K
// tile is 128 bytes where C % 128 == 0, else 64. Returns the launch's
// cudaError_t.
extern "C" int int8_conv_wg(const void* x, const void* w, const void* w_scale,
                            const void* in_scale, const void* bias, void* out,
                            int N, int H, int W, int C, int Cout, int KS,
                            int stride, int dil, int Ho, int Wo,
                            int out_dtype, int bn, void* stream) {
  const int esize = out_dtype == 1 ? 2 : 4;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 64 || Cout <= 0 ||
      (Cout * esize) % 16 || KS <= 0 || stride <= 0 || dil <= 0 || Ho <= 0 ||
      Wo <= 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)N * Ho * Wo;
  const long long k = (long long)KS * KS * C;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL ||
      (long long)N * H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bk = C % 128 == 0 ? 128 : 64;
  const long long tiles_n = (Cout + bn - 1) / bn;
  const long long tiles = (m + kBM - 1) / kBM * tiles_n;
  if (bn <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(w_scale),
           static_cast<const float*>(in_scale),
           static_cast<const float*>(bias),
           H, W, C, Cout, KS, stride, dil, dil * (KS - 1) / 2, Ho, Wo,
           (int)m, (int)k, (int)tiles_n, (int)tiles,
           !(KS == 1 && stride == 1)};
  if (p.im2col && !im2col_takes(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_dtype == 1
                   ? launch_bn<bf16>(bk, bn, x, w, out, p, N, s)
                   : launch_bn<float>(bk, bn, x, w, out, p, N, s));
}
