// The int8 product of the int8 serving path (nn/quant.py): a convolution
// of int8 NHWC activations with int8 weights, int32 sums on the int8
// tensor cores, and the dequantizing epilogue, as one implicit GEMM
//
//   out[m, n] = (float(sum_k A[m, k] * W[n, k]) * (w_scale[n] * in_scale)
//                [+ bias[n]]) as the output dtype
//
// with M = N * Ho * Wo output pixels (NHWC order), N = Cout and
// K = KS * KS * Cin in (r, s, c) order for a square KS x KS kernel (every
// convolution of the backbone; padded by dil * (KS - 1) / 2 on each side):
// A[m, k] is the input pixel under tap (r, s) of output pixel m, channel c,
// or 0 in the padding, and W is the weight [Cout, KS, KS, Cin] as a
// [Cout, K] matrix. A QuantDense is the
// same product as a 1x1 convolution over [M, 1, 1, K] with a bias.
//
// It replaces no Pallas kernel: the JAX package computes QuantConv with
// XLA's conv_general_dilated(int8, int8, preferred_element_type=int32) and
// QuantDense with dot_general(int8, int8, int32) (reftr_tpu/nn/quant.py:79,
// 118), which torch does not have on the card.
//
// Design (simple and right first): a 128 x 128 output tile per block of 8
// warps, each warp 64 x 32 of it as 4 x 4 mma.sync.m16n8k32 s8 x s8 -> s32
// products per 32-deep k-step; K in 64-deep tiles, each inside one tap
// (Cin % 64 == 0, which the wrapper checks), copied global -> shared by
// cp.async 16 bytes a thread-copy (zero-filled in the padding and past the
// ragged M and Cout edges) in a double buffer, so tile k + 1 loads while
// tile k multiplies. Shared rows are 64 bytes padded to 80, so the 8 rows
// of an ldmatrix 8 x 8 matrix fall in 8 disjoint groups of 4 banks. The
// fragments of m16n8k32 for 8-bit types hold 4 bytes a register in
// m16n8k16's places for 16-bit types, so ldmatrix.x4 on the byte tiles
// gives them as it gives bf16 fragments.
//
// The epilogue is bit-exact with the plain version (kernels/quant.py::
// int8_conv_plain) and JAX's float32 chain: __int2float_rn of the int32
// sum, times __fmul_rn(w_scale, in_scale), __fadd_rn of the bias, each
// rounded once (no contraction into an fma), then rounded to bf16 (round
// to nearest even) where the output is bf16.
//
// Bound: at the model's shapes most calls are bound by bytes (layer1's
// 1x1 convolutions: K = 64 or 256 with 64-256 outputs), the rest by the
// int8 operations (layer3 and layer4's 3x3, BERT's and the encoder's
// denses). This kernel does not overlap the epilogue with the next tile's
// loads and uses mma.sync: int8_conv_wg.cu ("wg": wgmma s8, a TMA ring,
// the output stored by TMA) redesigns it for Hopper and takes every shape
// of the model (2.3x faster summed over a forward's products at B=64,
// PERF.md §6); this one ("tc") keeps the shapes "wg" does not take
// (kernels/quant.py::int8_conv_variant: an output row not a multiple of
// 16 bytes, or a convolution TMA's im2col map cannot describe).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStride = kBK + 16;  // bytes a shared row: 64 + 16 padding
constexpr int kThreads = 256;      // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMi = kWarpM / 16, kNi = kWarpN / 8;

struct Params {
  const int8_t* x;        // [N, H, W, C]
  const int8_t* w;        // [Cout, K]
  const float* w_scale;   // [Cout]
  const float* in_scale;  // [1]
  const float* bias;      // [Cout] or nullptr
  void* out;              // [M, Cout]
  int n, h, w_in, c, cout, ks, stride, dil, pad, ho, wo;
  int m, k;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes zeros (src stays a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* out, long long i, float a,
                                       float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, long long i,
                                       float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Params p) {
  __shared__ __align__(16) int8_t sa[2][kBM * kStride];
  __shared__ __align__(16) int8_t sb[2][kBN * kStride];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // Each thread copies two 16-byte chunks of the A tile and two of the B
  // tile per k-tile: chunk id = tid + 256 * j, row id / 4, chunk id % 4.
  // The rows' output pixels do not change over k: keep where they start.
  long long a_base[2];
  int a_hi[2], a_wi[2];
  bool a_row[2];
  int b_row_ok[2];
  const int chunk = tid % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = (tid + kThreads * j) / 4;
    const long long m = m0 + row;
    a_row[j] = m < p.m;
    const long long mm = a_row[j] ? m : 0;
    const int wo = (int)(mm % p.wo);
    const long long t = mm / p.wo;
    const int ho = (int)(t % p.ho);
    const int nb = (int)(t / p.ho);
    a_hi[j] = ho * p.stride - p.pad;
    a_wi[j] = wo * p.stride - p.pad;
    a_base[j] = (long long)nb * p.h * p.w_in;
    b_row_ok[j] = n0 + row < p.cout;
  }

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    const int tap = k0 / p.c, c0 = k0 % p.c;
    const int r = tap / p.ks, s = tap % p.ks;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid + kThreads * j) / 4;
      const int hi = a_hi[j] + r * p.dil, wi = a_wi[j] + s * p.dil;
      const bool ok =
          a_row[j] && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_in;
      const int8_t* src =
          ok ? p.x + ((a_base[j] + (long long)hi * p.w_in + wi) * p.c + c0 +
                      chunk * 16)
             : p.x;
      cp_async16(&sa[stage][row * kStride + chunk * 16], src, ok ? 16 : 0);
      const int8_t* wsrc =
          b_row_ok[j] ? p.w + ((long long)(n0 + row) * p.k + k0 + chunk * 16)
                      : p.w;
      cp_async16(&sb[stage][row * kStride + chunk * 16], wsrc,
                 b_row_ok[j] ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int warp_m = warp / 4, warp_n = warp % 4;
  const int kt_count = p.k / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < kt_count; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < kt_count) {
      load_tile(kt + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int8_t* ta = sa[stage];
    const int8_t* tb = sb[stage];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const int row = warp_m * kWarpM + i * 16 + lane % 16;
        ldmatrix_x4(af[i], ta + row * kStride + ks + (lane / 16) * 16);
      }
#pragma unroll
      for (int j2 = 0; j2 < kNi / 2; ++j2) {
        uint32_t bf[4];
        const int row =
            warp_n * kWarpN + j2 * 16 + lane % 8 + (lane / 16) * 8;
        ldmatrix_x4(bf, tb + row * kStride + ks + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int i = 0; i < kMi; ++i) {
          mma_s8(acc[i][2 * j2], af[i], bf[0], bf[1]);
          mma_s8(acc[i][2 * j2 + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: d[0..1] row g, cols 2t..2t+1; d[2..3] row g + 8
  const float in_scale = *p.in_scale;
  T* out = static_cast<T*>(p.out);
  const int g = lane / 4, t2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < kNi; ++j) {
    const int col = n0 + warp_n * kWarpN + j * 8 + t2;
    if (col >= p.cout) continue;
    const float s0 = __fmul_rn(p.w_scale[col], in_scale);
    const float s1 = __fmul_rn(p.w_scale[col + 1], in_scale);
    const float b0 = p.bias ? p.bias[col] : 0.f;
    const float b1 = p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kMi; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * kWarpM + i * 16 + g + half * 8;
        if (m >= p.m) continue;
        float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * half]), s0);
        float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s1);
        if (p.bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store2(out, m * p.cout + col, v0, v1);
      }
    }
  }
}

}  // namespace

// x int8 [N, H, W, C]; w int8 [Cout, KS * KS * C]; w_scale float32 [Cout];
// in_scale float32 [1]; bias float32 [Cout] or null; out [N, Ho, Wo, Cout]
// float32 (out_dtype 0) or bf16 (1). C % 64 == 0, Cout % 2 == 0, x and w
// 16-byte aligned (the wrapper checks). Returns the launch's cudaError_t.
extern "C" int int8_conv(const void* x, const void* w, const void* w_scale,
                         const void* in_scale, const void* bias, void* out,
                         int N, int H, int W, int C, int Cout, int KS,
                         int stride, int dil, int Ho, int Wo, int out_dtype,
                         void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kBK || Cout <= 0 ||
      Cout % 2 || KS <= 0 || stride <= 0 || dil <= 0 || Ho <= 0 || Wo <= 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)N * Ho * Wo;
  const long long grid_m = (m + kBM - 1) / kBM;
  if (grid_m > 0x7fffffffLL || m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int8_t*>(x),
           static_cast<const int8_t*>(w),
           static_cast<const float*>(w_scale),
           static_cast<const float*>(in_scale),
           static_cast<const float*>(bias),
           out, N, H, W, C, Cout, KS, stride, dil, dil * (KS - 1) / 2, Ho,
           Wo, (int)m, KS * KS * C};
  const dim3 grid((unsigned)grid_m, (Cout + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      int8_conv_kernel<float><<<grid, kThreads, 0, s>>>(p);
      break;
    case 1:
      int8_conv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
