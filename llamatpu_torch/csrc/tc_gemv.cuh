// The building blocks of the port's TMA-fed tensor-core kernels: probes.cu's
// `probe_gemv_tc_kernel` (K18a-e, g-i), moe_grouped.cu's `grouped_tc_kernel`
// (K10-K13) and gemm.cu's GEMM (K4, K17: mbarriers and tensor maps).
//
// - mbarriers and TMA copies: a producer warp fills a ring of shared-memory
//   stages by cp.async.bulk (1-D, a row at a time) or cp.async.bulk.tensor
//   (2-D boxes of a tensor map), each completing on its stage's `full`
//   mbarrier; consumers release a stage on its `empty` one.
// - mma16: mma.sync m16n8k16 bf16 -> f32. The contraction index of each
//   16-column step is permuted alike in A and B, so that a lane's fragment of
//   a row is 4 adjacent columns: the mma's k = 2q, 2q + 1 and 2q + 8, 2q + 9
//   of lane (g = lane / 4, q = lane % 4) are the step's columns 4q .. 4q + 3.
// - mma_s8: mma.sync m16n8k32 s8 -> s32, permuted alike per 32-column step:
//   the mma's k = 4q .. 4q + 3 and 16 + 4q .. 16 + 4q + 3 are the step's
//   columns 8q .. 8q + 7, so a lane's fragment of a row is 8 adjacent bytes.
// - dequant4, dequant_block: 4 int8 weights of one 4-byte load (or 4 packed
//   nibbles) into a bf16 fragment, in registers, with no int-to-float
//   conversion.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

// ops/probes.py mirrors the codes; W_S8: int8 weights times int8 x, int32 sums
enum WKind { W_BF16 = 0, W_Q8_F32 = 1, W_Q8_BF16 = 2, W_S8 = 3 };

// a compile-time flag as an argument (a stage's products with or without guards)
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// ------------------------------------------------------ TMA and mbarriers
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy global -> shared of `bytes` (a multiple of 16), completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One TMA tensor copy: the box of `map` at (column k, row r) into shared
// memory at dst (aligned to the map's swizzle span), completing on bar. The
// whole box is written and counted, zeros outside the tensor.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int r,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(r), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void lds64(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short r;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(r) : "r"(addr));
  return r;
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 sums; lane (g, q) holds
// a's rows g (a0, a2) and g + 8 (a1, a3), b's column g (b0, b1), and c0, c1
// (row g) and c2, c3 (row g + 8) at columns 2q, 2q + 1.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16 x 8] += a[16 x 32] . b[32 x 8], int8 in, int32 sums (exact, wrapping);
// lane (g, q) holds a's rows g (a0, a2) and g + 8 (a1, a3) at k = 4q .. 4q + 3
// (a0, a1) and 16 + 4q .. 16 + 4q + 3 (a2, a3), the lowest byte first, b's
// column g at the same k (b0, b1), and c as mma16.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {  // cvt.rn.bf16x2.f32
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32 of the 4 bytes of u, each biased by `bias`, without the conversion
// pipe: byte e permuted under the exponent of 2^23 reads 2^23 + byte, and one
// subtraction of 2^23 + bias leaves the value exactly.
__device__ __forceinline__ void bytes_to_f32(uint32_t u, float bias, float (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)) - (8388608.f + bias);
}

// The 4 packed columns of raw's two bytes (low nibble first) as bytes n + 8.
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t raw) {
  const uint32_t u = (raw ^ 0x8888u) & 0xffffu;
  const uint32_t v = (u | (u << 8)) & 0x00ff00ffu;
  return (v | (v << 4)) & 0x0f0f0f0fu;
}

// 4 columns of one block-quant row (Q8_0: the 4 int8 bytes of raw; PACKED:
// the nibbles of its two low bytes) times their block scale sc, the f32
// product rounded to nearest, as the two bf16x2 halves of a fragment.
template <bool PACKED>
__device__ __forceinline__ void dequant_block(uint32_t raw, float sc, uint32_t& lo, uint32_t& hi) {
  float f[4];
  if constexpr (PACKED)
    bytes_to_f32(spread_nibbles(raw), 8.f, f);
  else
    bytes_to_f32(raw ^ 0x80808080u, 128.f, f);
  lo = pack_bf16x2(__fmul_rn(f[0], sc), __fmul_rn(f[1], sc));
  hi = pack_bf16x2(__fmul_rn(f[2], sc), __fmul_rn(f[3], sc));
}

// The fragment (two bf16x2) of the 4 int8 weights in raw (columns 4q .. 4q +
// 3, the lowest byte first), dequantized by the kind with the lane's scales:
// bytes_to_f32 of raw ^ 0x80808080 (q + 128), written out for the probes'
// ablation copies to edit.
template <int WK>
__device__ __forceinline__ void dequant4(uint32_t raw, const uint32_t (&sv)[4], uint32_t (&b)[2]) {
  const uint32_t u = raw ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)) - 8388736.f;
  if constexpr (WK == W_Q8_F32) {
    b[0] = pack_bf16x2(__fmul_rn(f[0], __uint_as_float(sv[0])), __fmul_rn(f[1], __uint_as_float(sv[1])));
    b[1] = pack_bf16x2(__fmul_rn(f[2], __uint_as_float(sv[2])), __fmul_rn(f[3], __uint_as_float(sv[3])));
  } else {  // bf16(q) is the high half of f (|q| <= 128: the low half is zero)
    const uint32_t q01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    const uint32_t q23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(b[0]) : "r"(q01), "r"(sv[0]));
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(b[1]) : "r"(q23), "r"(sv[1]));
  }
}

// ------------------------------------------------------ tensor maps (host)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (the libraries
// are not linked against libcuda); null where the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
