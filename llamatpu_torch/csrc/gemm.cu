// K4: the w8a8 prefill projection (T >= 128).
//
// Replaces llamatpu/ops/pallas_gemm.py `_gemm_kernel` (and its stacked
// `_gemm_kernel_li` twin: a layer is the view qs[li] here), which the JAX
// package keeps bit-identical to its XLA int8 dot
// `int8_prefill.rowq_matmul_mxu`:
//
//   y[t, o] = float(sum_k xi8[t, k] * qs[o, k]) * ax[t] * s[o]
//
// int8 x int8 products, an exact int32 sum (the caller asserts I <=
// _INT8_ACC_MAX_I), then the f32 epilogue in that order — so the result is
// bit-identical to the plain version whatever the summation order.
//
// Bound on the H100: about equally operations and bytes. A llama32-1b layer
// at T = 512 is ~62.3 G int8 operations (~31.5 us at 1979 TOP/s dense int8)
// and, with its f32 [T, O] outputs, ~116 MB (~34.8 us at 3.35 TB/s). This first
// version: 128 x 128 output tiles per 256-thread block, K in steps of 64
// copied by cp.async into two shared-memory stages (the next step's tiles
// land while this one multiplies; row stride 80 bytes, so the fragment reads
// are bank-conflict free), eight warps each owning a 64 x 32 sub-tile as
// 4 x 4 `mma.sync.m16n8k32` int8 tensor-core products with int32
// accumulators in registers. No TMA, no wgmma, no deeper pipeline yet: those
// are later work.
//
// K17: the bf16 variant, replacing llamatpu/ops/pallas_gemm.py
// `_gemm_kernel_bf16` (`rowq_gemm_pallas(variant="bf16")`, a diagnostic the
// JAX package's scripts/bench_gemm.py times against the int8 path):
//
//   y[t, o] = (sum_k bf16(xi8[t, k]) * bf16(qs[o, k]))_f32 * ax[t] * s[o]
//
// int8 values are exact in bf16 and their products exact in f32, so it
// differs from K4 only in the f32 summation's rounding. Bound on the H100:
// operations, at half K4's rate (989 TFLOP/s bf16 against 1979 TOP/s int8),
// ~5.4, 4.3, 34.7 and 17.4 us for llama32-1b's wqkv, wo, w13 and w2 at T =
// 512. Design: K4's kernel with another inner step: the same cp.async int8
// tiles, each 16-deep fragment converted to bf16 pairs in registers as it is
// read from shared memory, and `mma.sync.m16n8k16` bf16 products into f32
// accumulators; the epilogue is K4's.
#include <type_traits>

#include "common.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int BM = 128, BN = 128, BK = 64, PADK = BK + 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two adjacent int8 values in shared memory as a bf16 pair (exact), the
// lower k in the low half, as the mma fragments take them.
__device__ __forceinline__ uint32_t i8x2_bf16x2(const int8_t* p) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(p[0]),
                                                 static_cast<float>(p[1]));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a [BM, BK] int8 tile of a row-major [n_rows, K] matrix
// (K % 16 == 0, rows 16-byte aligned) into shared memory; out-of-range
// chunks are zero-filled.
__device__ __forceinline__ void load_tile_async(int8_t (*dst)[PADK], const int8_t* src, int row0,
                                                int n_rows, int k0, int K) {
  constexpr int chunks = BM * BK / 16;  // BM == BN
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int r = c / (BK / 16), kc = c - r * (BK / 16);
    const int gr = row0 + r, gk = k0 + kc * 16;
    const bool valid = gr < n_rows && gk < K;
    cp_async16(&dst[r][kc * 16], valid ? src + static_cast<long>(gr) * K + gk : src, valid);
  }
}

// The GEMM of both kernels: kBf16 selects K17's inner step (bf16 fragments,
// f32 sums) over K4's (int8 fragments, int32 sums).
template <bool kBf16>
__device__ __forceinline__ void gemm_body(const int8_t* __restrict__ x,
                                          const float* __restrict__ ax,
                                          const int8_t* __restrict__ w,
                                          const float* __restrict__ s,
                                          float* __restrict__ y, int T, int O, int K) {
  using Acc = std::conditional_t<kBf16, float, int>;
  __shared__ __align__(16) int8_t As[2][BM][PADK];
  __shared__ __align__(16) int8_t Bs[2][BN][PADK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols each
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // two-stage pipeline: the next K step's tiles copy while this one multiplies
  const int nk = (K + BK - 1) / BK;
  load_tile_async(As[0], x, m0, T, 0, K);
  load_tile_async(Bs[0], w, n0, O, 0, K);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile_async(As[st ^ 1], x, m0, T, (kt + 1) * BK, K);
      load_tile_async(Bs[st ^ 1], w, n0, O, (kt + 1) * BK, K);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles have landed
    __syncthreads();
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = wm * 64 + mt * 16 + g;
          a[mt][0] = i8x2_bf16x2(&As[st][r][kk + tg * 2]);
          a[mt][1] = i8x2_bf16x2(&As[st][r + 8][kk + tg * 2]);
          a[mt][2] = i8x2_bf16x2(&As[st][r][kk + 8 + tg * 2]);
          a[mt][3] = i8x2_bf16x2(&As[st][r + 8][kk + 8 + tg * 2]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + g;
          b[nt][0] = i8x2_bf16x2(&Bs[st][c][kk + tg * 2]);
          b[nt][1] = i8x2_bf16x2(&Bs[st][c][kk + 8 + tg * 2]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + tg * 4]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + tg * 4]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 16 + tg * 4]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[st][c][kk + tg * 4]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[st][c][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    }
    __syncthreads();  // the stage is overwritten by the copy issued next step
  }

  // epilogue: (float(acc) * ax[t]) * s[o], each product rounded (no FMA)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r0 = m0 + wm * 64 + mt * 16 + g;
      const int c0 = n0 + wn * 32 + nt * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        if (r >= T) continue;
        const float axr = ax[r];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q;
          if (c < O)
            y[static_cast<long>(r) * O + c] =
                __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][nt][h * 2 + q]), axr), s[c]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(256) gemm_s8_kernel(const int8_t* __restrict__ x,
                                                      const float* __restrict__ ax,
                                                      const int8_t* __restrict__ w,
                                                      const float* __restrict__ s,
                                                      float* __restrict__ y, int T, int O, int K) {
  gemm_body<false>(x, ax, w, s, y, T, O, K);
}

__global__ void __launch_bounds__(256) gemm_bf16_kernel(const int8_t* __restrict__ x,
                                                        const float* __restrict__ ax,
                                                        const int8_t* __restrict__ w,
                                                        const float* __restrict__ s,
                                                        float* __restrict__ y, int T, int O,
                                                        int K) {
  gemm_body<true>(x, ax, w, s, y, T, O, K);
}

}  // namespace

// xi8 [T, K] int8, ax [T] f32, qs [O, K] int8, s [O] f32 -> y [T, O] f32.
// K % 16 == 0 and 16-byte aligned rows (the wrapper checks).
// bf16 != 0 launches K17, else K4.
LT_EXPORT int lt_rowq_gemm(const void* xi8, const void* ax, const void* qs, const void* s, void* y,
                           int T, int O, int K, int bf16, void* stream) {
  dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM);
  auto kernel = bf16 ? gemm_bf16_kernel : gemm_s8_kernel;
  kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xi8), static_cast<const float*>(ax),
      static_cast<const int8_t*>(qs), static_cast<const float*>(s), static_cast<float*>(y), T, O,
      K);
  return static_cast<int>(cudaGetLastError());
}
