// K5 and K7: projections over ggml block-quant weights (Q8_0, Q4_0, and
// Q4_0 packed two values per byte), in decode and in prefill alike.
//
// K5 replaces llamatpu/ops/pallas_matmul.py `_kernel` and its stacked twin
// `_kernel_li` (a layer is the view qs[li] here, so one kernel takes a base
// pointer); K7 replaces `_kernel_packed4` / `_kernel_packed4_li`. Both
// compute
//
//   y[t, o] (f32) = sum_i  x[t, i].to(dt) * (qs[o, i].f32 * s[o, i / 32]).to(dt)
//
// with f32 accumulation, dt the dot dtype (f32 for f32 activations, else
// bf16). The dequantized weight is rounded to dt BEFORE the dot, exactly as
// the TPU kernel does (pallas_matmul.py:93): the scale multiply is an f32
// product rounded to nearest (__fmul_rn), then round-to-nearest-even to bf16.
// K7's values are two's-complement nibbles: byte c of a row holds canonical
// columns 2c (low nibble, sign-extended by (p << 28) >> 28) and 2c + 1
// (p >> 4), with p the byte read as a SIGNED int8 widened to int.
//
// Bound on the H100: decode (T = 1) is the weight stream, 1.125 B/weight for
// Q8_0 (int8 + f32 scale per 32) and 0.625 B/weight packed: the llama32-1b
// head (128256 x 2048) is ~88 us at 3.35 TB/s as Q8_0, ~49 us packed.
// Prefill at T = 512 is operations: ~62 GFLOP per llama32-1b layer, ~63 us
// at 989 TFLOP/s bf16.
//
// Design of this first version, two paths behind one entry point:
// - T < 16, GEMV: the activation rows sit in shared memory as f32 (MAXT of
//   them per block pass); a warp owns whole weight rows (grid-stride); each
//   lane streams 4-byte words of its row (a warp reads 128 contiguous bytes
//   per load, unrolled so enough bytes are in flight), dequantizes them with
//   the block scale of that word (one scale per 8 words Q8_0, per 4 words
//   packed), and multiplies them with the matching float4s of shared memory;
//   the row sum is a warp shuffle reduction.
// - T >= 16, tiled: 64 x 128 output tiles per 256-thread block, K in steps
//   of one 32-block: the activation tile is rounded to dt and the weight tile
//   dequantized (and rounded) into shared memory, then eight warps each take
//   a 32 x 32 sub-tile: for bf16 as `mma.sync.m16n8k16` bf16 tensor-core
//   products with f32 accumulators, for f32 as FMAs over the same fragment
//   layout. Rows past T and O are zero-filled and never stored. No
//   cp.async pipeline, TMA or wgmma yet: those are later work.
#include <type_traits>

#include "common.cuh"

LT_DEFINE_ERROR_STRING

namespace {

template <typename DT>
__device__ __forceinline__ DT cvt_to(float v);
template <>
__device__ __forceinline__ float cvt_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt_to<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ int sext_lo4(int p) {
  return static_cast<int>(static_cast<unsigned>(p) << 28) >> 28;
}

__device__ __forceinline__ int byte_of(int word, int k) {
  return static_cast<int8_t>((word >> (8 * k)) & 0xff);
}

// ------------------------------------------------------------------ GEMV
constexpr int kGemvThreads = 512;

template <int MAXT, bool PACKED, int DOT>
__global__ void __launch_bounds__(kGemvThreads)
    bq_gemv_kernel(const void* __restrict__ x, int x_dtype, const int8_t* __restrict__ qs,
                   const float* __restrict__ s, float* __restrict__ y, int T, int O, int I) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [nt, I]
  const int t0 = blockIdx.y * MAXT;
  const int nt = min(MAXT, T - t0);
  for (int i = threadIdx.x; i < nt * I; i += blockDim.x)
    xs[i] = lt_round(lt_load(x, x_dtype, static_cast<long>(t0) * I + i), DOT);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nb = I >> 5;
  const int wbytes = PACKED ? (I >> 1) : I;
  const int nwords = wbytes >> 2;
  for (int o = blockIdx.x * nwarps + (threadIdx.x >> 5); o < O; o += gridDim.x * nwarps) {
    const int* wrow = reinterpret_cast<const int*>(qs + static_cast<long>(o) * wbytes);
    const float* srow = s + static_cast<long>(o) * nb;
    float acc[MAXT];
#pragma unroll
    for (int t = 0; t < MAXT; ++t) acc[t] = 0.f;
#pragma unroll 4
    for (int c = lane; c < nwords; c += 32) {
      const int wv = __ldg(wrow + c);
      if (!PACKED) {
        // word c: canonical columns 4c .. 4c + 3, all in block c / 8
        const float sc = __ldg(srow + (c >> 3));
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = lt_round(__fmul_rn(static_cast<float>(byte_of(wv, k)), sc), DOT);
#pragma unroll
        for (int t = 0; t < MAXT; ++t) {
          if (t < nt) {
            const float4 xv = reinterpret_cast<const float4*>(xs + t * I)[c];
            acc[t] += xv.x * w[0] + xv.y * w[1] + xv.z * w[2] + xv.w * w[3];
          }
        }
      } else {
        // word c: canonical columns 8c .. 8c + 7, all in block c / 4
        const float sc = __ldg(srow + (c >> 2));
        float w[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = byte_of(wv, k);
          w[2 * k] = lt_round(__fmul_rn(static_cast<float>(sext_lo4(p)), sc), DOT);
          w[2 * k + 1] = lt_round(__fmul_rn(static_cast<float>(p >> 4), sc), DOT);
        }
#pragma unroll
        for (int t = 0; t < MAXT; ++t) {
          if (t < nt) {
            const float4* xr = reinterpret_cast<const float4*>(xs + t * I);
            const float4 a = xr[2 * c], b = xr[2 * c + 1];
            acc[t] += a.x * w[0] + a.y * w[1] + a.z * w[2] + a.w * w[3] + b.x * w[4] +
                      b.y * w[5] + b.z * w[6] + b.w * w[7];
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MAXT; ++t) acc[t] = lt_warp_sum(acc[t]);
    if (lane == 0)
      for (int t = 0; t < nt; ++t) y[static_cast<long>(t0 + t) * O + o] = acc[t];
  }
}

template <int MAXT, bool PACKED, int DOT>
int gemv_launch(const void* x, int x_dtype, const int8_t* qs, const float* s, float* y, int T,
                int O, int I, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(MAXT) * I * sizeof(float);
  cudaError_t e = lt_allow_smem(bq_gemv_kernel<MAXT, PACKED, DOT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nwarps = kGemvThreads / 32;
  const int row_blocks = (O + nwarps - 1) / nwarps;
  const int cap = 4 * lt_sm_count();
  dim3 grid(row_blocks < cap ? row_blocks : cap, (T + MAXT - 1) / MAXT);
  bq_gemv_kernel<MAXT, PACKED, DOT><<<grid, kGemvThreads, smem, st>>>(x, x_dtype, qs, s, y, T, O, I);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED, int DOT>
int gemv_dispatch(int maxt, const void* x, int x_dtype, const int8_t* qs, const float* s, float* y,
                  int T, int O, int I, cudaStream_t st) {
  switch (maxt) {
    case 1: return gemv_launch<1, PACKED, DOT>(x, x_dtype, qs, s, y, T, O, I, st);
    case 2: return gemv_launch<2, PACKED, DOT>(x, x_dtype, qs, s, y, T, O, I, st);
    case 4: return gemv_launch<4, PACKED, DOT>(x, x_dtype, qs, s, y, T, O, I, st);
    case 8: return gemv_launch<8, PACKED, DOT>(x, x_dtype, qs, s, y, T, O, I, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------ tiled
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int kGemmThreads = 256;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool PACKED, typename DT>
__global__ void __launch_bounds__(kGemmThreads)
    bq_gemm_kernel(const void* __restrict__ x, int x_dtype, const int8_t* __restrict__ qs,
                   const float* __restrict__ s, float* __restrict__ y, int T, int O, int I) {
  // shared-memory row stride: bf16 rows of 80 bytes and f32 rows of 33
  // words keep the fragment reads free of bank conflicts
  constexpr int LD = std::is_same<DT, float>::value ? BK + 1 : BK + 8;
  __shared__ __align__(16) DT As[BM][LD];
  __shared__ __align__(16) DT Ws[BN][LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, a 32 x 32 sub-tile each
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nb = I >> 5;
  const int wbytes = PACKED ? (I >> 1) : I;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kb = 0; kb < nb; ++kb) {
    // activation tile [BM, 32], rounded to the dot dtype
    for (int e = tid; e < BM * BK; e += kGemmThreads) {
      const int r = e / BK, k = e - r * BK;
      const int gr = m0 + r;
      const float v = gr < T ? lt_load(x, x_dtype, static_cast<long>(gr) * I + kb * BK + k) : 0.f;
      As[r][k] = cvt_to<DT>(v);
    }
    // weight tile [BN, 32]: thread -> (row r, half h of the block's 32 values)
    {
      const int r = tid >> 1, h = tid & 1;
      const int go = n0 + r;
      float w[16];
      if (go < O) {
        const float sc = __ldg(s + static_cast<long>(go) * nb + kb);
        const int8_t* src = qs + static_cast<long>(go) * wbytes + (PACKED ? kb * 16 + h * 8
                                                                          : kb * 32 + h * 16);
        if (!PACKED) {
          const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
          const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[j] = __fmul_rn(static_cast<float>(byte_of(words[j >> 2], j & 3)), sc);
        } else {
          const int2 raw = __ldg(reinterpret_cast<const int2*>(src));
          const int words[2] = {raw.x, raw.y};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = byte_of(words[j >> 2], j & 3);
            w[2 * j] = __fmul_rn(static_cast<float>(sext_lo4(p)), sc);
            w[2 * j + 1] = __fmul_rn(static_cast<float>(p >> 4), sc);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) Ws[r][h * 16 + j] = cvt_to<DT>(w[j]);
    }
    __syncthreads();

    if constexpr (std::is_same<DT, __nv_bfloat16>::value) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 2]);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 2]);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 2 + 8]);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + g;
          b[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[c][kk + tg * 2]);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[c][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
      // f32: FMAs producing the same fragment layout as the tensor-core path
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          av[mt][0] = As[wm * 32 + mt * 16 + g][k];
          av[mt][1] = As[wm * 32 + mt * 16 + g + 8][k];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bv[nt][0] = Ws[wn * 32 + nt * 8 + tg * 2][k];
          bv[nt][1] = Ws[wn * 32 + nt * 8 + tg * 2 + 1][k];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int hq = 0; hq < 4; ++hq)
              acc[mt][nt][hq] = fmaf(av[mt][hq >> 1], bv[nt][hq & 1], acc[mt][nt][hq]);
      }
    }
    __syncthreads();  // the tiles are overwritten next step
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int hq = 0; hq < 4; ++hq) {
        const int r = m0 + wm * 32 + mt * 16 + g + (hq >> 1) * 8;
        const int c = n0 + wn * 32 + nt * 8 + tg * 2 + (hq & 1);
        if (r < T && c < O) y[static_cast<long>(r) * O + c] = acc[mt][nt][hq];
      }
    }
  }
}

template <bool PACKED, typename DT>
int gemm_launch(const void* x, int x_dtype, const int8_t* qs, const float* s, float* y, int T,
                int O, int I, cudaStream_t st) {
  dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM);
  bq_gemm_kernel<PACKED, DT><<<grid, kGemmThreads, 0, st>>>(x, x_dtype, qs, s, y, T, O, I);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED>
int run(int maxt, const void* x, int x_dtype, const int8_t* qs, const float* s, float* y, int T,
        int O, int I, cudaStream_t st) {
  const bool f32 = x_dtype == LT_F32;
  if (maxt > 0)
    return f32 ? gemv_dispatch<PACKED, LT_F32>(maxt, x, x_dtype, qs, s, y, T, O, I, st)
               : gemv_dispatch<PACKED, LT_BF16>(maxt, x, x_dtype, qs, s, y, T, O, I, st);
  return f32 ? gemm_launch<PACKED, float>(x, x_dtype, qs, s, y, T, O, I, st)
             : gemm_launch<PACKED, __nv_bfloat16>(x, x_dtype, qs, s, y, T, O, I, st);
}

}  // namespace

// x [T, I] (x_dtype, the dot dtype), qs [O, I] int8 (packed: [O, I / 2]),
// s [O, I / 32] f32 -> y [T, O] f32. maxt > 0 takes the GEMV with maxt
// activation rows per block pass (1, 2, 4 or 8), 0 the tiled path. I % 32 ==
// 0 and 16-byte aligned rows (the wrapper checks).
LT_EXPORT int lt_block_matmul(const void* x, int x_dtype, const void* qs, const void* s, void* y,
                              int T, int O, int I, int packed, int maxt, void* stream) {
  if (T <= 0 || O <= 0 || I <= 0 || I % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(qs);
  const float* sc = static_cast<const float*>(s);
  float* out = static_cast<float*>(y);
  return packed ? run<true>(maxt, x, x_dtype, q, sc, out, T, O, I, st)
                : run<false>(maxt, x, x_dtype, q, sc, out, T, O, I, st);
}
