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
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): decode (T = 1) is the
// weight stream, 1.125 B/weight for Q8_0 (int8 + f32 scale per 32) and 0.625
// B/weight packed: the llama32-1b head (128256 x 2048) is ~88 us as Q8_0,
// ~49 us packed. Prefill at T = 512 is operations: ~62 GFLOP per llama32-1b
// layer's four projections, ~63 us.
//
// Routes, as ops/quant_matmul.py `block_route` picks them:
// - bf16 x, T > 32, I % 128 == 0 (prefill chunks): `bq_wgmma_kernel`, a
//   persistent, warp-specialised TMA + wgmma GEMM (below). The weights are
//   the M side, 128 rows a tile (64 for each of two consumer warpgroups), x
//   the N side, 128 or 256 rows a tile (NX = 2 x blocks: two wgmmas share
//   each A fragment); one thread of a producer warpgroup (setmaxnreg gives
//   its registers to the consumers) fills a ring of stages by
//   TMA tensor copies: the stage's 128 weight columns (the int8 box [128
//   rows, 128 bytes] in the 128-byte swizzle; packed [128 rows, 64 bytes] in
//   the 64-byte one), their f32 block scales [128 rows, 4] and the bf16 x
//   boxes [128 rows, 64 columns] in the 128-byte swizzle, which wgmma reads
//   as B straight from the stage. The consumers dequantize their weight
//   fragments in registers (byte or sign-extended nibble to f32 under the
//   exponent of 2^23, __fmul_rn by the block's scale, cvt.rn.bf16x2) into
//   the register A of wgmma m64n128k16 f32.bf16.bf16. B arrives in natural k
//   order, so A follows it: lane (g, q) holds columns 2q, 2q + 1, 2q + 8 and
//   2q + 9 of each 16-deep step, which Q8_0 reads as two 4-byte shared loads
//   a row and one byte permute, packed as one 8-byte load and one permute
//   (the step's bytes q and q + 4). A warpgroup dequantizes a stage once its
//   previous stage's wgmmas are done (ptxas serializes every wgmma where a
//   register operand is written while one is in flight); the other
//   warpgroup's products may run meanwhile. A stage is released once both
//   warpgroups' products on it are done. The walk over (tile, K
//   stage) iterations is gemm.cu's (wgmma.cuh `Walk`); ops/quant_matmul.py
//   `wgmma_plan` picks NX and the plan (plan_gemm's for K17, or whole tiles
//   in rounds) by a cost model fitted on the card. A shared tile's partial
//   sums go to a workspace and a second pass adds them in K order, so two
//   runs are bit-equal (no atomics). TMA zero-fills rows past T and O;
//   stores are masked.
// - bf16 x, T <= 32, I % 128 == 0 (decode, batched lanes): rowq_tc.cuh's
//   tensor-core GEMV template with the block-scale weight kinds (K5: Q8_0, K7:
//   packed; each weight box's scales staged beside it by TMA), its raw-sum
//   epilogue, on the plan of ops/ffn_fused.py `plan_tc`.
// - f32 x (the tensor cores give no f32 products), and bf16 x where I % 128
//   != 0 (a row of block scales is then not a 16-byte multiple, which TMA
//   needs): the CUDA-core routes of the first design. T < 16, GEMV: the
//   activation rows sit in shared memory as f32 (MAXT of them per block
//   pass); a warp owns whole weight rows (grid-stride); each lane streams
//   4-byte words of its row, dequantizes them with the block scale of that
//   word, and multiplies them with the matching float4s of shared memory;
//   the row sum is a warp shuffle reduction. T >= 16, tiled: 64 x 128 output
//   tiles per 256-thread block, K in steps of one 32-block: the activation
//   tile is rounded to dt and the weight tile dequantized (and rounded) into
//   shared memory, then eight warps each take a 32 x 32 sub-tile, as
//   `mma.sync.m16n8k16` bf16 tensor-core products or as f32 FMAs over the
//   same fragment layout.
#include <cuda.h>

#include <type_traits>

#include "rowq_tc.cuh"
#include "wgmma.cuh"

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

// ------------------------------------------------------------------ CUDA-core GEMV
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

// ------------------------------------------------------------------ CUDA-core tiled
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


// ------------------------------------------------------------------ wgmma GEMM
namespace bqg {

constexpr int BM = 128;                    // weight rows of a tile: two warpgroups of 64
constexpr int BN = 128;                    // x rows of a wgmma (its N); NX of them a tile
constexpr int BK = 128;                    // columns of a K stage
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer's warpgroup (one thread works)
// setmaxnreg: 128 x 40 + 256 x 232; 9 warps an SM would cap every thread at
// 168 and spill two x blocks' sums
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kXBox = BN * 128;            // a [128 rows, 64 bf16] x box
constexpr int kAcc = BN / 2;               // a thread's share of its warpgroup's 64 x BN
constexpr int kVecs = kAcc / 4;            // 16-byte accumulator vectors of a 64 x BN block
constexpr int kSmem = 232448 - 2048;       // dynamic shared memory, beside the barriers

// A stage: the weights' box, their scales, then NX x 2 x boxes (rows 128 xb,
// columns 64 h at box 2 xb + h).
template <bool PACKED, int NX>
struct Geo {
  static constexpr int wrow = PACKED ? BK / 2 : BK;  // weight bytes of a row a stage
  static constexpr int soff = BM * wrow;             // the scales [BM rows, 4 f32]
  static constexpr int xoff = soff + BM * 16;        // the x boxes (1024-aligned)
  static constexpr int stage = xoff + 2 * NX * kXBox;
  static constexpr int depth = (kSmem - 1024) / stage;  // 4, 5 (NX 1); 2, 3 (NX 2)
  static constexpr int smem = depth * stage + 1024;     // + the ring's alignment
};

// This thread's A fragments of a stage's 8 steps: weight rows r0 = wg 64 +
// warp 16 + g and r0 + 8 of the tile, columns 2q, 2q + 1 (a[.][0], a[.][1])
// and 2q + 8, 2q + 9 (a[.][2], a[.][3]) of each step, dequantized by the
// scale of their 32-column block. r0 % 8 == g, so both rows share the
// swizzle's chunk permutation.
template <bool PACKED>
__device__ __forceinline__ void load_frags(uint32_t st, int wg, uint32_t (&af)[8][4]) {
  using G = Geo<PACKED, 1>;
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;
  float s0[4], s8[4];
  rtc::lds128f(s0, st + G::soff + r0 * 16);
  rtc::lds128f(s8, st + G::soff + (r0 + 8) * 16);
  const uint32_t a0 = st + r0 * G::wrow, a8 = a0 + 8 * G::wrow;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t raw0, raw8;
    if constexpr (!PACKED) {
      // bytes 2q, 2q + 1 | 2q + 8, 2q + 9 of 16-byte chunk k (at k ^ g): the
      // halves of words q / 2 and q / 2 + 2
      const uint32_t off = static_cast<uint32_t>(((k ^ g) << 4) + 4 * (q >> 1));
      const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;
      raw0 = __byte_perm(lds32(a0 + off), lds32(a0 + off + 8), sel);
      raw8 = __byte_perm(lds32(a8 + off), lds32(a8 + off + 8), sel);
    } else {
      // bytes q and q + 4 of the step's 8 (64-byte rows: chunk k / 2 at
      // k / 2 ^ (r / 2) % 4 under the 64-byte swizzle)
      const uint32_t off = static_cast<uint32_t>((((k >> 1) ^ (g >> 1)) << 4) + 8 * (k & 1));
      const uint32_t sel = static_cast<uint32_t>(q | ((q + 4) << 4));
      uint32_t v[2];
      lds64(v, a0 + off);
      raw0 = __byte_perm(v[0], v[1], sel);
      lds64(v, a8 + off);
      raw8 = __byte_perm(v[0], v[1], sel);
    }
    dequant_block<PACKED>(raw0, s0[k >> 1], af[k][0], af[k][2]);
    dequant_block<PACKED>(raw8, s8[k >> 1], af[k][1], af[k][3]);
  }
}

// Element (h, c) of accumulator vector j of consumer thread ct of a tile:
// weight row o0 + (ct / 32) 16 + (ct % 32) / 4 + 8 h, x row t0 + 8 j + 2 (ct %
// 4) + c, d[4 j + 2 h + c] in the wgmma layout (vector j of x block j / 16 is
// its vector j % 16). y[t, o] f32, masked.
template <int NX>
__device__ __forceinline__ void store_vec(const float* v, int j, int tile, const Walk& w,
                                          float* __restrict__ y) {
  const int ct = threadIdx.x;
  const int o = (tile / w.tiles_m) * BM + (ct >> 5) * 16 + ((ct & 31) >> 2);
  const int t = (tile % w.tiles_m) * (NX * BN) + 8 * j + 2 * (ct & 3);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (t + c >= w.T) continue;
    float* yr = y + static_cast<long long>(t + c) * w.O;
    if (o < w.O) yr[o] = v[c];
    if (o + 8 < w.O) yr[o + 8] = v[2 + c];
  }
}

// A shared tile's partial sums: workspace slot (cta, slot) holds vector j of
// consumer thread ct at [j][ct] (coalesced 16-byte stores).
template <int NX>
__device__ __forceinline__ uint4* slot_ptr(uint4* ws, int cta, int slot) {
  return ws + static_cast<size_t>(cta * 2 + slot) * NX * kVecs * kConsumers + threadIdx.x;
}

template <bool PACKED, int NX>
__global__ void __launch_bounds__(kThreads, 1)
    bq_wgmma_kernel(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap ms,
                    const __grid_constant__ CUtensorMap mx, float* __restrict__ y,
                    uint4* __restrict__ ws, const Walk w) {
  using G = Geo<PACKED, NX>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[G::depth], empty[G::depth];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int i = 0; i < G::depth; ++i) {
      mbar_init(&full[i], 1);   // the producer's expect_tx, then TMA's bytes
      mbar_init(&empty[i], 2);  // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer's warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for_each_segment(w, [&](int t, int k0, int k1, int) {
        const int x0 = (t % w.tiles_m) * (NX * BN), o0 = (t / w.tiles_m) * BM;
        for (int k = k0; k < k1; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t st = ring + stage * G::stage;
          mbar_expect_tx(&full[stage], G::stage);  // OOB-filled bytes count too
          tma_load_2d(st, &mw, k * G::wrow, o0, &full[stage]);
          tma_load_2d(st + G::soff, &ms, k * (BK / 32), o0, &full[stage]);
#pragma unroll
          for (int b = 0; b < 2 * NX; ++b)
            tma_load_2d(st + G::xoff + b * kXBox, &mx, k * BK + 64 * (b & 1), x0 + BN * (b >> 1),
                        &full[stage]);
          if (++stage == G::depth) {
            stage = 0;
            phase ^= 1;
          }
        }
      });
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x >> 7;  // consumer warpgroup: tile weight rows wg * 64 ..
  const bool leader = (threadIdx.x & 127) == 0;
  int stage = 0;
  uint32_t phase = 0;
  for_each_segment(w, [&](int t, int k0, int k1, int slot) {
    float d[NX][kAcc];
#pragma unroll
    for (int b = 0; b < NX; ++b)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) d[b][i] = 0.f;
    int prev = -1;
    for (int k = k0; k < k1; ++k) {
      // The previous stage's products are done before this stage's
      // fragments are written: a register operand defined while any wgmma
      // is in flight makes ptxas serialize every wgmma.
      mbar_wait(&full[stage], phase);
      wg_wait<0>();
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      const uint32_t st = ring + stage * G::stage;
      uint32_t af[8][4];
      load_frags<PACKED>(st, wg, af);
      fence_frags(af);  // dequantized before the fence, not moved past it
#pragma unroll
      for (int b = 0; b < NX; ++b) fence_regs(d[b]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // 16 bf16 = 32 bytes of x a step, each x block
#pragma unroll
        for (int b = 0; b < NX; ++b)
          wgmma_bf16(d[b], af[kk],
                     smem_desc(st + G::xoff + (2 * b + (kk >> 2)) * kXBox) + 2 * (kk & 3), 1);
      wg_commit();
      prev = stage;
      if (++stage == G::depth) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    if (leader) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int b = 0; b < NX; ++b) fence_regs(d[b]);
    if (slot < 0) {
#pragma unroll
      for (int b = 0; b < NX; ++b)
#pragma unroll
        for (int j = 0; j < kVecs; ++j) store_vec<NX>(d[b] + 4 * j, b * kVecs + j, t, w, y);
    } else {
      uint4* p = slot_ptr<NX>(ws, blockIdx.x, slot);
#pragma unroll
      for (int b = 0; b < NX; ++b)
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          p[(b * kVecs + j) * kConsumers] =
              make_uint4(__float_as_uint(d[b][4 * j]), __float_as_uint(d[b][4 * j + 1]),
                         __float_as_uint(d[b][4 * j + 2]), __float_as_uint(d[b][4 * j + 3]));
    }
  });
}

// The second pass over the stream-K tiles, one block per (tile, vector j): a
// tile shared by CTAs c0..c1 is the sum of their partials in that order
// (their K order), stored as the kernel stores a whole tile.
template <int NX>
__global__ void __launch_bounds__(kConsumers)
    bq_wgmma_reduce(const uint4* __restrict__ ws, float* __restrict__ y, const Walk w) {
  const long long i0 = static_cast<long long>(blockIdx.x) * w.nk;
  const int c0 = w.owner(i0), c1 = w.owner(i0 + w.nk - 1);
  if (c0 == c1) return;  // one CTA did the whole tile and stored it
  const int j = blockIdx.y;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = c0; c <= c1; ++c) {
    const uint4 q =
        slot_ptr<NX>(const_cast<uint4*>(ws), c, w.begin(c) >= i0 ? 0 : 1)[j * kConsumers];
    if (c == c0) {
      v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
      v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
    } else {
      v[0] += __uint_as_float(q.x), v[1] += __uint_as_float(q.y);
      v[2] += __uint_as_float(q.z), v[3] += __uint_as_float(q.w);
    }
  }
  store_vec<NX>(v, j, w.tiles_dp + blockIdx.x, w, y);
}

// A 2-D row-major tensor [rows, cols] of `es`-byte elements as [box_rows,
// box_cols] boxes, zeros outside.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int es, const void* p, int cols, int rows,
             int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = f(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool PACKED, int NX>
int launch(const void* x, const void* qs, const float* s, float* y, uint4* ws, const Walk& w,
           int tiles_sk, cudaStream_t st) {
  using G = Geo<PACKED, NX>;
  CUtensorMap mw, ms, mx;
  int e = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs, w.K * G::wrow / BK, w.O, G::wrow, BM,
                   PACKED ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, w.K / 32, w.O, BK / 32, BM,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0)
    e = make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, w.K, w.T, 64, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const cudaError_t err = lt_allow_smem(bq_wgmma_kernel<PACKED, NX>, G::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bq_wgmma_kernel<PACKED, NX><<<w.ctas, kThreads, G::smem, st>>>(mw, ms, mx, y, ws, w);
  LT_RETURN_IF_ERROR();
  if (ws != nullptr)
    bq_wgmma_reduce<NX><<<dim3(tiles_sk, NX * kVecs), kConsumers, 0, st>>>(ws, y, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bqg

template <bool PACKED, int NX>
int run_wgmma(const void* x, const void* qs, const float* s, float* y, void* ws, int T, int O,
              int I, int ctas, int tiles_dp, cudaStream_t st) {
  if (I % bqg::BK || ctas < 1 || tiles_dp < 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(qs) |
       reinterpret_cast<uintptr_t>(s)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk w;
  w.T = T;
  w.O = O;
  w.K = I;
  w.tiles_m = (T + NX * bqg::BN - 1) / (NX * bqg::BN);
  w.nk = I / bqg::BK;
  w.tiles_dp = tiles_dp;
  w.ctas = ctas;
  const int tiles_sk = w.tiles_m * ((O + bqg::BM - 1) / bqg::BM) - tiles_dp;
  if (tiles_sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  w.total_sk = static_cast<long long>(tiles_sk) * w.nk;
  return bqg::launch<PACKED, NX>(x, qs, s, y, static_cast<uint4*>(ws), w, tiles_sk, st);
}

// T <= 32 bf16 rows on rowq_tc.cuh's block kinds, E_RAW, one pass.
template <typename Tag>
int run_tc(const void* x, const void* qs, const float* s, float* y, void* partial, int T, int O,
           int I, int g, int splits, int ksl, int ctas, cudaStream_t st) {
  rtc::Phase p = {};
  p.x = x;
  p.xkind = rtc::X_BF16;
  p.epi = lt::E_RAW;
  p.y = y;
  p.partial = static_cast<float*>(partial);
  p.T = T;
  p.O = O;
  p.I = I;
  p.g = g;
  p.splits = splits;
  p.ksl = ksl;
  p.ctas = ctas;
  return rtc::launch<false, Tag>(p, qs, O, st, s);
}

}  // namespace

// x [T, I] (x_dtype: bf16 or f32, the dot dtype), qs [O, I] int8 (packed:
// [O, I / 2]), s [O, I / 32] f32 -> y [T, O] f32, I % 32 == 0 and 16-byte
// aligned rows (the wrapper checks). `route`, as ops/quant_matmul.py
// block_route picks it, with its plan in a0..a3:
// - 0: the CUDA-core GEMV, a0 activation rows per block pass (1, 2, 4, 8);
// - 1: the CUDA-core tiled kernel;
// - 2: rowq_tc.cuh (bf16, T <= 32, I % 128 == 0), plan_tc's (g, splits,
//   ksl, ctas), scratch the slices' f32 sums where splits > 1;
// - 3: the wgmma GEMM (bf16, I % 128 == 0), plan_gemm's (ctas, tiles_dp) for
//   tiles of 128 weight rows and 128 a2 x rows (a2 = 1 or 2), scratch the
//   workspace [2 ctas, 128 * 128 a2] f32 where a tile is shared.
LT_EXPORT int lt_block_matmul(const void* x, int x_dtype, const void* qs, const void* s, void* y,
                              void* scratch, int T, int O, int I, int packed, int route, int a0,
                              int a1, int a2, int a3, void* stream) {
  if (T <= 0 || O <= 0 || I <= 0 || I % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(qs);
  const float* sc = static_cast<const float*>(s);
  float* out = static_cast<float*>(y);
  const bool f32 = x_dtype == LT_F32;
  if (route >= 2 && f32) return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case 0:
      if (packed)
        return f32 ? gemv_dispatch<true, LT_F32>(a0, x, x_dtype, q, sc, out, T, O, I, st)
                   : gemv_dispatch<true, LT_BF16>(a0, x, x_dtype, q, sc, out, T, O, I, st);
      return f32 ? gemv_dispatch<false, LT_F32>(a0, x, x_dtype, q, sc, out, T, O, I, st)
                 : gemv_dispatch<false, LT_BF16>(a0, x, x_dtype, q, sc, out, T, O, I, st);
    case 1:
      if (packed)
        return f32 ? gemm_launch<true, float>(x, x_dtype, q, sc, out, T, O, I, st)
                   : gemm_launch<true, __nv_bfloat16>(x, x_dtype, q, sc, out, T, O, I, st);
      return f32 ? gemm_launch<false, float>(x, x_dtype, q, sc, out, T, O, I, st)
                 : gemm_launch<false, __nv_bfloat16>(x, x_dtype, q, sc, out, T, O, I, st);
    case 2:
      return packed ? run_tc<rtc::K7>(x, q, sc, out, scratch, T, O, I, a0, a1, a2, a3, st)
                    : run_tc<rtc::K5>(x, q, sc, out, scratch, T, O, I, a0, a1, a2, a3, st);
    case 3:
      if (a2 == 2)
        return packed ? run_wgmma<true, 2>(x, q, sc, out, scratch, T, O, I, a0, a1, st)
                      : run_wgmma<false, 2>(x, q, sc, out, scratch, T, O, I, a0, a1, st);
      if (a2 == 1)
        return packed ? run_wgmma<true, 1>(x, q, sc, out, scratch, T, O, I, a0, a1, st)
                      : run_wgmma<false, 1>(x, q, sc, out, scratch, T, O, I, a0, a1, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
