// K10-K13: the grouped expert matmul of the MoE FFN, one design with four
// weight front ends.
//
// Replaces llamatpu/ops/moe_grouped.py `_gkernel` (K10: Q8_0 / Q4_0 values
// with f32 block scales), `_gkernel_packed4` (K11: Q4_0 packed two values per
// byte), `_gkernel_rowq` (K12: q8_row int8 with one f32 scale per out row)
// and `_gkernel_dense` (K13: bf16 / f32 weights). Each computes, for the
// expert-sorted rows of ops/moe_grouped.py `sort_by_expert`,
//
//   y[m, o] (f32) = sum_i  x[m, i].to(dt) * W_e[o, i]   with e = tile_expert[m / tm]
//
// where W_e is expert e's weight dequantized in f32 and rounded to the dot
// dtype dt (f32 for f32 activations, else bf16), as the TPU kernels do:
// K10 (q.f32 * s[o, i / 32]).to(dt) with the product rounded to nearest
// (__fmul_rn); K11 the same after the nibble unpack; K12 q.to(dt) (exact) and
// the row scale multiplying the f32 sum in the epilogue; K13 w.to(dt).
// Accumulation is f32. A tile whose expert is -1 (the tail past the last
// group) gives zeros; a pad row (row_token == n_tokens) is skipped and
// written as zero (its x row is the zero pad row, so that is its value).
//
// Bound on the H100: the weight stream of the experts the call uses. At
// Qwen1.5-MoE-A2.7B decode (one token, 4 routed + 4 folded shared experts)
// the fused gate/up call streams 8 x 2816 x 2048 weights, 51.9 MB as Q8_0
// (1.125 B/weight), ~15.5 us at 3.35 TB/s, and the down call half that; a
// 512-token prefill chunk touches all 64 experts (~623 MB a layer, ~186 us),
// above its ~72 us of bf16 tensor-core work.
//
// Design (first version): the grid is (O-block, m-block); a block reads its
// tile's expert and real-row count once, exits after zeroing its outputs when
// the tile is inactive, and otherwise streams rows [o0, o0 + rows) of that
// expert's weights once for all the tile's real rows. Two regimes, chosen by
// the tile size tm (the JAX package's rule: 8 at decode, 32 or 128 in prefill):
// - tm <= 8, GEMV (K5's and K1's inner loop, csrc/block_matmul.cu and
//   csrc/gemv.cuh): the tile's real rows sit in shared memory as f32; a warp
//   owns whole weight rows (grid-stride over the block's share of O), each
//   lane streams 4-byte words of its row, dequantizes them by front end and
//   multiplies them with the matching float4s of shared memory; the row sum
//   is a warp shuffle reduction. The per-tile weight base pointer is the only
//   new thing over K5.
// - tm >= 32, tiled (K5's `bq_gemm_kernel`): BM x 128 output tiles (BM = 32
//   or 64 rows inside one tile), K in steps of one 32-column block, the
//   activation tile rounded to dt and the weight tile dequantized by front
//   end into shared memory; warps of 32 x 32 sub-tiles take bf16
//   `mma.sync.m16n8k16` products with f32 accumulators, or FMAs over the same
//   fragment layout for f32. No cp.async pipeline, TMA or wgmma yet.
#include <type_traits>

#include "common.cuh"

LT_DEFINE_ERROR_STRING

namespace {

// weight front ends, mirrored by ops/moe_grouped.py
enum Kind { K_BLOCK = 0, K_PACKED = 1, K_ROWQ = 2, K_DENSE = 3 };

struct GArgs {
  const void* x;           // [Mp, I] activations (x_dtype)
  int x_dtype;
  const void* w;           // [E, O, I] int8 (packed: [E, O, I / 2]) or dense (w_dtype)
  int w_dtype;
  const float* s;          // [E, O, I / 32] block scales, or [E, O] row scales (K_ROWQ)
  const int* tile_expert;  // [Mp / tm]
  const int* row_token;    // [Mp] or null (every row real)
  int n_tokens;            // row_token == n_tokens marks a pad row
  float* y;                // [Mp, O] f32
  int Mp, O, I, tm;
};

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

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// bytes of one weight row, and of one expert's row scales
__device__ __forceinline__ long row_bytes(int kind, int w_dtype, int I) {
  if (kind == K_PACKED) return I >> 1;
  if (kind == K_DENSE) return static_cast<long>(I) * (w_dtype == LT_F32 ? 4 : 2);
  return I;
}

__device__ __forceinline__ int scales_per_row(int kind, int I) {
  return kind == K_ROWQ ? 1 : (kind == K_DENSE ? 0 : I >> 5);
}

// real rows of the `len` rows from m0, which are a prefix of them (pad rows
// follow the real ones inside every expert group); called by the whole
// block, every thread gets the count
__device__ __forceinline__ int real_rows(const GArgs& a, long m0, int len) {
  if (a.row_token == nullptr) return len;
  int total = 0;
  for (int r0 = 0; r0 < len; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    total += __syncthreads_count(r < len && a.row_token[m0 + r] < a.n_tokens);
  }
  return total;
}

// ------------------------------------------------------------------ GEMV
constexpr int kGemvThreads = 512;
constexpr int kGemvRows = 8;  // tm <= 8

// acc[t] += x[t, cols of word c] . W[row, cols of word c], front end KIND;
// a word is 4 columns (8 for K_PACKED)
template <int KIND, int DOT, int WDT>
__device__ __forceinline__ void gemv_word(const char* wrow, const float* srow, int c,
                                          const float* xs, int I, int nt,
                                          float (&acc)[kGemvRows]) {
  if (KIND == K_PACKED) {
    const int wv = __ldg(reinterpret_cast<const int*>(wrow) + c);
    const float sc = __ldg(srow + (c >> 2));  // columns 8c .. 8c + 7, block c / 4
    float w[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = byte_of(wv, k);
      w[2 * k] = lt_round(__fmul_rn(static_cast<float>(sext_lo4(p)), sc), DOT);
      w[2 * k + 1] = lt_round(__fmul_rn(static_cast<float>(p >> 4), sc), DOT);
    }
#pragma unroll
    for (int t = 0; t < kGemvRows; ++t) {
      if (t < nt) {
        const float4* xr = reinterpret_cast<const float4*>(xs + t * I);
        const float4 a = xr[2 * c], b = xr[2 * c + 1];
        acc[t] += a.x * w[0] + a.y * w[1] + a.z * w[2] + a.w * w[3] + b.x * w[4] +
                  b.y * w[5] + b.z * w[6] + b.w * w[7];
      }
    }
    return;
  }
  float w[4];
  if (KIND == K_DENSE) {
    if (WDT == LT_F32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(wrow) + c);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(wrow) + c);
      w[0] = bf16_bits(v.x & 0xffff), w[1] = bf16_bits(v.x >> 16);
      w[2] = bf16_bits(v.y & 0xffff), w[3] = bf16_bits(v.y >> 16);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = lt_round(w[k], DOT);
  } else {
    const int wv = __ldg(reinterpret_cast<const int*>(wrow) + c);
    if (KIND == K_ROWQ) {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = static_cast<float>(byte_of(wv, k));
    } else {
      const float sc = __ldg(srow + (c >> 3));  // columns 4c .. 4c + 3, block c / 8
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = lt_round(__fmul_rn(static_cast<float>(byte_of(wv, k)), sc), DOT);
    }
  }
#pragma unroll
  for (int t = 0; t < kGemvRows; ++t) {
    if (t < nt) {
      const float4 xv = reinterpret_cast<const float4*>(xs + t * I)[c];
      acc[t] += xv.x * w[0] + xv.y * w[1] + xv.z * w[2] + xv.w * w[3];
    }
  }
}

template <int KIND, int DOT, int WDT>
__global__ void __launch_bounds__(kGemvThreads) grouped_gemv_kernel(GArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [nt, I]
  const int tile = blockIdx.y;
  const long m0 = static_cast<long>(tile) * a.tm;
  const int e = a.tile_expert[tile];
  const int nt = e < 0 ? 0 : real_rows(a, m0, a.tm);
  const int I = a.I;
  for (int i = threadIdx.x; i < nt * I; i += blockDim.x)
    xs[i] = lt_round(lt_load(a.x, a.x_dtype, m0 * I + i), DOT);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long rb = row_bytes(KIND, WDT, I);
  const int spr = scales_per_row(KIND, I);
  const char* wexp = static_cast<const char*>(a.w) + static_cast<long>(e < 0 ? 0 : e) * a.O * rb;
  const float* sexp = a.s + static_cast<long>(e < 0 ? 0 : e) * a.O * spr;
  const int nwords = KIND == K_PACKED ? I >> 3 : I >> 2;
  for (int o = blockIdx.x * nwarps + (threadIdx.x >> 5); o < a.O; o += gridDim.x * nwarps) {
    float acc[kGemvRows];
#pragma unroll
    for (int t = 0; t < kGemvRows; ++t) acc[t] = 0.f;
    if (nt > 0) {
      const char* wrow = wexp + o * rb;
      const float* srow = sexp + static_cast<long>(o) * spr;
#pragma unroll 4
      for (int c = lane; c < nwords; c += 32) gemv_word<KIND, DOT, WDT>(wrow, srow, c, xs, I, nt, acc);
#pragma unroll
      for (int t = 0; t < kGemvRows; ++t) acc[t] = lt_warp_sum(acc[t]);
    }
    if (lane == 0) {
      const float rs = (KIND == K_ROWQ && nt > 0) ? __ldg(sexp + o) : 1.f;
      for (int t = 0; t < a.tm; ++t)
        a.y[(m0 + t) * a.O + o] = t < nt ? (KIND == K_ROWQ ? __fmul_rn(acc[t], rs) : acc[t]) : 0.f;
    }
  }
}

template <int KIND, int DOT, int WDT>
int gemv_launch(const GArgs& a, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.tm) * a.I * sizeof(float);
  cudaError_t err = lt_allow_smem(grouped_gemv_kernel<KIND, DOT, WDT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = a.Mp / a.tm;
  const int nwarps = kGemvThreads / 32;
  // about four blocks per SM in all: each block stages its tile's rows once
  const int want = (4 * lt_sm_count() + tiles - 1) / tiles;
  const int row_blocks = (a.O + nwarps - 1) / nwarps;
  dim3 grid(row_blocks < want ? row_blocks : want, tiles);
  grouped_gemv_kernel<KIND, DOT, WDT><<<grid, kGemvThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ tiled
constexpr int BN = 128, BK = 32;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 16 weights of row `go`, columns kb * 32 + h * 16 .. + 15, front end KIND
// (unrounded: the caller rounds to the dot dtype)
template <int KIND, int WDT>
__device__ __forceinline__ void tile_weights(const char* wexp, const float* sexp, long rb, int spr,
                                             int go, int kb, int h, float (&w)[16]) {
  const char* row = wexp + go * rb;
  if (KIND == K_DENSE) {
    if (WDT == LT_F32) {
      const float4* src = reinterpret_cast<const float4*>(row) + kb * 8 + h * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = __ldg(src + j);
        w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(row) + kb * 4 + h * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 v = __ldg(src + j);
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[8 * j + 2 * k] = bf16_bits(u[k] & 0xffff);
          w[8 * j + 2 * k + 1] = bf16_bits(u[k] >> 16);
        }
      }
    }
    return;
  }
  if (KIND == K_PACKED) {
    const float sc = __ldg(sexp + static_cast<long>(go) * spr + kb);
    const int2 raw = __ldg(reinterpret_cast<const int2*>(row + kb * 16 + h * 8));
    const int words[2] = {raw.x, raw.y};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = byte_of(words[j >> 2], j & 3);
      w[2 * j] = __fmul_rn(static_cast<float>(sext_lo4(p)), sc);
      w[2 * j + 1] = __fmul_rn(static_cast<float>(p >> 4), sc);
    }
    return;
  }
  const int4 raw = __ldg(reinterpret_cast<const int4*>(row + kb * 32 + h * 16));
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
  if (KIND == K_ROWQ) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = static_cast<float>(byte_of(words[j >> 2], j & 3));
  } else {
    const float sc = __ldg(sexp + static_cast<long>(go) * spr + kb);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j] = __fmul_rn(static_cast<float>(byte_of(words[j >> 2], j & 3)), sc);
  }
}

template <int KIND, typename DT, int WDT, int BM>
__global__ void __launch_bounds__(BM * 4) grouped_mma_kernel(GArgs a) {
  constexpr int NT = BM * 4;  // BM / 32 x 4 warps, a 32 x 32 sub-tile each
  constexpr int LD = std::is_same<DT, float>::value ? BK + 1 : BK + 8;
  __shared__ __align__(16) DT As[BM][LD];
  __shared__ __align__(16) DT Ws[BN][LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const long m0 = static_cast<long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int O = a.O, I = a.I;
  const int e = a.tile_expert[m0 / a.tm];
  const int nr = e < 0 ? 0 : real_rows(a, m0, BM);
  if (nr == 0) {  // an inactive tile or all pad rows: zeros
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, c = n0 + idx % BN;
      if (c < O) a.y[(m0 + r) * O + c] = 0.f;
    }
    return;
  }
  const long rb = row_bytes(KIND, WDT, I);
  const int spr = scales_per_row(KIND, I);
  const char* wexp = static_cast<const char*>(a.w) + static_cast<long>(e) * O * rb;
  const float* sexp = a.s + static_cast<long>(e) * O * spr;
  const int nb = I >> 5;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kb = 0; kb < nb; ++kb) {
    for (int idx = tid; idx < BM * BK; idx += NT) {  // activation tile, rounded to dt
      const int r = idx / BK, k = idx - r * BK;
      const float v = r < nr ? lt_load(a.x, a.x_dtype, (m0 + r) * I + kb * BK + k) : 0.f;
      As[r][k] = cvt_to<DT>(v);
    }
    for (int idx = tid; idx < BN * 2; idx += NT) {  // weight tile: (row r, half h)
      const int r = idx >> 1, h = idx & 1;
      const int go = n0 + r;
      float w[16];
      if (go < O) {
        tile_weights<KIND, WDT>(wexp, sexp, rb, spr, go, kb, h, w);
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
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 2]);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 2]);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 2 + 8]);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + g;
          bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[c][kk + tg * 2]);
          bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[c][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
      }
    } else {
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
        const int r = wm * 32 + mt * 16 + g + (hq >> 1) * 8;
        const int c = n0 + wn * 32 + nt * 8 + tg * 2 + (hq & 1);
        if (c < O) {
          float v = 0.f;
          if (r < nr) v = KIND == K_ROWQ ? __fmul_rn(acc[mt][nt][hq], __ldg(sexp + c))
                                         : acc[mt][nt][hq];
          a.y[(m0 + r) * O + c] = v;
        }
      }
    }
  }
}

template <int KIND, typename DT, int WDT>
int mma_launch(const GArgs& a, cudaStream_t st) {
  const int bm = a.tm % 64 == 0 ? 64 : 32;
  dim3 grid((a.O + BN - 1) / BN, a.Mp / bm);
  if (bm == 64)
    grouped_mma_kernel<KIND, DT, WDT, 64><<<grid, 256, 0, st>>>(a);
  else
    grouped_mma_kernel<KIND, DT, WDT, 32><<<grid, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int WDT>
int run(const GArgs& a, cudaStream_t st) {
  const bool f32 = a.x_dtype == LT_F32;
  if (a.tm <= kGemvRows)
    return f32 ? gemv_launch<KIND, LT_F32, WDT>(a, st) : gemv_launch<KIND, LT_BF16, WDT>(a, st);
  return f32 ? mma_launch<KIND, float, WDT>(a, st) : mma_launch<KIND, __nv_bfloat16, WDT>(a, st);
}

}  // namespace

// y[Mp, O] f32 = x[Mp, I] @ W[tile_expert[m / tm]]^T over expert-sorted rows.
// kind: 0 block quant (int8 values + f32 [E, O, I / 32] scales), 1 packed4,
// 2 q8_row (int8 + f32 [E, O] row scales), 3 dense (w_dtype). row_token may
// be null. tm <= 8 takes the GEMV, else tm % 32 == 0 and the tiled path.
// I % 32 == 0 and 16-byte aligned expert rows (the wrapper checks).
LT_EXPORT int lt_grouped_matmul(int kind, const void* x, int x_dtype, const void* w, int w_dtype,
                                const void* s, const void* tile_expert, const void* row_token,
                                int n_tokens, void* y, int Mp, int O, int I, int tm,
                                void* stream) {
  if (Mp <= 0 || O <= 0 || I <= 0 || I % 32 || tm <= 0 || Mp % tm ||
      (tm > kGemvRows && tm % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  GArgs a{x, x_dtype, w, w_dtype, static_cast<const float*>(s),
          static_cast<const int*>(tile_expert), static_cast<const int*>(row_token), n_tokens,
          static_cast<float*>(y), Mp, O, I, tm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case K_BLOCK: return run<K_BLOCK, LT_F32>(a, st);
    case K_PACKED: return run<K_PACKED, LT_F32>(a, st);
    case K_ROWQ: return run<K_ROWQ, LT_F32>(a, st);
    case K_DENSE:
      return w_dtype == LT_F32 ? run<K_DENSE, LT_F32>(a, st) : run<K_DENSE, LT_BF16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
