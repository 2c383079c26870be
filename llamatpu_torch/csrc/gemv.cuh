// The CUDA-core int8-weight GEMVs: y[t, o] = epilogue( sum_i xs[t, i] *
// w[o, i] ). gemv_kernel serves K1 (quant_matmul.cu) above 32 rows in f32 and
// at widths that are not multiples of 16; gemv_tiled_kernel (below) serves
// the f32 routes, and those at widths that are not multiples of 16, of K1,
// K2, K3, K9, K16 and K20, beside rowq_tc.cuh's tensor-core phases.
//
// What bounds it on the H100: the weight stream. At decode (T = 1) every
// weight byte is used for one multiply-add, so the time floor is the int8
// matrix's bytes over the 3.35 TB/s of HBM3; the activations are a few KB.
// gemv_kernel's design: the activation rows sit in shared memory as f32,
// copied once per block; each warp owns whole weight
// rows (grid-stride), each lane streams 4-byte words of its row (a warp reads
// 128 contiguous bytes per load, unrolled 8 deep so enough bytes are in
// flight) and multiplies them with the matching float4 of the shared
// activations (contiguous across lanes: no bank conflicts); the row sum is a
// warp shuffle reduction, the raw sum stored (K1 scales outside). 16 warps
// per block and a grid capped at a few blocks per SM amortise the per-block
// copy over many rows.
#pragma once

#include "common.cuh"

namespace lt {

enum Prologue { P_COPY = 0, P_RMSNORM = 1 };
enum Epilogue { E_RAW = 0, E_SCALE = 1, E_RESID = 2, E_RESID_OUT = 3, E_SILU_PAIR = 4 };

constexpr int kGemvThreads = 512;

struct GemvArgs {
  const void* x;        // [T, I] prologue input (x_dtype)
  int x_dtype;
  const float* norm_w;  // [I] f32, P_RMSNORM only (gemv_tiled_kernel)
  float eps;
  int dot_dtype;        // activations are rounded to it (P_RMSNORM, E_SILU_PAIR)
  const int8_t* w;      // [O, I] int8, row-major, rows 4-byte aligned
  const float* s;       // [O] per-row scale (every epilogue but E_RAW)
  float rs;             // residual scale (E_RESID, E_RESID_OUT)
  const void* res;      // [T, O] residual (res_dtype)
  int res_dtype;
  void* y;              // [T, O] output (y_dtype); [T, O / 2] for E_SILU_PAIR
  int y_dtype;
  int T, O, I;
};

// acc[t] = sum_i xs[t, i] * w[row, i], reduced over the warp (every lane
// gets the sums).
template <int MAXT>
__device__ __forceinline__ void row_dot(const int8_t* w, long row, const float* xs, int I, int nt,
                                        float (&acc)[MAXT]) {
  const int lane = threadIdx.x & 31;
  const int* wrow = reinterpret_cast<const int*>(w + row * I);
  const int nwords = I >> 2;  // 4 int8 per word
#pragma unroll
  for (int t = 0; t < MAXT; ++t) acc[t] = 0.f;
#pragma unroll 8
  for (int c = lane; c < nwords; c += 32) {
    const int wv = __ldg(wrow + c);
    const float w0 = static_cast<float>(static_cast<int8_t>(wv & 0xff));
    const float w1 = static_cast<float>(static_cast<int8_t>((wv >> 8) & 0xff));
    const float w2 = static_cast<float>(static_cast<int8_t>((wv >> 16) & 0xff));
    const float w3 = static_cast<float>(static_cast<int8_t>(wv >> 24));
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (t < nt) {
        const float4 xv = reinterpret_cast<const float4*>(xs + t * I)[c];
        acc[t] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAXT; ++t) acc[t] = lt_warp_sum(acc[t]);
}

// The epilogue of output idx = t * rows + o from the raw row sum v (and, for
// E_SILU_PAIR, the up row's sum u); shared by gemv_kernel and
// gemv_tiled_kernel. Explicit _rn intrinsics: each product rounds before the
// add, as in the JAX kernels (no FMA contraction of the epilogue).
template <int EPI>
__device__ __forceinline__ void gemv_store(const GemvArgs& a, long idx, int o, int rows, float v,
                                           float u) {
  if (EPI == E_RAW) {
    static_cast<float*>(a.y)[idx] = v;
  } else if (EPI == E_SCALE) {
    static_cast<float*>(a.y)[idx] = __fmul_rn(v, a.s[o]);
  } else if (EPI == E_SILU_PAIR) {  // act = round(gate * sigmoid(gate) * up)
    const float g = __fmul_rn(v, a.s[o]), up = __fmul_rn(u, a.s[o + rows]);
    static_cast<float*>(a.y)[idx] =
        lt_round(__fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), up), a.dot_dtype);
  } else {  // x2 = res + (acc * s) * rs: f32 (E_RESID) or rounded to y (E_RESID_OUT)
    const float r = __fadd_rn(lt_load(a.res, a.res_dtype, idx),
                              __fmul_rn(__fmul_rn(v, a.s[o]), a.rs));
    if (EPI == E_RESID)
      static_cast<float*>(a.y)[idx] = r;
    else
      lt_store(a.y, a.y_dtype, idx, r);
  }
}

// K1's GEMV: raw sums (E_RAW) of MAXT rows a block pass.
template <int MAXT>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(GemvArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [nt, I]
  const int t0 = blockIdx.y * MAXT;
  const int nt = min(MAXT, a.T - t0);
  for (int i = threadIdx.x; i < nt * a.I; i += blockDim.x)
    xs[i] = lt_load(a.x, a.x_dtype, static_cast<long>(t0) * a.I + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int o = blockIdx.x * nwarps + (threadIdx.x >> 5); o < a.O; o += gridDim.x * nwarps) {
    float acc[MAXT];
    row_dot<MAXT>(a.w, o, xs, a.I, nt, acc);
    if (lane != 0) continue;
    for (int t = 0; t < nt; ++t)
      gemv_store<E_RAW>(a, static_cast<long>(t0 + t) * a.O + o, o, a.O, acc[t], 0.f);
  }
}

// Rows of T handled per block pass, and its shared-memory need.
inline size_t gemv_smem(int maxt, int I) { return static_cast<size_t>(maxt) * I * sizeof(float); }

template <int MAXT>
inline int gemv_launch(const GemvArgs& a, cudaStream_t stream) {
  const int nwarps = kGemvThreads / 32;
  const size_t smem = gemv_smem(MAXT, a.I);
  cudaError_t e = lt_allow_smem(gemv_kernel<MAXT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_blocks = (a.O + nwarps - 1) / nwarps;
  const int cap = 4 * lt_sm_count();
  dim3 grid(row_blocks < cap ? row_blocks : cap, (a.T + MAXT - 1) / MAXT);
  gemv_kernel<MAXT><<<grid, kGemvThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- The tiled GEMV (K9's first design, layer_fused.cu): T <= MAXT rows.
//
// gemv_kernel keeps whole activation rows in f32 shared memory and runs a
// grid row per MAXT rows, so at T rows it reads the weights T / MAXT times and
// at T = 32, F = 8192 the rows would not fit in shared memory. Here every warp
// owns one output row (E_SILU_PAIR: a gate row and its up row) for all T
// rows, so each weight byte is read once per call; the activations are staged
// in shared memory in the working dtype XT (float or bf16: they are rounded
// to it anyway), kTileK columns at a time, and the row sums stay in registers
// across the tiles. P_RMSNORM computes each row's rsqrt(mean(x^2) + eps) once
// per block (a warp per row) and applies it, times norm_w, while staging.
// Where I % 16 == 0 each lane loads 16 weight bytes at a time (a warp reads
// 512 contiguous bytes), and a thread stages its columns of all T rows with
// the loads issued together: a first version with 4-byte loads and a
// staging loop that waited on each load was 22% slower at T = 8 (PERF.md);
// loading the tile's weights into registers before staging measured slower
// (fewer warps resident). What remains is the activations' shared-memory
// reads and the CUDA-core FMAs, T per weight: tensor-core tiles are next.
constexpr int kTileThreads = 512;
constexpr int kTileK = 1024;

template <typename XT>
__device__ __forceinline__ XT to_xt(float v);
template <>
__device__ __forceinline__ float to_xt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_xt<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

template <typename XT>
__device__ __forceinline__ float4 load4(const XT* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
  return make_float4(l.x, l.y, h.x, h.y);
}

// acc[t] (+ up[t]) += xs[t, k..k+3] . the 4 int8 weights of word wv (uv)
template <int MAXT, typename XT, int EPI>
__device__ __forceinline__ void fma_word(int wv, int uv, const XT* xs, int k, int nt,
                                         float (&acc)[MAXT], float (&up)[MAXT]) {
  const float w0 = static_cast<float>(static_cast<int8_t>(wv & 0xff));
  const float w1 = static_cast<float>(static_cast<int8_t>((wv >> 8) & 0xff));
  const float w2 = static_cast<float>(static_cast<int8_t>((wv >> 16) & 0xff));
  const float w3 = static_cast<float>(static_cast<int8_t>(wv >> 24));
  float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
  if (EPI == E_SILU_PAIR) {
    u0 = static_cast<float>(static_cast<int8_t>(uv & 0xff));
    u1 = static_cast<float>(static_cast<int8_t>((uv >> 8) & 0xff));
    u2 = static_cast<float>(static_cast<int8_t>((uv >> 16) & 0xff));
    u3 = static_cast<float>(static_cast<int8_t>(uv >> 24));
  }
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    if (t < nt) {
      const float4 xv = load4<XT>(xs + t * kTileK + k);
      acc[t] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
      if (EPI == E_SILU_PAIR) up[t] += xv.x * u0 + xv.y * u1 + xv.z * u2 + xv.w * u3;
    }
  }
}

template <int MAXT, typename XT, int PRO, int EPI>
__global__ void __launch_bounds__(kTileThreads) gemv_tiled_kernel(GemvArgs a) {
  extern __shared__ float4 tile_smem4[];
  XT* xs = reinterpret_cast<XT*>(tile_smem4);  // [MAXT, kTileK]
  __shared__ float rstd[MAXT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nt = a.T, I = a.I;
  const int rows = EPI == E_SILU_PAIR ? a.O / 2 : a.O;
  const int o = blockIdx.x * nwarps + warp;
  const bool live = o < rows;
  if (PRO == P_RMSNORM) {
    for (int t = warp; t < nt; t += nwarps) {
      float ss = 0.f;
#pragma unroll 8
      for (int i = lane; i < I; i += 32) {
        const float v = lt_load(a.x, a.x_dtype, static_cast<long>(t) * I + i);
        ss += v * v;
      }
      ss = lt_warp_sum(ss);
      if (lane == 0) rstd[t] = 1.0f / sqrtf(ss / static_cast<float>(I) + a.eps);
    }
    __syncthreads();
  }
  float acc[MAXT], up[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) acc[t] = up[t] = 0.f;
  const int* wrow = reinterpret_cast<const int*>(a.w + static_cast<long>(live ? o : 0) * I);
  const int* urow = reinterpret_cast<const int*>(
      a.w + static_cast<long>(EPI == E_SILU_PAIR && live ? o + rows : 0) * I);
  const bool vec = (I & 15) == 0;  // rows start 16-byte aligned
  for (int k0 = 0; k0 < I; k0 += kTileK) {
    const int kt = min(kTileK, I - k0);
    // stage the tile: a thread's loads of all T rows are issued together
    for (int k = threadIdx.x; k < kt; k += blockDim.x) {
      float v[MAXT];
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
        if (t < nt) v[t] = lt_load(a.x, a.x_dtype, static_cast<long>(t) * I + k0 + k);
      const float nw = PRO == P_RMSNORM ? a.norm_w[k0 + k] : 1.f;
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < nt) {
          if (PRO == P_RMSNORM) v[t] = v[t] * rstd[t] * nw;
          xs[t * kTileK + k] = to_xt<XT>(v[t]);
        }
      }
    }
    __syncthreads();
    if (live) {
      const int* wt = wrow + (k0 >> 2);
      const int* ut = urow + (k0 >> 2);
      const int nvec = vec ? kt >> 4 : 0;  // 16-byte chunks of this tile's row
#pragma unroll 2
      for (int c = lane; c < nvec; c += 32) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wt) + c);
        int4 uv = make_int4(0, 0, 0, 0);
        if (EPI == E_SILU_PAIR) uv = __ldg(reinterpret_cast<const int4*>(ut) + c);
        fma_word<MAXT, XT, EPI>(wv.x, uv.x, xs, 16 * c, nt, acc, up);
        fma_word<MAXT, XT, EPI>(wv.y, uv.y, xs, 16 * c + 4, nt, acc, up);
        fma_word<MAXT, XT, EPI>(wv.z, uv.z, xs, 16 * c + 8, nt, acc, up);
        fma_word<MAXT, XT, EPI>(wv.w, uv.w, xs, 16 * c + 12, nt, acc, up);
      }
      for (int c = 4 * nvec + lane; c < (kt >> 2); c += 32)  // the rest, word by word
        fma_word<MAXT, XT, EPI>(__ldg(wt + c), EPI == E_SILU_PAIR ? __ldg(ut + c) : 0, xs,
                                4 * c, nt, acc, up);
    }
    __syncthreads();  // xs is restaged by the next tile
  }
  if (!live) return;
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    acc[t] = lt_warp_sum(acc[t]);
    if (EPI == E_SILU_PAIR) up[t] = lt_warp_sum(up[t]);
  }
  if (lane != 0) return;
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
    if (t < nt) gemv_store<EPI>(a, static_cast<long>(t) * rows + o, o, rows, acc[t], up[t]);
}

template <int MAXT, typename XT, int PRO, int EPI>
inline int gemv_tiled_launch(const GemvArgs& a, cudaStream_t stream) {
  if (a.T < 1 || a.T > MAXT || a.I % 4) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(MAXT) * kTileK * sizeof(XT);
  cudaError_t e = lt_allow_smem(gemv_tiled_kernel<MAXT, XT, PRO, EPI>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nwarps = kTileThreads / 32;
  const int rows = EPI == E_SILU_PAIR ? a.O / 2 : a.O;
  gemv_tiled_kernel<MAXT, XT, PRO, EPI>
      <<<(rows + nwarps - 1) / nwarps, kTileThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt
