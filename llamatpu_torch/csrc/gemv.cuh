// The int8-weight GEMV shared by K1 (quant_matmul.cu) and K2/K3
// (layer_fused.cu): y[t, o] = epilogue( sum_i xs[t, i] * w[o, i] ).
//
// What bounds it on the H100: the weight stream. At decode (T = 1) every
// weight byte is used for one multiply-add, so the time floor is the int8
// matrix's bytes over the 3.35 TB/s of HBM3; the activations are a few KB.
// Design: the activation rows (after an optional rmsnorm prologue) sit in
// shared memory as f32, computed once per block; each warp owns whole weight
// rows (grid-stride), each lane streams 4-byte words of its row (a warp reads
// 128 contiguous bytes per load, unrolled 8 deep so enough bytes are in
// flight) and multiplies them with the matching float4 of the shared
// activations (contiguous across lanes: no bank conflicts); the row sum is a
// warp shuffle reduction. 16 warps per block and a grid capped at a few
// blocks per SM amortise the per-block prologue over many rows.
#pragma once

#include "common.cuh"

namespace lt {

enum Prologue { P_COPY = 0, P_RMSNORM = 1 };
enum Epilogue { E_RAW = 0, E_SCALE = 1, E_RESID = 2, E_RESID_OUT = 3, E_SILU_PAIR = 4 };

constexpr int kGemvThreads = 512;

struct GemvArgs {
  const void* x;        // [T, I] prologue input (x_dtype)
  int x_dtype;
  const float* norm_w;  // [I] f32, P_RMSNORM only
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

template <int MAXT, int PRO>
__device__ __forceinline__ void gemv_prologue(const GemvArgs& a, float* xs, int t0, int nt,
                                              float* red) {
  const int I = a.I;
  if (PRO == P_COPY) {
    for (int i = threadIdx.x; i < nt * I; i += blockDim.x)
      xs[i] = lt_load(a.x, a.x_dtype, static_cast<long>(t0) * I + i);
  } else {
    // h = round(x * rsqrt(mean(x^2) + eps) * w): f32 reduction, eps after the mean
    for (int t = 0; t < nt; ++t) {
      const long base = static_cast<long>(t0 + t) * I;
      float ss = 0.f;
      for (int i = threadIdx.x; i < I; i += blockDim.x) {
        const float v = lt_load(a.x, a.x_dtype, base + i);
        xs[t * I + i] = v;
        ss += v * v;
      }
      ss = lt_block_sum(ss, red);
      const float r = 1.0f / sqrtf(ss / static_cast<float>(I) + a.eps);
      for (int i = threadIdx.x; i < I; i += blockDim.x)
        xs[t * I + i] = lt_round(xs[t * I + i] * r * a.norm_w[i], a.dot_dtype);
    }
  }
  __syncthreads();
}

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

template <int MAXT, int PRO, int EPI>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(GemvArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [nt, I]
  __shared__ float red[32];
  const int t0 = blockIdx.y * MAXT;
  const int nt = min(MAXT, a.T - t0);
  gemv_prologue<MAXT, PRO>(a, xs, t0, nt, red);

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // E_SILU_PAIR: rows o (gate) and o + O/2 (up) go to the same warp
  const int rows = EPI == E_SILU_PAIR ? a.O / 2 : a.O;
  for (int o = blockIdx.x * nwarps + (threadIdx.x >> 5); o < rows; o += gridDim.x * nwarps) {
    float acc[MAXT];
    row_dot<MAXT>(a.w, o, xs, a.I, nt, acc);
    float up[MAXT];
    if (EPI == E_SILU_PAIR) row_dot<MAXT>(a.w, o + rows, xs, a.I, nt, up);
    if (lane != 0) continue;
    for (int t = 0; t < nt; ++t) {
      const long idx = static_cast<long>(t0 + t) * rows + o;
      // explicit _rn intrinsics: each product rounds before the add, as in
      // the JAX kernels (no FMA contraction of the epilogue)
      const float v = acc[t];
      if (EPI == E_RAW) {
        static_cast<float*>(a.y)[idx] = v;
      } else if (EPI == E_SCALE) {
        static_cast<float*>(a.y)[idx] = __fmul_rn(v, a.s[o]);
      } else if (EPI == E_SILU_PAIR) {  // act = round(gate * sigmoid(gate) * up)
        const float g = __fmul_rn(v, a.s[o]), u = __fmul_rn(up[t], a.s[o + rows]);
        static_cast<float*>(a.y)[idx] =
            lt_round(__fmul_rn(__fmul_rn(g, 1.0f / (1.0f + expf(-g))), u), a.dot_dtype);
      } else {  // x2 = res + (acc * s) * rs: f32 (E_RESID) or rounded to y (E_RESID_OUT)
        const float r = __fadd_rn(lt_load(a.res, a.res_dtype, idx),
                                  __fmul_rn(__fmul_rn(v, a.s[o]), a.rs));
        if (EPI == E_RESID)
          static_cast<float*>(a.y)[idx] = r;
        else
          lt_store(a.y, a.y_dtype, idx, r);
      }
    }
  }
}

// Rows of T handled per block pass, and its shared-memory need.
inline size_t gemv_smem(int maxt, int I) { return static_cast<size_t>(maxt) * I * sizeof(float); }

template <int MAXT, int PRO, int EPI>
inline int gemv_launch(const GemvArgs& a, cudaStream_t stream) {
  const int nwarps = kGemvThreads / 32;
  const size_t smem = gemv_smem(MAXT, a.I);
  cudaError_t e = lt_allow_smem(gemv_kernel<MAXT, PRO, EPI>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = EPI == E_SILU_PAIR ? a.O / 2 : a.O;
  const int row_blocks = (rows + nwarps - 1) / nwarps;
  const int cap = 4 * lt_sm_count();
  dim3 grid(row_blocks < cap ? row_blocks : cap, (a.T + MAXT - 1) / MAXT);
  gemv_kernel<MAXT, PRO, EPI><<<grid, kGemvThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt
