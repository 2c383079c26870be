// The exact int8 mode's projection (`--impl int8`): ggml's Q8_0 x Q8_0 block
// dot. Activations are quantized per 32-block as ggml does, each block's
// int8 x int8 products are summed exactly in int32, and the sum is scaled by
// (weight block scale) x (activation block scale, rounded through f16):
//
//   y[t, o] = sum_b (sum_k q[t, b, k] * w[o, b, k]) * (s_w[o, b] * d_f16[t, b])
//
// Replaces no TPU kernel: the JAX package computes this as an XLA
// `dot_general` (llamatpu/ops/int8_matmul.py:22-69). PyTorch on CUDA has no
// int32 matmul, and a plain torch version either materialises the
// [NB, T, O] block products or recasts the whole weight to a float type
// every call, so the port gives it a kernel of its own.
//
// Bound on the H100: bytes. It reads K5's bytes for the same weight: the
// int8 values and the f32 block scales once (the Llama-3.2-1B head: 262.7 MB
// + 32.8 MB, 0.088 ms at 3.35 TB/s), for T <= 16 rows.
//
// Design (a simple kernel that is right, not yet a fast one):
// - q8_quantize_kernel: one warp per (row, 32-block); the block's amax by
//   warp shuffles, then ggml's order with no contraction: d = amax / 127
//   (IEEE division), inv = 1 / d where d > 0, s = x * inv, q = trunc(s +
//   copysign(0.5, s)) (round half away from zero), d stored through f16
//   (subnormals included). The __f*_rn intrinsics keep nvcc from fusing a
//   product into the following add.
// - q8_dot_kernel: one warp per output row o and group of rows; lane pairs
//   own one 32-byte block, each lane 16 bytes (one int4 load of the weights,
//   read once for all the group's rows), four __dp4a per row, the pair's
//   sums added by a shuffle: the block's int32 sum, exact (|sum| <= 32 *
//   127 * 127). The even lane multiplies it by s_w * d in f32 (products
//   rounded as the plain version rounds them) and adds it to its row's f32
//   sum; a warp sum at the end. Sums are taken in another order than the
//   plain version's, so the two agree to rounding; a case whose every
//   partial sum is exact agrees bit for bit.
// - Grouped rows (the MoE experts): group g's rows read expert experts[g]
//   of a stacked weight (w_stride / s_stride elements apart); one row a
//   group, any number of groups.
#include "common.cuh"

#include <cuda_fp16.h>

LT_DEFINE_ERROR_STRING

namespace {

constexpr int WARPS = 8;  // output rows (warps) a CTA of q8_dot_kernel

__global__ void __launch_bounds__(WARPS * 32)
q8_quantize_kernel(const void* x, int x_dtype, int8_t* xq, float* xd, long blocks, int I) {
  const long blk = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= blocks) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int nb = I / 32;
  const long i = (blk / nb) * I + (blk % nb) * 32 + lane;
  const float v = lt_load(x, x_dtype, i);
  const float amax = lt_warp_max(fabsf(v));
  const float d = __fdiv_rn(amax, 127.0f);
  const float inv = d > 0.f ? __fdiv_rn(1.0f, d) : 0.f;
  const float s = __fmul_rn(v, inv);
  xq[i] = static_cast<int8_t>(__float2int_rz(__fadd_rn(s, copysignf(0.5f, s))));
  if (lane == 0) xd[blk] = __half2float(__float2half_rn(d));
}

__device__ __forceinline__ int dot16(int4 a, int4 b) {
  int s = __dp4a(a.x, b.x, 0);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
q8_dot_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xd,
              const int8_t* __restrict__ qs, const float* __restrict__ scales,
              const int* __restrict__ experts, long w_stride, long s_stride,
              float* __restrict__ y, int tg, int O, int I) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (o >= O) return;
  const int nb = I / 32;
  const long e = experts ? experts[blockIdx.y] : 0;
  const int8_t* wrow = qs + e * w_stride + static_cast<long>(o) * I;
  const float* srow = scales + e * s_stride + static_cast<long>(o) * nb;
  const long r0 = static_cast<long>(blockIdx.y) * tg;  // the group's first row
  const int half = lane & 1;
  float acc[MT];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc[t] = 0.f;
  for (int b0 = 0; b0 < nb; b0 += 16) {
    const int b = b0 + (lane >> 1);
    const bool live = b < nb;
    int4 w4 = make_int4(0, 0, 0, 0);
    float sw = 0.f;
    if (live) {
      w4 = __ldg(reinterpret_cast<const int4*>(wrow + b * 32 + half * 16));
      sw = __ldg(srow + b);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t >= tg) break;  // uniform across the warp
      const long r = r0 + t;
      int4 x4 = make_int4(0, 0, 0, 0);
      if (live) x4 = __ldg(reinterpret_cast<const int4*>(xq + r * I + b * 32 + half * 16));
      int s = dot16(w4, x4);
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the block's int32 sum
      if (live && !half) {
        const float c = __fmul_rn(sw, __ldg(xd + r * nb + b));
        acc[t] = __fadd_rn(acc[t], __fmul_rn(static_cast<float>(s), c));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (t >= tg) break;
    const float v = lt_warp_sum(acc[t]);
    if (lane == 0) y[(r0 + t) * O + o] = v;
  }
}

template <int MT>
int dot_launch(const int8_t* xq, const float* xd, const int8_t* qs, const float* scales,
               const int* experts, long w_stride, long s_stride, float* y, int groups, int tg,
               int O, int I, cudaStream_t s) {
  const dim3 grid((O + WARPS - 1) / WARPS, groups);
  q8_dot_kernel<MT><<<grid, WARPS * 32, 0, s>>>(xq, xd, qs, scales, experts, w_stride,
                                                s_stride, y, tg, O, I);
  LT_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// x: [groups * tg, I] (x_dtype: f32 or bf16), xq: [groups * tg, I] int8 and
// xd: [groups * tg, I / 32] f32 scratch, qs: int8 [.., O, I] and scales f32
// [.., O, I / 32] (experts null: one weight; else group g reads the weight
// at experts[g] * w_stride / s_stride), y: [groups * tg, O] f32. tg <= 16
// rows a group; I % 32 == 0 and 16-byte aligned rows (the wrapper checks).
LT_EXPORT int lt_int8_dot(const void* x, int x_dtype, void* xq, void* xd, const void* qs,
                          const void* scales, const void* experts, long long w_stride,
                          long long s_stride, void* y, int groups, int tg, int O, int I,
                          void* stream) {
  if (groups < 1 || groups > 65535 || tg < 1 || tg > 16 || O < 1 || I < 32 || I % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long blocks = static_cast<long>(groups) * tg * (I / 32);
  q8_quantize_kernel<<<static_cast<unsigned>((blocks + WARPS - 1) / WARPS), WARPS * 32, 0, s>>>(
      x, x_dtype, static_cast<int8_t*>(xq), static_cast<float*>(xd), blocks, I);
  LT_RETURN_IF_ERROR();
  const auto* q = static_cast<const int8_t*>(xq);
  const auto* d = static_cast<const float*>(xd);
  const auto* w = static_cast<const int8_t*>(qs);
  const auto* sc = static_cast<const float*>(scales);
  const auto* ex = static_cast<const int*>(experts);
  auto* out = static_cast<float*>(y);
  const int mt = tg <= 1 ? 1 : tg <= 2 ? 2 : tg <= 4 ? 4 : tg <= 8 ? 8 : 16;
  switch (mt) {
    case 1: return dot_launch<1>(q, d, w, sc, ex, w_stride, s_stride, out, groups, tg, O, I, s);
    case 2: return dot_launch<2>(q, d, w, sc, ex, w_stride, s_stride, out, groups, tg, O, I, s);
    case 4: return dot_launch<4>(q, d, w, sc, ex, w_stride, s_stride, out, groups, tg, O, I, s);
    case 8: return dot_launch<8>(q, d, w, sc, ex, w_stride, s_stride, out, groups, tg, O, I, s);
    default:
      return dot_launch<16>(q, d, w, sc, ex, w_stride, s_stride, out, groups, tg, O, I, s);
  }
}
