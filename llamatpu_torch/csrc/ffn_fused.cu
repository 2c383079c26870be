// K20 replaces llamatpu/ops/ffn_fused.py `_kernel` (through `ffn_fused_rowq`):
// the q8_row FFN of one layer for T <= 32 rows,
//   g13 = (x . w13^T) * s13            f32 (never rounded)
//   act = round(gate * sigmoid(gate) * up)   gate = g13[:, :F], up = g13[:, F:]
//   out = (act . w2^T) * s2            f32
// ("round" = to the working dtype: f32 for f32 x, else bf16).
//
// Bound on the H100: the weight stream. At Phi-3-medium width (D 5120, F
// 17920) one call reads 275.3 MB of int8 weights plus 0.2 MB of scales,
// 0.082 ms at 3.35 TB/s; its 13.2 GFLOP at T = 24 take 0.013 ms at the bf16
// tensor-core peak. The TPU kernel ran w13 and w2 as one sequential grid with
// g13 and act in VMEM scratch; here every output of the w2 phase needs all of
// act, so the two phases are two launches in stream order, act (T x F, 860 KB
// in bf16 at T = 24) passing through device memory, as K9's phases do.
//
// bf16 design (the dot of bf16 activations with int8 weights is exact in the
// tensor cores' f32 accumulate, so mma.sync m16n8k16 bf16 computes it):
// - a warp owns 16 weight rows (w13: 16 gate rows and their 16 up rows, so
//   the silu * up epilogue writes act directly) and reads each of them once
//   for all T rows: the weights are the mma's A operand (rows = outputs),
//   the activations its B operand (columns = the T rows, padded to NT * 8
//   with zeros);
// - a lane loads 16 contiguous weight bytes of its rows per 64-column step
//   (a warp reads 8 rows x 64 bytes), converts them exactly to bf16 and uses
//   them as the A fragments of four k16 mmas: the contraction index is
//   permuted the same way in A and B, so the lane's B fragments are the same
//   16 contiguous columns of its activation row (two 16-byte shared-memory
//   loads, conflict-free with an 8-element row pad);
// - the activations are staged in shared memory 512 columns at a time (x at
//   T = 24, D = 5120 is 240 KB, more than a block has), shared by the
//   block's 4 warps;
// - the w2 phase splits its contraction F into `ksplit` slices of blocks
//   (80 row blocks x 4 slices at D = 5120: enough blocks for 132 SMs), each
//   writing f32 partial sums; a last pass sums them in slice order
//   (deterministic) and applies s2.
// f32 design (an f32 dot needs f32 products, which the tensor cores do not
// give): the tiled CUDA-core GEMV of gemv.cuh (K9's phases): a warp per
// output row (w13: a gate row and its up row) reading it once for all T
// rows, the activations staged in shared memory 1024 columns at a time.
#include "gemv.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 16 * kWarps;
constexpr int kChunk = 512;  // activation columns staged per pass
constexpr int kPad = 8;      // bf16 pad per staged row: rows start 4 banks apart

// Signed byte k of w, sign-extended.
__device__ __forceinline__ int sbyte(int w, int k) { return (w << (24 - 8 * k)) >> 24; }

// Bytes k and k + 1 of w as two bf16 (exact: |v| <= 127), byte k in the low half.
__device__ __forceinline__ uint32_t bf16x2(int w, int k) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(sbyte(w, k)),
                                                 static_cast<float>(sbyte(w, k + 1)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of the four k16 steps of one 64-column step: bytes 4j..4j+3
// of the lane's 16 bytes of row g (r0) and row g + 8 (r8) go to step j as
// {a0, a1, a2, a3} = {r0 bytes 4j, 4j+1; r8 bytes 4j, 4j+1; r0 bytes 4j+2,
// 4j+3; r8 bytes 4j+2, 4j+3}: the logical k pairs (2q, 2q+1) and (2q+8,
// 2q+9) of the mma, q the lane's index in its quad.
__device__ __forceinline__ void a_frags(const int4& r0, const int4& r8, uint32_t (&a)[4][4]) {
  const int w0[4] = {r0.x, r0.y, r0.z, r0.w};
  const int w8[4] = {r8.x, r8.y, r8.z, r8.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = bf16x2(w0[j], 0);
    a[j][1] = bf16x2(w8[j], 0);
    a[j][2] = bf16x2(w0[j], 2);
    a[j][3] = bf16x2(w8[j], 2);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One phase of the bf16 path. x [T, K] bf16 (rows >= T read as zeros); w
// int8 [rows, K] (PAIR: [2 * rows, K], up row o + rows beside gate row o).
// Block (bx, by): rows [64 bx, 64 bx + 64) over the contraction slice by of
// gridDim.y. PAIR writes act [NT * 8, rows] bf16; otherwise partial
// [gridDim.y, NT * 8, rows] f32.
template <int NT, bool PAIR>
__global__ void __launch_bounds__(kWarps * 32)
    ffn_mma_kernel(const __nv_bfloat16* __restrict__ x, int T, int K,
                   const int8_t* __restrict__ w, const float* __restrict__ s, int rows,
                   __nv_bfloat16* __restrict__ act, float* __restrict__ partial) {
  __shared__ __align__(16) __nv_bfloat16 xs[NT * 8][kChunk + kPad];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int kper = K / gridDim.y, kbeg = blockIdx.y * kper;
  const long o = static_cast<long>(blockIdx.x) * kRowsPerBlock + warp * 16 + g;
  const int8_t* wg0 = w + o * K;
  const int8_t* wg8 = wg0 + 8L * K;
  const int8_t* wu0 = PAIR ? w + (o + rows) * K : wg0;
  const int8_t* wu8 = wu0 + 8L * K;
  float accg[NT][4], accu[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) accg[n][i] = accu[n][i] = 0.f;

  for (int c0 = kbeg; c0 < kbeg + kper; c0 += kChunk) {
    const int cw = min(kChunk, kbeg + kper - c0);
    const int vpr = cw >> 3;  // 16-byte vectors per staged row
    __syncthreads();          // the previous chunk is consumed
    for (int i = threadIdx.x; i < NT * 8 * vpr; i += blockDim.x) {
      const int r = i / vpr, c = (i - r * vpr) << 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < T) v = *reinterpret_cast<const uint4*>(x + static_cast<long>(r) * K + c0 + c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < cw; kk += 64) {
      const int col = c0 + kk + q * 16;
      const int4 g0 = __ldg(reinterpret_cast<const int4*>(wg0 + col));
      const int4 g8 = __ldg(reinterpret_cast<const int4*>(wg8 + col));
      int4 u0 = make_int4(0, 0, 0, 0), u8 = u0;
      if (PAIR) {
        u0 = __ldg(reinterpret_cast<const int4*>(wu0 + col));
        u8 = __ldg(reinterpret_cast<const int4*>(wu8 + col));
      }
      uint32_t ag[4][4], au[4][4];
      a_frags(g0, g8, ag);
      if (PAIR) a_frags(u0, u8, au);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4 lo = *reinterpret_cast<const uint4*>(&xs[n * 8 + g][kk + q * 16]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&xs[n * 8 + g][kk + q * 16 + 8]);
        const uint32_t b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(accg[n], ag[j], b[2 * j], b[2 * j + 1]);
          if (PAIR) mma_bf16(accu[n], au[j], b[2 * j], b[2 * j + 1]);
        }
      }
    }
  }
  // C fragment i of n-tile n: row o (+ 8 for i >= 2), activation row n * 8 +
  // 2q + (i & 1)
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long r = o + (i >= 2 ? 8 : 0);
      const int t = n * 8 + 2 * q + (i & 1);
      if (PAIR) {  // explicit _rn: each product rounds before the next, as in the JAX kernel
        const float gt = __fmul_rn(accg[n][i], s[r]), up = __fmul_rn(accu[n][i], s[r + rows]);
        act[static_cast<long>(t) * rows + r] =
            __float2bfloat16(__fmul_rn(__fmul_rn(gt, 1.0f / (1.0f + expf(-gt))), up));
      } else {
        partial[(static_cast<long>(blockIdx.y) * NT * 8 + t) * rows + r] = accg[n][i];
      }
    }
  }
}

// out[t, o] = (sum over the slices, in order, of partial[j, t, o]) * s2[o], t < T.
__global__ void ffn_finish_kernel(const float* __restrict__ partial, int ksplit, int tp, int T,
                                  int D, const float* __restrict__ s2, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * D) return;
  const int o = i % D;
  float acc = 0.f;
  for (int j = 0; j < ksplit; ++j) acc += partial[static_cast<long>(j) * tp * D + i];
  out[i] = __fmul_rn(acc, s2[o]);
}

template <int NT>
int ffn_bf16(const __nv_bfloat16* x, const int8_t* w13, const float* s13, const int8_t* w2,
             const float* s2, __nv_bfloat16* act, float* partial, float* out, int T, int D,
             int F, int ksplit, cudaStream_t st) {
  ffn_mma_kernel<NT, true><<<dim3(F / kRowsPerBlock, 1), kWarps * 32, 0, st>>>(
      x, T, D, w13, s13, F, act, nullptr);
  LT_RETURN_IF_ERROR();
  ffn_mma_kernel<NT, false><<<dim3(D / kRowsPerBlock, ksplit), kWarps * 32, 0, st>>>(
      act, NT * 8, F, w2, s2, D, nullptr, partial);
  LT_RETURN_IF_ERROR();
  ffn_finish_kernel<<<(T * D + 255) / 256, 256, 0, st>>>(partial, ksplit, NT * 8, T, D, s2, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXT>
int ffn_f32(const lt::GemvArgs& c, const lt::GemvArgs& d, cudaStream_t st) {
  const int e = lt::gemv_tiled_launch<MAXT, float, lt::P_COPY, lt::E_SILU_PAIR>(c, st);
  if (e) return e;
  return lt::gemv_tiled_launch<MAXT, float, lt::P_COPY, lt::E_SCALE>(d, st);
}

}  // namespace

// K20. x [T, D] (x_dtype; the working dtype is x's); w13 [2F, D], w2 [D, F]
// int8 with f32 row scales s13 [2F], s2 [D]; scratch act [Tp, F] in the
// working dtype (Tp = T rounded up to 8) and, for bf16, partial [ksplit, Tp,
// D] f32; out [T, D] f32. bf16 needs D % 64 == 0 and F % (64 * ksplit) == 0.
LT_EXPORT int lt_ffn_fused(const void* x, int x_dtype, const void* w13, const void* s13,
                           const void* w2, const void* s2, void* act, void* partial, void* out,
                           int T, int D, int F, int ksplit, void* stream) {
  if (T < 1 || T > 32 || D % 4 || F % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == LT_BF16) {
    if (D % kRowsPerBlock || F % kRowsPerBlock || ksplit < 1 || F % (64 * ksplit) ||
        partial == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* a13 = static_cast<const int8_t*>(w13);
    const auto* a2 = static_cast<const int8_t*>(w2);
    const auto* f13 = static_cast<const float*>(s13);
    const auto* f2 = static_cast<const float*>(s2);
    auto* ab = static_cast<__nv_bfloat16*>(act);
    auto* pf = static_cast<float*>(partial);
    auto* of = static_cast<float*>(out);
    switch ((T + 7) / 8) {
      case 1: return ffn_bf16<1>(xb, a13, f13, a2, f2, ab, pf, of, T, D, F, ksplit, st);
      case 2: return ffn_bf16<2>(xb, a13, f13, a2, f2, ab, pf, of, T, D, F, ksplit, st);
      case 3: return ffn_bf16<3>(xb, a13, f13, a2, f2, ab, pf, of, T, D, F, ksplit, st);
      default: return ffn_bf16<4>(xb, a13, f13, a2, f2, ab, pf, of, T, D, F, ksplit, st);
    }
  }
  // f32: act = round(silu(gate) * up) in f32 (a no-op rounding), then w2
  lt::GemvArgs c = {};
  c.x = x;
  c.x_dtype = LT_F32;
  c.dot_dtype = LT_F32;
  c.w = static_cast<const int8_t*>(w13);
  c.s = static_cast<const float*>(s13);
  c.y = act;
  c.y_dtype = LT_F32;
  c.T = T;
  c.O = 2 * F;
  c.I = D;
  lt::GemvArgs d = {};
  d.x = act;
  d.x_dtype = LT_F32;
  d.dot_dtype = LT_F32;
  d.w = static_cast<const int8_t*>(w2);
  d.s = static_cast<const float*>(s2);
  d.y = out;
  d.y_dtype = LT_F32;
  d.T = T;
  d.O = D;
  d.I = F;
  return T <= 8 ? ffn_f32<8>(c, d, st) : ffn_f32<32>(c, d, st);
}
