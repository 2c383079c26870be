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
// bf16 design: two phases of rowq_tc.cuh's template (TMA ring of weight
// boxes, mma.sync with the int8 weights made exact bf16 as A and x as B,
// persistent CTAs over the plan's units, a split contraction's slices added
// in order by a small second launch): w13 with each unit's 16 gate rows and
// their 16 up rows (E_SILU_PAIR writes act in bf16), then w2 with the scale
// (E_SCALE); each launch's producers fill their rings while the launch
// before finishes (programmatic dependent launch).
// bf16 needs D and F to be multiples of 16 (TMA row strides); every shape
// the JAX fit admits is (its tiles are multiples of 128 rows).
// f32 design (an f32 dot needs f32 products, which the tensor cores do not
// give): the tiled CUDA-core GEMV of gemv.cuh: a warp per output row (w13: a
// gate row and its up row) reading it once for all T rows, the activations
// staged in shared memory 1024 columns at a time.
#include "rowq_tc.cuh"

LT_DEFINE_ERROR_STRING

namespace {

template <int MAXT>
int ffn_f32(const lt::GemvArgs& c, const lt::GemvArgs& d, cudaStream_t st) {
  const int e = lt::gemv_tiled_launch<MAXT, float, lt::P_COPY, lt::E_SILU_PAIR>(c, st);
  if (e) return e;
  return lt::gemv_tiled_launch<MAXT, float, lt::P_COPY, lt::E_SCALE>(d, st);
}

}  // namespace

// K20. x [T, D] (x_dtype; the working dtype is x's); w13 [2F, D], w2 [D, F]
// int8 with f32 row scales s13 [2F], s2 [D]; out [T, D] f32. The plan of
// ops/ffn_fused.py plan_tc for each phase (g, splits, ksl, ctas). bf16 x:
// D and F multiples of 16, act [T, F] bf16, partial f32 scratch of the larger
// split phase's units' sums (plan_tc). f32 x
// (gemv.cuh, plans unused): act [T, F] f32.
LT_EXPORT int lt_ffn_fused(const void* x, int x_dtype, const void* w13, const void* s13,
                           const void* w2, const void* s2, void* act, void* partial,
                           void* out, int T, int D, int F, int g13,
                           int splits13, int ksl13, int ctas13, int g2, int splits2, int ksl2,
                           int ctas2, void* stream) {
  if (T < 1 || T > 32 || D % 4 || F % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == LT_BF16) {
    if (D % 16 || F % 16 || splits13 < 1 || splits2 < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    rtc::Phase c = {};
    c.x = x;
    c.xkind = rtc::X_BF16;
    c.s = static_cast<const float*>(s13);
    c.y = act;
    c.epi = lt::E_SILU_PAIR;
    c.partial = static_cast<float*>(partial);
    c.T = T;
    c.O = F;
    c.I = D;
    c.up = F;
    c.g = g13;
    c.splits = splits13;
    c.ksl = ksl13;
    c.ctas = ctas13;
    int e = rtc::launch<true, rtc::K20>(c, w13, 2L * F, st);
    if (e) return e;
    rtc::Phase d = c;
    d.x = act;
    d.s = static_cast<const float*>(s2);
    d.y = out;
    d.epi = lt::E_SCALE;
    d.O = D;
    d.I = F;
    d.up = 0;
    d.g = g2;
    d.splits = splits2;
    d.ksl = ksl2;
    d.ctas = ctas2;
    return rtc::launch<false, rtc::K20>(d, w2, D, st);
  }
  if (x_dtype != LT_F32) return static_cast<int>(cudaErrorInvalidValue);
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
