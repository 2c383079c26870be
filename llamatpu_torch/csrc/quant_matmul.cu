// K1: the q8_row projection at T < 128 (decode: the vocab head, one call per
// token and per prefill chunk; the batched step's wo, w13 and w2 where the
// fused tails decline).
//
// Replaces llamatpu/ops/pallas_matmul.py `_kernel_rowq` (and its stacked
// `_kernel_rowq_li` twin: a layer is the view qs[li] here, so one kernel takes
// a base pointer). Computes y[T, O] f32 = x[T, I] . qs[O, I]^T with x f32 or
// bf16, the int8 weights converted exactly, f32 accumulation; the per-row
// scale multiplies the output OUTSIDE the kernel, as on the TPU
// (pallas_matmul.py:155), so the weight stream is exactly 1.0 byte/weight.
//
// Bound on the H100: bytes. The llama32-1b head reads 128256 x 2048 int8 =
// 262.7 MB per call (~78 us at 3.35 TB/s); Phi-3-medium's w13 183.5 MB, w2
// 91.8 MB, wo 26.2 MB at every T <= 32.
//
// bf16 design: rowq_tc.cuh's tensor-core template with the E_RAW epilogue,
// on the plan of ops/ffn_fused.py plan_tc: each weight byte is read once for
// up to 32 rows (a split contraction adds a small second launch that sums
// the slices). 33 <= T < 128 rows (a short prefill chunk) run as
// ceil(T / 32) passes of near-equal rows, each pass reading the weights once;
// the passes are launches in stream order, and each pass's producer fills its
// ring while the pass before finishes (programmatic dependent launch).
// f32 x (no f32 tensor-core products) and widths that are not multiples of
// 16 (no TMA): gemv.cuh's tiled GEMV for T <= 32 (a warp per output row,
// read once for all rows), its row-pass GEMV above that.
#include "rowq_tc.cuh"

LT_DEFINE_ERROR_STRING

// x: [T, I] (x_dtype), qs: [O, I] int8, y: [T, O] f32. The route, as
// ops/quant_matmul.py `rowq_route` picks it:
// - splits > 0: rowq_tc.cuh, bf16 x, I % 16 == 0, `passes` launches of at
//   most 32 rows on the plan (g, splits, ksl, ctas) of the largest pass,
//   partial f32 scratch of its units' sums (plan_tc) where splits > 1;
// - maxt > 0: gemv.cuh's gemv_kernel, `maxt` rows a block pass (1, 2, 4 or
//   8; maxt * I * 4 bytes of shared memory);
// - otherwise gemv.cuh's tiled GEMV, T <= 32.
LT_EXPORT int lt_rowq_gemv(const void* x, int x_dtype, const void* qs, void* y, void* partial,
                           int T, int O, int I, int maxt, int g, int splits, int ksl, int ctas,
                           int passes, void* stream) {
  if (T < 1 || O < 1 || I % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lt;
  if (splits > 0) {
    if (x_dtype != LT_BF16 || I % 16 || passes < 1 || (T + passes - 1) / passes > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    rtc::Phase p = {};
    p.xkind = rtc::X_BF16;
    p.epi = E_RAW;
    p.partial = static_cast<float*>(partial);
    p.O = O;
    p.I = I;
    p.g = g;
    p.splits = splits;
    p.ksl = ksl;
    p.ctas = ctas;
    for (int k = 0; k < passes; ++k) {
      const long t0 = static_cast<long>(T) * k / passes, t1 = static_cast<long>(T) * (k + 1) / passes;
      p.x = static_cast<const __nv_bfloat16*>(x) + t0 * I;
      p.y = static_cast<float*>(y) + t0 * O;
      p.T = static_cast<int>(t1 - t0);
      const int e = rtc::launch<false, rtc::K1>(p, qs, O, s);
      if (e) return e;
    }
    return 0;
  }
  GemvArgs a = {};
  a.x = x;
  a.x_dtype = x_dtype;
  a.w = static_cast<const int8_t*>(qs);
  a.y = y;
  a.y_dtype = LT_F32;
  a.T = T;
  a.O = O;
  a.I = I;
  switch (maxt) {
    case 0:
      return x_dtype == LT_F32 ? gemv_tiled_launch<32, float, P_COPY, E_RAW>(a, s)
                               : gemv_tiled_launch<32, __nv_bfloat16, P_COPY, E_RAW>(a, s);
    case 1: return gemv_launch<1>(a, s);
    case 2: return gemv_launch<2>(a, s);
    case 4: return gemv_launch<4>(a, s);
    case 8: return gemv_launch<8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
