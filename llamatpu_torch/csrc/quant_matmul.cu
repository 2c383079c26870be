// K1: the q8_row projection at T < 128 (decode: the vocab head, one call per
// token and per prefill chunk).
//
// Replaces llamatpu/ops/pallas_matmul.py `_kernel_rowq` (and its stacked
// `_kernel_rowq_li` twin: a layer is the view qs[li] here, so one kernel takes
// a base pointer). Computes y[T, O] f32 = x[T, I] . qs[O, I]^T with x f32 or
// bf16, the int8 weights converted exactly, f32 accumulation; the per-row
// scale multiplies the output OUTSIDE the kernel, as on the TPU
// (pallas_matmul.py:155), so the weight stream is exactly 1.0 byte/weight.
//
// Bound on the H100: bytes. The llama32-1b head reads 128256 x 2048 int8 =
// 262.7 MB per call (~78 us at 3.35 TB/s); see gemv.cuh for what the design
// does about it (x in shared memory, warp-per-row 128-byte coalesced reads).
#include "gemv.cuh"

LT_DEFINE_ERROR_STRING

// x: [T, I] (x_dtype), qs: [O, I] int8, y: [T, O] f32. Rows of T are taken
// `maxt` at a time (1, 2, 4 or 8; maxt * I * 4 bytes of shared memory).
LT_EXPORT int lt_rowq_gemv(const void* x, int x_dtype, const void* qs, void* y, int T, int O,
                           int I, int maxt, void* stream) {
  lt::GemvArgs a = {};
  a.x = x;
  a.x_dtype = x_dtype;
  a.w = static_cast<const int8_t*>(qs);
  a.y = y;
  a.y_dtype = LT_F32;
  a.T = T;
  a.O = O;
  a.I = I;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace lt;
  switch (maxt) {
    case 1: return gemv_launch<1, P_COPY, E_RAW>(a, s);
    case 2: return gemv_launch<2, P_COPY, E_RAW>(a, s);
    case 4: return gemv_launch<4, P_COPY, E_RAW>(a, s);
    case 8: return gemv_launch<8, P_COPY, E_RAW>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
