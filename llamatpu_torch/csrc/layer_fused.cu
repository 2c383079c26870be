// K2, K3 and K9: the fused calls of a q8_row decode layer.
//
// K2 replaces llamatpu/ops/layer_fused.py `_qkv_kernel`: h = rmsnorm(x) *
// attn_norm[li], rounded to the working dtype, then y = (h . wqkv[li]^T) * s,
// for T <= 32 rows (the lanes of a batched decode step). Bound on the H100:
// bytes (3072 x 2048 int8 = 6.3 MB per llama32-1b layer, ~1.9 us; 7680 x 5120
// = 39.3 MB at Phi-3-medium, ~11.7 us) at every T <= 32. rmsnorm needs whole
// rows of x before any product, and at Phi-3-medium width 24 rows of x (240
// KB in bf16) do not fit one CTA's shared memory, so the contraction is
// split across CTAs. bf16 design: two launches in stream order. A small
// phase writes h [T, D] in bf16 (a block a row: f32 sum of squares, eps
// after the mean, (x . rstd) . nw rounded once), then rowq_tc.cuh's
// tensor-core template stages slices of h by bulk copies and applies the
// row scales (E_SCALE), each weight byte read once; under programmatic
// dependent launch its producers fill their rings with weights while the
// norm phase runs. (Norming whole rows in the GEMV's shared memory, where
// one CTA holds them, measured slower: PERF.md.) f32 x (no f32 tensor-core
// products), and widths that are not multiples of 16 (no TMA): gemv.cuh's
// tiled GEMV with the norm as its prologue, a warp per output row reading it
// once for all T rows.
//
// K3 replaces llamatpu/ops/layer_fused.py `_attn_tail_kernel` (megakernel
// v3): append this token's post-RoPE K|V row at `pos`; masked f32 GQA
// attention over s <= pos; wo + residual (f32 x2); rmsnorm; w13; silu * up;
// w2 + residual. Bound on the H100: bytes, ~54.5 MB of weights per llama32-1b
// layer plus 8 * (pos + 1) * 256 B of cache (~16.6 us at pos 512). On the TPU
// one sequential grid carried scratch from phase to phase; on Hopper rmsnorm
// needs all of x2 and w2 all of act, so the phases need grid-wide order.
// The first design (0.0775 ms at pos 512, PERF.md) ran four launches: a
// block per KV head for append + attention (8 of 132 SMs on Llama-3.2-1B),
// then three CUDA-core GEMV phases, each waiting for the one before. This
// design, one C entry point, is K6's attention feeding K9's phases:
//   1. append + attention on attention.cu's cluster body (K6's
//      dense_cluster_kernel, included below in a namespace of its own):
//      clusters of CTAs per KV head, a TMA ring, the fused row write, pos
//      read from the device (so the host never needs it). Its output, aflat
//      in f32, is rounded to bf16 where the wo phase stages it (rowq_tc.cuh
//      X_F32), the TPU kernel's rounding point. The kernel triggers its
//      dependents at once: under programmatic dependent launch the wo
//      phase's producers fill their rings with weight boxes while the
//      attention runs (its CTAs take the SMs the clusters leave free);
//   2.-4. K9's three rowq_tc.cuh phases at T = 1 (wo with the residual and
//      the sums of squares, w13 on the rmsnorm of x2 with silu * up, w2 with
//      the residual out), tagged rtc::K3.
// f32 activations and widths that are not multiples of 16 keep gemv.cuh's
// tiled GEMV phases (K9's route) behind the same attention phase; their bf16
// staging rounds aflat.
//
// Numerics kept from the TPU kernel (layer_fused.py:454-567): the new KV row
// is cast to the cache dtype before it is attended; aflat, h and act are
// rounded to the working dtype; x2 stays f32; the output is cast to x's dtype;
// the cache is written only at `pos` (a pos outside [0, S) writes nothing and
// gives NaN, as K6).

// K9 replaces llamatpu/ops/layer_fused.py `_tail_kernel` (through
// `layer_tail_fused_rowq`): everything after attention for T <= 32 rows (the
// B lanes of a batched decode step): x2 = x + rs * (attn . wo^T) * so (f32);
// h = round(x2 * rsqrt(mean(x2^2) + eps) * ffn_norm); gate | up =
// (h . w13^T) * s13; act = round(gate * sigmoid(gate) * up) from the f32 gate
// and up; out = x2 + rs * (act . w2^T) * s2, cast to x's dtype ("round" = to
// the working dtype: f32 for f32 x, else bf16). Bound on the H100: the weight
// stream, wo 4.19 + w13 33.55 + w2 16.78 = 54.5 MB per llama32-1b layer
// (16.3 us) at every T <= 32. On the TPU one sequential grid carried x2, h,
// g13 and act in VMEM scratch from phase to phase; here rmsnorm needs all of
// x2 and w2 all of act, so the phases are three launches in stream order,
// the scratch (x2 f32, act, the per-16-row sums of squares of x2) in device
// buffers from the wrapper. bf16 design: rowq_tc.cuh's tensor-core template
// (TMA ring of weight boxes, mma.sync with the int8 weights made exact bf16
// as A and the activations as B, persistent CTAs over ops/ffn_fused.py
// plan_tc's units, a split contraction's slices added in order by a small
// second launch): wo with the residual (E_RESID, which also writes each 16-row block's
// sum of x2^2); w13 on h staged once a CTA and slice from x2 and those sums
// (X_F32_NORM), each unit 16 gate rows and their up rows (E_SILU_PAIR, act in
// bf16); w2 with the residual out (E_RESID_OUT). Each launch's producer fills
// its ring with weights while the phase before finishes (programmatic
// dependent launch). f32 activations (no f32 tensor-core
// products), and widths that are not multiples of 16 (no TMA), take the
// tiled GEMV of gemv.cuh: a warp per output row reads that row once for all
// T rows, the activations staged in shared memory 1024 columns at a time.

// K16 replaces llamatpu/ops/layer_fused.py `_tail_kernel_kt` (taken by
// `layer_tail_fused_rowq` when `_W2_KTILE` is set; scripts/sweep_tail.py
// times it against K9): K9's function with w2 streamed as contraction tiles
// [D, tf] into an f32 accumulator, out = x2 + rs * (sum_j act[:, j] .
// w2[:, j]^T) * s2 over the tiles j in order. Bound on the H100: K9's, the
// 54.5 MB weight stream per llama32-1b layer (16.3 us). On the TPU one core
// walked the tiles in order with the accumulator in VMEM; here the tiles run
// in parallel. The first design (0.1180 ms at T = 8, PERF.md) ran K9's
// first-design CUDA-core phases and a split-K w2 of its own. This design, for
// bf16 at widths that are multiples of 16: K9's rowq_tc.cuh phases, the w2
// phase on a plan whose contraction slices are the tiles (ops/layer_fused.py
// `kt_plan`: ksl = tf, splits = F / tf; tagged rtc::K16), the slices' sums
// added in slice order, the TPU kernel's tile order, by rowq_tc_reduce. f32,
// and widths that are not multiples of 16: gemv.cuh's wo and w13 phases,
// then a block per (16 rows of D, tile j): act's tile staged in shared
// memory in the working dtype, a warp per row of w2 reading its tf bytes of
// the tile, f32 partial sums [n_tiles, T, D], summed in tile order by a last
// pass that applies s2, rs and the residual.
#include "rowq_tc.cuh"

// K3's attention phase runs attention.cu's cluster body (K6's); the file is
// included here without its entry points, in a namespace of its own (its
// helpers share names with tc_gemv.cuh's)
#define LT_CLUSTER_BODY_ONLY
namespace ca {
#include "attention.cu"
}  // namespace ca
#undef LT_CLUSTER_BODY_ONLY

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kNormThreads = 256;

// K2's first phase: h[t] = round((x[t] . rsqrt(mean(x[t]^2) + eps)) . nw) in
// bf16, a block a row, 8 bf16 a thread and load (D % 16 == 0).
__global__ void __launch_bounds__(kNormThreads)
    qkv_rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ nw,
                       float eps, __nv_bfloat16* __restrict__ h, int D) {
  __shared__ float red[32];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x from the kernel before
  const long base = static_cast<long>(blockIdx.x) * D;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const int nv = D / 8;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += kNormThreads) {
    const uint4 v = xr[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      ss += f.x * f.x + f.y * f.y;
    }
  }
  ss = lt_block_sum(ss, red);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  uint4* hr = reinterpret_cast<uint4*>(h + base);
  for (int i = threadIdx.x; i < nv; i += kNormThreads) {
    const uint4 v = xr[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float4 na = __ldg(reinterpret_cast<const float4*>(nw) + 2 * i);
    const float4 nb = __ldg(reinterpret_cast<const float4*>(nw) + 2 * i + 1);
    const float n[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      o[j] = pack_bf16x2(__fmul_rn(__fmul_rn(f.x, r), n[2 * j]),
                         __fmul_rn(__fmul_rn(f.y, r), n[2 * j + 1]));
    }
    hr[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// K2. x [T, D] (x_dtype), norm_w [D] f32, qs [O, D] int8, s [O] f32 ->
// y [T, O] f32 (the wrapper casts it to x's dtype), T <= 32. The plan of
// ops/ffn_fused.py plan_tc (g, splits, ksl, ctas; splits = 0: gemv.cuh's
// route). Tensor-core route: bf16 x, D % 16 == 0, h [T, D] bf16 scratch,
// partial f32 scratch of the plan's units' sums where splits > 1; x, norm_w
// and qs 16-byte aligned.
LT_EXPORT int lt_qkv_norm(const void* x, int x_dtype, const void* norm_w, float eps,
                          const void* qs, const void* s, void* y, void* h, void* partial, int T,
                          int O, int D, int dot_dtype, int g, int splits, int ksl, int ctas,
                          void* stream) {
  if (T < 1 || T > 32 || D % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 0) {
    if (x_dtype != LT_BF16 || dot_dtype != LT_BF16 || D % 16 || h == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(T);
    cfg.blockDim = dim3(kNormThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t ce = cudaLaunchKernelEx(
        &cfg, qkv_rmsnorm_kernel, static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(norm_w), eps, static_cast<__nv_bfloat16*>(h), D);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    rtc::Phase p = {};
    p.x = h;
    p.xkind = rtc::X_BF16;
    p.s = static_cast<const float*>(s);
    p.y = y;
    p.epi = lt::E_SCALE;
    p.partial = static_cast<float*>(partial);
    p.T = T;
    p.O = O;
    p.I = D;
    p.g = g;
    p.splits = splits;
    p.ksl = ksl;
    p.ctas = ctas;
    return rtc::launch<false, rtc::K2>(p, qs, O, st);
  }
  lt::GemvArgs a = {};
  a.x = x;
  a.x_dtype = x_dtype;
  a.norm_w = static_cast<const float*>(norm_w);
  a.eps = eps;
  a.dot_dtype = dot_dtype;
  a.w = static_cast<const int8_t*>(qs);
  a.s = static_cast<const float*>(s);
  a.y = y;
  a.y_dtype = LT_F32;
  a.T = T;
  a.O = O;
  a.I = D;
  return dot_dtype == LT_F32
             ? lt::gemv_tiled_launch<32, float, lt::P_RMSNORM, lt::E_SCALE>(a, st)
             : lt::gemv_tiled_launch<32, __nv_bfloat16, lt::P_RMSNORM, lt::E_SCALE>(a, st);
}

namespace {

// ---------------------------------------------- K3's attention phase
// K6's dense cluster body into aflat [KV, G, vhd] f32; the kernel lets its
// dependents (the wo phase) launch at once
template <typename CT, int GM, int NP>
__global__ void __launch_bounds__(ca::kPagedThreads, GM * NP <= 16 ? 2 : 1)
    attn_tail_cluster_kernel(ca::ClusterArgs a) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  ca::cluster_attention<CT, false, true, false, GM, NP>(a, ca::StripeArgs{});
}

template <typename CT, int GM, int NP>
int attn_phase(const ca::ClusterArgs& a, cudaStream_t st) {
  const size_t smem =
      ca::cluster_smem<CT, false, GM>(a.G, a.hd, a.vhd, a.rows, a.cluster, ca::kPagedDepth);
  const cudaError_t e = cudaFuncSetAttribute(attn_tail_cluster_kernel<CT, GM, NP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster * a.KV, 1, 1);
  cfg.blockDim = dim3(ca::kPagedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, attn_tail_cluster_kernel<CT, GM, NP>, a));
}

template <typename CT>
int attn_phase_t(const ca::ClusterArgs& a, cudaStream_t st) {  // vhd <= 128: NP 1 or 2
  if (a.G == 1) return a.vhd <= 64 ? attn_phase<CT, 1, 1>(a, st) : attn_phase<CT, 1, 2>(a, st);
  if (a.G <= 4) return a.vhd <= 64 ? attn_phase<CT, 4, 1>(a, st) : attn_phase<CT, 4, 2>(a, st);
  return a.vhd <= 64 ? attn_phase<CT, 8, 1>(a, st) : attn_phase<CT, 8, 2>(a, st);
}

// ------------------------------------- the layer tail of K3, K9 and K16
// The scratch and weights of a tail: x2 [T, D] f32, act [T, F] (bf16 on
// the tensor cores, f32 on gemv.cuh), ssp [T, D / 16] f32 and the slices'
// sums (tensor cores), K16's tile partials (gemv.cuh).
struct Tail {
  const void* attn;  // [T, H]: x's dtype (K9, K16) or K3's f32 aflat
  int attn_dtype, x_dtype, dot_dtype;
  const void* x;     // [T, D] residual (x_dtype)
  const float* ffn_norm;
  float eps, rs;
  const void *wo, *w13, *w2;
  const float *so, *s13, *s2;
  void *x2, *act, *out;
  float *ssp, *partial;
  int T, D, H, F;
};

// rowq_tc.cuh's three phases, the plan of each (g, splits, ksl, ctas) from
// ops/ffn_fused.py plan_tc: x2 = x + rs * (attn . wo^T) * so, f32, and each
// 16-row block's sum of x2^2; h = round(rmsnorm(x2) * ffn_norm), act =
// round(silu(gate) * up), bf16; out = x2 + rs * (act . w2^T) * s2, cast to
// x's dtype. Tag names the caller's wo and w13 launches, W2 its w2 launch.
template <typename Tag, typename W2, int MAXT>
int tail_tc(const Tail& t, int xkind, const int* plan, cudaStream_t st) {
  rtc::Phase b = {};
  b.x = t.attn;
  b.xkind = xkind;
  b.s = t.so;
  b.rs = t.rs;
  b.res = t.x;
  b.res_dtype = t.x_dtype;
  b.y = t.x2;
  b.epi = lt::E_RESID;
  b.ssp_out = t.ssp;
  b.partial = t.partial;
  b.T = t.T;
  b.O = t.D;
  b.I = t.H;
  b.g = plan[0];
  b.splits = plan[1];
  b.ksl = plan[2];
  b.ctas = plan[3];
  int e = rtc::launch<false, Tag, MAXT>(b, t.wo, t.D, st);
  if (e) return e;
  rtc::Phase c = b;
  c.x = t.x2;
  c.xkind = rtc::X_F32_NORM;
  c.norm_w = t.ffn_norm;
  c.ssp_in = t.ssp;
  c.ssp_blocks = (t.D + rtc::kRows - 1) / rtc::kRows;
  c.eps = t.eps;
  c.s = t.s13;
  c.res = nullptr;
  c.y = t.act;
  c.epi = lt::E_SILU_PAIR;
  c.ssp_out = nullptr;
  c.O = t.F;
  c.I = t.D;
  c.up = t.F;
  c.g = plan[4];
  c.splits = plan[5];
  c.ksl = plan[6];
  c.ctas = plan[7];
  e = rtc::launch<true, Tag, MAXT>(c, t.w13, 2L * t.F, st);
  if (e) return e;
  rtc::Phase d = b;
  d.x = t.act;
  d.xkind = rtc::X_BF16;
  d.s = t.s2;
  d.res = t.x2;
  d.res_dtype = LT_F32;
  d.y = t.out;
  d.y_dtype = t.x_dtype;
  d.epi = lt::E_RESID_OUT;
  d.ssp_out = nullptr;
  d.I = t.F;
  d.g = plan[8];
  d.splits = plan[9];
  d.ksl = plan[10];
  d.ctas = plan[11];
  return rtc::launch<false, W2, MAXT>(d, t.w2, t.D, st);
}

// gemv.cuh's tiled GEMV phases of the same function (act f32): b wo, c w13,
// d w2
void tail_gemv_args(const Tail& t, lt::GemvArgs& b, lt::GemvArgs& c, lt::GemvArgs& d) {
  b = {};
  b.x = t.attn;
  b.x_dtype = t.attn_dtype;
  b.dot_dtype = t.dot_dtype;
  b.w = static_cast<const int8_t*>(t.wo);
  b.s = t.so;
  b.rs = t.rs;
  b.res = t.x;
  b.res_dtype = t.x_dtype;
  b.y = t.x2;
  b.y_dtype = LT_F32;
  b.T = t.T;
  b.O = t.D;
  b.I = t.H;
  c = {};
  c.x = t.x2;
  c.x_dtype = LT_F32;
  c.norm_w = t.ffn_norm;
  c.eps = t.eps;
  c.dot_dtype = t.dot_dtype;
  c.w = static_cast<const int8_t*>(t.w13);
  c.s = t.s13;
  c.y = t.act;
  c.y_dtype = LT_F32;
  c.T = t.T;
  c.O = 2 * t.F;
  c.I = t.D;
  d = {};
  d.x = t.act;
  d.x_dtype = LT_F32;
  d.dot_dtype = t.dot_dtype;
  d.w = static_cast<const int8_t*>(t.w2);
  d.s = t.s2;
  d.rs = t.rs;
  d.res = t.x2;
  d.res_dtype = LT_F32;
  d.y = t.out;
  d.y_dtype = t.x_dtype;
  d.T = t.T;
  d.O = t.D;
  d.I = t.F;
}

template <int MAXT, typename XT>
int tail_phases(const lt::GemvArgs& b, const lt::GemvArgs& c, const lt::GemvArgs& d,
                cudaStream_t st) {
  int e = lt::gemv_tiled_launch<MAXT, XT, lt::P_COPY, lt::E_RESID>(b, st);
  if (e) return e;
  e = lt::gemv_tiled_launch<MAXT, XT, lt::P_RMSNORM, lt::E_SILU_PAIR>(c, st);
  if (e) return e;
  return lt::gemv_tiled_launch<MAXT, XT, lt::P_COPY, lt::E_RESID_OUT>(d, st);
}

int tail_gemv(const Tail& t, cudaStream_t st) {
  lt::GemvArgs b, c, d;
  tail_gemv_args(t, b, c, d);
  if (t.dot_dtype == LT_F32)
    return t.T <= 8 ? tail_phases<8, float>(b, c, d, st) : tail_phases<32, float>(b, c, d, st);
  return t.T <= 8 ? tail_phases<8, __nv_bfloat16>(b, c, d, st)
                  : tail_phases<32, __nv_bfloat16>(b, c, d, st);
}

// the tensor-core route's inputs: bf16 x and working dtype, every width % 16
bool tc_ok(const Tail& t) {
  return t.x_dtype == LT_BF16 && t.dot_dtype == LT_BF16 && t.D % 16 == 0 && t.H % 16 == 0 &&
         t.F % 16 == 0;
}

Tail make_tail(const void* attn, int attn_dtype, int x_dtype, const void* x, const void* ffn_norm,
               float eps, float rs, const void* wo, const void* so, const void* w13,
               const void* s13, const void* w2, const void* s2, void* x2, void* act, void* ssp,
               void* partial, void* out, int T, int D, int H, int F, int dot_dtype) {
  Tail t = {};
  t.attn = attn;
  t.attn_dtype = attn_dtype;
  t.x_dtype = x_dtype;
  t.dot_dtype = dot_dtype;
  t.x = x;
  t.ffn_norm = static_cast<const float*>(ffn_norm);
  t.eps = eps;
  t.rs = rs;
  t.wo = wo;
  t.w13 = w13;
  t.w2 = w2;
  t.so = static_cast<const float*>(so);
  t.s13 = static_cast<const float*>(s13);
  t.s2 = static_cast<const float*>(s2);
  t.x2 = x2;
  t.act = act;
  t.out = out;
  t.ssp = static_cast<float*>(ssp);
  t.partial = static_cast<float*>(partial);
  t.T = T;
  t.D = D;
  t.H = H;
  t.F = F;
  return t;
}

}  // namespace

// K3. One decode layer after the qkv projection (B = 1, T = 1):
//   q [KV, G, hd], kvn [KV, hd + vhd] (x_dtype); kv: this layer's cache
//   [KV, S, hd + vhd] (cache_dtype f32 or bf16, 16-byte aligned), written at
//   pos, an int32 on the device; cluster, rows: ops/attention.py plan_dense's
//   plan of the attention phase; x [D] (x_dtype); ffn_norm [D] f32; wo [D,
//   KV*G*vhd], w13 [2F, D], w2 [D, F] int8 with f32 row scales so, s13, s2;
//   scratch aflat [KV*G*vhd] f32, x2 [D] f32, act [F] (bf16 on the tensor
//   cores, else f32), ssp [D / 16] f32 and the split phases' sums (tensor
//   cores); out [D] (x_dtype); the three phases' plans of plan_tc (splits_o
//   = 0: gemv.cuh's route).
LT_EXPORT int lt_attn_tail(const void* q, const void* kvn, int x_dtype, void* kv, int cache_dtype,
                           const void* pos, int S, int KV, int G, int hd, int vhd, float scale,
                           int cluster, int rows, const void* x, const void* ffn_norm, float eps,
                           float rs, const void* wo, const void* so, const void* w13,
                           const void* s13, const void* w2, const void* s2, void* aflat, void* x2,
                           void* act, void* ssp, void* partial, void* out, int D, int F,
                           int dot_dtype, int g_o, int splits_o, int ksl_o, int ctas_o, int g13,
                           int splits13, int ksl13, int ctas13, int g2, int splits2, int ksl2,
                           int ctas2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 8 || hd < 8 || vhd < 8 || hd % 8 || vhd % 8 || vhd > 128 ||
      hd + vhd > ca::kMaxW || KV < 1 || S < 1 || S > (1 << 30) ||
      (cache_dtype != LT_F32 && cache_dtype != LT_BF16) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || rows < 1 || rows > 32 ||
      32 % rows || S % rows || reinterpret_cast<uintptr_t>(kv) % 16 || D % 4 || F % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdim = KV * G * vhd;
  const int plan[12] = {g_o, splits_o, ksl_o, ctas_o, g13, splits13, ksl13, ctas13,
                        g2, splits2, ksl2, ctas2};
  const Tail t = make_tail(aflat, LT_F32, x_dtype, x, ffn_norm, eps, rs, wo, so, w13, s13, w2,
                           s2, x2, act, ssp, partial, out, 1, D, hdim, F, dot_dtype);
  if (splits_o > 0 && !tc_ok(t)) return static_cast<int>(cudaErrorInvalidValue);

  // 1. append + attention: aflat [KV, G, vhd] f32
  ca::ClusterArgs a = {};
  a.q = q;
  a.in_dtype = x_dtype;
  a.cache = kv;
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(aflat);
  a.kvn = kvn;
  a.kvn_dtype = x_dtype;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.vhd = vhd;
  a.S = S;
  a.cluster = cluster;
  a.rows = rows;
  a.scale = scale;
  int e = cache_dtype == LT_F32 ? attn_phase_t<float>(a, st) : attn_phase_t<__nv_bfloat16>(a, st);
  if (e) return e;
  // 2.-4. wo + residual, rmsnorm + w13 + silu * up, w2 + residual
  if (splits_o > 0) return tail_tc<rtc::K3, rtc::K3, 1>(t, rtc::X_F32, plan, st);
  return tail_gemv(t, st);
}

// K9. attn [T, H], x [T, D] (x_dtype); ffn_norm [D] f32; wo [D, H], w13
// [2F, D], w2 [D, F] int8 with f32 row scales so, s13, s2; scratch x2 [T, D]
// f32; out [T, D] (x_dtype). T <= 32. The plan of ops/ffn_fused.py plan_tc for
// each phase (g, splits, ksl, ctas; splits_o = 0: gemv.cuh's route).
// Tensor-core route: bf16 x, D, H and F multiples of 16, act [T, F] bf16, ssp
// [T, D / 16] f32, partial f32 scratch of the largest split phase's units'
// sums (plan_tc). gemv.cuh's route: act [T, F] f32.
LT_EXPORT int lt_tail(const void* attn, int x_dtype, const void* x, const void* ffn_norm,
                      float eps, float rs, const void* wo, const void* so, const void* w13,
                      const void* s13, const void* w2, const void* s2, void* x2, void* act,
                      void* ssp, void* partial, void* out, int T, int D, int H,
                      int F, int dot_dtype, int g_o, int splits_o, int ksl_o, int ctas_o,
                      int g13, int splits13, int ksl13, int ctas13, int g2, int splits2,
                      int ksl2, int ctas2, void* stream) {
  if (T < 1 || T > 32 || D % 4 || H % 4 || F % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int plan[12] = {g_o, splits_o, ksl_o, ctas_o, g13, splits13, ksl13, ctas13,
                        g2, splits2, ksl2, ctas2};
  const Tail t = make_tail(attn, x_dtype, x_dtype, x, ffn_norm, eps, rs, wo, so, w13, s13, w2,
                           s2, x2, act, ssp, partial, out, T, D, H, F, dot_dtype);
  if (splits_o > 0) {
    if (!tc_ok(t)) return static_cast<int>(cudaErrorInvalidValue);
    return tail_tc<rtc::K9, rtc::K9, 32>(t, rtc::X_BF16, plan, st);
  }
  return tail_gemv(t, st);
}

namespace {

// K16's w2 phase: partial[j, t, o] = sum over k in tile j of act[t, k] * w2[o, k]
// (act f32, already rounded to the working dtype XT), a warp per row o.
template <int MAXT, typename XT>
__global__ void __launch_bounds__(lt::kTileThreads) w2_ktile_kernel(const float* __restrict__ act,
                                                                     const int8_t* __restrict__ w2,
                                                                     float* __restrict__ partial,
                                                                     int T, int D, int F, int tf) {
  extern __shared__ float4 kt_smem4[];
  XT* xs = reinterpret_cast<XT*>(kt_smem4);  // [MAXT, kTileK], first tf columns used
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int o = blockIdx.x * nwarps + warp, j = blockIdx.y, k0 = j * tf;
  for (int k = threadIdx.x; k < tf; k += blockDim.x) {
#pragma unroll
    for (int t = 0; t < MAXT; ++t)
      if (t < T) xs[t * lt::kTileK + k] = lt::to_xt<XT>(act[static_cast<long>(t) * F + k0 + k]);
  }
  __syncthreads();
  if (o >= D) return;
  float acc[MAXT], unused[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) acc[t] = unused[t] = 0.f;
  const int4* wt = reinterpret_cast<const int4*>(w2 + static_cast<long>(o) * F + k0);
#pragma unroll 2
  for (int c = lane; c < (tf >> 4); c += 32) {
    const int4 wv = __ldg(wt + c);
    lt::fma_word<MAXT, XT, lt::E_RESID>(wv.x, 0, xs, 16 * c, T, acc, unused);
    lt::fma_word<MAXT, XT, lt::E_RESID>(wv.y, 0, xs, 16 * c + 4, T, acc, unused);
    lt::fma_word<MAXT, XT, lt::E_RESID>(wv.z, 0, xs, 16 * c + 8, T, acc, unused);
    lt::fma_word<MAXT, XT, lt::E_RESID>(wv.w, 0, xs, 16 * c + 12, T, acc, unused);
  }
#pragma unroll
  for (int t = 0; t < MAXT; ++t) acc[t] = lt_warp_sum(acc[t]);
  if (lane != 0) return;
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
    if (t < T) partial[(static_cast<long>(j) * T + t) * D + o] = acc[t];
}

// K16's last pass: out[t, o] = x2[t, o] + (sum_j partial[j, t, o]) * s2[o] * rs,
// the partials summed in tile order (K9's epilogue, gemv_store).
__global__ void ktile_sum_kernel(lt::GemvArgs a, const float* __restrict__ partial, int n_tiles) {
  const long n = static_cast<long>(a.T) * a.O;
  for (long idx = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int j = 0; j < n_tiles; ++j) v += partial[j * n + idx];
    lt::gemv_store<lt::E_RESID_OUT>(a, idx, static_cast<int>(idx % a.O), a.O, v, 0.f);
  }
}

template <int MAXT, typename XT>
int tail_kt_phases(const lt::GemvArgs& b, const lt::GemvArgs& c, const lt::GemvArgs& d,
                   float* partial, int tf, cudaStream_t st) {
  int e = lt::gemv_tiled_launch<MAXT, XT, lt::P_COPY, lt::E_RESID>(b, st);
  if (e) return e;
  e = lt::gemv_tiled_launch<MAXT, XT, lt::P_RMSNORM, lt::E_SILU_PAIR>(c, st);
  if (e) return e;
  const size_t smem = static_cast<size_t>(MAXT) * lt::kTileK * sizeof(XT);
  cudaError_t ce = lt_allow_smem(w2_ktile_kernel<MAXT, XT>, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int nwarps = lt::kTileThreads / 32;
  const int n_tiles = d.I / tf;
  dim3 grid((d.O + nwarps - 1) / nwarps, n_tiles);
  w2_ktile_kernel<MAXT, XT><<<grid, lt::kTileThreads, smem, st>>>(
      static_cast<const float*>(d.x), d.w, partial, d.T, d.O, d.I, tf);
  LT_RETURN_IF_ERROR();
  const long n = static_cast<long>(d.T) * d.O;
  const int blocks = static_cast<int>((n + 255) / 256);
  ktile_sum_kernel<<<blocks, 256, 0, st>>>(d, partial, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K16. lt_tail's arguments, plus the contraction tile tf (a multiple of 16,
// at most 1024, dividing F). Tensor-core route (splits_o > 0): the w2 plan's
// slices are the tiles (ksl2 = tf, splits2 = F / tf), partial holds the
// split phases' sums. gemv.cuh's route: partial [F / tf, T, D] f32.
LT_EXPORT int lt_tail_kt(const void* attn, int x_dtype, const void* x, const void* ffn_norm,
                         float eps, float rs, const void* wo, const void* so, const void* w13,
                         const void* s13, const void* w2, const void* s2, void* x2, void* act,
                         void* ssp, void* partial, void* out, int T, int D, int H, int F, int tf,
                         int dot_dtype, int g_o, int splits_o, int ksl_o, int ctas_o, int g13,
                         int splits13, int ksl13, int ctas13, int g2, int splits2, int ksl2,
                         int ctas2, void* stream) {
  if (T < 1 || T > 32 || D % 4 || H % 4 || tf % 16 || tf > lt::kTileK || tf < 16 || F % tf)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int plan[12] = {g_o, splits_o, ksl_o, ctas_o, g13, splits13, ksl13, ctas13,
                        g2, splits2, ksl2, ctas2};
  const Tail t = make_tail(attn, x_dtype, x_dtype, x, ffn_norm, eps, rs, wo, so, w13, s13, w2,
                           s2, x2, act, ssp, partial, out, T, D, H, F, dot_dtype);
  if (splits_o > 0) {
    if (!tc_ok(t) || ksl2 != tf || splits2 != F / tf)
      return static_cast<int>(cudaErrorInvalidValue);
    return tail_tc<rtc::K9, rtc::K16, 32>(t, rtc::X_BF16, plan, st);
  }
  lt::GemvArgs b, c, d;
  tail_gemv_args(t, b, c, d);
  float* p = t.partial;
  if (dot_dtype == LT_F32)
    return T <= 8 ? tail_kt_phases<8, float>(b, c, d, p, tf, st)
                  : tail_kt_phases<32, float>(b, c, d, p, tf, st);
  return T <= 8 ? tail_kt_phases<8, __nv_bfloat16>(b, c, d, p, tf, st)
                : tail_kt_phases<32, __nv_bfloat16>(b, c, d, p, tf, st);
}
