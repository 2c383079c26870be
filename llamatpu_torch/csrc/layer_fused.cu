// K2, K3 and K9: the fused calls of a q8_row decode layer.
//
// K2 replaces llamatpu/ops/layer_fused.py `_qkv_kernel`: h = rmsnorm(x) *
// attn_norm[li], rounded to the working dtype, then y = (h . wqkv[li]^T) * s.
// Bound on the H100: bytes (3072 x 2048 int8 = 6.3 MB per llama32-1b layer,
// ~1.9 us). Design: gemv.cuh with the norm as its prologue; every block
// recomputes the norm of x (2048 values) instead of a second launch. At T
// rows (the lanes of a batched decode step) the grid has a row per token, so
// the weights are read T times; K9's tiled GEMV, which reads them once,
// measured no faster at 8 and 32 rows.
//
// K3 replaces llamatpu/ops/layer_fused.py `_attn_tail_kernel` (megakernel
// v3): append this token's post-RoPE K|V row at `pos`; masked f32 GQA
// attention over s <= pos; wo + residual (f32 x2); rmsnorm; w13; silu * up;
// w2 + residual. Bound on the H100: bytes, ~54.5 MB of weights per llama32-1b
// layer plus 8 * (pos + 1) * 256 B of cache (~16.6 us at pos 512). On the TPU
// one sequential grid carried scratch from phase to phase; on Hopper rmsnorm
// needs all of x2 and w2 needs all of act, so the phases need grid-wide order.
// Design of this version: one C entry point issuing four launches in stream
// order, the scratch (aflat, x2, act) in device buffers the wrapper allocates:
//   1. append + attention, one block per KV head (chunked online softmax);
//   2. wo + residual          (gemv.cuh, P_COPY + E_RESID, x2 in f32);
//   3. rmsnorm + w13 + silu * up (gemv.cuh, P_RMSNORM + E_SILU_PAIR: a warp
//      takes gate row o and up row o + F, so act is written once);
//   4. w2 + residual          (gemv.cuh, P_COPY + E_RESID_OUT).
// A persistent cooperative kernel with grid-wide barriers (one launch per
// layer) is later work.
//
// Numerics kept from the TPU kernel (layer_fused.py:454-567): the new KV row
// is cast to the cache dtype before it is attended; aflat, h and act are
// rounded to the working dtype; x2 stays f32; the output is cast to x's dtype;
// the cache is written only at `pos`.
//
// K9 replaces llamatpu/ops/layer_fused.py `_tail_kernel` (through
// `layer_tail_fused_rowq`): everything after attention for T <= 32 rows (the
// B lanes of a batched decode step): x2 = x + rs * (attn . wo^T) * so (f32);
// h = round(x2 * rsqrt(mean(x2^2) + eps) * ffn_norm); gate | up =
// (h . w13^T) * s13; act = round(gate * sigmoid(gate) * up) from the f32 gate
// and up; out = x2 + rs * (act . w2^T) * s2, cast to x's dtype ("round" = to
// the working dtype: f32 for f32 x, else bf16). Bound on the H100: the weight
// stream, wo 4.19 + w13 33.55 + w2 16.78 = 54.5 MB per llama32-1b layer
// (16.3 us) at every T <= 32. Design: K3's three tail phases generalized to T
// rows, one C entry point issuing three launches in stream order (the scratch
// x2 and act in device buffers from the wrapper), each the tiled GEMV of
// gemv.cuh: a warp per output row reads that row once for all T rows, 16
// bytes per lane and load, the activations staged in shared memory in the
// working dtype, 1024 columns at a time (at T = 32, f32 and F = 8192 a whole
// row set would not fit in 227 KB). Every row's activations are read from
// shared memory once per weight row, so the shared-memory traffic grows with
// T; a tensor-core tile would read them once per 16 rows (later work).
// On the TPU one sequential grid carried x2, h, g13 and act in VMEM scratch
// from phase to phase; here rmsnorm needs all of x2 and w2 all of act, so the
// phases are separate launches.
//
// K16 replaces llamatpu/ops/layer_fused.py `_tail_kernel_kt` (taken by
// `layer_tail_fused_rowq` when `_W2_KTILE` is set; scripts/sweep_tail.py
// times it against K9): K9's function with w2 streamed as contraction tiles
// [D, tf] into an f32 accumulator, out = x2 + rs * (sum_j act[:, j] .
// w2[:, j]^T) * s2 over the tiles j in order. Bound on the H100: K9's, the
// 54.5 MB weight stream per llama32-1b layer (16.3 us). On the TPU one core
// walked the tiles in order with the accumulator in VMEM; here the tiles run
// in parallel. Design: K9's wo and w13 launches, then a split-K w2 phase, a
// block per (16 rows of D, tile j): act's tile staged in shared memory in the
// working dtype, a warp per row of w2 reading its tf bytes of the tile (16
// per lane and load), writing f32 partial sums [n_tiles, T, D]; a last pass
// sums each output's partials in tile order (deterministic; it differs from
// K9 only in the f32 summation order) and applies s2, rs and the residual.
// The partials cost 4 * n_tiles * T * D bytes of writes and reads (1 MB at T
// = 32 on llama32-1b, against 16.8 MB of w2).
#include "gemv.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kAttnThreads = 512;
constexpr int kAttnChunk = 512;  // positions scored per pass (shared memory)
constexpr int kMaxG = 8;         // query heads per KV head
constexpr int kMaxPL = 4;        // head elements per lane: hd, vhd <= 128
constexpr int kVBatch = 4;       // V rows in flight per warp

template <typename CT>
__device__ __forceinline__ float to_f(CT v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename CT>
__device__ __forceinline__ CT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct AttnArgs {
  const void* q;    // [KV, G, hd] post-RoPE queries (q_dtype)
  const void* kvn;  // [KV, hd + vhd] post-RoPE packed K|V row (q_dtype)
  int q_dtype;
  void* kv;         // this layer's cache [KV, S, hd + vhd] (CT), written at pos
  int S, pos, G, hd, vhd;
  float scale;
  float* aflat;     // [KV * G * vhd] f32, values rounded to dot_dtype
  int dot_dtype;
};

inline size_t attn_smem_bytes(int G, int hd, int vhd, int nwarps) {
  return sizeof(float) * (G * hd + G * kAttnChunk + nwarps * G * vhd + 3 * G);
}

// One block per KV head (hd, vhd multiples of 32, <= 128; G <= 8). Scores
// of a chunk of positions (a thread per position) go to shared memory; their
// softmax statistics are updated online (running max / sum per query head);
// then warps take positions in turn, lane e of a warp holding elements
// lane + 32e of the head so each V row is one coalesced read, accumulate the
// weighted V rows in registers, and the warps' partial sums are added at the
// end. Cache reads use plain loads (not the read-only path): the block wrote
// row `pos` itself just before.
template <typename CT>
__global__ void __launch_bounds__(kAttnThreads) attn_append_kernel(AttnArgs a) {
  extern __shared__ float attn_smem[];
  const int G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const int vpl = vhd >> 5;
  const int kvh = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* qs = attn_smem;                 // [G, hd]
  float* p = qs + G * hd;                // [G, kAttnChunk] scores, then exp weights
  float* part = p + G * kAttnChunk;      // [nwarps, G, vhd] per-warp partial sums
  float* m = part + nwarps * G * vhd;    // [G] running max
  float* l = m + G;                      // [G] running sum
  float* alpha = l + G;                  // [G] rescale of this chunk
  CT* kv = static_cast<CT*>(a.kv) + static_cast<long>(kvh) * a.S * W;

  for (int i = tid; i < W; i += blockDim.x)
    kv[static_cast<long>(a.pos) * W + i] =
        from_f<CT>(lt_load(a.kvn, a.q_dtype, static_cast<long>(kvh) * W + i));
  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = lt_load(a.q, a.q_dtype, static_cast<long>(kvh) * G * hd + i);
  if (tid < G) {
    m[tid] = -1e30f;
    l[tid] = 0.f;
  }
  float acc[kMaxG][kMaxPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kMaxPL; ++e) acc[g][e] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 <= a.pos; c0 += kAttnChunk) {
    const int n = min(kAttnChunk, a.pos + 1 - c0);
    // scores: a thread per position, its K row read in 16-byte vectors, q . k
    // for every query head of this KV head (q reads are warp broadcasts)
    for (int j = tid; j < n; j += blockDim.x) {
      const CT* krow = kv + static_cast<long>(c0 + j) * W;
      constexpr int N = 16 / sizeof(CT);
      float d[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) d[g] = 0.f;
      for (int e0 = 0; e0 < hd; e0 += N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + e0);
        const CT* kvals = reinterpret_cast<const CT*>(&raw);
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const float k = to_f<CT>(kvals[u]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) d[g] += qs[g * hd + e0 + u] * k;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) p[g * kAttnChunk + j] = d[g] * a.scale;
    }
    __syncthreads();
    // online-softmax statistics, one warp per query head
    for (int g = warp; g < G; g += nwarps) {
      float* pg = p + g * kAttnChunk;
      float mx = -1e30f;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
      mx = lt_warp_max(mx);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = lt_warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m[g] - m_new);
        alpha[g] = al;
        l[g] = l[g] * al + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, v] = acc * alpha + sum over this warp's positions of p[g, j] * V[j, v]
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float al = alpha[g];
#pragma unroll
        for (int e = 0; e < kMaxPL; ++e) acc[g][e] *= al;
      }
    }
    // kVBatch positions per warp per step, their V rows loaded before use so
    // the loads are in flight together (a serial loop waits on each)
    for (int j0 = warp; j0 < n; j0 += nwarps * kVBatch) {
      float v[kVBatch][kMaxPL];
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int j = j0 + u * nwarps;
        const CT* vrow = kv + static_cast<long>(c0 + j) * W + hd;
#pragma unroll
        for (int e = 0; e < kMaxPL; ++e)
          v[u][e] = (j < n && e < vpl) ? to_f<CT>(vrow[lane + 32 * e]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int j = j0 + u * nwarps;
        if (j >= n) break;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pj = p[g * kAttnChunk + j];
#pragma unroll
            for (int e = 0; e < kMaxPL; ++e) acc[g][e] += pj * v[u][e];
          }
        }
      }
    }
    __syncthreads();  // p is rewritten by the next chunk
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kMaxPL; ++e)
      if (g < G && e < vpl) part[(warp * G + g) * vhd + lane + 32 * e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < G * vhd; idx += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += part[w * G * vhd + idx];
    a.aflat[static_cast<long>(kvh) * G * vhd + idx] =
        lt_round(s / fmaxf(l[idx / vhd], 1e-38f), a.dot_dtype);
  }
}

}  // namespace

// K2. x [T, D] (x_dtype), norm_w [D] f32, qs [O, D] int8, s [O] f32 ->
// y [T, O] f32 (the wrapper casts it to x's dtype).
LT_EXPORT int lt_qkv_norm(const void* x, int x_dtype, const void* norm_w, float eps,
                          const void* qs, const void* s, void* y, int T, int O, int D,
                          int dot_dtype, void* stream) {
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
  return lt::gemv_launch<1, lt::P_RMSNORM, lt::E_SCALE>(a, static_cast<cudaStream_t>(stream));
}

// K3. One decode layer after the qkv projection (B = 1, T = 1):
//   q [KV, G, hd], kvn [KV, hd + vhd] (x_dtype); kv: this layer's cache
//   [KV, S, hd + vhd] (cache_dtype), written at pos; x [D] (x_dtype);
//   ffn_norm [D] f32; wo [D, KV*G*vhd], w13 [2F, D], w2 [D, F] int8 with f32
//   row scales so, s13, s2; scratch aflat [KV*G*vhd], x2 [D], act [F] f32;
//   out [D] (x_dtype).
LT_EXPORT int lt_attn_tail(const void* q, const void* kvn, int x_dtype, void* kv, int cache_dtype,
                           int S, int pos, int KV, int G, int hd, int vhd, float scale,
                           const void* x, const void* ffn_norm, float eps, float rs,
                           const void* wo, const void* so, const void* w13, const void* s13,
                           const void* w2, const void* s2, void* aflat, void* x2, void* act,
                           void* out, int D, int F, int dot_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || pos < 0 || pos >= S || hd % 32 || vhd % 32 || hd > 32 * kMaxPL ||
      vhd > 32 * kMaxPL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdim = KV * G * vhd;

  // 1. append + attention
  AttnArgs at = {q, kvn, x_dtype, kv, S, pos, G, hd, vhd, scale,
                 static_cast<float*>(aflat), dot_dtype};
  const size_t smem = attn_smem_bytes(G, hd, vhd, kAttnThreads / 32);
  if (cache_dtype == LT_F32) {
    cudaError_t e = lt_allow_smem(attn_append_kernel<float>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attn_append_kernel<float><<<KV, kAttnThreads, smem, st>>>(at);
  } else {
    cudaError_t e = lt_allow_smem(attn_append_kernel<__nv_bfloat16>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attn_append_kernel<__nv_bfloat16><<<KV, kAttnThreads, smem, st>>>(at);
  }
  LT_RETURN_IF_ERROR();

  // 2. x2 = x + rs * (aflat . wo^T) * so, f32
  lt::GemvArgs b = {};
  b.x = aflat;
  b.x_dtype = LT_F32;
  b.w = static_cast<const int8_t*>(wo);
  b.s = static_cast<const float*>(so);
  b.rs = rs;
  b.res = x;
  b.res_dtype = x_dtype;
  b.y = x2;
  b.y_dtype = LT_F32;
  b.T = 1;
  b.O = D;
  b.I = hdim;
  int e = lt::gemv_launch<1, lt::P_COPY, lt::E_RESID>(b, st);
  if (e) return e;

  // 3. h = round(rmsnorm(x2) * ffn_norm); gate | up = (h . w13^T) * s13;
  //    act = round(silu(gate) * up), each warp taking a gate row and its up row
  lt::GemvArgs c = {};
  c.x = x2;
  c.x_dtype = LT_F32;
  c.norm_w = static_cast<const float*>(ffn_norm);
  c.eps = eps;
  c.dot_dtype = dot_dtype;
  c.w = static_cast<const int8_t*>(w13);
  c.s = static_cast<const float*>(s13);
  c.y = act;
  c.y_dtype = LT_F32;
  c.T = 1;
  c.O = 2 * F;
  c.I = D;
  e = lt::gemv_launch<1, lt::P_RMSNORM, lt::E_SILU_PAIR>(c, st);
  if (e) return e;

  // 4. out = x2 + rs * (act . w2^T) * s2, cast to x's dtype
  lt::GemvArgs d = {};
  d.x = act;
  d.x_dtype = LT_F32;
  d.w = static_cast<const int8_t*>(w2);
  d.s = static_cast<const float*>(s2);
  d.rs = rs;
  d.res = x2;
  d.res_dtype = LT_F32;
  d.y = out;
  d.y_dtype = x_dtype;
  d.T = 1;
  d.O = D;
  d.I = F;
  return lt::gemv_launch<1, lt::P_COPY, lt::E_RESID_OUT>(d, st);
}

namespace {

template <int MAXT, typename XT>
int tail_phases(const lt::GemvArgs& b, const lt::GemvArgs& c, const lt::GemvArgs& d,
                cudaStream_t st) {
  int e = lt::gemv_tiled_launch<MAXT, XT, lt::P_COPY, lt::E_RESID>(b, st);
  if (e) return e;
  e = lt::gemv_tiled_launch<MAXT, XT, lt::P_RMSNORM, lt::E_SILU_PAIR>(c, st);
  if (e) return e;
  return lt::gemv_tiled_launch<MAXT, XT, lt::P_COPY, lt::E_RESID_OUT>(d, st);
}

}  // namespace

// K9. attn [T, H], x [T, D] (x_dtype); ffn_norm [D] f32; wo [D, H], w13
// [2F, D], w2 [D, F] int8 with f32 row scales so, s13, s2; scratch x2 [T, D],
// act [T, F] f32; out [T, D] (x_dtype). T <= 32.
LT_EXPORT int lt_tail(const void* attn, int x_dtype, const void* x, const void* ffn_norm,
                      float eps, float rs, const void* wo, const void* so, const void* w13,
                      const void* s13, const void* w2, const void* s2, void* x2, void* act,
                      void* out, int T, int D, int H, int F, int dot_dtype, void* stream) {
  if (T < 1 || T > 32 || D % 4 || H % 4 || F % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 1. x2 = x + rs * (attn . wo^T) * so, f32
  lt::GemvArgs b = {};
  b.x = attn;
  b.x_dtype = x_dtype;
  b.dot_dtype = dot_dtype;
  b.w = static_cast<const int8_t*>(wo);
  b.s = static_cast<const float*>(so);
  b.rs = rs;
  b.res = x;
  b.res_dtype = x_dtype;
  b.y = x2;
  b.y_dtype = LT_F32;
  b.T = T;
  b.O = D;
  b.I = H;
  // 2. h = round(rmsnorm(x2) * ffn_norm); act = round(silu(gate) * up)
  lt::GemvArgs c = {};
  c.x = x2;
  c.x_dtype = LT_F32;
  c.norm_w = static_cast<const float*>(ffn_norm);
  c.eps = eps;
  c.dot_dtype = dot_dtype;
  c.w = static_cast<const int8_t*>(w13);
  c.s = static_cast<const float*>(s13);
  c.y = act;
  c.y_dtype = LT_F32;
  c.T = T;
  c.O = 2 * F;
  c.I = D;
  // 3. out = x2 + rs * (act . w2^T) * s2, cast to x's dtype
  lt::GemvArgs d = {};
  d.x = act;
  d.x_dtype = LT_F32;
  d.dot_dtype = dot_dtype;
  d.w = static_cast<const int8_t*>(w2);
  d.s = static_cast<const float*>(s2);
  d.rs = rs;
  d.res = x2;
  d.res_dtype = LT_F32;
  d.y = out;
  d.y_dtype = x_dtype;
  d.T = T;
  d.O = D;
  d.I = F;
  if (dot_dtype == LT_F32)
    return T <= 8 ? tail_phases<8, float>(b, c, d, st) : tail_phases<32, float>(b, c, d, st);
  return T <= 8 ? tail_phases<8, __nv_bfloat16>(b, c, d, st)
                : tail_phases<32, __nv_bfloat16>(b, c, d, st);
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

// K16. lt_tail's arguments, plus partial [F / tf, T, D] f32 scratch and the
// contraction tile tf (a multiple of 16, at most 1024, dividing F).
LT_EXPORT int lt_tail_kt(const void* attn, int x_dtype, const void* x, const void* ffn_norm,
                         float eps, float rs, const void* wo, const void* so, const void* w13,
                         const void* s13, const void* w2, const void* s2, void* x2, void* act,
                         void* partial, void* out, int T, int D, int H, int F, int tf,
                         int dot_dtype, void* stream) {
  if (T < 1 || T > 32 || D % 4 || H % 4 || tf % 16 || tf > lt::kTileK || tf < 16 || F % tf)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lt::GemvArgs b = {};
  b.x = attn;
  b.x_dtype = x_dtype;
  b.dot_dtype = dot_dtype;
  b.w = static_cast<const int8_t*>(wo);
  b.s = static_cast<const float*>(so);
  b.rs = rs;
  b.res = x;
  b.res_dtype = x_dtype;
  b.y = x2;
  b.y_dtype = LT_F32;
  b.T = T;
  b.O = D;
  b.I = H;
  lt::GemvArgs c = {};
  c.x = x2;
  c.x_dtype = LT_F32;
  c.norm_w = static_cast<const float*>(ffn_norm);
  c.eps = eps;
  c.dot_dtype = dot_dtype;
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
  d.dot_dtype = dot_dtype;
  d.w = static_cast<const int8_t*>(w2);
  d.s = static_cast<const float*>(s2);
  d.rs = rs;
  d.res = x2;
  d.res_dtype = LT_F32;
  d.y = out;
  d.y_dtype = x_dtype;
  d.T = T;
  d.O = D;
  d.I = F;
  float* p = static_cast<float*>(partial);
  if (dot_dtype == LT_F32)
    return T <= 8 ? tail_kt_phases<8, float>(b, c, d, p, tf, st)
                  : tail_kt_phases<32, float>(b, c, d, p, tf, st);
  return T <= 8 ? tail_kt_phases<8, __nv_bfloat16>(b, c, d, p, tf, st)
                : tail_kt_phases<32, __nv_bfloat16>(b, c, d, p, tf, st);
}
