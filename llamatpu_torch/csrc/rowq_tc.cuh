// The batched q8_row GEMV phases of K1 (quant_matmul.cu `lt_rowq_gemv`), K2
// (layer_fused.cu `lt_qkv_norm`), K3 (layer_fused.cu `lt_attn_tail`, after its
// attention phase), K9 (layer_fused.cu `lt_tail`), K16 (layer_fused.cu
// `lt_tail_kt`: K9's phases, w2 on contraction tiles) and K20 (ffn_fused.cu
// `lt_ffn_fused`) on the tensor cores: one template,
// `rowq_tc_kernel<NF, PAIR, Tag>`, run once per phase in stream order. Tag
// (K1, K2, K3, K9, K16, K20) names the caller in the kernel's symbol, so a
// profiler trace tells their launches apart. K5 and K7's bf16 decode rows
// (block_matmul.cu) run the same body as `rowq_tc_bq_kernel<NF, Tag>` on
// their block-quant weights (`WeightKind`: Q8_0, Q4_0 packed two a byte),
// each weight box's f32 block scales staged beside it, the A fragments
// dequantized by them in registers; their bound is the same weight stream
// at 1.125 and 0.625 bytes a weight.
//
// A phase computes, for T <= 32 bf16 activation rows x [T, I] and q8_row
// weights w [rows, I] (int8, one f32 scale per row),
//   sum[t, o] = sum_i x[t, i] . w[o, i]        (f32, exact products)
// and one epilogue of gemv.cuh on the f32 sums, in the JAX order with
// explicit _rn intrinsics (gemv.cuh `gemv_store`):
//   E_RESID      x2  = res + (sum . s) . rs                      f32
//   E_SILU_PAIR  act = round(gate . sigmoid(gate) . up),  gate = sum . s[o],
//                up = sum_up . s[o + up]: the gate row o and the up row o + up
//                of w13 are one unit, so act is written once
//   E_RESID_OUT  out = x2 + (sum . s) . rs, cast to out's dtype
//   E_SCALE      out = sum . s                                   f32
//   E_RAW        out = sum (K1: the row scale stays outside)    f32
// The activations are staged as bf16 from x (X_BF16), as the rmsnorm
// h = round(x2 . rsqrt(mean(x2^2) + eps) . nw) of f32 x2 rows (X_F32_NORM),
// mean(x2^2) from the per-16-row sums of squares the E_RESID phase wrote, or
// as f32 rows rounded to bf16 (X_F32: K3's attention output, rounded where
// the TPU kernel rounds aflat).
// K2's rmsnorm of bf16 x is a small phase of its own (layer_fused.cu), whose
// bf16 h this template stages as X_BF16.
//
// Bound on the H100: the weight stream. K9 at Llama-3.2-1B reads 54.5 MB of
// int8 a layer (16.3 us at 3.35 TB/s) at every T <= 32; K20 at Phi-3-medium
// 275.3 MB (82 us); K1 on Llama-3.2-1B's vocab head 262.7 MB (78 us); K2 at
// Phi-3-medium 39.3 MB (11.7 us); the products (2 T flops a weight byte) take
// under a fifth of that at the bf16 tensor-core peak.
//
// Design (PR 9-13's TMA-fed tensor-core GEMV, tc_gemv.cuh's pieces):
// - Units: a row block of g groups of 16 output rows (PAIR: each group's 16
//   gate rows with their 16 up rows) times a contraction slice of `ksl`
//   columns (a multiple of 128). The plan (ops/ffn_fused.py `plan_tc`,
//   checked by the CPU tests) picks g and the slices: a CTA's bf16 slice of
//   x fits its shared memory, the units fill the SMs, and few units keep
//   their fixed cost down; units are slice-major, CTA c takes the
//   contiguous range [c U / ctas, (c + 1) U / ctas), so its x slice changes
//   at most once or twice a phase.
// - Persistent CTAs of 13 warps, one an SM. Warp 8 is the producer,
//   filling a ring of stages by TMA boxes [16 rows, 128 bytes] (the 128-byte
//   swizzle) of the weights: a stage is one box for each consumer warp (PAIR:
//   a gate and an up box), 8 / g warps to a group, each taking the next 128
//   columns. The weights do not depend on the previous phase, so under
//   programmatic dependent launch the producer fills the ring while that
//   phase finishes.
// - The 8 consumer warps stage the CTA's x slice (after griddepcontrol.wait;
//   bf16 x by one bulk copy a row, the rmsnorm of f32 x2 by their loads)
//   as bf16 rows of pitch 2 ksl + 32 bytes (the 8 rows of a fragment in
//   distinct banks), zeros past T and past I. Each takes its box of a stage:
//   8 steps of mma.sync m16n8k16 with the weights as A (16 rows, q8_row int8
//   made exact bf16 by the byte permute, tc_gemv.cuh's k order) and x as B
//   (8 rows a fragment, NF = ceil(T / 8) fragments), and hands its part of
//   the unit to the finishers through shared memory.
// - Warps 9-12 (the finishers) add a group's parts in warp order and free
//   them for the consumers' next unit. With one slice they keep the sums in
//   `fin` (each thread its own outputs) and apply the epilogue; otherwise
//   they store the slice's sums to f32 scratch, and a second, small launch
//   (`rowq_tc_reduce`, a thread per 4 outputs, after the first has
//   finished) adds each output's slices in order 0, 1, ... and applies the
//   epilogue. No CTA waits on another (no atomics): the
//   consumers never wait for a global load or a store after their products
//   (under a full weight stream each takes ~1 us, and on the consumers'
//   path the units' ends cost more than their stream), and the finishers
//   never wait for one either. Two runs are bit-equal, and the launches
//   allocate nothing and sync nothing, so a CUDA graph captures them.
// - The epilogue reads and writes 4 outputs of one x row as one 16-byte
//   (f32) or 8-byte (bf16) access where O is a multiple of 4.
// Where it does not apply (gemv.cuh's tiled GEMV stays): f32 activations
// (the tensor cores give no f32 products), and K1's, K2's, K3's, K9's and
// K16's contraction widths that are not multiples of 16 (TMA row strides are
// 16-byte multiples); K20 in bf16 raises for them, as no shape the JAX fit
// admits has one.
#pragma once

#include "gemv.cuh"
#include "tc_gemv.cuh"

namespace rtc {

constexpr int kWarps = 8;                         // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kFinishers = 128;                   // warps 9-12: the epilogues
constexpr int kThreads = kConsumers + 32 + kFinishers;  // + the producer warp
constexpr int kRows = 16;                         // output rows of a group
constexpr int kBoxCols = 128;                     // columns (bytes) of a box: a warp's share
constexpr int kBoxBytes = kRows * kBoxCols;
constexpr int kMaxDepth = 8;
constexpr int kMaxGroups = 4;                     // 16-row groups a unit
constexpr int kReduceThreads = 256;               // the split phases' second launch
constexpr int kDynSmem = 232448 - 1024;           // 227 KB less the static barriers' room

// The callers, as the kernel's last template argument (its symbol names them)
struct K1 {};
struct K2 {};
struct K3 {};
struct K9 {};
struct K16 {};
struct K20 {};
struct K5 {};
struct K7 {};

// The weight kind a caller streams: q8_row int8 (K1, K2, K9, K20; its row
// scale in the epilogue or outside), Q8_0 int8 with f32 scales of each
// 32-column block (K5), Q4_0 packed two's-complement nibbles, two columns a
// byte, with the same block scales (K7). A box row is 128 bytes: 128 columns,
// 256 packed; the block kinds stage each box's [16 rows, cols / 32] f32
// scales beside it, by a TMA box of their own.
enum WeightKind { WT_ROWQ = 0, WT_Q8 = 1, WT_Q4P = 2 };
template <typename Tag>
struct WeightOf {
  static constexpr int kind = WT_ROWQ;
};
template <>
struct WeightOf<K5> {
  static constexpr int kind = WT_Q8;
};
template <>
struct WeightOf<K7> {
  static constexpr int kind = WT_Q4P;
};
template <int WK>
struct WGeo {
  static constexpr int cols = WK == WT_Q4P ? 2 * kBoxCols : kBoxCols;  // columns of a box
  static constexpr int ns = WK == WT_ROWQ ? 0 : cols / 32;             // block scales a box row
  static constexpr int sbox = kRows * ns * 4;                          // a box's scales, bytes
};

enum XKind { X_BF16 = 0, X_F32_NORM = 1, X_F32 = 2 };

struct Phase {
  const void* x;          // [T, I]: bf16 (X_BF16), f32 x2 (X_F32_NORM) or f32 (X_F32)
  int xkind;
  const float* norm_w;    // [I] (X_F32_NORM)
  const float* ssp_in;    // [T, ssp_blocks] sums of squares of x2 (X_F32_NORM)
  int ssp_blocks;
  float eps;
  const float* s;         // row scales [rows] (not read by E_RAW)
  float rs;               // residual scale
  const void* res;        // [T, O] residual (E_RESID, E_RESID_OUT)
  int res_dtype;
  void* y;                // [T, O]: f32 (E_RESID, E_SCALE, E_RAW), bf16 (E_SILU_PAIR), y_dtype
  int y_dtype, epi;
  float* ssp_out;         // [T, O / 16] (E_RESID)
  float* partial;         // [units, 16 g Tp (x 2 PAIR)] f32 slice sums (splits > 1)
  int T, O, I, up;        // up: the up rows' offset in w (PAIR)
  int g, splits, ksl, ctas;  // the plan: 16-row groups a unit, slices, CTAs
  int wpg, rows, nrb, units, depth, stage, xpitch, xoff, redoff, finoff;  // warps a group, rows a unit
  int vec;                // O % 4 == 0 and y, s, res 16-byte aligned: 4 outputs an access
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// q8_row int8 fragment (4 columns of one row, lowest byte first) as two
// exact bf16x2: byte ^ 0x80 under the exponent of 2^23 reads 2^23 + q + 128,
// one subtraction leaves q, and bf16(q) is the high half (|q| <= 128).
__device__ __forceinline__ void rowq_bf16(uint32_t raw, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = raw ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// ------------------------------------------------------------- producer
template <bool PAIR, int WK>
__device__ void produce(const Phase& p, const CUtensorMap* mw, const CUtensorMap* ms,
                        uint32_t ring, uint64_t* full, uint64_t* empty, int lane, int u0, int u1) {
  using G = WGeo<WK>;
  int slot = 0;
  unsigned phase = 0;
  for (int u = u0; u < u1; ++u) {
    const int s = u / p.nrb, rb = u - s * p.nrb;
    const int k0 = s * p.ksl, k1 = min(p.I, k0 + p.ksl);
    for (int k = k0; k < k1; k += G::cols * p.wpg) {
      // warp w's box: group w / wpg's rows, columns k + cols (w % wpg); those
      // past the slice are not loaded (nb a group)
      const int nb = min(p.wpg, (k1 - k + G::cols - 1) / G::cols);
      const int nbox = (PAIR ? 2 : 1) * p.g * nb;
      mbar_wait(&empty[slot], phase ^ 1);
      __syncwarp();
      if (lane == 0)
        mbar_expect_tx(&full[slot], static_cast<unsigned>(nbox * (kBoxBytes + G::sbox)));
      __syncwarp();
      if (lane < nbox) {  // box (w, h) of warp w = gi wpg + b (PAIR: h 0 gate, 1 up)
        const int h = PAIR ? lane & 1 : 0, j = PAIR ? lane >> 1 : lane;
        const int gi = j / nb, b = j - gi * nb, w = gi * p.wpg + b;
        const int row = rb * p.rows + gi * kRows + h * p.up, col = k + b * G::cols;
        tma_load_2d(ring + slot * p.stage + ((PAIR ? 2 : 1) * w + h) * kBoxBytes, mw,
                    WK == WT_Q4P ? col / 2 : col, row, &full[slot]);
        if constexpr (WK != WT_ROWQ)  // the box's block scales, after the weight boxes
          tma_load_2d(ring + slot * p.stage + kWarps * kBoxBytes + w * G::sbox, ms, col / 32,
                      row, &full[slot]);
      }
      if (++slot == p.depth) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

// ------------------------------------------------------------- finishers
// The consumers hand each unit's parts (in `red`) to the finishers: `full`
// when the 8 consumer warps have written them, `free` when the finishers
// have read them.
struct Hand {
  uint64_t full, free;
};

__device__ __forceinline__ void finisher_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kFinishers) : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// ------------------------------------------------------------- consumers
// The CTA's x slice [k0, k1) into shared memory as bf16 rows of xpitch
// bytes: Tp rows, ksl columns, zeros past T and I (rows past T are zeroed
// once, at the start). X_BF16: one bulk copy a row, issued by thread 0 and
// completing on xbar (the columns past I zeroed by the threads first);
// X_F32_NORM and X_F32: the threads' loads, a batch issued before its stores.
template <int NF>
__device__ void stage_x(const Phase& p, unsigned char* xs, const float* rstd, int k0, int k1,
                        int ct, uint64_t* xbar, unsigned& xphase) {
  if (p.xkind == X_BF16) {
    const int bytes = 2 * (k1 - k0), tail = 2 * p.ksl - bytes;
    for (int i = ct; i < p.T * (tail / 16); i += kConsumers) {
      const int t = i / (tail / 16);
      *reinterpret_cast<uint4*>(xs + t * p.xpitch + bytes + 16 * (i - t * (tail / 16))) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    if (ct == 0) {
      mbar_expect_tx(xbar, static_cast<unsigned>(p.T * bytes));
      for (int t = 0; t < p.T; ++t)
        bulk_load(xs + t * p.xpitch,
                  static_cast<const __nv_bfloat16*>(p.x) + static_cast<long>(t) * p.I + k0,
                  static_cast<unsigned>(bytes), xbar);
    }
    mbar_wait(xbar, xphase);
    xphase ^= 1;
    return;
  }
  constexpr int kBatch = 8;
  const int vpr = p.ksl / 8;  // 16-byte vectors (8 bf16) a row
  const int n = p.T * vpr;
  for (int i0 = ct; i0 < n; i0 += kBatch * kConsumers) {
    uint4 v[kBatch];
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kConsumers, t = i / vpr, k = k0 + 8 * (i - t * vpr);
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      a[j] = b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && k < k1) {
        const float4* r = reinterpret_cast<const float4*>(static_cast<const float*>(p.x) +
                                                          static_cast<long>(t) * p.I + k);
        a[j] = __ldcg(r);
        b[j] = __ldcg(r + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kConsumers, t = i / vpr, c = 8 * (i - t * vpr), k = k0 + c;
      if (i >= n) break;
      if (k < k1 && p.xkind == X_F32) {  // round to bf16
        v[j] = make_uint4(pack_bf16x2(a[j].x, a[j].y), pack_bf16x2(a[j].z, a[j].w),
                          pack_bf16x2(b[j].x, b[j].y), pack_bf16x2(b[j].z, b[j].w));
      } else if (k < k1) {
        // h = round(x2 * rstd * nw): f32 products in the JAX order
        const float r = rstd[t];
        const float4 na = __ldg(reinterpret_cast<const float4*>(p.norm_w + k));
        const float4 nb = __ldg(reinterpret_cast<const float4*>(p.norm_w + k) + 1);
        v[j].x = pack_bf16x2(__fmul_rn(__fmul_rn(a[j].x, r), na.x), __fmul_rn(__fmul_rn(a[j].y, r), na.y));
        v[j].y = pack_bf16x2(__fmul_rn(__fmul_rn(a[j].z, r), na.z), __fmul_rn(__fmul_rn(a[j].w, r), na.w));
        v[j].z = pack_bf16x2(__fmul_rn(__fmul_rn(b[j].x, r), nb.x), __fmul_rn(__fmul_rn(b[j].y, r), nb.y));
        v[j].w = pack_bf16x2(__fmul_rn(__fmul_rn(b[j].z, r), nb.z), __fmul_rn(__fmul_rn(b[j].w, r), nb.w));
      }
      *reinterpret_cast<uint4*>(xs + t * p.xpitch + 2 * c) = v[j];
    }
  }
}

// Warp w's products on box w of a stage: 8 steps of 16 columns. Lane (g, q)
// reads rows g and g + 8 of the box (128-byte rows, chunk j ^ g under the
// swizzle) and x rows 8 n + g at the step's columns 4q .. 4q + 3.
template <int NF, bool PAIR>
__device__ __forceinline__ void products(uint32_t wb, uint32_t xb, int xpitch, int g,
                                         float (&acc)[NF][4], float (&accu)[NF][4]) {
  const int q4 = 4 * (threadIdx.x & 3);
  const uint32_t r0 = wb + g * kBoxCols + q4, r8 = r0 + 8 * kBoxCols;
  uint32_t wg[8][2], wu[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t off = static_cast<uint32_t>((j ^ g) << 4);
    wg[j][0] = lds32(r0 + off);
    wg[j][1] = lds32(r8 + off);
    if (PAIR) {
      wu[j][0] = lds32(r0 + kBoxBytes + off);
      wu[j][1] = lds32(r8 + kBoxBytes + off);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t bx[NF][2];
#pragma unroll
    for (int n = 0; n < NF; ++n) lds64(bx[n], xb + n * 8 * xpitch + 32 * j);
    uint32_t a[4];
    rowq_bf16(wg[j][0], a[0], a[2]);
    rowq_bf16(wg[j][1], a[1], a[3]);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      mma16(acc[n], a, bx[n]);
    }
    if (PAIR) {
      rowq_bf16(wu[j][0], a[0], a[2]);
      rowq_bf16(wu[j][1], a[1], a[3]);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        mma16(accu[n], a, bx[n]);
      }
    }
  }
}

__device__ __forceinline__ void lds128f(float (&r)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
               : "r"(addr));
}

// The block kinds' products on box w of a stage (K5, K7): lane (g, q) takes
// the same k order and x rows as `products`, its A fragments of rows g and g
// + 8 dequantized in registers by the scale of their 32-column block (f32
// product rounded to nearest, then to bf16, as the TPU kernel rounds the
// weight before the dot). Q8_0: 8 steps, the 4 int8 columns of a step one
// 4-byte load; packed: 16 steps of the box's 256
// columns, the step's 4 columns two bytes, their nibbles spread into bytes
// under the exponent of 2^23 (tc_gemv.cuh's dequant_block, as K10 / K11). A row's
// scales of the box are one or two 16-byte loads.
template <int NF, int WK>
__device__ __forceinline__ void products_block(uint32_t wb, uint32_t sb, uint32_t xb, int xpitch,
                                               int g, float (&acc)[NF][4]) {
  using G = WGeo<WK>;
  constexpr int STEPS = G::cols / 16;
  const int q = threadIdx.x & 3;
  float sg[G::ns], s8[G::ns];
#pragma unroll
  for (int v = 0; v < G::ns / 4; ++v) {
    float a[4], b[4];
    lds128f(a, sb + g * G::ns * 4 + 16 * v);
    lds128f(b, sb + (g + 8) * G::ns * 4 + 16 * v);
#pragma unroll
    for (int e = 0; e < 4; ++e) sg[4 * v + e] = a[e], s8[4 * v + e] = b[e];
  }
  uint32_t w0[STEPS], w8[STEPS];
  const uint32_t r0 = wb + g * kBoxCols, r8 = r0 + 8 * kBoxCols;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (WK == WT_Q8) {  // columns 16 j + 4 q ..: 4 bytes of 16-byte chunk j
      const uint32_t off = static_cast<uint32_t>(((j ^ g) << 4) + 4 * q);
      w0[j] = lds32(r0 + off);
      w8[j] = lds32(r8 + off);
    } else {            // bytes 8 j + 2 q, + 1 of chunk j / 2
      const uint32_t off = static_cast<uint32_t>((((j >> 1) ^ g) << 4) + 8 * (j & 1) + 2 * q);
      w0[j] = lds16(r0 + off);
      w8[j] = lds16(r8 + off);
    }
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    uint32_t bx[NF][2];
#pragma unroll
    for (int n = 0; n < NF; ++n) lds64(bx[n], xb + n * 8 * xpitch + 32 * j);
    uint32_t a[4];
    dequant_block<WK == WT_Q4P>(w0[j], sg[j * 16 / 32], a[0], a[2]);
    dequant_block<WK == WT_Q4P>(w8[j], s8[j * 16 / 32], a[1], a[3]);
#pragma unroll
    for (int n = 0; n < NF; ++n) mma16(acc[n], a, bx[n]);
  }
}

// The epilogue of 4 outputs of a unit: one x row t, weight rows o .. o + 3
// of one 16-row group (`row` of the first within it), from their full sums v
// (and the up rows' u), with their row scales and residuals loaded
// beforehand. Every lane of a warp takes part: E_RESID also writes each
// group's sum of squares of x2 for each t, which 4 neighbouring lanes hold.
// With p.vec the 4 outputs are one access (all or none of them < O).
struct Quad {
  int o, t, row;
};

struct Quad4 {
  float s[4], su[4], res[4];
};

__device__ __forceinline__ Quad quad_at(const Phase& p, int rb, int qd, int tp) {
  const int i = 4 * qd, gi = i / (kRows * tp), r = i - gi * kRows * tp;
  return {rb * p.rows + gi * kRows + r % kRows, r / kRows, r % kRows};
}

__device__ __forceinline__ void load4(const void* a, int dtype, long idx, float (&v)[4]) {
  if (dtype == LT_F32) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a) + idx));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a) + idx));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  }
}

__device__ __forceinline__ void store4(void* a, int dtype, long idx, const float (&v)[4]) {
  if (dtype == LT_F32)
    *reinterpret_cast<float4*>(static_cast<float*>(a) + idx) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a) + idx) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

__device__ __forceinline__ Quad4 quad_load(const Phase& p, const Quad& q, bool live) {
  Quad4 r = {};
  if (!live || q.t >= p.T || q.o >= p.O) return r;
  const bool resid = p.epi == lt::E_RESID || p.epi == lt::E_RESID_OUT;
  if (p.vec) {
    if (p.epi != lt::E_RAW) load4(p.s, LT_F32, q.o, r.s);
    if (p.epi == lt::E_SILU_PAIR) load4(p.s, LT_F32, q.o + p.up, r.su);
    if (resid) load4(p.res, p.res_dtype, static_cast<long>(q.t) * p.O + q.o, r.res);
    return r;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = q.o + e;
    if (o < p.O) {
      if (p.epi != lt::E_RAW) r.s[e] = __ldg(p.s + o);
      if (p.epi == lt::E_SILU_PAIR) r.su[e] = __ldg(p.s + o + p.up);
      if (resid) r.res[e] = lt_load(p.res, p.res_dtype, static_cast<long>(q.t) * p.O + o);
    }
  }
  return r;
}

__device__ __forceinline__ void epilogue(const Phase& p, const Quad& q, const float4& v4,
                                         const float4& u4, const Quad4& in, bool live) {
  const float v[4] = {v4.x, v4.y, v4.z, v4.w}, u[4] = {u4.x, u4.y, u4.z, u4.w};
  const bool on = live && q.t < p.T && q.o < p.O;
  float out[4], sq = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (p.epi == lt::E_RAW) {
      out[e] = v[e];
    } else if (p.epi == lt::E_SCALE) {
      out[e] = __fmul_rn(v[e], in.s[e]);
    } else if (p.epi == lt::E_SILU_PAIR) {
      const float gt = __fmul_rn(v[e], in.s[e]), up = __fmul_rn(u[e], in.su[e]);
      out[e] = __fmul_rn(__fmul_rn(gt, 1.0f / (1.0f + expf(-gt))), up);
    } else {
      out[e] = __fadd_rn(in.res[e], __fmul_rn(__fmul_rn(v[e], in.s[e]), p.rs));
      if (p.epi == lt::E_RESID && q.o + e < p.O) sq = __fadd_rn(sq, __fmul_rn(out[e], out[e]));
    }
  }
  const int ydt = p.epi == lt::E_SILU_PAIR ? LT_BF16 : p.epi == lt::E_RESID_OUT ? p.y_dtype : LT_F32;
  const long idx = static_cast<long>(q.t) * p.O + q.o;
  if (on && p.vec) {
    store4(p.y, ydt, idx, out);
  } else if (on) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (q.o + e < p.O) lt_store(p.y, ydt, idx + e, out[e]);
  }
  if (p.epi == lt::E_RESID) {
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
    if (on && q.row == 0)
      p.ssp_out[static_cast<long>(q.t) * ((p.O + kRows - 1) / kRows) + q.o / kRows] = sq;
  }
}

// Warps 9-12: for each unit of the CTA in turn, its sums from the
// consumers' parts (a group's parts in warp order), each finisher thread
// taking quads ft, ft + 128, ...: with one slice into `fin`, then the parts
// are free and the thread applies the epilogue to its quads; otherwise into
// the unit's scratch, then the parts are free.
template <int NF, bool PAIR>
__device__ void finish(const Phase& p, Hand& hd, const float* red, float* fin, int ft, int u0,
                       int u1) {
  constexpr int NOUT = kRows * 8 * NF, NH = PAIR ? 2 : 1;
  const int nout = p.g * NOUT, nq = nout / 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the residuals; y after its readers
  for (int u = u0; u < u1; ++u) {
    const int n = u - u0;
    mbar_wait(&hd.full, n & 1);
    float4* dst = p.splits == 1 ? reinterpret_cast<float4*>(fin)
                                : reinterpret_cast<float4*>(p.partial + static_cast<long>(u) * NH * nout);
    for (int qd = ft; qd < nq; qd += kFinishers) {
      const int gi = 4 * qd / NOUT, r = 4 * qd - gi * NOUT;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
      for (int j = 0; j < p.wpg; ++j) {
        const int o = (gi * p.wpg + j) * NOUT + r;
        add4(v, *reinterpret_cast<const float4*>(red + o));
        if (PAIR) add4(w, *reinterpret_cast<const float4*>(red + kWarps * NOUT + o));
      }
      dst[qd] = v;
      if (PAIR) dst[nq + qd] = w;
    }
    finisher_sync();  // every finisher has read the parts
    if (ft == 0) mbar_arrive(&hd.free);
    if (p.splits > 1) continue;
    const float4* f = reinterpret_cast<const float4*>(fin);
    for (int m0 = 0; m0 < nq; m0 += kFinishers) {  // every thread: the shuffles
      const int qd = m0 + ft;
      const bool live = qd < nq;
      const Quad at = quad_at(p, u, qd, 8 * NF);
      const Quad4 in = quad_load(p, at, live);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
      if (live) {
        v = f[qd];
        if (PAIR) w = f[nq + qd];
      }
      epilogue(p, at, v, w, in, live);
    }
  }
}

// A split phase's second launch: each output's slice sums added in order 0,
// 1, ..., then the epilogue, a thread a quad (4 outputs of one x row); a
// row block's g 16 Tp outputs are a multiple of 32 quads, so a warp's quads
// lie in one block and E_RESID's 4 lanes of a 16-row group in one warp.
template <int NF, bool PAIR, typename Tag>
__global__ void __launch_bounds__(kReduceThreads) rowq_tc_reduce(const Phase p) {
  constexpr int TP = 8 * NF, NH = PAIR ? 2 : 1;
  const int nout = p.g * kRows * TP, nq = nout / 4;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the first launch's slice sums
  const long i = static_cast<long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const int rb = static_cast<int>(i / nq), qd = static_cast<int>(i - static_cast<long>(rb) * nq);
  const bool live = rb < p.nrb;
  const Quad at = quad_at(p, rb, qd, TP);
  const Quad4 in = quad_load(p, at, live);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
  for (int s = 0; live && s < p.splits; ++s) {
    const float* part = p.partial + (static_cast<long>(s) * p.nrb + rb) * NH * nout + 4 * qd;
    add4(v, __ldcg(reinterpret_cast<const float4*>(part)));
    if (PAIR) add4(w, __ldcg(reinterpret_cast<const float4*>(part + nout)));
  }
  epilogue(p, at, v, w, in, live);
}

template <int NF, bool PAIR, int WK>
__device__ void consume(const Phase& p, uint32_t ring, unsigned char* base, float* rstd,
                        Hand& hd, uint64_t* full, uint64_t* empty, uint64_t* xbar, int warp,
                        int lane, int u0, int u1) {
  constexpr int TP = 8 * NF, NOUT = kRows * TP;  // x rows staged; outputs a unit
  constexpr int NH = PAIR ? 2 : 1;
  const int g = lane >> 2, q = lane & 3, ct = threadIdx.x;
  unsigned char* xs = base + p.xoff;
  float* red = reinterpret_cast<float*>(base + p.redoff);  // [NH][warp][t][row]
  asm volatile("griddepcontrol.wait;\n" ::: "memory");     // the previous phase's outputs
  if (p.xkind == X_F32_NORM) {  // rsqrt(mean(x2^2) + eps) a row, the blocks' sums in order
    for (int t = warp; t < p.T; t += kWarps) {
      float ss = 0.f;
      for (int b = lane; b < p.ssp_blocks; b += 32)
        ss += __ldcg(p.ssp_in + static_cast<long>(t) * p.ssp_blocks + b);
      ss = lt_warp_sum(ss);
      if (lane == 0) rstd[t] = 1.0f / sqrtf(ss / static_cast<float>(p.I) + p.eps);
    }
    consumer_sync();
  }
  for (int i = ct; i < (TP - p.T) * (p.xpitch / 16); i += kConsumers)  // rows past T
    reinterpret_cast<uint4*>(xs + p.T * p.xpitch)[i] = make_uint4(0u, 0u, 0u, 0u);
  int slot = 0, cur = -1;
  unsigned phase = 0, xphase = 0;
  for (int u = u0; u < u1; ++u) {
    const int s = u / p.nrb, rb = u - s * p.nrb;
    const int k0 = s * p.ksl, k1 = min(p.I, k0 + p.ksl);
    if (s != cur) {  // a new slice of x: every warp is done with the old one
      consumer_sync();
      stage_x<NF>(p, xs, rstd, k0, k1, ct, xbar, xphase);
      consumer_sync();
      cur = s;
    }
    float acc[NF][4], accu[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = accu[n][i] = 0.f;
    using G = WGeo<WK>;
    const int wb = warp % p.wpg;  // the warp's box within its group's share of a stage
    for (int k = k0; k < k1; k += G::cols * p.wpg) {
      const int nb = min(p.wpg, (k1 - k + G::cols - 1) / G::cols);
      mbar_wait(&full[slot], phase);
      const uint32_t st = ring + slot * p.stage;
      const uint32_t xb = smem_u32(xs) + g * p.xpitch + 8 * q + 2 * (k - k0 + wb * G::cols);
      if (wb >= nb) {
      } else if constexpr (WK == WT_ROWQ) {
        products<NF, PAIR>(st + (PAIR ? 2 : 1) * warp * kBoxBytes, xb, p.xpitch, g, acc, accu);
      } else {
        products_block<NF, WK>(st + warp * kBoxBytes, st + kWarps * kBoxBytes + warp * G::sbox,
                               xb, p.xpitch, g, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == p.depth) {
        slot = 0;
        phase ^= 1;
      }
    }
    // the warp's part to the finishers: acc[n][2h + c] is row g + 8h, x row
    // 8n + 2q + c, once they have read the previous unit's
    if (u > u0) mbar_wait(&hd.free, (u - u0 - 1) & 1);
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = ((warp * TP) + 8 * n + 2 * q + (i & 1)) * kRows + g + 8 * (i >> 1);
        red[at] = acc[n][i];
        if (PAIR) red[kWarps * NOUT + at] = accu[n][i];
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&hd.full);
  }
}

// The kernel's body: ms is the block scales' map of K5 and K7, null otherwise.
template <int NF, bool PAIR, typename Tag>
__device__ __forceinline__ void rowq_tc_body(const CUtensorMap* mw, const CUtensorMap* ms,
                                             const Phase& p) {
  constexpr int WK = WeightOf<Tag>::kind;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth], empty[kMaxDepth], xbar;
  __shared__ __align__(8) Hand hd;
  __shared__ float rstd[32];
  const uint32_t raw = smem_u32(smem_raw), ring = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int d = 0; d < p.depth; ++d) {
      mbar_init(&full[d]);            // the producer's expect_tx
      mbar_init(&empty[d], kWarps);   // one arrive a consumer warp
    }
    mbar_init(&xbar);  // a staged x slice's bulk copies
    mbar_init(&hd.full, kWarps);  // a unit's parts written by every consumer warp
    mbar_init(&hd.free);          // and read by the finishers
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int u0 = static_cast<int>(static_cast<long>(blockIdx.x) * p.units / p.ctas);
  const int u1 = static_cast<int>(static_cast<long>(blockIdx.x + 1) * p.units / p.ctas);
  if (warp == kWarps) {
    produce<PAIR, WK>(p, mw, ms, ring, full, empty, lane, u0, u1);
    return;
  }
  if (warp > kWarps) {
    finish<NF, PAIR>(p, hd, reinterpret_cast<const float*>(base + p.redoff),
                     reinterpret_cast<float*>(base + p.finoff), threadIdx.x - kConsumers - 32, u0,
                     u1);
    return;
  }
  consume<NF, PAIR, WK>(p, ring, base, rstd, hd, full, empty, &xbar, warp, lane, u0, u1);
}

template <int NF, bool PAIR, typename Tag>
__global__ void __launch_bounds__(kThreads, 1)
    rowq_tc_kernel(const __grid_constant__ CUtensorMap mw, const Phase p) {
  rowq_tc_body<NF, PAIR, Tag>(&mw, nullptr, p);
}

// K5 and K7: the weights' map and their block scales' map
template <int NF, typename Tag>
__global__ void __launch_bounds__(kThreads, 1)
    rowq_tc_bq_kernel(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap ms,
                      const Phase p) {
  rowq_tc_body<NF, false, Tag>(&mw, &ms, p);
}

// int8 weights [rows, cols] bytes as [16 rows, 128 bytes] boxes, the
// 128-byte swizzle (f32 block scales [rows, cols]: [16 rows, box_cols] boxes,
// no swizzle), zeros outside.
inline int make_map(CUtensorMap* map, const void* w, long rows, int cols, bool f32 = false,
                    int box_cols = kBoxCols) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int es = f32 ? 4 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      f(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
        const_cast<void*>(w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NF, bool PAIR, typename Tag>
int launch_nf(Phase p, const void* w, long wrows, cudaStream_t st, const float* bs) {
  constexpr int TP = 8 * NF, NH = PAIR ? 2 : 1;
  using G = WGeo<WeightOf<Tag>::kind>;
  p.stage = NH * kWarps * kBoxBytes + kWarps * G::sbox;
  p.xpitch = 2 * p.ksl + 32;  // 32 or 96 mod 128 bytes: a fragment's 8 rows in distinct banks
  const int xbytes = TP * p.xpitch, red = NH * kWarps * kRows * TP * 4;
  const int fin = p.splits == 1 ? NH * p.g * kRows * TP * 4 : 0;  // a unit's sums
  p.depth = min(kMaxDepth, (kDynSmem - 1024 - xbytes - red - fin) / p.stage);
  if (p.depth < 2) return static_cast<int>(cudaErrorInvalidValue);
  p.xoff = p.depth * p.stage;
  p.redoff = p.xoff + xbytes;
  p.finoff = p.redoff + red;
  const size_t smem = 1024 + static_cast<size_t>(p.finoff) + fin;
  CUtensorMap mw, ms = {};
  int e = make_map(&mw, w, wrows, p.I * kBoxCols / G::cols);
  if (e == 0 && G::ns) e = make_map(&ms, bs, wrows, p.I / 32, true, G::ns);
  if (e) return e;
  // set at every launch: a function-local static here would be one symbol
  // for every library that includes this header
  cudaError_t ce;
  if constexpr (G::ns > 0)
    ce = lt_allow_smem(rowq_tc_bq_kernel<NF, Tag>, smem);
  else
    ce = lt_allow_smem(rowq_tc_kernel<NF, PAIR, Tag>, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (G::ns > 0)
    e = static_cast<int>(cudaLaunchKernelEx(&cfg, rowq_tc_bq_kernel<NF, Tag>, mw, ms, p));
  else
    e = static_cast<int>(cudaLaunchKernelEx(&cfg, rowq_tc_kernel<NF, PAIR, Tag>, mw, p));
  if (e || p.splits == 1) return e;
  const long quads = static_cast<long>(p.nrb) * p.g * kRows * TP / 4;
  cfg.gridDim = dim3(static_cast<unsigned>((quads + kReduceThreads - 1) / kReduceThreads));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.dynamicSmemBytes = 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, rowq_tc_reduce<NF, PAIR, Tag>, p));
}

// One phase: its plan (splits, ksl, ctas) from ops/ffn_fused.py plan_tc,
// checked here too; w [wrows, I] int8 (K7: [wrows, I / 2] packed bytes),
// 16-byte aligned; x 16-byte aligned; with more than one slice, partial
// holds the plan's units' sums. K5 and K7 read the block scales bs [wrows,
// I / 32] f32 (I % 128 == 0 and bs 16-byte aligned: TMA row strides).
// MAXT: the most rows the caller passes (K3's one row builds NF = 1 only).
template <bool PAIR, typename Tag, int MAXT = 32>
int launch(Phase p, const void* w, long wrows, cudaStream_t st, const float* bs = nullptr) {
  using G = WGeo<WeightOf<Tag>::kind>;
  if (p.g < 1 || p.g > kMaxGroups || kWarps % p.g) return static_cast<int>(cudaErrorInvalidValue);
  if (G::ns && (PAIR || p.I % 128 || reinterpret_cast<uintptr_t>(bs) % 16 || bs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.wpg = kWarps / p.g;
  p.rows = p.g * kRows;
  p.nrb = (p.O + p.rows - 1) / p.rows;
  p.units = p.nrb * p.splits;
  if (p.T < 1 || p.T > MAXT || p.I % 16 || p.ksl < G::cols || p.ksl % G::cols || p.splits < 1 ||
      static_cast<long>(p.splits) * p.ksl < p.I || (p.splits - 1) * p.ksl >= p.I ||
      p.ctas < 1 || p.ctas > p.units || (p.splits > 1 && p.partial == nullptr) ||
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(p.x) |
       reinterpret_cast<uintptr_t>(p.partial)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = p.O % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(p.y) | reinterpret_cast<uintptr_t>(p.s) |
           reinterpret_cast<uintptr_t>(p.res)) % 16 == 0;
  static_assert(MAXT >= 1 && MAXT <= 32, "T <= 32 rows");
  if constexpr (MAXT <= 8) {
    return launch_nf<1, PAIR, Tag>(p, w, wrows, st, bs);
  } else {
    switch ((p.T + 7) / 8) {
      case 1: return launch_nf<1, PAIR, Tag>(p, w, wrows, st, bs);
      case 2: return launch_nf<2, PAIR, Tag>(p, w, wrows, st, bs);
      case 3: return launch_nf<3, PAIR, Tag>(p, w, wrows, st, bs);
      default: return launch_nf<4, PAIR, Tag>(p, w, wrows, st, bs);
    }
  }
}

}  // namespace rtc
