// K18 and K19: the rate probes of scripts/bench_roofline.py and
// scripts/bench_dma_sweep.py, on two kernel templates and their second passes.
//
// The TPU probes ask what byte rate a weight stream reaches under each way of
// consuming it. Their port asks the same of the H100: every byte of the
// weights really moves from device memory, and each probe consumes it as the
// TPU body did.
//
// 1. probe_gemv_tc_kernel<W_BF16> (K18a step_pallas_bf16, K18i call3_bf16):
//    y[l, t, o] = sum_k x[t, k] * w[l, o, k], x bf16 [T <= 8, I], w bf16
//    [L, O, I], f32 sums. Bound: the weight bytes, 33.6 MB a [4096, 4096]
//    layer (10.0 us at 3.35 TB/s) and 805 MB the [24, 4096, 4096] stack
//    (240.5 us); 8 operations a weight byte at T = 8, ~37x under the bf16
//    ridge. The first design (a CUDA-core GEMV, now gone) reached 0.42 TB/s
//    a layer and 0.61 TB/s on the stack, a fifth of bf16 torch.matmul: each
//    16-byte weight load fed 64 CUDA-core FMAs and 256 bytes of f32 x reads
//    from shared memory, a lane kept at most two loads in flight at 25 %
//    occupancy, and x was restaged every 1024 columns between two block
//    barriers with no weight load in flight. This design keeps HBM busy and
//    the products off the CUDA cores:
//    - persistent CTAs, one per SM, walk work units of (layer, stripe of
//      kStripe = 8 weight rows, K slice), unit u = c, c + ctas, ... of CTA
//      c; the planner (ops/probes.py plan_gemv, checked by the CPU tests)
//      takes the whole K as one slice unless stripes alone leave the SMs
//      under 90 % busy (then the slices' f32 partial sums go to a workspace
//      and a second pass adds them in K order: deterministic, no atomics) or
//      I exceeds kMaxSlice. ctas is a multiple of the slice count, so a CTA
//      keeps one slice for its whole walk. 8-row units keep the last round
//      short: 94 rounds of 132 on the stack, where 32-row ones left a 24th
//      round 27 % full;
//    - x's columns of that slice come first, by TMA into the ring's first
//      slots (Stage::xrows rows a slot: 4 at 4 KB rows, so rows 0-3 and
//      4-7); each consumer warp copies its fragments into registers for the
//      whole walk (64 a lane at I = 4096; zero for rows t >= T) and the
//      slots go back to the ring: no x traffic in the ring's loop. Plain
//      loads of x from L2 beside the weight stream (132 SMs reading one 64
//      KB) cost a layer about twice what this copy ahead of it costs
//      (bench/gemv_ablation.py times the copy);
//    - the producer warp streams each unit's weights through a kDepth = 6
//      deep ring of [8 rows, kStageK = 2048 columns] stages (32 KB), one
//      cp.async.bulk a row into a row pitch 32 bytes over a
//      multiple of 128 (conflict-free 8-byte loads), completing on the
//      stage's `full` mbarrier; the consumer warps release a stage on its
//      `empty` mbarrier, so the next copy into it is issued while the
//      products run. The TMA unit's cost is per copy: row copies of 0.5-1 KB
//      (tried) streamed the stack slower than these;
//    - the products on tensor cores: mma.sync m16n8k16 bf16 -> f32 with x as
//      the A operand and the stage as the B operand (n = the 8 weight rows):
//      each weight element is read once from HBM and once from shared memory
//      for all rows. The k order inside each 16-column step is permuted
//      alike in A and B (as in ffn_fused.cu), so a lane's fragment of a row
//      is 4 adjacent columns: one 8-byte load. Consumer warp w takes the
//      steps j = w + 8i of each stage, kGroup = 4 steps' loads ahead of their
//      products. x of step i fills the A rows 0-7 (even i) or 8-15 (odd i)
//      of one register quad per step pair, so no register is copied or
//      zeroed for an mma, and the even and odd steps sum into two
//      accumulators (two chains of dependent mma, not one); a whole stage
//      runs without the guards of a short one (no branches between its
//      steps). At the unit's end each warp's part (its even sum plus its odd
//      one) and the eight parts are added in order through shared memory.
//    Rows past O are not copied and their sums not stored; K tails are whole
//    16-column steps (I % 16 == 0).
// 2. probe_gemv_tc_kernel<W_Q8_F32 | W_Q8_BF16, TILED> (K18b step_q8_current,
//    K18c step_q8_bf16mul, the stacked K18g call3_q8_current): the same walk
//    over int8 weights w [L, O, I] with f32 scales s [L, O, NB]: wd[l, o, k]
//    = bf16(f32(q) * s[o, k % NB]) (W_Q8_F32) or bf16(bf16(q) * bf16(s[o, k
//    % NB])) (W_Q8_BF16), as the scripts' pltpu.repeat tiles the [O, NB]
//    scales along the columns (NB = I / 32 there). Bound: bytes, the int8
//    weights and the scales (18.9 MB a [4096, 4096] layer: 5.7 us; 453 MB
//    the stack: 135 us). The first design (a CUDA-core GEMV, now gone) read
//    the stack at 0.16 TB/s: 16 f32 scale loads a 16-byte weight load, an
//    I2F conversion a weight on the 16-a-clock conversion pipe, the
//    products as CUDA-core FMAs. Here:
//    - a stage is [8 rows, 2048 int8 columns] (16 KB) at a row pitch 16 bytes
//      over a multiple of 128, so a lane group's 4-byte fragment loads are
//      free of bank conflicts; the ring holds 12 (the same 192 KB), x rows
//      0-7 its first four. Stages of 4096 columns, 6 deep, stream the stack
//      as fast but a single layer 8 % slower (the first bytes wait for a
//      32 KB stage);
//    - the B fragment of a step is one 4-byte load (columns 4q .. 4q + 3 of
//      row g), dequantized in registers: byte e of raw ^ 0x80808080 is q +
//      128; a byte permute puts it under the exponent of 2^23, and one f32
//      subtraction of 2^23 + 128 leaves q exactly (all 256 values). Then
//      W_Q8_F32: __fmul_rn by the scale and cvt.rn.bf16x2.f32; W_Q8_BF16:
//      the high halves of two such f32 (bf16(q), exact) times the rounded
//      scales by mul.rn.bf16x2 (the exact product of two bf16 values has
//      at most 16 significant bits, so one rounding equals the f32
//      product's). Per weight element a lane issues 1 permute, 1 FADD, 1
//      FMUL and half a cvt (W_Q8_F32) or 1.5 permutes, 1 FADD and half an
//      HMUL2 (W_Q8_BF16), plus a quarter XOR, shared load and mma. On the
//      H100 the I2F conversion and an integer bf16 rounding in their place
//      both stream the stack slower (bench/gemv_ablation.py);
//    - TILED (16 * kParts % NB == 0, NB = 128 on the probes): warp w's
//      columns of a step j = w + 8i are kbeg + 16j + 4q + e, so modulo NB
//      they are (kbeg + 16w) % NB + 4q + e for the whole walk; each lane
//      holds its four scales of row o0 + g for a unit (one 16-byte __ldg,
//      issued a unit ahead: a load from HBM under the stream waited for at
//      the unit's start cost the stack a fifth of its time). Any other NB (a
//      multiple of 16 dividing I) loads the four scales of each step beside
//      its fragment.
//    The scale bytes still come from HBM once, and count in the bound. On
//    the stack the conversions keep the kernel ~15 % over the int8 stream
//    probe (K18j); on one layer a call's fixed cost (launch, x copy, the
//    ring's fill) weighs about twice what the conversions add
//    (bench/gemv_ablation.py's "no dequantization" variant).
// 3. probe_gemv_tc_kernel<W_S8, false, BS> (K18d step_q8_int8dot, K18h
//    call3_q8_int8dot; K18e step_q8_int8dot_blockscale with block scales):
//    y[l, t, o] = f32((xq . w[l, o])_int32) for xq int8 [T <= 8, I], w int8
//    [L, O, I]; the block-scale form times corr[l, o, t] = sum_b s[l, o, b] *
//    xsc[t, b] (f32). Bound: bytes, the int8 weights (16.8 MB a [4096, 4096]
//    layer: 5.0 us; 403 MB the stack: 120 us), and for K18e the scales (2.1
//    MB more: 5.7 us); 2 operations a weight byte at T = 8, far under the
//    int8 ridge, so mma.sync does. The first design (a dp4a GEMV, now gone:
//    16 weight rows a block, one 16-byte load a lane and row in flight, xq
//    restaged in shared memory every 1024 columns between two block
//    barriers, 32 dp4a and 8 shared x loads a weight load, and K18e's
//    corrections a lane-0 loop of 128 dependent scale products each) read a
//    layer at 0.36 TB/s and the stack at 0.88. Here the walk is item 1's:
//    - xq's slice arrives by TMA into the ring's first two slots (4 rows a
//      slot at a pitch of 4096 + 32 bytes) and stays in registers as the A
//      operand (32 a lane at I = 4096);
//    - stages of [8 rows, 2048 int8 columns] at a row pitch 32 bytes over a
//      multiple of 128 (conflict-free 8-byte loads), 12 deep, as the q8
//      kinds' (the same 16 KB stages and ring bytes);
//    - mma.sync m16n8k32 s8 -> s32 (mma_s8) with the raw stage bytes as the
//      B operand: no conversion. Each 32-column step's contraction index is
//      permuted alike in A and B (the mma's k = 4q .. 4q + 3 and 16 + 4q ..
//      16 + 4q + 3 are the step's columns 8q .. 8q + 7), so a lane's
//      fragment of a row is 8 adjacent bytes: one 8-byte load of B and of
//      each x row. Even and odd steps fill A rows 0-7 and 8-15 and sum apart,
//      as item 1's. A slice with an odd number of 16-column halves ends in a
//      step whose second half (lanes q = 2, 3) has zero x: its B bytes lie
//      within the stage's row pitch, stale, and multiply zeros;
//    - exact: the mma sums, the parts and the K slices' partial sums are all
//      int32 (|sum| <= I * 127 * 128 < 2^31 below I = 132104), the partial
//      sums an int32 workspace that the second pass (probe_s8_sum_kernel)
//      adds in int32 before the one conversion to f32. f32 partials would
//      round above 2^24 (66,064,384 at I = 4096) where the script's int32
//      dot does not;
//    - block scales (BS, K18e whole-K): a lane holds its xsc values (b =
//      lane + 32 m, m < kSRegs, every t) in registers for the walk; warp
//      w's lanes copy their scales of stripe row w by cp.async into a
//      shared ring kScaleAhead = 2 units ahead, waited for at the unit's end
//      by cp.async.wait_group (a register lookahead's copy at each unit's
//      start waited on the loads of the unit before, so no depth helped).
//      At the unit's end warp w forms corr[t] of row w (block_corr): a lane
//      over its b in order by FMA, then a butterfly over the lanes that
//      hands half its sums on at each of its first three steps (9
//      shuffles), in place of the first design's serial loop; scales past
//      kSRegs * 32 are read there. A fixed order, so two runs are
//      bit-equal; a split's second pass forms the same sums, one warp a
//      row, after the int32 sum, so a split changes no bit.
//      bench/gemv_ablation.py's S8_VARIANTS time each piece.
// 4. probe_stream_kernel (K18f step_dma_probe, K18j call3_dma_probe, K19a
//    probe_blockspec, K19b probe_manual_dma, K19c int8dot_manual_dma): the
//    weight rows stream through a `depth`-deep ring of shared-memory stages,
//    each stage one TMA bulk copy (cp.async.bulk) completing on its own
//    mbarrier, a persistent grid of one block per SM taking the stages in
//    turn. Only the rows the TPU body touched are read out of a stage (the
//    first rows of each `ch`-row chunk), except in the int8-dot mode, which
//    multiplies every row. A stage is consumed, and the block synchronised,
//    before the next copy into its slot is issued (the TPU scripts issue it
//    first: bench_dma_sweep.py:107-108, 157-158). Bound: bytes.
//
// How the TPU's (depth, ch) map onto Hopper: a TPU stage was a whole [ch, I]
// chunk of 1-4 MB in VMEM; here a block has at most 227 KB. So `depth` stays
// the number of copies in flight per block (per SM), `ch` stays the chunk
// whose first rows are touched (and whose int8 dot is summed in int32 before
// it becomes f32), and a stage holds the largest power-of-two number of rows
// dividing `ch` such that `depth` stages fit in kRingBytes. The BlockSpec
// forms (K18f/j, K19a) ran the TPU's double-buffered pipeline: depth 2.
// Stage g goes to block g % grid. The touched rows (f32) or each chunk's
// int32 dot sums (atomic adds, exact in any order) go to a scratch buffer,
// and one pass then writes the
// [T, O] output in the TPU order: the last chunk's rows (+ x[t, 0]), or the
// per-chunk sums in chunk order. So the result is deterministic and, for the
// sums, in the reference's summation order.
#include <type_traits>

#include "tc_gemv.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 8;           // activation rows (the TPU harness pads T = 1 to 8)
constexpr int kRingBytes = 128 * 1024;
constexpr int kMaxDepth = 16;
constexpr int kMaxSlices = 2;      // int8-dot stream: 16-byte column slices per thread

enum SMode { S_LAST = 0, S_SUM = 1, S_DOT = 2 };

// ------------------------------------------------------ tensor-core GEMV
constexpr int kStripe = 8;                         // weight rows of a work unit (the mma's n)
constexpr int kStageK = 2048;                      // weight columns of a ring stage
constexpr int kDepth = 6;                          // ring stages of bf16 weights (32 KB each)
constexpr int kMaxSlice = 4096;                    // x columns a CTA holds
constexpr int kParts = 8;                          // consumer warps: column parts of a stage
constexpr int kGroup = 4;                          // a warp's steps loaded, converted, multiplied together
constexpr int kConsumers = 32 * kParts;
constexpr int kTcThreads = kConsumers + 32;        // + the producer warp
constexpr int kRedPitch = kStripe + 1;             // sums a row t of a part's
constexpr int kSRegs = 4;                          // W_S8 block scales a lane holds (b = lane + 32 m)
constexpr int kScaleAhead = 2;                     // W_S8: units whose block scales are in flight
static_assert(kStripe == kParts, "W_S8 block scales: warp w forms the correction of stripe row w");

// A ring stage of weight kind WK: K columns of 8 rows; int8 stages hold half
// the bytes, and the ring twice as many of them (the same ring bytes). A step
// is kstep columns (16; 32 for W_S8's int8 mma); a lane's fragment of a step's
// row is lane_bytes adjacent bytes (4 columns of bf16 or int8, or 8 of W_S8's
// int8), and the row pitch (32 bytes over a multiple of 128 for 8-byte
// fragments, 16 for 4-byte ones) keeps a lane group's fragment loads free of
// bank conflicts. x (bf16, or W_S8's int8 xq) takes the first xslots slots,
// xrows rows a slot at the pitch xpitch; a lane's x fragment of a step is 8
// bytes.
template <int WK>
struct Stage {
  static constexpr int esize = WK == W_BF16 ? 2 : 1;
  static constexpr int xsize = WK == W_S8 ? 1 : 2;
  static constexpr int kstep = WK == W_S8 ? 32 : 16;
  static constexpr int K = kStageK;
  static constexpr int depth = kDepth * 2 / esize;
  static constexpr int steps = K / kstep / kParts;  // a warp's steps of a stage
  static constexpr int lane_bytes = kstep / 4 * esize;
  static constexpr int pitch = K * esize + (lane_bytes == 8 ? 32 : 16);
  static constexpr int bytes = kStripe * pitch;
  static constexpr int xpitch = kMaxSlice * xsize + 32;
  static constexpr int xrows = bytes / xpitch;
  static constexpr int xslots = (kMaxT + xrows - 1) / xrows;
  static constexpr int xfrags = kMaxSlice / kstep / kParts;  // a lane's x fragments
  static_assert(xrows >= 1 && xslots < depth, "x fits the ring's first slots");
  static_assert(kstep / 4 * xsize == 8, "a lane's x fragment of a step is 8 bytes");
};

// The walk: unit u is stripe u / nks (layer s / ns, rows (s % ns) * kStripe
// ..) over K slice u % nks; CTA c takes u = c, c + ctas, ... (ctas % nks ==
// 0: one slice a CTA). ops/probes.py GemvPlan mirrors it.
struct TcWalk {
  const void* x;           // [T, I] bf16 (W_S8: int8 xq)
  const void* w;           // [L, O, I] bf16 or int8
  const float* s;          // int8 w: the scales [L, O, NB] (W_S8: the block scales, or null)
  const float* xsc;        // W_S8 block scales: xsc [T, NB]
  void* out;               // y [L, T, O] f32 (nks == 1) or the partial sums [nks, L, T, O]
                           // (f32; W_S8: int32)
  int T, O, I, L, NB, ns, nks, ctas;
  __device__ int units() const { return L * ns * nks; }
  // first column of slice ks (whole 16-column steps)
  __device__ int slice_k(int ks) const {
    return static_cast<int>(static_cast<long long>(ks) * (I / 16) / nks) * 16;
  }
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 sums, n = the 8 weight
// rows of a stripe; lane (g = lane / 4, q = lane % 4) holds a's rows g (a0,
// a2) and g + 8 (a1, a3), and c0, c1 (row g) and c2, c3 (row g + 8) at
// columns 2q, 2q + 1. The contraction index of each 16-column step is
// permuted alike in a and b: the mma's k = 2q, 2q + 1 and 2q + 8, 2q + 9 are
// the step's columns 4q .. 4q + 3, so each lane's x and weight fragments of
// a row are 4 adjacent columns. x takes rows 0-7 of one step and rows 8-15
// of the next (a quad of registers holds both), so an even step's sums are
// c0, c1 of one accumulator and an odd step's c2, c3 of another; the other
// half of each is dropped (mma16, tc_gemv.cuh). W_S8's 32-column steps lay
// out alike (mma_s8): a lane's fragments are columns 8q .. 8q + 7.

// The lane's four scales s[c .. c + 3] (v) as the kind multiplies by them:
// f32 bits (W_Q8_F32), or two bf16x2 of the scales rounded to bf16 (W_Q8_BF16).
template <int WK>
__device__ __forceinline__ void to_scales(const float4& v, uint32_t (&sv)[4]) {
  if constexpr (WK == W_Q8_F32) {
    sv[0] = __float_as_uint(v.x);
    sv[1] = __float_as_uint(v.y);
    sv[2] = __float_as_uint(v.z);
    sv[3] = __float_as_uint(v.w);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    sv[0] = *reinterpret_cast<const uint32_t*>(&lo);
    sv[1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// W_S8 block scales: the lane's s[row + b], b = lane + 32 m (m < kSRegs; 0 past NB).
__device__ __forceinline__ void load_block_scales(float (&v)[kSRegs], const float* row, int NB,
                                                  int lane) {
#pragma unroll
  for (int m = 0; m < kSRegs; ++m) {
    const int b = lane + 32 * m;
    v[m] = b < NB ? __ldg(row + b) : 0.f;
  }
}

// The lane's xsc[t, b] for b = lane + 32 m (m < kSRegs), every t (clamped
// to valid addresses: t >= T reads row T - 1, b >= NB column NB - 1).
__device__ __forceinline__ void load_xsc(float (&xv)[kSRegs][kMaxT], const float* xsc, int NB,
                                         int T, int lane) {
#pragma unroll
  for (int m = 0; m < kSRegs; ++m)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      xv[m][t] = __ldg(xsc + min(t, T - 1) * NB + min(lane + 32 * m, NB - 1));
}

// corr[t] = sum over b of row[b] * xsc[t, b] (f32) for one weight row, by a
// warp; returns corr[lane / 4] (t >= T: a copy of row T - 1's). Lane l sums
// b = l + 32 m in order of m, one FMA each (sv and xv for m < kSRegs, row
// and xsc themselves past them); then a butterfly over the lanes (offsets
// 16, 8, 4, 2, 1) that hands half of its sums on at each of the first three
// steps: 9 shuffles, not 40, and each t's sums added in the butterfly's
// tree. Any warp that forms them for the row (the whole-K kernel's or the
// split's second pass) gets the same bits.
__device__ __forceinline__ float block_corr(const float (&sv)[kSRegs],
                                            const float (&xv)[kSRegs][kMaxT], const float* row,
                                            const float* xsc, int NB, int T, int lane) {
  float c[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) c[t] = 0.f;
#pragma unroll
  for (int m = 0; m < kSRegs; ++m)
    if (lane + 32 * m < NB)
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) c[t] = fmaf(sv[m], xv[m][t], c[t]);
  for (int b = lane + 32 * kSRegs; b < NB; b += 32) {
    const float v = __ldg(row + b);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) c[t] = fmaf(v, __ldg(xsc + min(t, T - 1) * NB + b), c[t]);
  }
  // step 1 keeps t with bit 2 = lane bit 4, step 2 bit 1 = lane bit 3,
  // step 3 bit 0 = lane bit 2: lane l ends with t = l / 4
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float d4[4], d3[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d4[i] = (h4 ? c[i + 4] : c[i]) + __shfl_xor_sync(0xffffffffu, h4 ? c[i] : c[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    d3[i] = (h3 ? d4[i + 2] : d4[i]) + __shfl_xor_sync(0xffffffffu, h3 ? d4[i] : d4[i + 2], 8);
  float z = (h2 ? d3[1] : d3[0]) + __shfl_xor_sync(0xffffffffu, h2 ? d3[0] : d3[1], 4);
  z += __shfl_xor_sync(0xffffffffu, z, 2);
  return z + __shfl_xor_sync(0xffffffffu, z, 1);
}

// W_S8 block scales through shared memory: a lane's 4-byte copies (zero
// past NB) of a unit's row, one commit group (empty where the walk has no
// such unit), so no register waits on them until the unit that needs them
// (cp.async.wait_group).
__device__ __forceinline__ void copy_block_scales(uint32_t dst, const float* row, int NB,
                                                  int lane, bool unit) {
  if (unit)
#pragma unroll
    for (int m = 0; m < kSRegs; ++m) {
      const int b = lane + 32 * m;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 128 * m),
                   "l"(row + min(b, NB - 1)), "r"(b < NB ? 4 : 0)
                   : "memory");
    }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void read_block_scales(float (&v)[kSRegs], const float* slot) {
#pragma unroll
  for (int m = 0; m < kSRegs; ++m) v[m] = slot[32 * m];
}

// Dynamic shared memory: the ring [S::depth][kStripe rows of S::pitch], then
// two buffers of the parts' sums [kParts][kMaxT][kRedPitch] (f32; W_S8:
// int32); BS (W_S8 whole-K with block scales): then two buffers of the
// stripe's corrections [kMaxT][kStripe] f32 and the block scales' ring
// [kScaleAhead][kParts][kSRegs * 32] f32.
// TILED (int8 kinds): 16 * kParts % NB == 0, so a lane's scales are fixed for
// a unit.
template <int WK, bool TILED, bool BS>
__global__ void __launch_bounds__(kTcThreads) probe_gemv_tc_kernel(TcWalk a) {
  using S = Stage<WK>;
  using Acc = typename std::conditional<WK == W_S8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S::depth], empty[S::depth];
  Acc* red = reinterpret_cast<Acc*>(smem + S::depth * S::bytes);
  float* cbuf = reinterpret_cast<float*>(red + 2 * kParts * kMaxT * kRedPitch);
  const int c = blockIdx.x, ks = c % a.nks;
  const int kbeg = a.slice_k(ks), kend = a.slice_k(ks + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int d = 0; d < S::depth; ++d) {
      mbar_init(&full[d]);              // the producer's expect_tx, then the bytes
      mbar_init(&empty[d], kParts);     // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kParts) {  // the producer warp: lane r copies row r of each stage
    // x's slice first, S::xrows rows a slot (rows t < T)
    for (int h = 0; h < S::xslots; ++h) {
      const int rows = max(0, min(S::xrows, a.T - S::xrows * h));
      if (lane == 0)
        mbar_expect_tx(&full[h], static_cast<unsigned>(rows * (kend - kbeg) * S::xsize));
      __syncwarp();
      if (lane < rows)
        bulk_load(smem + h * S::bytes + lane * S::xpitch,
                  static_cast<const char*>(a.x) +
                      (static_cast<long long>(S::xrows * h + lane) * a.I + kbeg) * S::xsize,
                  (kend - kbeg) * S::xsize, &full[h]);
    }
    int slot = S::xslots;
    unsigned phase = 0;
    for (int u = c; u < a.units(); u += a.ctas) {
      const int s = u / a.nks, l = s / a.ns, o0 = (s % a.ns) * kStripe;
      const int rows = min(kStripe, a.O - o0);
      const char* src = static_cast<const char*>(a.w) +
                        (static_cast<long long>(l) * a.O + o0 + lane) * a.I * S::esize;
      for (int k = kbeg; k < kend; k += S::K) {
        const int kc = min(S::K, kend - k);
        mbar_wait(&empty[slot], phase ^ 1);
        if (lane == 0) mbar_expect_tx(&full[slot], static_cast<unsigned>(rows * kc * S::esize));
        __syncwarp();
        if (lane < rows)
          bulk_load(smem + slot * S::bytes + lane * S::pitch, src + k * S::esize, kc * S::esize,
                    &full[slot]);
        if (++slot == S::depth) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  // int8 kinds: the lane's scales of row o0 + g of unit u (rows past O read
  // row O - 1; their sums are dropped). TILED: the four a unit are loaded one
  // unit ahead (a load from HBM under the stream takes 1-2 us), the first
  // before x is read.
  auto scale_row = [&](int u) {
    const int s = u / a.nks, o = min((s % a.ns) * kStripe + g, a.O - 1);
    return a.s + (static_cast<long long>(s / a.ns) * a.O + o) * a.NB + 4 * q;
  };
  float4 snext = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (TILED)
    if (c < a.units()) snext = ldg4(scale_row(c) + (kbeg + 16 * warp) % a.NB);
  // BS: warp w's block scales of stripe row w (past O: row O - 1) of unit
  // u, copied kScaleAhead units ahead into the lane's slots of the scale
  // ring; the lane's xsc values in registers for the whole walk
  auto bs_row = [&](int u) {
    const int o = min((u % a.ns) * kStripe + warp, a.O - 1);
    return a.s + (static_cast<long long>(u / a.ns) * a.O + o) * a.NB;
  };
  float* sring = cbuf + 2 * kMaxT * kStripe + warp * kSRegs * 32 + lane;
  auto bs_slot = [&](int n) { return sring + (n % kScaleAhead) * kParts * kSRegs * 32; };
  float xv[kSRegs][kMaxT];
  if constexpr (BS) {
#pragma unroll
    for (int n = 0; n < kScaleAhead; ++n)
      copy_block_scales(smem_u32(bs_slot(n)), bs_row(c + n * a.ctas), a.NB, lane,
                        c + n * a.ctas < a.units());
    load_xsc(xv, a.xsc, a.NB, a.T, lane);
  }
  // This warp's x fragments of the slice, from the ring's first slots into
  // registers for the whole walk (the mma's A operand): step j = warp +
  // kParts * i of stage st is f = st * S::steps + i, the lane's 8 bytes of
  // x[g] at col + (S::kstep / 4) q for the step's first column col, in quad
  // f / 2 (rows g for even f, g + 8 for odd f); zero for t >= T and past the
  // slice. Then the slots go back to the ring.
  for (int h = 0; h < S::xslots; ++h) mbar_wait(&full[h], 0);
  const uint32_t x_lane =
      smem_u32(smem) + (g / S::xrows) * S::bytes + (g % S::xrows) * S::xpitch + 8 * q;
  uint32_t xq[S::xfrags / 2][4];
#pragma unroll
  for (int f = 0; f < S::xfrags; ++f) {
    const int col = (f / S::steps) * S::K + (warp + kParts * (f % S::steps)) * S::kstep;
    uint32_t v[2] = {0u, 0u};
    if (g < a.T && kbeg + col + S::kstep / 4 * q < kend) lds64(v, x_lane + col * S::xsize);
    xq[f / 2][f % 2] = v[0];
    xq[f / 2][2 + f % 2] = v[1];
  }
#pragma unroll
  for (int m = 0; m < S::xfrags / 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(xq[m][e]));
  __syncwarp();
  if (lane == 0)
    for (int h = 0; h < S::xslots; ++h) mbar_arrive(&empty[h]);

  // this lane's B fragments: weight row g, its lane_bytes of a step
  const uint32_t b_lane = smem_u32(smem) + g * S::pitch + S::lane_bytes * q;
  int slot = S::xslots, buf = 0;
  unsigned phase = 0;
  for (int u = c; u < a.units(); u += a.ctas) {
    const int s = u / a.nks, l = s / a.ns, o0 = (s % a.ns) * kStripe;
    const float* srow = nullptr;  // int8, not TILED: the unit's scale row
    uint32_t su[4] = {0u, 0u, 0u, 0u};  // TILED: the lane's four for the unit
    if constexpr (TILED) {  // this unit's scales; the next unit's go out now
      to_scales<WK>(snext, su);
      if (u + a.ctas < a.units()) snext = ldg4(scale_row(u + a.ctas) + (kbeg + 16 * warp) % a.NB);
    } else if constexpr (WK == W_Q8_F32 || WK == W_Q8_BF16) {
      srow = scale_row(u);
    }
    Acc acc[2][4] = {};  // even and odd steps
#pragma unroll
    for (int st = 0; st < kMaxSlice / S::K; ++st) {
      const int k = kbeg + st * S::K;
      if (k >= kend) break;
      // this warp's: j = warp (mod kParts); W_S8's last may be half a step
      const int steps = (min(S::K, kend - k) + S::kstep - 1) / S::kstep;
      mbar_wait(&full[slot], phase);
      const uint32_t wb = b_lane + slot * S::bytes;
      // kGroup steps a group: their fragments are loaded (bf16 and W_S8's
      // int8 8 bytes, the q8 kinds' raw int8 4 bytes in [.][0]), converted
      // (q8 kinds), then multiplied. A whole stage runs without the guards j
      // < steps: no branches between its steps, so their loads and
      // conversions interleave.
      auto products = [&](auto guard) {
        constexpr bool G = decltype(guard)::value;
#pragma unroll
        for (int i0 = 0; i0 < S::steps; i0 += kGroup) {
          uint32_t ld[kGroup][2], bf[kGroup][2];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const int j = warp + kParts * (i0 + i);
            if (!G || j < steps) {
              if constexpr (S::lane_bytes == 8)
                lds64(ld[i], wb + j * S::kstep * S::esize);
              else
                ld[i][0] = lds32(wb + j * 16);
            }
          }
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const int j = warp + kParts * (i0 + i);
            if (G && j >= steps) continue;
            if constexpr (WK == W_BF16 || WK == W_S8) {
              bf[i][0] = ld[i][0];
              bf[i][1] = ld[i][1];
            } else if constexpr (TILED) {
              dequant4<WK>(ld[i][0], su, bf[i]);
            } else {
              uint32_t sv[4];
              to_scales<WK>(ldg4(srow + (k + 16 * j) % a.NB), sv);
              dequant4<WK>(ld[i][0], sv, bf[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
            if (!G || warp + kParts * (i0 + i) < steps) {
              if constexpr (WK == W_S8)
                mma_s8(acc[(i0 + i) & 1], xq[(st * S::steps + i0 + i) / 2], bf[i]);
              else
                mma16(acc[(i0 + i) & 1], xq[(st * S::steps + i0 + i) / 2], bf[i]);
            }
        }
      };
      if (steps == S::K / S::kstep)
        products(Flag<false>());
      else
        products(Flag<true>());
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == S::depth) {
        slot = 0;
        phase ^= 1;
      }
    }
    // this warp's part: t = g, rows 2q and 2q + 1 of the stripe
    Acc* r = red + (buf * kParts + warp) * kMaxT * kRedPitch + g * kRedPitch + 2 * q;
    r[0] = acc[0][0] + acc[1][2];
    r[1] = acc[0][1] + acc[1][3];
    if constexpr (BS) {  // warp w: the corrections of stripe row w, t = g in lanes (g, 0)
      const int n = (u - c) / a.ctas;  // the unit's place in this CTA's walk
      float sv[kSRegs];
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kScaleAhead - 1) : "memory");
      read_block_scales(sv, bs_slot(n));
      const float corr = block_corr(sv, xv, bs_row(u), a.xsc, a.NB, a.T, lane);
      if (q == 0) cbuf[(buf * kMaxT + g) * kStripe + warp] = corr;
      const int un = u + kScaleAhead * a.ctas;  // into the slot just read
      copy_block_scales(smem_u32(bs_slot(n)), bs_row(un), a.NB, lane, un < a.units());
    }
    consumer_sync();
    // thread (t, row): the parts in order (W_S8: int32, exact in any order)
    if (threadIdx.x < kMaxT * kStripe) {
      const int t = threadIdx.x / kStripe, row = threadIdx.x % kStripe;
      const int o = o0 + row;
      if (t < a.T && o < a.O) {
        const Acc* p = red + buf * kParts * kMaxT * kRedPitch + t * kRedPitch + row;
        Acc v = p[0];
#pragma unroll
        for (int w = 1; w < kParts; ++w) v += p[w * kMaxT * kRedPitch];
        const long long i = ((static_cast<long long>(ks) * a.L + l) * a.T + t) * a.O + o;
        if constexpr (WK == W_S8) {
          if (a.nks > 1) {
            static_cast<int*>(a.out)[i] = v;
          } else {
            float y = static_cast<float>(v);
            if constexpr (BS) y = __fmul_rn(y, cbuf[(buf * kMaxT + t) * kStripe + row]);
            static_cast<float*>(a.out)[i] = y;
          }
        } else {
          static_cast<float*>(a.out)[i] = v;
        }
      }
    }
    buf ^= 1;  // the next unit writes the other buffer; the one after waits on its barrier
  }
}

// y[i] = sum over the K slices, in order, of part[ks][i] (n = L * T * O).
__global__ void probe_gemv_sum_kernel(const float* __restrict__ part, int nks, long long n,
                                      float* __restrict__ y) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int ks = 1; ks < nks; ++ks) v += part[ks * n + i];
    y[i] = v;
  }
}

// W_S8 over K slices: y[l, t, o] = f32(the int32 sum over the slices of
// part[ks][l, t, o]), times corr[t] of row (l, o) where the block scales s
// and xsc are given (block_corr: the bits of the whole-K kernel's, so a
// split changes no bit of y). Without scales a thread an element (as
// probe_gemv_sum_kernel); with them a warp a row (l, o), lane t its y[l, t, o].
__global__ void probe_s8_sum_kernel(const int* __restrict__ part, const float* __restrict__ s,
                                    const float* __restrict__ xsc, float* __restrict__ y, int nks,
                                    int L, int T, int O, int NB) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (s == nullptr) {
    const long long n = static_cast<long long>(L) * T * O;
    for (long long i = tid; i < n; i += stride) {
      int v = part[i];
      for (int ks = 1; ks < nks; ++ks) v += part[ks * n + i];
      y[i] = static_cast<float>(v);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(L) * O;
  for (long long w = tid / 32; w < rows; w += stride / 32) {
    const long long l = w / O;
    const int o = static_cast<int>(w - l * O);
    float sv[kSRegs], xv[kSRegs][kMaxT];
    load_block_scales(sv, s + w * NB, NB, lane);
    load_xsc(xv, xsc, NB, T, lane);
    // lane t: corr[t] (block_corr leaves it in lane 4t)
    const float corr = __shfl_sync(0xffffffffu, block_corr(sv, xv, s + w * NB, xsc, NB, T, lane),
                                   (4 * lane) & 31);
    if (lane < T) {
      int v = 0;
      for (int ks = 0; ks < nks; ++ks) v += part[((ks * L + l) * T + lane) * O + o];
      y[(l * T + lane) * O + o] = __fmul_rn(static_cast<float>(v), corr);
    }
  }
}

template <int WK, bool TILED, bool BS = false>
cudaError_t gemv_launch(const TcWalk& a, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(Stage<WK>::depth) * Stage<WK>::bytes +
                      4 * 2 * kParts * kMaxT * kRedPitch +
                      (BS ? 4 * (2 * kMaxT * kStripe + kScaleAhead * kParts * kSRegs * 32) : 0);
  const cudaError_t e = lt_allow_smem(probe_gemv_tc_kernel<WK, TILED, BS>, smem);
  if (e != cudaSuccess) return e;
  probe_gemv_tc_kernel<WK, TILED, BS><<<a.ctas, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The GEMV's plan (ops/probes.py plan_gemv) as the kernel takes it: nks K
// slices of whole 16-column steps, ctas CTAs (a multiple of nks), every
// slice at most kMaxSlice columns, a workspace where nks > 1.
bool plan_ok(int T, int O, int I, int L, int nks, int ctas, const void* part) {
  const int n16 = I / 16;
  return T >= 1 && T <= kMaxT && I >= 16 && I % 16 == 0 && O >= 1 && L >= 1 && nks >= 1 &&
         nks <= n16 && ctas >= nks && ctas % nks == 0 &&
         (n16 + nks - 1) / nks * 16 <= kMaxSlice && (nks == 1 || part != nullptr);
}

TcWalk make_walk(const void* x, const void* w, const void* s, void* y, void* part, int T, int O,
                 int I, int L, int NB, int nks, int ctas) {
  TcWalk a;
  a.x = x;
  a.w = w;
  a.s = static_cast<const float*>(s);
  a.xsc = nullptr;
  a.out = nks > 1 ? part : y;
  a.T = T;
  a.O = O;
  a.I = I;
  a.L = L;
  a.NB = NB;
  a.ns = (O + kStripe - 1) / kStripe;
  a.nks = nks;
  a.ctas = ctas;
  return a;
}

// blocks of 256 threads for n items of a second pass, at most 4 an SM
int pass_blocks(long long n) {
  const long long cap = 4LL * lt_sm_count();
  return static_cast<int>((n + 255) / 256 < cap ? (n + 255) / 256 : cap);
}

// ------------------------------------------------------------ int8 dot
__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -------------------------------------------------------------- stream
struct StreamArgs {
  const char* w;      // the weight rows [n_rows, row_bytes], flattened over layers
  long n_rows;
  int row_bytes, esize;      // esize: 2 = bf16, 1 = int8
  int ch, stage_rows, depth;
  int nr, nc;                // touched rows of a chunk and their columns
  const void* x;             // bf16 [T, I] (S_LAST, S_SUM) or int8 xq [T, I] (S_DOT)
  int T, I;
  float* rec;                // S_LAST: [nr, nc]; S_SUM: [n_chunks, nr, nc]
  int* part;                 // S_DOT: [n_chunks, T] int32 sums of each chunk (zeroed first)
};

template <int MODE>
__global__ void __launch_bounds__(kThreads) probe_stream_kernel(StreamArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  __shared__ int red[kThreads / 32][kMaxT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned stage_bytes = static_cast<unsigned>(a.stage_rows) * a.row_bytes;
  const long n_stages = a.n_rows / a.stage_rows;
  const long n_chunks = a.n_rows / a.ch;
  const long b = blockIdx.x, nb = gridDim.x;
  const long mine = (n_stages - b + nb - 1) / nb;  // stages b, b + nb, ...
  if (tid == 0) {
    for (int d = 0; d < a.depth; ++d) mbar_init(&full[d]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // S_DOT: this thread's 16-byte column slices of xq, for every row t
  int xr[kMaxSlices][kMaxT][4];
  const int n_slices = a.I / 16;
  if (MODE == S_DOT) {
#pragma unroll
    for (int sl = 0; sl < kMaxSlices; ++sl) {
      const int c = tid + sl * kThreads;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        int4 v = make_int4(0, 0, 0, 0);
        if (c < n_slices && t < a.T)
          v = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(a.x) +
                                             static_cast<long>(t) * a.I + c * 16);
        xr[sl][t][0] = v.x;
        xr[sl][t][1] = v.y;
        xr[sl][t][2] = v.z;
        xr[sl][t][3] = v.w;
      }
    }
  }

  auto issue = [&](long n) {
    const int slot = static_cast<int>(n % a.depth);
    const long g = b + n * nb;
    mbar_expect_tx(&full[slot], stage_bytes);
    bulk_load(ring + static_cast<long>(slot) * stage_bytes, a.w + g * stage_bytes, stage_bytes,
              &full[slot]);
  };
  if (tid == 0)
    for (long n = 0; n < mine && n < a.depth; ++n) issue(n);

  for (long n = 0; n < mine; ++n) {
    const int slot = static_cast<int>(n % a.depth);
    mbar_wait(&full[slot], static_cast<unsigned>((n / a.depth) & 1));
    const unsigned char* st = ring + static_cast<long>(slot) * stage_bytes;
    const long g = b + n * nb, row0 = g * a.stage_rows;
    if (MODE == S_DOT) {
      int acc[kMaxT];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) acc[t] = 0;
      for (int rr = 0; rr < a.stage_rows; ++rr) {
#pragma unroll
        for (int sl = 0; sl < kMaxSlices; ++sl) {
          const int c = tid + sl * kThreads;
          if (c < n_slices) {
            const int4 wv =
                *reinterpret_cast<const int4*>(st + static_cast<long>(rr) * a.row_bytes + c * 16);
#pragma unroll
            for (int t = 0; t < kMaxT; ++t) {
              int v = __dp4a(wv.x, xr[sl][t][0], acc[t]);
              v = __dp4a(wv.y, xr[sl][t][1], v);
              v = __dp4a(wv.z, xr[sl][t][2], v);
              acc[t] = __dp4a(wv.w, xr[sl][t][3], v);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int v = warp_isum(acc[t]);
        if (lane == 0) red[warp][t] = v;
      }
      __syncthreads();
      if (tid < a.T) {  // int32 sums wrap, so the chunk's sum is exact in any order
        unsigned v = 0;
        for (int w = 0; w < kThreads / 32; ++w) v += static_cast<unsigned>(red[w][tid]);
        atomicAdd(reinterpret_cast<unsigned*>(a.part) + (row0 / a.ch) * a.T + tid, v);
      }
    } else {
      for (int rr = 0; rr < a.stage_rows; ++rr) {
        const long row = row0 + rr, c = row / a.ch;
        const int r = static_cast<int>(row - c * a.ch);
        if (r >= a.nr || (MODE == S_LAST && c != n_chunks - 1)) continue;
        float* dst = a.rec + ((MODE == S_SUM ? c * a.nr : 0) + r) * a.nc;
        const unsigned char* src = st + static_cast<long>(rr) * a.row_bytes;
        for (int col = tid; col < a.nc; col += blockDim.x)
          dst[col] = a.esize == 2
                         ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(src)[col])
                         : static_cast<float>(reinterpret_cast<const int8_t*>(src)[col]);
      }
    }
    __syncthreads();  // the stage is consumed: its slot may be refilled
    if (tid == 0 && n + a.depth < mine) issue(n + a.depth);
  }
}

// The [T, O] output from the scratch, in the TPU order:
//   S_LAST: out[t, c] = rec[t, c] + x[t, 0] for t < nr, c < nc;
//   S_SUM:  out[t, c] = (sum over chunks in order of rec[chunk, t, c]) + x[t, 0];
//   S_DOT:  out[t, 0] = sum over chunks in order of f32(part[chunk, t]), the
//           chunk's int32 sum (block 0 stages part in shared memory first);
// zero elsewhere.
template <int MODE>
__global__ void probe_stream_finish_kernel(StreamArgs a, float* __restrict__ out, int O) {
  extern __shared__ int part_s[];  // S_DOT: [n_chunks, T]
  const long n_chunks = a.n_rows / a.ch;
  const int n_out = a.T * O;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_out; i += gridDim.x * blockDim.x) {
    const int t = i / O, c = i - t * O;
    if (MODE == S_DOT) {
      if (c != 0) out[i] = 0.f;
      continue;
    }
    float v = 0.f;
    if (t < a.nr && c < a.nc) {
      const float xv = __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[
          static_cast<long>(t) * a.I]);
      if (MODE == S_LAST) {
        v = __fadd_rn(a.rec[t * a.nc + c], xv);
      } else {
        float acc = 0.f;
#pragma unroll 8
        for (long k = 0; k < n_chunks; ++k)
          acc = __fadd_rn(acc, a.rec[(k * a.nr + t) * a.nc + c]);
        v = __fadd_rn(acc, xv);
      }
    }
    out[i] = v;
  }
  if (MODE == S_DOT && blockIdx.x == 0) {
    for (long i = threadIdx.x; i < n_chunks * a.T; i += blockDim.x) part_s[i] = a.part[i];
    __syncthreads();
    if (threadIdx.x < a.T) {
      float acc = 0.f;
      for (long k = 0; k < n_chunks; ++k)
        acc = __fadd_rn(acc, static_cast<float>(part_s[k * a.T + threadIdx.x]));
      out[threadIdx.x * O] = acc;
    }
  }
}

template <int MODE>
int stream_launch(StreamArgs a, float* out, int O, cudaStream_t st) {
  const size_t ring = static_cast<size_t>(a.depth) * a.stage_rows * a.row_bytes;
  cudaError_t e = lt_allow_smem(probe_stream_kernel<MODE>, ring);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n_stages = a.n_rows / a.stage_rows;
  const int grid = static_cast<int>(n_stages < lt_sm_count() ? n_stages : lt_sm_count());
  if (MODE == S_DOT) {
    e = cudaMemsetAsync(a.part, 0, sizeof(int) * (a.n_rows / a.ch) * a.T, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  probe_stream_kernel<MODE><<<grid, kThreads, ring, st>>>(a);
  LT_RETURN_IF_ERROR();
  const size_t fin = MODE == S_DOT ? sizeof(int) * (a.n_rows / a.ch) * a.T : 0;
  e = lt_allow_smem(probe_stream_finish_kernel<MODE>, fin);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_stream_finish_kernel<MODE><<<(a.T * O + 255) / 256, 256, fin, st>>>(a, out, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K18a, b, c, g, i. x bf16 [T, I]; w [L, O, I], bf16 (wkind W_BF16) or int8
// with f32 scales s [L, O, NB] (W_Q8_F32, W_Q8_BF16: column k scaled by s[.,
// k % NB]); y [L, T, O] f32. The plan (ops/probes.py plan_gemv): nks K
// slices, ctas CTAs (a multiple of nks); part: f32 [nks, L, T, O] when nks >
// 1. 1 <= T <= 8, I % 16 == 0, every slice at most kMaxSlice columns; int8:
// NB % 16 == 0 and I % NB == 0; x, w and s 16-byte aligned.
LT_EXPORT int lt_probe_gemv(const void* x, const void* w, const void* s, void* y, void* part,
                            int T, int O, int I, int L, int NB, int wkind, int nks, int ctas,
                            void* stream) {
  const bool q8 = wkind == W_Q8_F32 || wkind == W_Q8_BF16;
  if (!plan_ok(T, O, I, L, nks, ctas, part) || (!q8 && wkind != W_BF16) ||
      (q8 && (s == nullptr || NB < 16 || NB % 16 || I % NB)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(s)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcWalk a = make_walk(x, w, s, y, part, T, O, I, L, NB, nks, ctas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tiled = q8 && (16 * kParts) % NB == 0;
  cudaError_t e;
  if (wkind == W_BF16)
    e = gemv_launch<W_BF16, false>(a, st);
  else if (wkind == W_Q8_F32)
    e = tiled ? gemv_launch<W_Q8_F32, true>(a, st) : gemv_launch<W_Q8_F32, false>(a, st);
  else
    e = tiled ? gemv_launch<W_Q8_BF16, true>(a, st) : gemv_launch<W_Q8_BF16, false>(a, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nks > 1) {
    const long long n = static_cast<long long>(L) * T * O;
    probe_gemv_sum_kernel<<<pass_blocks(n), 256, 0, st>>>(static_cast<const float*>(part), nks,
                                                          n, static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

// K18d, e, h: the GEMV's W_S8 kind. xq int8 [T, I]; w int8 [L, O, I]; y [L,
// T, O] f32 = f32((xq . w[l]^T)_int32), times corr[l, o, t] = sum_b s[l, o,
// b] * xsc[t, b] (f32) where the block scales s [L, O, NB] and xsc [T, NB]
// are given (both or neither). The plan as lt_probe_gemv's; part: int32
// [nks, L, T, O] when nks > 1, the slices' sums, which the second pass adds
// in int32 before it converts them and applies the block scales. xq and w
// 16-byte aligned, s and xsc 4-byte.
LT_EXPORT int lt_probe_int8dot(const void* xq, const void* w, const void* s, const void* xsc,
                               void* y, void* part, int T, int O, int I, int L, int NB, int nks,
                               int ctas, void* stream) {
  if (!plan_ok(T, O, I, L, nks, ctas, part) || (s == nullptr) != (xsc == nullptr) ||
      (s != nullptr && NB < 1) ||
      (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(xsc)) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  TcWalk a = make_walk(xq, w, s, y, part, T, O, I, L, NB, nks, ctas);
  a.xsc = static_cast<const float*>(xsc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = s != nullptr && nks == 1 ? gemv_launch<W_S8, false, true>(a, st)
                                                 : gemv_launch<W_S8, false>(a, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nks > 1)
    probe_s8_sum_kernel<<<pass_blocks((s != nullptr ? 32LL * O : static_cast<long long>(T) * O) * L),
                          256, 0, st>>>(
        static_cast<const int*>(part), static_cast<const float*>(s),
        static_cast<const float*>(xsc), static_cast<float*>(y), nks, L, T, O, NB);
  return static_cast<int>(cudaGetLastError());
}

// K18f, j, K19a-c. w: n_rows rows of I elements (esize 2: bf16, 1: int8);
// chunks of ch rows (n_rows % ch == 0), a ring `depth` deep; mode S_LAST /
// S_SUM touch the first nr rows of the last / every chunk at nc columns;
// S_DOT takes xq int8 [T, I]. Scratch: rec f32 (S_LAST [nr, nc], S_SUM
// [n_rows / ch, nr, nc]), part int32 (S_DOT [n_rows / ch, T]). out [T, O] f32.
LT_EXPORT int lt_probe_stream(const void* w, int n_rows, int I, int esize, int ch, int depth,
                              int mode, int nr, int nc, const void* x, int T, void* rec,
                              void* part, void* out, int O, void* stream) {
  const int row_bytes = I * esize;
  if (T < 1 || T > kMaxT || depth < 1 || depth > kMaxDepth || ch < 1 || n_rows % ch ||
      row_bytes % 16 || nr > ch || nr > kMaxT || nc > I || nc > O ||
      (mode == S_DOT && (esize != 1 || I > 16 * kMaxSlices * kThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  int stage_rows = 1;  // the largest power of two dividing ch with depth stages in the ring
  while (ch % (2 * stage_rows) == 0 &&
         static_cast<long>(depth) * 2 * stage_rows * row_bytes <= kRingBytes)
    stage_rows *= 2;
  if (static_cast<long>(depth) * stage_rows * row_bytes > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a;
  a.w = static_cast<const char*>(w);
  a.n_rows = n_rows;
  a.row_bytes = row_bytes;
  a.esize = esize;
  a.ch = ch;
  a.stage_rows = stage_rows;
  a.depth = depth;
  a.nr = nr;
  a.nc = nc;
  a.x = x;
  a.T = T;
  a.I = I;
  a.rec = static_cast<float*>(rec);
  a.part = static_cast<int*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == S_LAST) return stream_launch<S_LAST>(a, o, O, st);
  if (mode == S_SUM) return stream_launch<S_SUM>(a, o, O, st);
  return stream_launch<S_DOT>(a, o, O, st);
}
