// K10-K13: the grouped expert matmul of the MoE FFN, one tensor-core kernel
// template with four weight front ends.
//
// Replaces llamatpu/ops/moe_grouped.py `_gkernel` (K10: Q8_0 / Q4_0 values
// with f32 block scales), `_gkernel_packed4` (K11: Q4_0 packed two values per
// byte), `_gkernel_rowq` (K12: q8_row int8 with one f32 scale per out row)
// and `_gkernel_dense` (K13: bf16 / f32 weights). Each computes, for the
// expert-sorted rows of ops/moe_grouped.py `sort_by_expert`,
//
//   y[m, o] (f32) = sum_i  x[m, i].to(dt) * W_e[o, i]   with e = tile_expert[m / tm]
//
// where W_e is expert e's weight dequantized in f32 and rounded to the dot
// dtype dt (f32 for f32 activations, else bf16), as the TPU kernels do:
// K10 (q.f32 * s[o, i / 32]).to(dt) with the product rounded to nearest
// (__fmul_rn); K11 the same after the nibble unpack; K12 q.to(dt) (exact) and
// the row scale multiplying the f32 sum in the epilogue; K13 w.to(dt).
// Accumulation is f32. A tile whose expert is -1 (the tail past the last
// group) gives zeros; a pad row (row_token == n_tokens, a suffix of its tile)
// is written as zero.
//
// Bound on the H100 (3.35 TB/s): the weight bytes of the experts the call
// uses, and the f32 output. At Qwen1.5-MoE-A2.7B decode (one token, 4 routed
// + 4 folded shared experts) the fused gate/up call streams 8 x 2816 x 2048
// Q8_0 weights and their scales, 51.9 MB (15.5 us), the down call half that;
// a 512-token prefill chunk touches 63 of 64 experts, 613 MB of Q8_0 for
// gate/up and down (183 us), beside 238 MB of f32 output over the 12288
// sorted rows and ~72 us of bf16 tensor-core work.
//
// Design: persistent CTAs (one an SM) of three warpgroups walk work units u
// = c, c + ctas, ... (ops/moe_grouped.py plan_grouped, which the CPU tests
// check): unit u is tile u / nob against weight rows [o0, o0 + rows) of the
// tile's expert, o0 = (u % nob) * rows. The plan depends only on (Mp, tm, O,
// I, the SM count): every warp reads the tile's expert and counts its real
// rows (a ballot over row_token) on the device, two units ahead, so the
// launch is capturable in a CUDA graph, and a unit of an inactive tile moves
// no weight byte (its consumers write zeros). Each unit streams its expert
// rows once for all the tile's real rows. The first warpgroup's first warp
// is the producer; setmaxnreg leaves that warpgroup 40 registers a thread
// and gives the two consumer warpgroups (8 warps) 232, where 9 warps an SM
// would cap every thread at 168 and spill the tiled form's sums.
// - The ring: the producer fills up to 16 stages (~208 KB) by TMA tensor
//   copies of [rows, 128-byte] boxes of the weights (viewed as bytes [E * O,
//   row bytes], the 128-byte swizzle, zeros past the row) and one box of
//   their block scales [rows, KC / 32] (f32, zeros past I / 32; where I %
//   128 != 0 a row's scales are not 16-byte aligned, and 4-byte cp.async
//   copies fill the same layout), completing on the stage's `full`
//   mbarrier; consumers release a stage on its `empty` one. No step loads a
//   scale from global memory.
// - The products: mma.sync m16n8k16 bf16 -> f32 with the weights as A (16
//   rows a fragment) and x as B (the tile's rows, 8 a fragment), so the M side
//   of a tile is its real rows rounded up to 8. A lane's A fragment of a row
//   is 4 adjacent columns (tc_gemv.cuh's k order), dequantized in registers
//   once per tile and element: int8 by dequant4 with the lane's one block
//   scale (4 columns never straddle a 32-column block), packed4 from 2 bytes
//   (nibbles spread into bytes, then the same permute under 2^23), q8_row by
//   the permute alone (bf16(q) exact), f32 by cvt.rn.bf16x2, bf16 as loaded.
//   Lane group g reads weight row sigma(g) (and + 8) and x row sigma(g): a
//   permutation of 0..7 under which each fragment load of a swizzled box is
//   free of bank conflicts.
// - tm <= 8 with bf16 x (decode), GEMV form: a unit is 16 weight rows (1408
//   units at one token's gate/up: 97 % of the SMs busy in the last round);
//   each warp holds its x fragments of the tile's <= 8 real rows in
//   registers, loaded from L2 (the next tile's a unit ahead, into a second
//   set); stages are 1024 bytes of each of the 16 rows (8 boxes), and warp w
//   takes the 16-column steps j = w (mod 8) of each stage, 4 steps' loads,
//   conversions and products at a time, in two accumulators (even and odd
//   steps); the 8 parts are added in order through shared memory. A stage
//   past I runs guarded; I <= 4096.
// - Otherwise (tm = 32 or 128 in prefill, f32 x, or I > 4096), tiled form: a
//   unit is 128 weight rows, 16 a warp, every warp all of K; a stage holds
//   128 weight columns (64 for bf16 / f32 weights and for f32 x) of the 128
//   rows, and the tile's x rows of those columns as [8 rows, 64 columns]
//   boxes (the 128-byte swizzle), only the real rows' boxes. Each
//   dequantized A fragment feeds the mma of every 8-row x fragment of the
//   tile (a warp holds up to 16 x 4 f32 sums); the x fragments go in groups
//   of 8, each group's loads issued before the products of the one before,
//   the next step's A loads before this step's products, and a row's 4
//   block scales of a stage in one 16-byte load. Zeros past I in
//   both operands make a partial last stage exact unguarded.
// - f32 x: the same walk, ring and boxes (x in f32, unswizzled), with f32
//   weights and CUDA-core FMAs in column order (no TF32): lane (g, q) sums
//   weight rows g and g + 8 against x rows q, q + 4, ... of the tile.
// - Deterministic: no atomics; every output element is written by one lane,
//   in a fixed order.
// bench/moe_ablation.py times the kernel beside copies of it with one piece
// changed (PERF.md records what each costs).
#include "tc_gemv.cuh"

LT_DEFINE_ERROR_STRING

namespace {

// weight front ends, mirrored by ops/moe_grouped.py
enum Kind { K_BLOCK = 0, K_PACKED = 1, K_ROWQ = 2, K_DENSE = 3 };

constexpr int kParts = 8;                  // consumer warps: two warpgroups
constexpr int kConsumers = 32 * kParts;
constexpr int kThreads = kConsumers + 128;  // + the producer's warpgroup (one warp works)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kRingBytes = 208 * 1024;
constexpr int kMaxDepth = 16;
constexpr int kMaxSlice = 4096;            // GEMV: x columns held in registers
constexpr int kMaxT = 8;                   // GEMV: rows of a tile
constexpr int kXSteps = kMaxSlice / 16 / kParts;  // GEMV: a lane's x fragments
constexpr int kRedPitch = 16 + 1;          // GEMV: floats of an x row of a part's sums

template <int KIND, int WDT, bool XF32, bool GEMV>
struct Geo {
  static constexpr int bits = KIND == K_PACKED ? 4 : KIND == K_DENSE ? (WDT == LT_F32 ? 32 : 16) : 8;
  static constexpr bool scaled = KIND == K_BLOCK || KIND == K_PACKED;  // block scales in the ring
  static constexpr int BR = GEMV ? 16 : 16 * kParts;                   // weight rows of a unit
  static constexpr int KC = GEMV ? (bits == 4 ? 1024 : 8192 / bits)                 // stage columns
                           : (XF32 || bits >= 16) ? 64 : 128;
  static constexpr int WB = KC * bits / 8;                             // stage bytes of a row
  static constexpr int IB = WB < 128 ? WB : 128;                       // box bytes of a row
  static constexpr int NBOX = WB / IB;
  static constexpr int BOX = BR * IB;
  static constexpr int WBYTES = NBOX * BOX;
  static constexpr int NS = scaled ? KC / 32 : 0;                      // scales of a row a stage
  static constexpr int SBYTES = (BR * NS * 4 + 1023) / 1024 * 1024;    // [BR, NS] f32
  static constexpr int STEPS = KC / 16;                                // 16-column steps a stage
  static constexpr int SPW = STEPS / kParts;                           // GEMV: a warp's steps
  static constexpr int XS = XF32 ? 4 : 2;                              // x bytes (tiled)
  static constexpr int XB = KC / 64;                                   // x boxes of a fragment
  static constexpr int XBOX = 8 * 64 * XS;                             // [8 rows, 64 columns]
  static constexpr int FB = 4 * bits / 8;                              // A fragment bytes of a row
};

struct Args {
  const void* x;            // [Mp, I] bf16 or f32
  const float* s;           // [E, O, I / 32] block scales, [E, O] row scales (K_ROWQ)
  const int* tile_expert;   // [Mp / tm]
  const int* row_token;     // [Mp] or null (every row real)
  float* y;                 // [Mp, O]
  int n_tokens, Mp, O, I, tm, E, row_bytes;
  int nob, units, ctas;     // the plan: O blocks a tile, units, CTAs
  int depth, stage, soff;   // ring stages, their bytes, the scales' offset in a stage
  int tma_scales;           // the scales by a TMA box a stage (I % 128 == 0), else cp.async
};

// 128-, 64- or 32-byte swizzle of a box whose rows are SPAN bytes (none for
// wider rows): 16-byte chunk bits 4.. ^= bits 7.. of the offset.
template <int SPAN>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t m = SPAN == 128 ? 7 : SPAN == 64 ? 3 : SPAN == 32 ? 1 : 0;
  return off ^ (((off >> 7) & m) << 4);
}

// the row of lane group g for fragments of FB bytes a row: 8-byte loads
// (bf16 weights, x) take rows 0 2 4 6 | 1 3 5 7 so that each half-warp's
// chunks differ; 16-byte loads (f32 weights) 0 4 1 5 2 6 3 7 for each
// quarter-warp; 2- and 4-byte loads are conflict-free on any rows.
template <int FB>
__device__ __forceinline__ int sigma(int g) {
  return FB == 8 ? (2 * g) % 8 + g / 4 : FB == 16 ? 4 * (g % 2) + g / 2 : g;
}

__device__ __forceinline__ void lds128(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// bar's phase also waits for this thread's cp.async copies (the pending
// count is raised by one first, so the barrier's expected count is unchanged)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The address of byte b of weight row r of a stage's boxes.
template <class G>
__device__ __forceinline__ uint32_t w_addr(uint32_t wbase, int r, int b) {
  return wbase + (b / G::IB) * G::BOX + swz<G::IB>(r * G::IB + b % G::IB);
}

// The address of scale b of weight row r of a stage: [BR, NS] f32 as a TMA
// box lays it out (rows of NS * 4 bytes; the 128-byte swizzle for 32 a row,
// none for 4), so that each lane group's rows fall in distinct banks.
template <class G>
__device__ __forceinline__ uint32_t s_addr(uint32_t sbase, int r, int b) {
  return sbase + swz<G::NS * 4>((r * G::NS + b) * 4);
}

// A row's raw fragment (columns col .. col + 3 of the stage) and (SC) its
// block scale, loaded; then converted to the bf16 fragment, or to f32.
template <class G, int KIND, bool SC = true>
__device__ __forceinline__ void load_row(uint32_t wb, uint32_t sb, int r, int col,
                                         uint32_t (&raw)[4], float& sc) {
  const uint32_t addr = w_addr<G>(wb, r, col * G::bits / 8);
  if constexpr (G::FB == 2) {
    raw[0] = lds16(addr);
  } else if constexpr (G::FB == 4) {
    raw[0] = lds32(addr);
  } else if constexpr (G::FB == 8) {
    uint32_t v[2];
    lds64(v, addr);
    raw[0] = v[0], raw[1] = v[1];
  } else {
    lds128(raw, addr);
  }
  if constexpr (G::scaled && SC) sc = __uint_as_float(lds32(s_addr<G>(sb, r, col / 32)));
}

template <int KIND, int WDT>
__device__ __forceinline__ void to_bf16(const uint32_t (&raw)[4], float sc, uint32_t (&b)[2]) {
  if constexpr (KIND == K_BLOCK || KIND == K_PACKED) {
    dequant_block<KIND == K_PACKED>(raw[0], sc, b[0], b[1]);
  } else if constexpr (KIND == K_ROWQ) {  // bf16(q) exact: the high half of f
    float f[4];
    bytes_to_f32(raw[0] ^ 0x80808080u, 128.f, f);
    b[0] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    b[1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  } else if constexpr (WDT == LT_F32) {
    b[0] = pack_bf16x2(__uint_as_float(raw[0]), __uint_as_float(raw[1]));
    b[1] = pack_bf16x2(__uint_as_float(raw[2]), __uint_as_float(raw[3]));
  } else {
    b[0] = raw[0], b[1] = raw[1];
  }
}

template <int KIND, int WDT>
__device__ __forceinline__ void to_f32(const uint32_t (&raw)[4], float sc, float (&f)[4]) {
  if constexpr (KIND == K_BLOCK || KIND == K_ROWQ) {
    bytes_to_f32(raw[0] ^ 0x80808080u, 128.f, f);
  } else if constexpr (KIND == K_PACKED) {
    bytes_to_f32(spread_nibbles(raw[0]), 8.f, f);
  } else if constexpr (WDT == LT_F32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(raw[e]);
  } else {
    f[0] = __uint_as_float(raw[0] << 16), f[1] = __uint_as_float(raw[0] & 0xffff0000u);
    f[2] = __uint_as_float(raw[1] << 16), f[3] = __uint_as_float(raw[1] & 0xffff0000u);
  }
  if constexpr (KIND == K_BLOCK || KIND == K_PACKED) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(f[e], sc);
  }
}

// A unit's tile, weight rows and expert, and the tile's real rows (0 for an
// inactive tile): read by each warp on its own.
struct Unit {
  int tile, o0, e, nr;
  long m0;
};

constexpr int kMaxTm = 128;  // tile rows: 4 row_token values a lane

// A CTA's walk over units u = c, c + ctas, ...: each unit's expert and
// row_token values are loaded two units ahead, and the following unit's real
// rows are counted (a ballot) when a unit starts, so nothing waits for them
// and `up`, the unit after the current one, is known while it runs.
template <int BR>
struct Walk {
  const Args& a;
  int lane, u, e;
  int rt[kMaxTm / 32];  // unit u + ctas's, in flight
  Unit up;              // unit u
  __device__ Walk(const Args& args, int ln) : a(args), lane(ln), u(blockIdx.x) {
    fetch(u);
    finish();
    fetch(u + a.ctas);
  }
  __device__ void fetch(int v) {
    e = -1;
    if (v >= a.units) return;
    const int tile = v / a.nob;
    e = __ldg(a.tile_expert + tile);
#pragma unroll
    for (int k = 0; k < kMaxTm / 32; ++k) {
      const int r = 32 * k + lane;
      rt[k] = a.row_token != nullptr && r < a.tm
                  ? __ldg(a.row_token + static_cast<long>(tile) * a.tm + r) : 0;
    }
  }
  __device__ void finish() {  // `up` from the loads of unit u
    up.tile = u / a.nob;
    up.o0 = (u - up.tile * a.nob) * BR;
    up.m0 = static_cast<long>(up.tile) * a.tm;
    up.e = u < a.units ? e : -1;
    up.nr = 0;
    if (up.e >= 0) {  // pad rows are a suffix of the tile
#pragma unroll
      for (int k = 0; k < kMaxTm / 32; ++k)
        up.nr += __popc(__ballot_sync(0xffffffffu, 32 * k + lane < a.tm && rt[k] < a.n_tokens));
      if (a.row_token == nullptr) up.nr = a.tm;
    }
  }
  __device__ bool next(Unit& t) {
    if (u >= a.units) return false;
    t = up;
    u += a.ctas;
    finish();
    fetch(u + a.ctas);
    return true;
  }
};

struct Ring {
  int slot = 0;
  unsigned phase = 0;
  int depth;
  __device__ void next() {
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------------------- producer
template <class G, bool GEMV>
__device__ void produce(const Args& a, const CUtensorMap* mw, const CUtensorMap* mx,
                        const CUtensorMap* ms, uint32_t ring, uint64_t* full, uint64_t* empty,
                        int lane) {
  Ring rg;
  rg.depth = a.depth;
  const int nsr = a.I / 32;
  Walk<G::BR> walk(a, lane);
  Unit t;
  while (walk.next(t)) {
    if (t.nr == 0) continue;
    const int nf = (t.nr + 7) / 8;
    const int wrow = t.e * a.O + t.o0;
    for (int k = 0; k < a.I; k += G::KC) {
      mbar_wait(&empty[rg.slot], rg.phase ^ 1);
      const uint32_t st = ring + rg.slot * a.stage;
      if constexpr (G::scaled) {  // without the TMA box: zeros past I / 32 and the last row
        if (!a.tma_scales) {
          const long rows = static_cast<long>(a.E) * a.O;
          for (int idx = lane; idx < G::BR * G::NS; idx += 32) {
            const int r = idx / G::NS, b = idx - r * G::NS, blk = k / 32 + b;
            const uint32_t dst = s_addr<G>(st + a.soff, r, b);
            if (blk < nsr && wrow + r < rows)
              cp_async4(dst, a.s + static_cast<long>(wrow + r) * nsr + blk);
            else
              sts32(dst, 0u);
          }
          cp_async_arrive(&full[rg.slot]);
        }
      }
      const int kb = k * G::bits / 8;  // first byte of the stage in a row
      // GEMV: the boxes that start inside the row (the steps past I are
      // guarded); tiled: all of them, and the x boxes of the real rows
      const int nw = GEMV ? min(G::NBOX, (a.row_bytes - kb + G::IB - 1) / G::IB) : G::NBOX;
      const int nx = GEMV ? 0 : nf * G::XB, ns = G::scaled && a.tma_scales ? 1 : 0;
      __syncwarp();
      if (lane == 0)
        mbar_expect_tx(&full[rg.slot], static_cast<unsigned>(nw * G::BOX + nx * G::XBOX +
                                                             ns * G::BR * G::NS * 4));
      __syncwarp();
      for (int c = lane; c < nw + nx + ns; c += 32) {
        if (c == nw + nx) {
          tma_load_2d(st + a.soff, ms, k / 32, wrow, &full[rg.slot]);
        } else if (c < nw) {
          tma_load_2d(st + c * G::BOX, mw, kb + c * G::IB, wrow, &full[rg.slot]);
        } else {
          const int cx = c - nw, f = cx / G::XB, xb = cx - f * G::XB;
          tma_load_2d(st + G::WBYTES + cx * G::XBOX, mx, k + 64 * xb,
                      static_cast<int>(t.m0) + 8 * f, &full[rg.slot]);
        }
      }
      rg.next();
    }
  }
}

// ------------------------------------------------------------- epilogues
// zeros for rows [r0, tm) of the unit, columns [c0, c0 + cols) of its rows
__device__ __forceinline__ void zero_rows(const Args& a, const Unit& t, int r0, int c0, int cols,
                                          int tid, int nthreads) {
  for (int idx = tid; idx < (a.tm - r0) * cols; idx += nthreads) {
    const int m = r0 + idx / cols, o = c0 + idx % cols;
    if (o < a.O) a.y[(t.m0 + m) * a.O + o] = 0.f;
  }
}

template <int KIND>
__device__ __forceinline__ float row_scale(const Args& a, const Unit& t, int o) {
  return KIND == K_ROWQ && o < a.O ? __ldg(a.s + static_cast<long>(t.e) * a.O + o) : 1.f;
}

// ------------------------------------------------------------- tiled form
// A unit with nf <= NFM x fragments: warp w's 16 weight rows against all of
// them, all of K, then the stores.
template <class G, int KIND, int WDT, int NFM>
__device__ void tiled_unit(const Args& a, const Unit& t, Ring& rg, uint32_t ring, uint64_t* full,
                           uint64_t* empty, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int nf = (t.nr + 7) / 8;
  const int rw = 16 * warp + sigma<G::FB>(g);  // weight rows rw, rw + 8 of the unit
  const int rx = sigma<8>(g);                  // x row of each fragment
  float acc[NFM][4];
#pragma unroll
  for (int f = 0; f < NFM; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;
  constexpr int FG = NFM < 8 ? NFM : 8;  // x fragments a group: loaded a group ahead
  const uint32_t xlane = swz<128>(rx * 128 + 8 * q);  // x[rx][4q ..] of a box's first step
  for (int k = 0; k < a.I; k += G::KC) {
    mbar_wait(&full[rg.slot], rg.phase);
    const uint32_t wb = ring + rg.slot * a.stage, xb = wb + G::WBYTES, sb = wb + a.soff;
    // the stage's block scales of rows rw and rw + 8 (NS = 4: a 16-byte row;
    // step j's 4-column fragments lie in block j / 2)
    uint32_t sc0[4] = {0u, 0u, 0u, 0u}, sc1[4] = {0u, 0u, 0u, 0u};
    if constexpr (G::scaled) {
      static_assert(G::NS == 4, "tiled bf16-x stages hold 128 columns: 4 blocks a row");
      lds128(sc0, s_addr<G>(sb, rw, 0));
      lds128(sc1, s_addr<G>(sb, rw + 8, 0));
    }
    uint32_t r0[2][4], r1[2][4];  // a step's raw A rows, the next step's loaded ahead
    float unused = 0.f;
    load_row<G, KIND, false>(wb, sb, rw, 4 * q, r0[0], unused);
    load_row<G, KIND, false>(wb, sb, rw + 8, 4 * q, r1[0], unused);
#pragma unroll
    for (int j = 0; j < G::STEPS; ++j) {
      const int col = 16 * j + 4 * q, c = j & 1;
      uint32_t b0[2], b1[2];
      to_bf16<KIND, WDT>(r0[c], __uint_as_float(sc0[j / 2]), b0);
      to_bf16<KIND, WDT>(r1[c], __uint_as_float(sc1[j / 2]), b1);
      const uint32_t af[4] = {b0[0], b1[0], b0[1], b1[1]};
      if (j + 1 < G::STEPS) {
        load_row<G, KIND, false>(wb, sb, rw, col + 16, r0[c ^ 1], unused);
        load_row<G, KIND, false>(wb, sb, rw + 8, col + 16, r1[c ^ 1], unused);
      }
      // x[rx][col ..] of fragment f: box f * XB + j / 4, step j % 4 of the box
      // (16-column steps are 32-byte chunk pairs, so the swizzle XORs them whole)
      const uint32_t xs = xb + (j / 4) * G::XBOX + (xlane ^ (32 * (j % 4)));
      uint32_t bx[2][FG][2];
#pragma unroll
      for (int f = 0; f < FG; ++f)
        if (f < nf) lds64(bx[0][f], xs + f * G::XB * G::XBOX);
#pragma unroll
      for (int f0 = 0; f0 < NFM; f0 += FG) {
        const int b = (f0 / FG) & 1;
        if (f0 + FG < NFM && f0 + FG < nf) {
#pragma unroll
          for (int f = 0; f < FG; ++f)
            if (f0 + FG + f < nf) lds64(bx[b ^ 1][f], xs + (f0 + FG + f) * G::XB * G::XBOX);
        }
        if (f0 < nf) {
#pragma unroll
          for (int f = 0; f < FG; ++f)
            if (f0 + f < nf) mma16(acc[f0 + f], af, bx[b][f]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[rg.slot]);
    rg.next();
  }
  // c0, c1: weight row rw, x rows sigma(2q), sigma(2q + 1); c2, c3: row rw + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = t.o0 + rw + 8 * h;
    const float rs = row_scale<KIND>(a, t, o);
#pragma unroll
    for (int f = 0; f < NFM; ++f) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = 8 * f + sigma<8>(2 * q + c);
        if (f < nf && m < a.tm && o < a.O) {
          const float v = acc[f][2 * h + c];
          a.y[(t.m0 + m) * a.O + o] = m < t.nr ? (KIND == K_ROWQ ? __fmul_rn(v, rs) : v) : 0.f;
        }
      }
    }
  }
  zero_rows(a, t, 8 * nf, t.o0 + 16 * warp, 16, lane, 32);
}

// f32 x: lane (g, q) sums weight rows g, g + 8 of the warp against x rows
// 4i + q (i < 2 nf), in column order.
template <class G, int KIND, int WDT, int NFM>
__device__ void fma_unit(const Args& a, const Unit& t, Ring& rg, uint32_t ring, uint64_t* full,
                         uint64_t* empty, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int nf = (t.nr + 7) / 8;
  const int rw = 16 * warp + g;
  float acc[2 * NFM][2];
#pragma unroll
  for (int i = 0; i < 2 * NFM; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int k = 0; k < a.I; k += G::KC) {
    mbar_wait(&full[rg.slot], rg.phase);
    const uint32_t wb = ring + rg.slot * a.stage, xb = wb + G::WBYTES, sb = wb + a.soff;
#pragma unroll 1
    for (int c4 = 0; c4 < G::KC; c4 += 4) {  // 4 columns of both rows, then every x row
      float w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t raw[4];
        float sc = 0.f;
        load_row<G, KIND>(wb, sb, rw + 8 * h, c4, raw, sc);
        to_f32<KIND, WDT>(raw, sc, w[h]);
      }
#pragma unroll
      for (int i = 0; i < 2 * NFM; ++i) {
        if (i < 2 * nf) {
          const int m = 4 * i + q;  // fragment m / 8, row m % 8 of its box (rows of 256 bytes)
          uint32_t v[4];
          lds128(v, xb + (m / 8) * G::XBOX + (m % 8) * 256 + 4 * c4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][0] = fmaf(w[0][e], __uint_as_float(v[e]), acc[i][0]);
            acc[i][1] = fmaf(w[1][e], __uint_as_float(v[e]), acc[i][1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[rg.slot]);
    rg.next();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = t.o0 + rw + 8 * h;
    const float rs = row_scale<KIND>(a, t, o);
#pragma unroll
    for (int i = 0; i < 2 * NFM; ++i) {
      const int m = 4 * i + q;
      if (i < 2 * nf && m < a.tm && o < a.O)
        a.y[(t.m0 + m) * a.O + o] =
            m < t.nr ? (KIND == K_ROWQ ? __fmul_rn(acc[i][h], rs) : acc[i][h]) : 0.f;
    }
  }
  zero_rows(a, t, 8 * nf, t.o0 + 16 * warp, 16, lane, 32);
}

template <int N>
struct Frags {
  static constexpr int value = N;
};

template <class G, int KIND, int WDT, bool XF32>
__device__ void consume_tiled(const Args& a, uint32_t ring, uint64_t* full, uint64_t* empty,
                              int warp, int lane) {
  Ring rg;
  rg.depth = a.depth;
  Walk<G::BR> walk(a, lane);
  Unit t;
  while (walk.next(t)) {
    if (t.nr == 0) {
      zero_rows(a, t, 0, t.o0 + 16 * warp, 16, lane, 32);
      continue;
    }
    // the unit at nf <= N x fragments (N: 1, 2, 4, 8, 16)
    auto unit = [&](auto n) {
      constexpr int N = decltype(n)::value;
      if constexpr (XF32)
        fma_unit<G, KIND, WDT, N>(a, t, rg, ring, full, empty, warp, lane);
      else
        tiled_unit<G, KIND, WDT, N>(a, t, rg, ring, full, empty, warp, lane);
    };
    const int nf = (t.nr + 7) / 8;
    if (nf <= 1)
      unit(Frags<1>());
    else if (nf <= 2)
      unit(Frags<2>());
    else if (nf <= 4)
      unit(Frags<4>());
    else if (nf <= 8)
      unit(Frags<8>());
    else
      unit(Frags<16>());
  }
}

// ------------------------------------------------------------- GEMV form
// GEMV: this warp's x fragments of a tile's real rows from global memory
// (L2): step j = warp + kParts * i of stage st is fragment f = st * SPW + i,
// x[g][col + 4q .. + 3] for the step's first column col; zero for g >= nr
// and past I.
template <class G>
__device__ __forceinline__ void load_x(const Args& a, const Unit& t, int warp, int lane,
                                       uint32_t (&xr)[kXSteps][2]) {
  const int g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* row = static_cast<const __nv_bfloat16*>(a.x) + (t.m0 + g) * a.I + 4 * q;
#pragma unroll
  for (int f = 0; f < kXSteps; ++f) {
    const int col = (f / G::SPW) * G::KC + (warp + kParts * (f % G::SPW)) * 16;
    uint2 v = make_uint2(0u, 0u);
    if (g < t.nr && col < a.I) v = __ldg(reinterpret_cast<const uint2*>(row + col));
    xr[f][0] = v.x, xr[f][1] = v.y;
  }
}

template <class G, int KIND, int WDT>
__device__ void consume_gemv(const Args& a, uint32_t ring, float* red, uint64_t* full,
                             uint64_t* empty, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int rw = sigma<G::FB>(g);  // weight rows rw, rw + 8 of the unit
  Ring rg;
  rg.depth = a.depth;
  int xtile = -1, ntile = -1, buf = 0;
  uint32_t xr[kXSteps][2], xn[kXSteps][2];  // x of this unit's tile, and of the next tile
  Walk<G::BR> walk(a, lane);
  Unit t;
  while (walk.next(t)) {
    if (t.nr == 0) {
      zero_rows(a, t, 0, t.o0, 16, 32 * warp + lane, kConsumers);
      continue;
    }
    if (t.tile != xtile) {  // loaded a unit ahead, or now
      if (t.tile == ntile) {
#pragma unroll
        for (int f = 0; f < kXSteps; ++f) xr[f][0] = xn[f][0], xr[f][1] = xn[f][1];
      } else {
        load_x<G>(a, t, warp, lane, xr);
      }
      xtile = t.tile;
    }
    if (walk.up.nr > 0 && walk.up.tile != xtile && walk.up.tile != ntile) {
      load_x<G>(a, walk.up, warp, lane, xn);  // used when that unit starts
      ntile = walk.up.tile;
    }
    float acc[2][4] = {};  // even and odd steps
#pragma unroll
    for (int st = 0; st < kMaxSlice / G::KC; ++st) {
      const int k = st * G::KC;
      if (k >= a.I) break;
      const int steps = min(G::KC, a.I - k) / 16;
      mbar_wait(&full[rg.slot], rg.phase);
      const uint32_t wb = ring + rg.slot * a.stage, sb = wb + a.soff;
      // a stage's steps in groups of 4: loads, conversions, products; a whole
      // stage without the guards j < steps
      auto products = [&](auto guard) {
        constexpr bool GD = decltype(guard)::value;
        constexpr int NG = G::SPW < 4 ? G::SPW : 4;
#pragma unroll
        for (int i0 = 0; i0 < G::SPW; i0 += NG) {
          uint32_t r0[NG][4], r1[NG][4], af[NG][4];
          float s0[NG], s1[NG];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int j = warp + kParts * (i0 + i);
            s0[i] = s1[i] = 0.f;
            if (!GD || j < steps) {
              load_row<G, KIND>(wb, sb, rw, 16 * j + 4 * q, r0[i], s0[i]);
              load_row<G, KIND>(wb, sb, rw + 8, 16 * j + 4 * q, r1[i], s1[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int j = warp + kParts * (i0 + i);
            if (GD && j >= steps) continue;
            uint32_t b0[2], b1[2];
            to_bf16<KIND, WDT>(r0[i], s0[i], b0);
            to_bf16<KIND, WDT>(r1[i], s1[i], b1);
            af[i][0] = b0[0], af[i][1] = b1[0], af[i][2] = b0[1], af[i][3] = b1[1];
          }
#pragma unroll
          for (int i = 0; i < NG; ++i)
            if (!GD || warp + kParts * (i0 + i) < steps)
              mma16(acc[(i0 + i) & 1], af[i], xr[st * G::SPW + i0 + i]);
        }
      };
      if (steps == G::STEPS)
        products(Flag<false>());
      else
        products(Flag<true>());
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[rg.slot]);
      rg.next();
    }
    // this warp's part: weight rows rw (c0, c1) and rw + 8 (c2, c3), x rows 2q, 2q + 1
    float* r = red + (buf * kParts + warp) * kMaxT * kRedPitch;
    r[(2 * q) * kRedPitch + rw] = acc[0][0] + acc[1][0];
    r[(2 * q + 1) * kRedPitch + rw] = acc[0][1] + acc[1][1];
    r[(2 * q) * kRedPitch + rw + 8] = acc[0][2] + acc[1][2];
    r[(2 * q + 1) * kRedPitch + rw + 8] = acc[0][3] + acc[1][3];
    consumer_sync();
    // thread (x row m, weight row): the parts in order
    const int ct = 32 * warp + lane;  // consumer thread (m, weight row)
    if (ct < kMaxT * 16) {
      const int m = ct / 16, row = ct % 16, o = t.o0 + row;
      if (m < a.tm && o < a.O) {
        float v = 0.f;
        if (m < t.nr) {
          const float* p = red + buf * kParts * kMaxT * kRedPitch + m * kRedPitch + row;
          v = p[0];
#pragma unroll
          for (int w = 1; w < kParts; ++w) v += p[w * kMaxT * kRedPitch];
          if (KIND == K_ROWQ) v = __fmul_rn(v, row_scale<KIND>(a, t, o));
        }
        a.y[(t.m0 + m) * a.O + o] = v;
      }
    }
    buf ^= 1;  // the next unit writes the other buffer; the one after waits on its barrier
  }
}

template <int KIND, int WDT, bool XF32, bool GEMV>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_tc_kernel(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap ms, const Args a) {
  using G = Geo<KIND, WDT, XF32, GEMV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth], empty[kMaxDepth];
  const uint32_t raw = smem_u32(smem_raw), ring = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int d = 0; d < a.depth; ++d) {
      mbar_init(&full[d]);           // the producer's expect_tx (cp.async arrivals net zero)
      mbar_init(&empty[d], kParts);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp < 4) {  // the producer's warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0) produce<G, GEMV>(a, &mw, &mx, &ms, ring, full, empty, lane);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if constexpr (GEMV)
    consume_gemv<G, KIND, WDT>(a, ring, reinterpret_cast<float*>(base + a.depth * a.stage), full,
                               empty, warp - 4, lane);
  else
    consume_tiled<G, KIND, WDT, XF32>(a, ring, full, empty, warp - 4, lane);
}

// A byte-typed (dtype UINT8) or bf16 / f32 row-major [rows, cols] tensor as
// [box_rows, box_cols] boxes, swizzled by the box's row bytes (128 / 64 / 32;
// none above 128), zeros outside.
int make_map(CUtensorMap* map, CUtensorMapDataType dt, int esize, const void* p, long cols,
             long rows, int box_cols, int box_rows) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int span = box_cols * esize;
  const CUtensorMapSwizzle sw = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : span == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = f(map, dt, 2, const_cast<void*>(p), dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int KIND, int WDT, bool XF32, bool GEMV>
int launch(Args a, const void* w, cudaStream_t st) {
  using G = Geo<KIND, WDT, XF32, GEMV>;
  a.nob = (a.O + G::BR - 1) / G::BR;
  a.units = (a.Mp / a.tm) * a.nob;
  if (a.ctas < 1 || a.ctas > a.units) return static_cast<int>(cudaErrorInvalidValue);
  a.row_bytes = static_cast<int>(static_cast<long>(a.I) * G::bits / 8);
  const int xbytes = GEMV ? 0 : ((a.tm + 7) / 8) * G::XB * G::XBOX;
  a.soff = G::WBYTES + xbytes;
  a.stage = (a.soff + G::SBYTES + 1023) / 1024 * 1024;
  a.depth = min(kMaxDepth, kRingBytes / a.stage);
  if (a.depth < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the scales [E * O, I / 32] f32 as [BR, NS] boxes: rows of 16-byte multiples
  a.tma_scales = G::scaled && G::NS % 4 == 0 && a.I % 128 == 0;
  CUtensorMap mw, mx, ms;  // maps a form does not read are copies of mw
  int e = make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, a.row_bytes,
                   static_cast<long>(a.E) * a.O, G::IB, G::BR);
  mx = ms = mw;
  if (e == 0 && a.tma_scales)
    e = make_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.s, a.I / 32,
                 static_cast<long>(a.E) * a.O, G::NS, G::BR);
  if (e == 0 && !GEMV)
    e = make_map(&mx, XF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 G::XS, a.x, a.I, a.Mp, 64, 8);
  if (e != 0) return e;
  const size_t smem = 1024 + static_cast<size_t>(a.depth) * a.stage +
                      (GEMV ? sizeof(float) * 2 * kParts * kMaxT * kRedPitch : 0);
  const cudaError_t err = lt_allow_smem(grouped_tc_kernel<KIND, WDT, XF32, GEMV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_tc_kernel<KIND, WDT, XF32, GEMV><<<a.ctas, kThreads, smem, st>>>(mw, mx, ms, a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int WDT>
int run(const Args& a, const void* w, bool x_f32, bool gemv, cudaStream_t st) {
  if (x_f32) return launch<KIND, WDT, true, false>(a, w, st);
  return gemv ? launch<KIND, WDT, false, true>(a, w, st) : launch<KIND, WDT, false, false>(a, w, st);
}

}  // namespace

// y[Mp, O] f32 = x[Mp, I] @ W[tile_expert[m / tm]]^T over expert-sorted rows.
// kind: 0 block quant (int8 values + f32 [E, O, I / 32] scales), 1 packed4
// ([E, O, I / 2] bytes), 2 q8_row (int8 + f32 [E, O] row scales), 3 dense
// (w_dtype). row_token may be null. The plan of ops/moe_grouped.py
// plan_grouped: gemv (bf16 x, tm <= 8, I <= 4096) or the tiled form, `ctas`
// persistent CTAs. I % 32 == 0, tm <= 8 or tm % 8 == 0 up to 128, 16-byte aligned x
// and w (the wrapper checks).
LT_EXPORT int lt_grouped_matmul(int kind, const void* x, int x_dtype, const void* w, int w_dtype,
                                const void* s, const void* tile_expert, const void* row_token,
                                int n_tokens, void* y, int Mp, int O, int I, int tm, int E,
                                int gemv, int ctas, void* stream) {
  const bool x_f32 = x_dtype == LT_F32;
  if (Mp <= 0 || O <= 0 || I <= 0 || E <= 0 || I % 32 || tm <= 0 || Mp % tm ||
      (tm > kMaxT && (tm % 8 || tm > kMaxTm)) || (gemv && (x_f32 || tm > kMaxT || I > kMaxSlice)) ||
      (x_dtype != LT_F32 && x_dtype != LT_BF16) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.s = static_cast<const float*>(s);
  a.tile_expert = static_cast<const int*>(tile_expert);
  a.row_token = static_cast<const int*>(row_token);
  a.y = static_cast<float*>(y);
  a.n_tokens = n_tokens;
  a.Mp = Mp;
  a.O = O;
  a.I = I;
  a.tm = tm;
  a.E = E;
  a.ctas = ctas;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case K_BLOCK: return run<K_BLOCK, LT_I8>(a, w, x_f32, gemv, st);
    case K_PACKED: return run<K_PACKED, LT_I8>(a, w, x_f32, gemv, st);
    case K_ROWQ: return run<K_ROWQ, LT_I8>(a, w, x_f32, gemv, st);
    case K_DENSE:
      return w_dtype == LT_F32 ? run<K_DENSE, LT_F32>(a, w, x_f32, gemv, st)
                               : run<K_DENSE, LT_BF16>(a, w, x_f32, gemv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
