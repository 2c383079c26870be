// K4 and K17: the w8a8 GEMMs of the q8_row prefill projections (T >= 128).
//
// K4 replaces llamatpu/ops/pallas_gemm.py `_gemm_kernel` (and its stacked
// `_gemm_kernel_li` twin: a layer is the view qs[li] here), which the JAX
// package keeps bit-identical to its XLA int8 dot
// `int8_prefill.rowq_matmul_mxu`:
//
//   y[t, o] = float(sum_k xi8[t, k] * qs[o, k]) * ax[t] * s[o]
//
// int8 x int8 products, an exact int32 sum (the caller asserts I <=
// _INT8_ACC_MAX_I), then the f32 epilogue in that order, each product
// rounded: the result is bit-identical to the plain version whatever the
// summation order or the split of K.
//
// K17 replaces `_gemm_kernel_bf16` (`rowq_gemm_pallas(variant="bf16")`, the
// diagnostic scripts/bench_gemm.py times against the int8 path):
//
//   y[t, o] = (sum_k bf16(xi8[t, k]) * bf16(qs[o, k]))_f32 * ax[t] * s[o]
//
// int8 values are exact in bf16 and their products exact in f32, so it
// differs from K4 only in the rounding of the f32 sums.
//
// Bounds on the H100 SXM (3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s bf16): a
// llama32-1b layer at T = 512 (wqkv, wo, w13, w2) is 62.3 G operations and
// ~116 MB (the weights once, the f32 outputs once): K4 34.8 us by bytes
// (31.5 by operations), K17 63.0 us by operations. Phi-3-medium at T = 128 is
// 341 MB of weights and 28 MB of outputs a layer: 110 us by bytes for both.
// At prefill widths T is 128-512, so many shapes have fewer 128 x 128
// output tiles than the card has SMs (llama wo at T = 128: 16 tiles on 132
// SMs) and a long K behind each (w2 at Phi-3-medium: 140 stages of 128).
//
// Design (the same kernel for both, one template flag for the inner step):
// - Operands by TMA. One producer thread issues cp.async.bulk.tensor loads
//   of a [128 rows, 128 bytes of K] tile of xi8 and of qs per stage into a
//   ring of shared-memory stages (6 for K4, 4 for K17), each with a `full`
//   mbarrier (TMA's byte count) and an `empty` one (both consumer
//   warpgroups' release). Both operands are int8 and K-major, the only
//   major-ness wgmma takes for 8-bit types, so nothing is transposed; 128
//   bytes of K is exactly the 128-byte swizzle, whose layout wgmma reads
//   without bank conflicts. Rows past T or O and the K tail (I % 128 != 0)
//   are zero-filled by TMA, so every T >= 1, O >= 1 and I % 16 == 0 works.
// - K4's step: two consumer warpgroups, each 64 rows of the tile, issue
//   wgmma m64n128k32 s32.s8.s8 straight from the swizzled stage (4 per
//   stage) with int32 accumulators in registers, one stage in flight while
//   the previous one is released.
// - K17's step: wgmma reads B only from shared memory, so each stage's int8 B
//   tile is widened once, by all 256 consumer threads, into a bf16 tile in
//   the same swizzled layout (16-byte shared loads, byte permutes into the
//   mantissa of 2^23 and one f32 subtraction a value, the bf16 half taken by
//   a permute: exact, no int->float conversion); fence.proxy.async makes the
//   threads' writes visible to wgmma. A is widened the same way into
//   registers, as the register operand of wgmma m64n128k16 f32.bf16.bf16 (8
//   per stage): each row's fragment is one 32-bit load, because the k order
//   inside each 16-deep step is permuted alike in A and B. Two bf16 B tiles
//   alternate, so a stage widens while the previous stage's products run,
//   and the int8 stage is released once it is widened.
// - The walk: persistent CTAs over (tile, K stage) iterations, planned by
//   ops/gemm.py `plan_gemm` (checked by the CPU tests). K4 with whole tiles
//   on at least 0.4 of the SMs is bound by the card's L2-to-SM traffic (a
//   16 KB tile of each operand a stage), so there it takes whole tiles, one
//   a CTA in rounds: at every path shape with 60 or more tiles that beat
//   any split of K, whose partial sums only add traffic. Below that, and for
//   K17 (twice K4's cost a product, plus the widening) always, the card is
//   filled: as many CTAs as SMs, whole tiles in rounds where rounds alone
//   keep the SMs >= 90 % busy, else the tiles of the last one to two rounds
//   (all of them below one round) walked stream-K: their iterations cut into
//   equal contiguous ranges, one a CTA. A tile done by one CTA gets the
//   epilogue at once; a tile shared by CTAs gets each CTA's raw partial sums
//   in a workspace slot (at most two a CTA: the tile its range starts in,
//   the tile it ends in), and a second pass, one block per (tile, 16-byte
//   vector), sums the pieces in K order and applies the epilogue once: int32
//   for K4 (exact, so still bit-identical), f32 in a fixed order for K17
//   (deterministic). No atomics. The wrapper allocates the workspace.
// - Epilogue: (float(acc) * ax[t]) * s[o], each product rounded (no FMA),
//   stored as float2 of adjacent columns straight from the accumulator
//   fragments.
#include <cuda.h>

#include <type_traits>

#include "wgmma.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int BM = 128, BN = 128, BK = 128;  // output tile rows (T) x cols (O); K stage (bytes)
constexpr int kConsumers = 256;              // two warpgroups, 64 tile rows each
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kTileBytes = BM * BK;          // one operand's stage (BM == BN): 16 KB
constexpr int kStageBytes = 2 * kTileBytes;  // A, then B
constexpr int kAcc = BN / 2;                 // a thread's share of its warpgroup's 64 x BN
constexpr int kVecs = kAcc / 4;              // 16-byte accumulator vectors a thread

template <bool kBf16>
struct Cfg {
  static constexpr int kStages = kBf16 ? 4 : 6;
  static constexpr int kWide = kStages * kStageBytes;  // K17's two bf16 B tiles
  static constexpr int kSmem = kWide + (kBf16 ? 2 * kStageBytes : 0) + 1024;  // + alignment
};

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, int8, int32 sums
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// Four int8 values (the lowest k in the low byte) as two bf16 pairs, exactly:
// each byte biased by 128 goes into the low mantissa byte of 2^23, one f32
// subtraction removes 2^23 + 128, and the bf16 is the upper half (|v| <= 128
// needs 8 significant bits, which bf16 has).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// K17's order of the contraction index inside each 16-deep step: the int8
// bytes 4t .. 4t + 3 of a step are its k = 2t, 2t + 1, 2t + 8, 2t + 9, so a
// thread's A fragment of a row is one 32-bit shared load (widen4's lo, hi).
// B is widened in the same order; the products are the same, summed in
// another order.

// The int8 B tile of a stage (128 rows x 128 bytes, 128-byte swizzle) widened
// into bf16 at dst: two 64-column halves of [128 rows][128 bytes] in the same
// swizzle, as wgmma reads them. 1024 16-byte chunks, 4 a consumer thread.
__device__ __forceinline__ void widen_b(uint32_t src, uint32_t dst) {
#pragma unroll
  for (int n = 0; n < BN * 8 / kConsumers; ++n) {
    const int j = threadIdx.x + n * kConsumers, r = j >> 3, c = j & 7;  // row, 16-deep step
    uint32_t v[4], lo[4], hi[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(src + r * 128 + ((c ^ (r & 7)) << 4)));
#pragma unroll
    for (int q = 0; q < 4; ++q) widen4(v[q], lo[q], hi[q]);
    // step c is bf16 half c / 4, chunks 2 (c % 4) (k 0..7) and 2 (c % 4) + 1
    const uint32_t row = dst + (c >> 2) * kTileBytes + r * 128;
    const int c2 = (c & 3) * 2;
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(row + ((c2 ^ (r & 7)) << 4)),
                 "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     row + (((c2 + 1) ^ (r & 7)) << 4)),
                 "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                 : "memory");
  }
}

// This thread's bf16 A fragments of the 8 steps of a stage, from the int8 A
// tile (128-byte swizzle): rows wg * 64 + warp * 16 + g and + 8.
__device__ __forceinline__ void load_a(uint32_t src, int wg, uint32_t (&af)[8][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const uint32_t r0 = src + (wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + g) * 128 + 4 * t;
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // rows r0, r0 + 8 are both g modulo 8
    uint32_t x0, x1;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x0) : "r"(r0 + ((k ^ g) << 4)));
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x1) : "r"(r0 + 8 * 128 + ((k ^ g) << 4)));
    widen4(x0, af[k][0], af[k][2]);
    widen4(x1, af[k][1], af[k][3]);
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float to_f32(int v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ uint32_t bits(int v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ void add_bits(int& d, uint32_t v) { d += static_cast<int>(v); }
__device__ __forceinline__ void add_bits(float& d, uint32_t v) { d += __uint_as_float(v); }
__device__ __forceinline__ void set_bits(int& d, uint32_t v) { d = static_cast<int>(v); }
__device__ __forceinline__ void set_bits(float& d, uint32_t v) { d = __uint_as_float(v); }

// The epilogue of accumulator vector j (d[4 j .. 4 j + 3]) of consumer
// thread ct of a finished tile. In the wgmma accumulator layout ct holds rows
// (ct / 32) * 16 + (ct % 32) / 4 + {0, 8} and columns 8 j + 2 (ct % 4) + {0, 1}:
// d[4 j + 2 h + q] is row + 8 h, column + q.
template <typename Acc>
__device__ __forceinline__ void store_vec(const Acc* v, int j, int tile, const Walk& w,
                                          const float* __restrict__ ax,
                                          const float* __restrict__ s, float* __restrict__ y) {
  const int ct = threadIdx.x;
  const int row0 = (tile % w.tiles_m) * BM + (ct >> 5) * 16 + ((ct & 31) >> 2);
  const int c = (tile / w.tiles_m) * BN + 2 * (ct & 3) + 8 * j;
  const bool pair = (w.O & 1) == 0 && c + 1 < w.O;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= w.T) continue;
    const float a = ax[r];
    float* yr = y + static_cast<long long>(r) * w.O;
    if (pair) {
      *reinterpret_cast<float2*>(yr + c) =
          make_float2(__fmul_rn(__fmul_rn(to_f32(v[2 * h]), a), s[c]),
                      __fmul_rn(__fmul_rn(to_f32(v[2 * h + 1]), a), s[c + 1]));
    } else {
      if (c < w.O) yr[c] = __fmul_rn(__fmul_rn(to_f32(v[2 * h]), a), s[c]);
      if (c + 1 < w.O) yr[c + 1] = __fmul_rn(__fmul_rn(to_f32(v[2 * h + 1]), a), s[c + 1]);
    }
  }
}

// A shared tile's raw partial sums: workspace slot (cta, slot) holds vector j
// of consumer thread ct at [j][ct] (coalesced 16-byte stores).
__device__ __forceinline__ uint4* slot_ptr(uint4* ws, int cta, int slot) {
  return ws + static_cast<size_t>(cta * 2 + slot) * kVecs * kConsumers + threadIdx.x;
}

template <bool kBf16>
__device__ __forceinline__ void gemm_body(const CUtensorMap* mx, const CUtensorMap* mw,
                                          const float* __restrict__ ax,
                                          const float* __restrict__ s, float* __restrict__ y,
                                          uint4* __restrict__ ws, const Walk& w) {
  using C = Cfg<kBf16>;
  using Acc = std::conditional_t<kBf16, float, int>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages], empty[C::kStages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // 128-byte swizzle: 1024-aligned
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], 1);          // the producer's expect_tx, then TMA's bytes
      mbar_init(&empty[i], 2);         // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues every load
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for_each_segment(w, [&](int t, int k0, int k1, int) {
        const int m0 = (t % w.tiles_m) * BM, n0 = (t / w.tiles_m) * BN;
        for (int k = k0; k < k1; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t a = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);  // OOB-filled bytes count too
          tma_load_2d(a, mx, k * BK, m0, &full[stage]);
          tma_load_2d(a + kTileBytes, mw, k * BK, n0, &full[stage]);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      });
    }
    return;
  }

  const int wg = threadIdx.x >> 7;  // consumer warpgroup: tile rows wg * 64 ..
  const bool leader = (threadIdx.x & 127) == 0;
  int stage = 0, widx = 0;  // widx: K17's stages so far (its bf16 buffer)
  uint32_t phase = 0;
  for_each_segment(w, [&](int t, int k0, int k1, int slot) {
    Acc d[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0;
    int prev = -1;
    for (int k = k0; k < k1; ++k) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = ring + stage * kStageBytes;
      if constexpr (kBf16) {
        // B widens into one of two bf16 buffers while the previous stage's
        // products still run; A is widened into registers once they are done
        const uint32_t wide = ring + C::kWide + (widx & 1) * 2 * kTileBytes;
        widen_b(a + kTileBytes, wide);
        wg_wait<0>();
        uint32_t af[8][4];
        load_a(a, wg, af);
        fence_frags(af);  // widened before the fence, not moved past it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        consumer_sync();  // B is widened; every warpgroup's previous products are done
        fence_regs(d);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)  // 16 bf16 = 32 bytes a step
          wgmma_bf16(d, af[kk], smem_desc(wide + (kk >> 2) * kTileBytes) + 2 * (kk & 3), 1);
        wg_commit();
        if (leader) mbar_arrive(&empty[stage]);
        ++widx;
      } else {
        const uint64_t da = smem_desc(a + wg * 64 * 128), db = smem_desc(a + kTileBytes);
        fence_regs(d);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 32 int8 = 32 bytes a step
          wgmma_s8(d, da + 2 * kk, db + 2 * kk, 1);
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
      }
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    if constexpr (!kBf16) {
      if (leader) mbar_arrive(&empty[prev]);
    }
    fence_regs(d);
    if (slot < 0) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j) store_vec(d + 4 * j, j, t, w, ax, s, y);
    } else {
      uint4* p = slot_ptr(ws, blockIdx.x, slot);
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        p[j * kConsumers] =
            make_uint4(bits(d[4 * j]), bits(d[4 * j + 1]), bits(d[4 * j + 2]), bits(d[4 * j + 3]));
    }
  });
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ ax, const float* __restrict__ s,
                   float* __restrict__ y, uint4* __restrict__ ws, Walk w) {
  gemm_body<false>(&mx, &mw, ax, s, y, ws, w);
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                     const float* __restrict__ ax, const float* __restrict__ s,
                     float* __restrict__ y, uint4* __restrict__ ws, Walk w) {
  gemm_body<true>(&mx, &mw, ax, s, y, ws, w);
}

// The second pass over the stream-K tiles, one block per (tile, vector j):
// a tile shared by CTAs c0..c1 is the sum of their partials in that order
// (their K order), then the epilogue. Loads go eight pieces at a time.
template <typename Acc>
__device__ __forceinline__ void reduce_body(const uint4* __restrict__ ws,
                                            const float* __restrict__ ax,
                                            const float* __restrict__ s, float* __restrict__ y,
                                            const Walk& w) {
  constexpr int kBatch = 8;
  const long long i0 = static_cast<long long>(blockIdx.x) * w.nk;
  const int c0 = w.owner(i0), c1 = w.owner(i0 + w.nk - 1);
  if (c0 == c1) return;  // one CTA did the whole tile and stored it
  const int j = blockIdx.y;
  Acc v[4];
  for (int c = c0; c <= c1; c += kBatch) {
    uint4 q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c + u <= c1)
        q[u] = slot_ptr(const_cast<uint4*>(ws), c + u, w.begin(c + u) >= i0 ? 0 : 1)[j * kConsumers];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c + u > c1) break;
      if (c + u == c0) {
        set_bits(v[0], q[u].x), set_bits(v[1], q[u].y), set_bits(v[2], q[u].z), set_bits(v[3], q[u].w);
      } else {
        add_bits(v[0], q[u].x), add_bits(v[1], q[u].y), add_bits(v[2], q[u].z), add_bits(v[3], q[u].w);
      }
    }
  }
  store_vec(v, j, w.tiles_dp + blockIdx.x, w, ax, s, y);
}

__global__ void __launch_bounds__(kConsumers)
    gemm_s8_reduce_kernel(const uint4* __restrict__ ws, const float* __restrict__ ax,
                          const float* __restrict__ s, float* __restrict__ y, Walk w) {
  reduce_body<int>(ws, ax, s, y, w);
}

__global__ void __launch_bounds__(kConsumers)
    gemm_bf16_reduce_kernel(const uint4* __restrict__ ws, const float* __restrict__ ax,
                            const float* __restrict__ s, float* __restrict__ y, Walk w) {
  reduce_body<float>(ws, ax, s, y, w);
}

// An int8 row-major [rows, K] matrix as [128 rows, 128 bytes] boxes in the
// 128-byte swizzle, zero-filled outside.
int make_map(CUtensorMap* map, const void* p, int K, int rows) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = f(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides,
                       box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The main kernel, then the second pass when a tile is shared (ws != null).
template <bool kBf16, typename Kernel, typename Reduce>
int launch(Kernel kernel, Reduce reduce, const void* xi8, const void* qs, const float* ax,
           const float* s, float* y, uint4* ws, const Walk& w, int tiles_sk, cudaStream_t st) {
  using C = Cfg<kBf16>;
  CUtensorMap mx, mw;
  int e = make_map(&mx, xi8, w.K, w.T);
  if (e != 0) return e;
  e = make_map(&mw, qs, w.K, w.O);
  if (e != 0) return e;
  const cudaError_t err = lt_allow_smem(kernel, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<w.ctas, kThreads, C::kSmem, st>>>(mx, mw, ax, s, y, ws, w);
  LT_RETURN_IF_ERROR();
  if (ws != nullptr) reduce<<<dim3(tiles_sk, kVecs), kConsumers, 0, st>>>(ws, ax, s, y, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi8 [T, K] int8, ax [T] f32, qs [O, K] int8, s [O] f32 -> y [T, O] f32.
// K % 16 == 0 and 16-byte aligned rows (the wrapper checks). The plan of
// ops/gemm.py plan_gemm: `ctas` persistent CTAs, `tiles_dp` tiles done whole
// before the stream-K walk, ws [2 ctas, 128 * 128] 4-byte words when a tile
// is shared (else null). bf16 != 0 launches K17, else K4.
LT_EXPORT int lt_rowq_gemm(const void* xi8, const void* ax, const void* qs, const void* s, void* y,
                           void* ws, int T, int O, int K, int bf16, int ctas, int tiles_dp,
                           void* stream) {
  Walk w;
  w.T = T;
  w.O = O;
  w.K = K;
  w.tiles_m = (T + BM - 1) / BM;
  w.nk = (K + BK - 1) / BK;
  w.tiles_dp = tiles_dp;
  w.ctas = ctas;
  const int tiles_sk = w.tiles_m * ((O + BN - 1) / BN) - tiles_dp;
  w.total_sk = static_cast<long long>(tiles_sk) * w.nk;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(ax);
  const auto* sc = static_cast<const float*>(s);
  auto* out = static_cast<float*>(y);
  auto* part = static_cast<uint4*>(ws);
  return bf16 ? launch<true>(gemm_bf16_kernel, gemm_bf16_reduce_kernel, xi8, qs, a, sc, out, part,
                             w, tiles_sk, st)
              : launch<false>(gemm_s8_kernel, gemm_s8_reduce_kernel, xi8, qs, a, sc, out, part, w,
                              tiles_sk, st);
}
