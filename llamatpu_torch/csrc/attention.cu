// Decode attention of one layer (T = 1): K6 and K8 (each with its int8
// variant), one cluster kernel body behind both, and the walk kernel behind
// K14 and K15.
//
// ---- K6: fused KV-append + decode attention over the dense packed cache.
//
// Replaces llamatpu/ops/pallas_attention.py `_fused_write_kernel` (through
// `decode_attention_fused_write`, and `decode_attention_fused_write_q` for
// the int8 variant, quant=True): row pos_vec[b] of this layer's packed cache
// [B, KV, S, hd + vhd] is written with this token's K|V row cast to the cache
// dtype (under int8 the row arrives quantized and its two scales go to the
// scale rows [B, KV, 2, S]), and that same cast row is attended, so the result
// equals write-then-attend; nothing else of the cache changes. Scores are
// (q . k) * scale in f32 (* k_scale[s] under int8) over rows s <= pos;
// softmax; the V scale multiplies exp(score - m) in the partial output only;
// out [B, KV, G, vhd] f32.
//
// Bound on the H100: bytes, (pos + 1) cache rows of (hd + vhd) * itemsize per
// KV head (llama32-1b at pos 512: 8 heads x 513 rows x 256 B = 1.05 MB,
// 0.31 us; int8 (128 + 8) B a row, 0.17 us), i.e. latency-bound at chat
// lengths: the launch, the first copy's latency and the combines are most
// of the time. On the TPU one grid step held a head's whole stripe in VMEM.
//
// The first design took 0.0123 ms at B = 1 (1.9x SDPA): a grid of
// ceil(S / 64) x KV x B blocks that followed the physical length (half of
// them exiting at once at pos 512 of 1152 rows), dependent 16-byte K loads
// with nothing prefetched, 64 serial V loads a thread, and partial outputs
// through device memory to a second launch; the int8 variant ran the walk
// kernel at 64 rows a block, also two launches. This design,
// dense_cluster_kernel, is K8's single launch over a stripe instead of a
// table (the shared body is cluster_attention below):
//   - grid (C * KV, B) in clusters of C CTAs (ops/attention.py plan_dense
//     picks C and the stage rows R, a power of two dividing 32, from shapes
//     alone: never from pos, which the host cannot read without a sync).
//     Rank r takes the lane's R-row units r, r + C, ... up to pos
//     (ops/attention.py dense_shares). A head's rows are contiguous, so a
//     stage is one cp.async.bulk of R whole rows (S % R == 0: a stage never
//     passes S) and its address follows from the rank alone: the rank's
//     first stage is issued before pos is loaded, taking the pos load off
//     the first copy's path. Rows past pos in the last stage are masked by
//     the consumers. Under int8 a consumer lane loads its row's two scales
//     from the scale rows itself, before it waits for the stage: two more
//     bulk copies a stage (K8's int8 way) paced the ring by copies.
//   - the fused write: the rank whose units hold pos writes the cast row (and
//     scales) to the cache before its block barrier and keeps the row in
//     shared memory; the consumer warp of the stage holding pos puts it in
//     place of the staged row before scoring (the scale loads come after the
//     barrier, so they read the new scales). The bulk copy may have read the old row or the new one; either
//     is overwritten, and the row is never read back through the async proxy
//     (a proxy fence orders the shared-memory write before the slot's next
//     copy). No other CTA reads row pos.
//   - consumers and combines as K8's (below): a consumer warp scores 16 rows
//     of its stage at a time; an empty rank exits at once; rank 0 waits only
//     for the ranks that had rows (the count follows from pos on the device).
// pos outside [0, S) writes nothing and gives NaN. A parked lane at S - 1
// writes there, as in JAX. Offsets are 64-bit (a stacked cache passes 2 GB).
//
// ---- K8: paged decode attention over the shared block pool.
//
// Replaces llamatpu/ops/pallas_attention.py `_paged_kernel` (body
// `_split_kernel`, through `decode_attention_paged`): row s of lane b lives in
// pool block tables[b, s / BS] at offset s % BS of this layer's pool
// [NBLK, KV, BS, hd + vhd]; scores (q . k) * scale in f32 over rows s <= pos;
// online softmax, out = acc / l, [B, KV, G, vhd] f32. The pool is only read
// (the KV write is a torch index write before the call). The int8 variant
// (`quant=True`, through `decode_attention_paged_q`) reads int8 rows and the
// scale pool [NBLK, KV, 2, BS] through the same tables: scores take
// * k_scale[s], and the V scale multiplies exp(score - m) in the partial
// output only (never the sum l).
//
// Bound on the H100: bytes, the live rows of every lane, (pos_b + 1) rows of
// (hd + vhd) * 2 bytes per KV head (llama32-1b, B = 8 lanes at pos 512:
// 8 x 8 x 513 x 256 B = 8.4 MB, 2.5 us; int8: (128 + 8) B per row, 4.5 MB,
// 1.4 us): 4-8 operations a byte, far under the tensor cores' ridge, so the
// arithmetic stays f32 on CUDA cores (bf16 products of exp(score - m) would
// round the weights to 8 bits). On the TPU the grid walked the lane's
// table block by block in order, with the table in scalar prefetch.
//
// The first design took 0.019 ms there (7.5x the bound; int8 14x, slower
// than bf16 at half the bytes): a grid of ceil(MAXBLK * BS / 64) x KV x B
// blocks of 64 rows, most of them exiting at once past pos; in each a table
// read, then dependent 16-byte K loads with nothing prefetched, then 64
// serial 2-byte V loads a thread; partial outputs through device memory to a
// second launch whose threads combined up to 33 partials each. Its time
// followed the table's width and latency chains, not the bytes. This design,
// paged_cluster_kernel, is one launch whose work follows the length:
//   - grid (C * KV, B) in clusters of C CTAs (1, 2, 4 or 8; ops/attention.py
//     plan_paged picks C from B * KV, MAXBLK and the SM count). The lane's
//     rows s <= pos fall in units of a stage's rows (whole pool blocks, or a
//     piece of one); rank r of the cluster of (lane b, KV head h) takes units
//     r, r + C, ... (ops/attention.py paged_shares): the ranks' loads differ
//     by a unit at most, and a rank's table entries follow from r alone, so
//     they load beside pos instead of after it.
//   - a producer warp (its table entries cached in shared memory) streams
//     the rank's rows through a ring of 8 stages of 16 rows
//     (fewer where 16 pass 8 KB): one cp.async.bulk per pool block (a
//     block's rows of one KV head are contiguous; a block longer than a
//     stage goes in stage-sized pieces), under int8 one more for the block's
//     [2, BS] scales (plain loads at BS = 1, under the 16 bytes a bulk copy
//     needs), all completing on the stage's `full` mbarrier; the stage's
//     consumer frees it on its `empty` one.
//   - 8 consumer warps, warp w taking stages w, w + 8, ... (the ring holds 8,
//     so no warp waits on a stage two rounds ahead) with its own online
//     softmax: lanes r and r + 16 score row r, each half of its 16-byte K
//     vectors, row r starting at vector r (a bulk copy cannot pad rows and
//     every row starts on a multiple of 128 bytes; rotated, a quarter-warp
//     never hits one bank twice), against q in f32 in shared memory (loaded
//     once, laid out so the rotated reads sit side by side); scores in log2
//     units, weights by ex2; then P.V with every lane on two V elements of
//     each row in turn (NP pairs a lane, a template constant), its [G, 2 NP]
//     sums in registers. No block barrier a stage. At the end the 8 warps'
//     (m, l, sums) combine in warp order.
//   - the combine through distributed shared memory: every rank with rows
//     but 0 combines its warps' states straight into rank 0's shared memory
//     (st.shared::cluster, after a cluster barrier that every CTA arrived at
//     on starting, so rank 0 runs and its barriers exist), arrives on an
//     mbarrier there (release at cluster scope) and exits; an empty rank
//     exits at once. Rank 0 waits on the mbarrier (acquire) for as many
//     arrivals as ranks had rows, skips states with no row (m = -inf) and
//     writes sum_r w_r acc_r / sum_r w_r l_r, w_r = 2^(m_r - max m). No
//     scratch, no atomics: the same bits on every run.
// A lane with pos < 0 or pos >= MAXBLK * BS gets NaN. Table entries past pos
// are never read; a parked lane (every entry the trash block) reads the trash
// block. Offsets are 64-bit (a stacked pool passes 2 GB).
//
// ---- The walk kernel: K14 and K15.
//
// K14 replaces `_split_kernel`'s dense callers (`_split_call`,
// pallas_attention.py:349, and `_split_fused_call`, :481): S-tiled
// online-softmax decode attention over the dense packed cache [B, KV, S, W]
// in bf16, f32 or int8 (+ the scale rows [B, KV, 2, S]), unfused, fused (row
// pos written IN PLACE with kv_new, and under int8 its two scales, before it
// is attended) or with the stripe's softmax statistics (m, l) for a
// cross-shard combine. K15 replaces `_full_kernel` (:119): masked attention
// over the first s_use rows, bf16/f32/int8; it is the same kernel without the
// write, reading rows s <= min(pos, s_use - 1). Numerics of both: scores
// (q . k) * scale in f32 (* k_scale under int8), masking s <= pos, online
// softmax keeping m and l, the partial output adds exp(score - m)
// (* v_scale) * v, out = acc / l.
//
// Bound on the H100: bytes, the live rows once. Llama-3.2-1B, pos 32767, one
// layer, B = 1: bf16 8 heads x 32768 rows x 256 B = 67.1 MB, 20.0 us at
// 3.35 TB/s; int8 8 x 32768 x (128 + 8) B = 35.7 MB, 10.6 us. On the TPU the
// grid walked the S tiles of one head in order, the DMA clamped to the tile
// holding pos, with m, l and acc carried in VMEM scratch. Here the walk is
// split across blocks so a long stripe fills the SMs:
//   1. grid (ceil(s_use / R), KV, B), R rows per block (the wrapper picks R,
//      a power of two from 64 to 1024, so that about two blocks run per SM
//      at the longest position). A block past min(pos, s_use - 1) exits at
//      once (the clamped DMA's counterpart). The block walks its rows in
//      chunks of 64, each chunk's packed rows (and int8 scales) copied into
//      shared memory by cp.async in 16-byte pieces, two stages, so the next
//      chunk streams in while one is used. Four threads per row score a
//      quarter of the staged K row each against all G heads, a warp per head
//      updates m, l and the rescale factor, and a thread per (head, V
//      element) rescales its accumulator in shared memory and adds the
//      chunk. In fused mode the block holding pos first writes the row (and
//      scales) to the cache and synchronises before its first copy; no other
//      block reads it.
//   2. grid (KV, B): the combine pass over at most ceil(s_use / R) partials
//      (33 at a 32k cache), which also writes the stripe's m and l in stats
//      mode.
// Offsets into the cache are 64-bit: a 32k stacked cache is 1.1 GB.
#include "common.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kChunk = 64;     // rows per chunk of the walk
constexpr int kThreads = 256;  // four threads per row of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxW = 256;     // hd + vhd
static_assert(kThreads == 4 * kChunk, "four threads score each row of a chunk");
#define kNegInf (-__int_as_float(0x7f800000))  // -inf

template <typename CT>
__device__ __forceinline__ float c2f(CT v);
template <>
__device__ __forceinline__ float c2f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float c2f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float c2f<int8_t>(int8_t v) { return static_cast<float>(v); }

template <typename CT>
__device__ __forceinline__ CT f2c(float v);
template <>
__device__ __forceinline__ float f2c<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 f2c<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ int8_t f2c<int8_t>(float v) {  // exact integers
  return static_cast<int8_t>(v);
}

// a value of a bf16, f32 or int8 array as f32
__device__ __forceinline__ float load_any(const void* p, int dtype, long i) {
  return dtype == LT_I8 ? static_cast<float>(static_cast<const int8_t*>(p)[i])
                        : lt_load(p, dtype, i);
}

struct Args {
  const void* q;    // [B, KV, G, hd] (in_dtype)
  const void* kvn;  // fused mode: [B, KV, hd + vhd] (the walk's kvn_dtype)
  int in_dtype;
  void* kv;         // this layer's cache [B, KV, S, hd + vhd] (CT)
  const int* pos;   // [B]
  int B, KV, G, S, hd, vhd;
  float scale;
  float* part_o;    // [B, KV, nsplit, G, vhd]
  float* part_ml;   // [B, KV, nsplit, G, 2]: local max, local sum
  float* out;       // [B, KV, G, vhd]
  int nsplit;
  int rows;         // cache rows per pass-1 block
  int s_use;        // rows read: s <= min(pos, s_use - 1)
  float* m_out;     // [B, KV, G] stripe max (stats mode) or null
  float* l_out;     // [B, KV, G] stripe sum (stats mode) or null
};


// The walk's pass 2: rescale the partials by exp(m_i - max m) and divide by
// the rescaled sum; in stats mode also write that max and sum.
__global__ void __launch_bounds__(kThreads) attn_walk_combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.G, vhd = a.vhd;
  const long bh = static_cast<long>(b) * a.KV + h;
  const int pos = a.pos[b];
  float* out = a.out + bh * G * vhd;
  if (pos < 0 || pos >= a.S) {  // no row was attended: make the fault visible
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = threadIdx.x; idx < G * vhd; idx += blockDim.x) out[idx] = nan;
    if (a.m_out != nullptr)
      for (int g = threadIdx.x; g < G; g += blockDim.x)
        a.m_out[bh * G + g] = a.l_out[bh * G + g] = nan;
    return;
  }
  const int nvalid = min(pos, a.s_use - 1) / a.rows + 1;
  const float* ml = a.part_ml + bh * a.nsplit * G * 2;
  const float* po = a.part_o + bh * a.nsplit * G * vhd;
  for (int idx = threadIdx.x; idx < G * vhd; idx += blockDim.x) {
    const int g = idx / vhd;
    float mx = kNegInf;
    for (int i = 0; i < nvalid; ++i) mx = fmaxf(mx, ml[(i * G + g) * 2]);
    float den = 0.f, num = 0.f;
    for (int i = 0; i < nvalid; ++i) {
      const float w = expf(ml[(i * G + g) * 2] - mx);
      den += w * ml[(i * G + g) * 2 + 1];
      num += w * po[i * G * vhd + idx];
    }
    out[idx] = num / den;
    if (a.m_out != nullptr && idx == g * vhd) {
      a.m_out[bh * G + g] = mx;
      a.l_out[bh * G + g] = den;
    }
  }
}

// ------------------------------------------------------------------ K8
// TMA bulk copies, mbarriers and cluster operations of the cluster kernels.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete. A wait of over ~2^32 cycles
// (seconds) traps: a fault in the ring fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// One bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Order this thread's earlier shared-memory writes (generic proxy) before
// later bulk copies into the same bytes (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, in two halves: every thread of every CTA of the
// cluster arrives (its writes before it released), and waits for the other
// non-exited threads' arrivals (their writes acquired).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrive on the mbarrier at the offset of `bar` in the cluster's CTA `rank`,
// releasing this thread's (and, through a CTA barrier before it, its CTA's)
// writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Wait for the phase of `parity` of a local mbarrier that other CTAs of the
// cluster arrive on, acquiring their writes (traps after ~2^32 cycles, as
// mbar_wait).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// Store v at the offset of `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ void st_rank(float* p, unsigned rank, float v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}
constexpr int kPagedConsumers = 256;                      // 8 consumer warps
constexpr int kPagedWarps = kPagedConsumers / 32;
constexpr int kPagedThreads = kPagedConsumers + 32;       // + the producer warp
constexpr int kPagedDepth = 8;  // ring stages: one a consumer warp, so no warp waits two rounds ahead
constexpr int kMaxCluster = 8;
constexpr int kTblCache = 256;  // table entries of a rank held in shared memory
constexpr int kSub = 16;        // rows a consumer warp scores at once: two lanes a row
constexpr int kMaxSub = 2;      // 16-row passes of a dense stage (at most 32 rows)

__device__ __forceinline__ void paged_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPagedConsumers) : "memory");
}

struct ClusterArgs {
  const void* q;        // [B, KV, G, hd] (in_dtype)
  int in_dtype;
  const void* cache;    // paged: this layer's pool [NBLK, KV, BS, hd + vhd];
                        // dense: this layer's cache [B, KV, S, hd + vhd] (CT, written at pos)
  const float* scales;  // int8: the scale pool [NBLK, KV, 2, BS] / the scale rows
                        // [B, KV, 2, S] (dense: written at pos); else null
  const int* tables;    // paged: [B, MAXBLK]
  const int* pos;       // [B]
  float* out;           // [B, KV, G, vhd]
  const void* kvn;      // dense: this token's rows [B, KV, hd + vhd] (kvn_dtype)
  int kvn_dtype;
  const float* snew;    // dense int8: this token's scales [B, KV, 2]
  int KV, G, hd, vhd;
  int bs_shift, maxblk;  // paged: block size 1 << bs_shift, table width
  int S;                 // dense: rows of a stripe
  int cluster;
  int rows;  // rows of a ring stage: paged a power of two <= 16, dense one dividing 32
  float scale;
};

// Two adjacent elements (the first at an even index of a 16-byte aligned row) as f32.
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}
__device__ __forceinline__ float2 ld_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld_pair(const int8_t* p) {
  const char2 x = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(x.x), static_cast<float>(x.y));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P.V of a stage for one consumer warp: acc[g][2 u + i] += w[j][g] *
// V[j][2 (lane + 32 u) + i] over the stage's rows j < n, NP pairs a lane.
template <typename CT, int GM, int NP>
__device__ __forceinline__ void pv_rows(float (&acc)[GM][2 * NP], const unsigned char* st, int row_bytes,
                                        int hd, int vhd, int n, const float* pw, int lane) {
  const CT* v0 = reinterpret_cast<const CT*>(st) + hd + 2 * lane;
  const int pitch = row_bytes / static_cast<int>(sizeof(CT));
  bool in[NP];
#pragma unroll
  for (int u = 0; u < NP; ++u) in[u] = 2 * (lane + 32 * u) < vhd;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const CT* vr = v0 + j * pitch;
    float w[GM];
    if constexpr (GM % 4 == 0) {
#pragma unroll
      for (int g = 0; g < GM; g += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(pw + j * GM + g);
        w[g] = w4.x;
        w[g + 1] = w4.y;
        w[g + 2] = w4.z;
        w[g + 3] = w4.w;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) w[g] = pw[j * GM + g];
    }
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const float2 vv = in[u] ? ld_pair(vr + 64 * u) : make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        acc[g][2 * u] += w[g] * vv.x;
        acc[g][2 * u + 1] += w[g] * vv.y;
      }
    }
  }
}

// Dynamic shared memory: the ring [kPagedDepth][rows x (hd + vhd)] (each stage on
// a 128-byte boundary; at the end the consumer warps' sums [8][G][vhd] f32
// reuse it), q f32 [GM][N / 4][kMaxW / N][4], this rank's sums [G][vhd] f32,
// in a cluster rank 0's copy of the others' [C][G][vhd] f32, and under paged
// int8 (SCALES) the stages' scales [kPagedDepth][2 * rows] f32.
template <typename CT, bool SCALES, int GM>
size_t cluster_smem(int G, int hd, int vhd, int rows, int cluster) {
  const size_t pitch = (static_cast<size_t>(rows) * (hd + vhd) * sizeof(CT) + 127) / 128 * 128;
  size_t ring = kPagedDepth * pitch;
  const size_t red = static_cast<size_t>(kPagedWarps) * G * vhd * sizeof(float);
  ring = ((ring > red ? ring : red) + 127) / 128 * 128;
  return ring +
         (static_cast<size_t>(GM) * kMaxW +
          static_cast<size_t>(G) * vhd * (cluster > 1 ? cluster + 1 : 1)) * sizeof(float) +
         (SCALES ? static_cast<size_t>(kPagedDepth) * 2 * rows * sizeof(float) : 0);
}

// The body of K8 (DENSE = false: rows through the block tables) and K6
// (DENSE = true: a contiguous stripe, row pos written). GM: G rounded up to
// 1, 4 or 8; NP: V element pairs a lane (vhd <= 64, 128 or 256). Together
// the size of the P.V sums in registers.
template <typename CT, bool QUANT, bool DENSE, int GM, int NP>
__device__ __forceinline__ void cluster_attention(const ClusterArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kPagedDepth], empty[kPagedDepth];
  __shared__ __align__(8) uint64_t pushed;  // rank 0: the other ranks' states have arrived
  __shared__ __align__(16) float pbuf[kPagedWarps][kSub * GM];  // each warp's stage weights
  __shared__ float mw[kPagedWarps][GM], lw[kPagedWarps][GM];  // the consumer warps' m, l
  __shared__ float m_s[GM], l_s[GM];                            // this rank's
  __shared__ float cm[kMaxCluster][GM], cl[kMaxCluster][GM];    // rank 0: the others'
  __shared__ int tbl[DENSE ? 1 : kTblCache];
  __shared__ __align__(16) unsigned char newrow[DENSE ? kMaxW * sizeof(CT) : 16];  // dense: row pos, cast
  const int C = a.cluster, G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const unsigned rank = cluster_rank();
  const int h = blockIdx.x / C, b = blockIdx.y;
  const int shift = a.bs_shift, bs = 1 << shift;
  const int R = a.rows;
  constexpr int D = kPagedDepth;
  const int row_bytes = W * static_cast<int>(sizeof(CT));
  const int pitch = (R * row_bytes + 127) & ~127;
  const int SB = bs < R ? bs : R;  // paged: rows of a stage's scale piece [2][SB]
  size_t ring = static_cast<size_t>(D) * pitch;
  const size_t red_bytes = static_cast<size_t>(kPagedWarps) * G * vhd * sizeof(float);
  ring = ((ring > red_bytes ? ring : red_bytes) + 127) / 128 * 128;
  float* red = reinterpret_cast<float*>(smem);  // [8][G][vhd], after the last stage
  constexpr int N = 16 / sizeof(CT);  // elements of a 16-byte K vector
  const int nvec = hd / N;             // 16-byte K vectors a row
  constexpr int kQVecs = kMaxW / N;     // q's stride between (head, float4) rows, in vectors
  float* qf = reinterpret_cast<float*>(smem + ring);  // [GM][N / 4][kQVecs][4]
  float* accs = qf + GM * kMaxW;
  float* cacc = accs + G * vhd;  // rank 0: the others' sums [C][G][vhd] (C > 1)
  float* scr = cacc + (C > 1 ? C * G * vhd : 0);  // paged int8: [kPagedDepth][2 * rows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long bh = static_cast<long>(b) * a.KV + h;
  // dense: this lane-head's stripe, its scale rows [2][S], a stage's copy bytes
  const unsigned char* stripe =
      static_cast<const unsigned char*>(a.cache) + (DENSE ? bh * a.S * row_bytes : 0);
  const float* srows = DENSE && QUANT ? a.scales + bh * 2 * a.S : nullptr;
  const unsigned stage_tx = static_cast<unsigned>(R * row_bytes);  // dense: rows only
  const bool first_ahead = DENSE && static_cast<int>(rank) * R < a.S;  // the stage issued before pos

  // the rank's table entries (paged), entry p of stage k at k gpu + p: they
  // follow from the rank alone, so they load beside pos and q; the
  // producer's lane 0 initialises the ring's barriers while the loads are in
  // flight, and (dense) issues the rank's first stage, unit `rank`
  const int gpu = R > bs ? R >> shift : 1;  // table entries a unit
  const int* trow = DENSE ? nullptr : a.tables + static_cast<long>(b) * a.maxblk;
  if (warp == kPagedWarps) {
    int tv[DENSE ? 1 : kTblCache / 32];
    if constexpr (!DENSE) {
#pragma unroll
      for (int u = 0; u < kTblCache / 32; ++u) {
        const int t = lane + 32 * u, k = t / gpu;
        const int j = (((static_cast<int>(rank) + C * k) * R) >> shift) + t - k * gpu;
        tv[u] = j < a.maxblk ? trow[j] : 0;
      }
    }
    if (lane == 0) {
      for (int d = 0; d < D; ++d) {
        mbar_init(&full[d], 1);   // the producer's expect_tx, then the bytes
        mbar_init(&empty[d], 1);  // the consumer warp of the stage
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (first_ahead) {
        fence_proxy_async();  // the initialised barrier, seen by the copy
        mbar_expect_tx(&full[0], stage_tx);
        const int s0 = static_cast<int>(rank) * R;
        bulk_load(smem, stripe + static_cast<long>(s0) * row_bytes,
                  static_cast<unsigned>(R * row_bytes), &full[0]);
      }
    }
    if constexpr (!DENSE) {
#pragma unroll
      for (int u = 0; u < kTblCache / 32; ++u) tbl[lane + 32 * u] = tv[u];
    }
  }

  // this rank's stages: stage k is the lane's R-row unit u = rank + C k,
  // rows [u R, min(u R + R, pos + 1)) (paged: whole pool blocks, or a piece
  // of one); ranks 0 .. nranks - 1 have rows. pos is loaded here and waited
  // for only after q (and, dense, this token's row) are in flight.
  const int pos = a.pos[b];
  // q in f32 [GM][N / 4][kQVecs][4] (zero past G): the float4 f of K vector
  // v of head g at (g N / 4 + f) kQVecs + v, so the lanes' rotated vectors
  // sit side by side and every head's offset is a constant
  for (int i = tid; i < GM * hd; i += kPagedThreads) {
    const int g = i / hd, e = i - g * hd, vec = e / N, u = e - vec * N;
    qf[((g * (N / 4) + u / 4) * kQVecs + vec) * 4 + (u & 3)] =
        g < G ? lt_load(a.q, a.in_dtype, bh * G * hd + i) : 0.f;
  }
  static_assert(kMaxW <= kPagedThreads, "a thread holds one element of the new row");
  const CT kv_e = DENSE && tid < W ? f2c<CT>(load_any(a.kvn, a.kvn_dtype, bh * W + tid)) : f2c<CT>(0.f);
  const float sc_e = DENSE && QUANT && tid < 2 ? a.snew[bh * 2 + tid] : 0.f;
  const bool valid = pos >= 0 && pos < (DENSE ? a.S : (a.maxblk << shift));
  const int nu = valid ? pos / R + 1 : 0;
  const int nstages = nu > static_cast<int>(rank) ? (nu - static_cast<int>(rank) + C - 1) / C : 0;
  const int nranks = nu < C ? nu : C;
  if (rank == 0 && warp == kPagedWarps && lane == 0) {
    mbar_init(&pushed, nranks > 1 ? nranks - 1 : 1);  // one arrive from each other rank with rows
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C > 1) cluster_arrive_relaxed();  // waited for before the combine's stores
  if (rank != 0 && static_cast<int>(rank) >= nranks) {  // no row: nothing to push
    if (first_ahead && warp == kPagedWarps && lane == 0) mbar_wait(&full[0], 0);  // its copy lands
    return;
  }
  if constexpr (DENSE) {
    // the rank holding pos: row pos := kv_new cast to the cache dtype (and
    // its scales), in the cache and in shared memory for the stage holding it
    if (valid && (pos / R) % C == static_cast<int>(rank)) {
      if (tid < W) {
        reinterpret_cast<CT*>(newrow)[tid] = kv_e;
        reinterpret_cast<CT*>(const_cast<unsigned char*>(stripe))[static_cast<long>(pos) * W + tid] = kv_e;
      }
      if (QUANT && tid < 2) const_cast<float*>(srows)[tid * a.S + pos] = sc_e;
    }
  }
  __syncthreads();

  if (warp == kPagedWarps) {
    // the producer warp: a stage's copies (paged: lane i the pool blocks i,
    // i + 32, ... of the stage; dense: lane 0 one copy of R rows)
    if constexpr (DENSE) {
      if (lane == 0) {
        for (int k = 1; k < nstages; ++k) {  // stage 0 is in flight already
          const int slot = k % D;
          const unsigned phase = (k / D) & 1;
          const int s0 = (static_cast<int>(rank) + C * k) * R;
          mbar_wait(&empty[slot], phase ^ 1);
          mbar_expect_tx(&full[slot], stage_tx);
          bulk_load(smem + slot * pitch, stripe + static_cast<long>(s0) * row_bytes,
                    static_cast<unsigned>(R * row_bytes), &full[slot]);
        }
        if (first_ahead && nstages == 0) mbar_wait(&full[0], 0);  // issued, not consumed
      }
    } else {
      const unsigned char* pool = static_cast<const unsigned char*>(a.cache);
      for (int k = 0; k < nstages; ++k) {
        const int slot = k % D;
        const unsigned phase = (k / D) & 1;
        const int s0 = (static_cast<int>(rank) + C * k) * R, n = min(R, pos + 1 - s0);
        const int first = s0 >> shift, pieces = ((s0 + n - 1) >> shift) - first + 1;
        unsigned char* dst = smem + slot * pitch;
        float* sdst = scr + slot * 2 * R;
        mbar_wait(&empty[slot], phase ^ 1);
        if (QUANT && bs == 1) {  // 8 bytes a block: plain loads, stored before the arrive
          for (int i = lane; i < pieces; i += 32) {
            const int t = k * gpu + i;
            const long blk = t < kTblCache ? tbl[t] : trow[first + i];
            const float2 sv = *reinterpret_cast<const float2*>(a.scales + (blk * a.KV + h) * 2);
            sdst[2 * i] = sv.x;
            sdst[2 * i + 1] = sv.y;
          }
          __syncwarp();
        }
        if (lane == 0) {
          unsigned tx = static_cast<unsigned>(n * row_bytes);
          if (QUANT && bs > 1) tx += static_cast<unsigned>(bs <= R ? pieces * 2 * bs * 4 : 2 * R * 4);
          mbar_expect_tx(&full[slot], tx);
        }
        __syncwarp();
        for (int i = lane; i < pieces; i += 32) {
          const int j = first + i, t = k * gpu + i;
          const long blk = t < kTblCache ? tbl[t] : trow[j];
          const int rs = max(s0, j << shift), re = min(s0 + n, (j + 1) << shift);
          const int off = rs & (bs - 1);
          const long row0 = ((blk * a.KV + h) << shift) + off;
          bulk_load(dst + (rs - s0) * row_bytes, pool + row0 * row_bytes,
                    static_cast<unsigned>((re - rs) * row_bytes), &full[slot]);
          if (QUANT && bs > 1) {
            const float* sb = a.scales + ((blk * a.KV + h) << (shift + 1));
            if (bs <= R) {
              bulk_load(sdst + (rs - s0) * 2, sb, static_cast<unsigned>(2 * bs * 4), &full[slot]);
            } else {
              bulk_load(sdst, sb + off, static_cast<unsigned>(R * 4), &full[slot]);
              bulk_load(sdst + R, sb + bs + off, static_cast<unsigned>(R * 4), &full[slot]);
            }
          }
        }
      }
    }
    return;
  }

  // the consumer warps: warp w takes stages w, w + 8, ... (the ring holds 8,
  // so a warp never waits on a stage two rounds ahead), 16 rows of it at a
  // time, lanes r and r + 16 row r, each half of its K vectors. Scores in
  // log2 units: x * scale * log2(e), weights by ex2.
  const float sl2 = a.scale * 1.4426950408889634f;
  const int r = lane & 15, half = lane >> 4;
  const int rot = r % nvec;  // row r reads K vector (v + r) % nvec at step v: no bank twice
  const float4* q4 = reinterpret_cast<const float4*>(qf);
  float* pw = pbuf[warp];    // the 16 rows' weights [16][GM]
  float m[GM], l[GM], acc[GM][2 * NP];  // acc[g][2 u + i]: V element 2 (lane + 32 u) + i
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < 2 * NP; ++u) acc[g][u] = 0.f;
  }
  for (int k = warp; k < nstages; k += kPagedWarps) {
    const int slot = k % D;
    const unsigned phase = (k / D) & 1;
    const int s0 = (static_cast<int>(rank) + C * k) * R;
    const int n = min(R, pos + 1 - s0);
    unsigned char* st = smem + slot * pitch;
    const float* ssc = scr + slot * 2 * R;  // paged int8: row j's K scale at (j / SB) * 2 SB + j % SB
    // dense int8: lane r's K and V scales of its row in each 16-row pass,
    // plain loads issued before the stage is waited for (row pos's were
    // written by this CTA before its barrier, so the loads see them)
    float kq[kMaxSub], vq[kMaxSub];
#pragma unroll
    for (int t = 0; t < kMaxSub; ++t) {
      const int j = t * kSub + r;
      const bool in = DENSE && QUANT && j < n;
      kq[t] = in ? srows[s0 + j] : 1.f;
      vq[t] = in ? srows[a.S + s0 + j] : 1.f;
    }
    mbar_wait(&full[slot], phase);
    if (DENSE && pos < s0 + R) {  // the stage holding row pos: the cast row in place of the copy's
      const int j = pos - s0;
      uint4* dst = reinterpret_cast<uint4*>(st + j * row_bytes);
      const uint4* src = reinterpret_cast<const uint4*>(newrow);
      for (int i = lane; i < row_bytes / 16; i += 32) dst[i] = src[i];
      fence_proxy_async();  // before the slot's next bulk copy
      __syncwarp();
    }
    for (int j0 = 0; j0 < n; j0 += kSub) {
      const unsigned char* sub = st + j0 * row_bytes;
      const int nn = min(kSub, n - j0);
      const bool live = r < nn;
      // row r: q . k for every head, the K vectors rotated by r, the two
      // halves' sums added by a shuffle
      float d[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] = 0.f;
      if (live) {
        const unsigned char* row = sub + r * row_bytes;
#pragma unroll 4
        for (int v0 = half; v0 < nvec; v0 += 2) {
          int vec = v0 + rot;
          if (vec >= nvec) vec -= nvec;
          const uint4 raw = *reinterpret_cast<const uint4*>(row + vec * 16);
          const CT* kv = reinterpret_cast<const CT*>(&raw);
          float kf[N];
#pragma unroll
          for (int u = 0; u < N; ++u) kf[u] = c2f<CT>(kv[u]);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
#pragma unroll
            for (int f = 0; f < N / 4; ++f) {
              const float4 qq = q4[(g * (N / 4) + f) * kQVecs + vec];
              d[g] += qq.x * kf[4 * f];
              d[g] += qq.y * kf[4 * f + 1];
              d[g] += qq.z * kf[4 * f + 2];
              d[g] += qq.w * kf[4 * f + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] += __shfl_xor_sync(0xffffffffu, d[g], 16);
      const int rr = j0 + r;
      const int sj = (rr / SB) * 2 * SB + (rr & (SB - 1));
      float ks = 1.f, vs = 1.f;
      if (DENSE) {
#pragma unroll
        for (int t = 0; t < kMaxSub; ++t)
          if (t * kSub == j0) {
            ks = kq[t];
            vs = vq[t];
          }
      } else if (QUANT && live) {
        ks = ssc[sj];
        vs = ssc[sj + SB];
      }

      // the online softmax over the 16 rows, every head at once
      float sc[GM], mx[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) mx[g] = sc[g] = live ? d[g] * sl2 * ks : kNegInf;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)  // lanes r and r + 16 hold the same row
#pragma unroll
        for (int g = 0; g < GM; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
      float al[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        al[g] = ex2(m[g] - m_new);
        const float e = half ? 0.f : ex2(sc[g] - m_new);  // 0 for a row past n
        l[g] = l[g] * al[g] + e;
        if (!half) pw[r * GM + g] = e * vs;
        m[g] = m_new;
      }
      __syncwarp();

      // P.V: every lane its V elements 2 (lane + 32 u), + 1 of each row in turn
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int u = 0; u < 2 * NP; ++u) acc[g][u] *= al[g];
      pv_rows<CT, GM, NP>(acc, sub, row_bytes, hd, vhd, nn, pw, lane);
      __syncwarp();  // the stage and pw are read: both free for the next
    }
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // this warp's state (l summed over its lanes), then the warps' states
  // combined in order through shared memory (the ring, every stage read
  // by now)
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
  paged_consumer_sync();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    float* rd = red + (warp * G + g) * vhd;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int e = 2 * (lane + 32 * u);
      if (e < vhd) {
        rd[e] = acc[g][2 * u];
        rd[e + 1] = acc[g][2 * u + 1];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      mw[warp][g] = m[g];
      lw[warp][g] = l[g];
    }
  }
  paged_consumer_sync();

  // the combine: every rank with rows but 0 puts its m, l and sums straight
  // into rank 0's shared memory (cm, cl, cacc at its rank), arrives there
  // and exits; rank 0 adds them up in rank order
  if (rank != 0) cluster_wait();  // rank 0 has started: its barrier initialised
  for (int i = tid; i < G * vhd; i += kPagedConsumers) {
    const int g = i / vhd;
    float mx = kNegInf;
    for (int w = 0; w < kPagedWarps; ++w) mx = fmaxf(mx, mw[w][g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kPagedWarps; ++w) {
      if (mw[w][g] == kNegInf) continue;  // a warp with no rows
      const float wt = ex2(mw[w][g] - mx);
      num += wt * red[w * G * vhd + i];
      den += wt * lw[w][g];
    }
    if (rank == 0) {
      accs[i] = num;
      if (i == g * vhd) {
        m_s[g] = mx;
        l_s[g] = den;
      }
    } else {
      st_rank(cacc + rank * G * vhd + i, 0, num);
      if (i == g * vhd) {
        st_rank(&cm[rank][g], 0, mx);
        st_rank(&cl[rank][g], 0, den);
      }
    }
  }
  paged_consumer_sync();
  if (rank != 0) {
    if (tid == 0) mbar_arrive_rank(&pushed, 0);
    return;
  }
  if (nranks > 1) mbar_wait_cluster(&pushed, 0);
  float* out = a.out + bh * G * vhd;
  for (int i = tid; i < G * vhd; i += kPagedConsumers) {
    const int g = i / vhd;
    float mx = m_s[g];
    for (int r = 1; r < nranks; ++r) mx = fmaxf(mx, cm[r][g]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < nranks; ++r) {
      const float mr = r == 0 ? m_s[g] : cm[r][g];
      if (mr == kNegInf) continue;  // a rank with no rows
      const float w = ex2(mr - mx);
      den += w * (r == 0 ? l_s[g] : cl[r][g]);
      num += w * (r == 0 ? accs[i] : cacc[r * G * vhd + i]);
    }
    out[i] = valid ? __fdividef(num, den) : __int_as_float(0x7fc00000);  // no row attended: NaN
  }
}

template <typename CT, bool QUANT, int GM, int NP>
__global__ void __launch_bounds__(kPagedThreads, GM * NP <= 8 ? 3 : GM * NP <= 16 ? 2 : 1)
    paged_cluster_kernel(ClusterArgs a) {
  cluster_attention<CT, QUANT, false, GM, NP>(a);
}

template <typename CT, bool QUANT, int GM, int NP>
__global__ void __launch_bounds__(kPagedThreads, GM * NP <= 16 ? 2 : 1)
    dense_cluster_kernel(ClusterArgs a) {
  cluster_attention<CT, QUANT, true, GM, NP>(a);
}

template <typename CT, bool QUANT, bool DENSE, int GM, int NP>
int launch_cluster(const ClusterArgs& a, int B, cudaStream_t st) {
  void (*kernel)(ClusterArgs) = nullptr;
  if constexpr (DENSE)
    kernel = dense_cluster_kernel<CT, QUANT, GM, NP>;
  else
    kernel = paged_cluster_kernel<CT, QUANT, GM, NP>;
  const size_t smem = cluster_smem<CT, QUANT && !DENSE, GM>(a.G, a.hd, a.vhd, a.rows, a.cluster);
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster * a.KV, B, 1);
  cfg.blockDim = dim3(kPagedThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

template <typename CT, bool QUANT, bool DENSE, int GM>
int launch_cluster_v(const ClusterArgs& a, int B, cudaStream_t st) {
  return a.vhd <= 64 ? launch_cluster<CT, QUANT, DENSE, GM, 1>(a, B, st)
         : a.vhd <= 128 ? launch_cluster<CT, QUANT, DENSE, GM, 2>(a, B, st)
                        : launch_cluster<CT, QUANT, DENSE, GM, 4>(a, B, st);
}

template <typename CT, bool QUANT, bool DENSE>
int launch_cluster_g(const ClusterArgs& a, int B, cudaStream_t st) {
  return a.G == 1 ? launch_cluster_v<CT, QUANT, DENSE, 1>(a, B, st)
         : a.G <= 4 ? launch_cluster_v<CT, QUANT, DENSE, 4>(a, B, st)
                    : launch_cluster_v<CT, QUANT, DENSE, 8>(a, B, st);
}

template <bool DENSE>
int launch_cluster_t(const ClusterArgs& a, int cache_dtype, int B, cudaStream_t st) {
  if (cache_dtype == LT_I8) return launch_cluster_g<int8_t, true, DENSE>(a, B, st);
  if (cache_dtype == LT_F32) return launch_cluster_g<float, false, DENSE>(a, B, st);
  return launch_cluster_g<__nv_bfloat16, false, DENSE>(a, B, st);
}

// The walk kernel's pass 1 (K14, K15).
struct WalkArgs {
  Args base;          // q, kvn, in_dtype (q's), kv, pos, sizes, scale, scratch, rows, s_use, stats
  int kvn_dtype;      // fused mode: kv_new's dtype (the cache's for int8)
  const float* snew;  // fused int8: this token's scales [B, KV, 2]
  float* sc;          // int8: this layer's scale rows [B, KV, 2, S], else null
  int fused;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kRowPad = 16;  // bytes after each staged row: rows start on different banks

// Dynamic shared memory of the walk kernel: two stages of kChunk packed rows
// (and, under int8, their K and V scales).
template <typename CT, bool QUANT>
constexpr size_t walk_smem(int W) {
  return 2 * kChunk * (W * sizeof(CT) + kRowPad) + (QUANT ? 2 * 2 * kChunk * sizeof(float) : 0);
}

template <typename CT, bool QUANT>
__global__ void __launch_bounds__(kThreads) attn_walk_kernel(WalkArgs w) {
  const Args& a = w.base;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = a.pos[b];
  if (pos < 0 || pos >= a.S) return;
  const int last = min(pos, a.s_use - 1);  // the last row attended
  const int s_begin = sp * a.rows;
  if (s_begin > last) return;
  const int s_end = min(s_begin + a.rows, last + 1);
  const int G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float qf[kMaxG * kMaxW];
  __shared__ float acc[kMaxG * kMaxW];
  __shared__ float p[kMaxG][kChunk];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  extern __shared__ __align__(16) unsigned char stage[];
  const int row_bytes = W * static_cast<int>(sizeof(CT)), stride = row_bytes + kRowPad;
  float* stage_sc = reinterpret_cast<float*>(stage + 2 * kChunk * stride);  // [2][2][kChunk]
  const long bh = static_cast<long>(b) * a.KV + h;
  const long S = a.S;
  CT* kvh = static_cast<CT*>(a.kv) + bh * S * W;
  const float* sch = QUANT ? w.sc + bh * 2 * S : nullptr;

  for (int i = tid; i < G * hd; i += blockDim.x) qf[i] = lt_load(a.q, a.in_dtype, bh * G * hd + i);
  for (int i = tid; i < G * vhd; i += blockDim.x) acc[i] = 0.f;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (w.fused && pos < s_begin + a.rows) {  // this block holds row pos: write it first
    for (int e = tid; e < W; e += blockDim.x)
      kvh[pos * static_cast<long>(W) + e] = f2c<CT>(load_any(a.kvn, w.kvn_dtype, bh * W + e));
    if (QUANT && tid < 2) w.sc[bh * 2 * S + tid * S + pos] = w.snew[bh * 2 + tid];
  }
  __syncthreads();  // the new row is visible to the whole block before it is read

  // start copying the chunk of rows c0.. into stage `slot`: 16-byte pieces of
  // the packed rows (and 4-byte scales), all in flight at once
  const int pieces = row_bytes / 16;
  auto fetch = [&](int c0, int slot) {
    const int n = min(kChunk, s_end - c0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(kvh + c0 * static_cast<long>(W));
    unsigned char* dst = stage + slot * kChunk * stride;
    for (int i = tid; i < n * pieces; i += blockDim.x) {
      const int r = i / pieces, o = i - r * pieces;
      cp_async16(dst + r * stride + o * 16, src + static_cast<long>(r) * row_bytes + o * 16);
    }
    if (QUANT)
      for (int i = tid; i < 2 * n; i += blockDim.x) {
        const int kvs = i / n, r = i - kvs * n;  // 0: K scale, 1: V scale
        cp_async4(stage_sc + (slot * 2 + kvs) * kChunk + r, sch + kvs * S + c0 + r);
      }
    cp_async_commit();
  };

  constexpr int N = 16 / sizeof(CT);
  const int j = tid >> 2, quarter = tid & 3;
  fetch(s_begin, 0);
  for (int c0 = s_begin, slot = 0; c0 < s_end; c0 += kChunk, slot ^= 1) {
    const int n = min(kChunk, s_end - c0);
    if (c0 + kChunk < s_end) {  // the next chunk streams in while this one is used
      fetch(c0 + kChunk, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* rows = stage + slot * kChunk * stride;
    const float* ks = stage_sc + slot * 2 * kChunk;  // int8: K scales, V scales at + kChunk

    // scores: four threads per row, each a quarter of the K row in 16-byte
    // vectors against all G heads; quarters summed by shuffles
    float d[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) d[g] = 0.f;
    if (j < n) {
      const CT* kr = reinterpret_cast<const CT*>(rows + j * stride);
      for (int e0 = quarter * N; e0 < hd; e0 += 4 * N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + e0);
        const CT* kv16 = reinterpret_cast<const CT*>(&raw);
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const float k = c2f<CT>(kv16[u]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) d[g] += qf[g * hd + e0 + u] * k;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 1);
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 2);
    }
    if (j < n && quarter == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) p[g][j] = QUANT ? d[g] * a.scale * ks[j] : d[g] * a.scale;
    }
    __syncthreads();

    // online softmax, a warp per query head: the new max, the rescale factor
    // of what came before, and the chunk's weights (V scale folded in)
    for (int g = warp; g < G; g += kWarps) {
      const float m_old = m_s[g];
      float mx = kNegInf;
      for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p[g][jj]);
      const float m_new = fmaxf(m_old, lt_warp_max(mx));
      float sum = 0.f;
      for (int jj = lane; jj < n; jj += 32) {
        const float e = expf(p[g][jj] - m_new);
        p[g][jj] = QUANT ? e * ks[kChunk + jj] : e;
        sum += e;
      }
      sum = lt_warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha_s[g] = al;
        l_s[g] = l_s[g] * al + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // accumulators: a thread per (query head, V element), the staged V rows
    // read across the threads of a warp
    for (int idx = tid; idx < G * vhd; idx += blockDim.x) {
      const int g = idx / vhd, e = idx - g * vhd;
      const unsigned char* vcol = rows + (hd + e) * sizeof(CT);
      float s = 0.f;
      for (int jj = 0; jj < n; ++jj)
        s += p[g][jj] * c2f<CT>(*reinterpret_cast<const CT*>(vcol + jj * stride));
      acc[idx] = acc[idx] * alpha_s[g] + s;
    }
    __syncthreads();  // p, alpha and this stage are rewritten by the next chunks
  }

  float* ml = a.part_ml + (bh * a.nsplit + sp) * G * 2;
  if (tid < G) {
    ml[tid * 2] = m_s[tid];
    ml[tid * 2 + 1] = l_s[tid];
  }
  float* po = a.part_o + (bh * a.nsplit + sp) * G * vhd;
  for (int i = tid; i < G * vhd; i += blockDim.x) po[i] = acc[i];
}

template <typename CT, bool QUANT>
int launch_walk(const WalkArgs& w, dim3 grid, int W, cudaStream_t st) {
  // the static arrays and the stages together pass 48 KB: opt in always
  const size_t smem = walk_smem<CT, QUANT>(W);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_walk_kernel<CT, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_walk_kernel<CT, QUANT><<<grid, kThreads, smem, st>>>(w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6 and its int8 variant: one launch of dense_cluster_kernel. q [B, KV, G,
// hd] (in_dtype); kvn: this token's rows [B, KV, hd + vhd] (kvn_dtype; int8
// under int8), written at pos[b] of kv, this layer's cache [B, KV, S, hd + vhd]
// (cache_dtype); sc, snew: int8 only, this layer's scale rows [B, KV, 2, S]
// f32 and this token's scales [B, KV, 2] f32 (else null); pos int32 [B]; out
// [B, KV, G, vhd] f32. cluster: CTAs a (lane, KV head), 1, 2, 4 or 8; rows:
// rows of a ring stage, a power of two dividing 32 and S. Cache and scale
// rows 16-byte aligned.
LT_EXPORT int lt_dense_attention(const void* q, int in_dtype, const void* kvn, int kvn_dtype,
                                 const void* snew, void* kv, int cache_dtype, void* sc,
                                 const void* pos, int B, int KV, int G, int S, int hd, int vhd,
                                 float scale, void* out, int cluster, int rows, void* stream) {
  const bool quant = cache_dtype == LT_I8;
  const int vec = quant ? 16 : 8;
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd < vec || vhd < vec || hd % vec || vhd % vec ||
      B < 1 || B > 65535 || KV < 1 || S < 1 || S > (1 << 30) || quant != (sc != nullptr) ||
      quant != (snew != nullptr) || quant != (kvn_dtype == LT_I8) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || rows < 1 || rows > 32 ||
      32 % rows || S % rows || reinterpret_cast<uintptr_t>(kv) % 16 ||
      reinterpret_cast<uintptr_t>(sc) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ClusterArgs a = {};
  a.q = q;
  a.in_dtype = in_dtype;
  a.cache = kv;
  a.scales = static_cast<const float*>(sc);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.kvn = kvn;
  a.kvn_dtype = kvn_dtype;
  a.snew = static_cast<const float*>(snew);
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.vhd = vhd;
  a.S = S;
  a.cluster = cluster;
  a.rows = rows;
  a.scale = scale;
  return launch_cluster_t<true>(a, cache_dtype, B, static_cast<cudaStream_t>(stream));
}

// K8 and its int8 variant: one launch of paged_cluster_kernel. q [B, KV, G,
// hd] (in_dtype); pool: this layer's pool [NBLK, KV, BS, hd + vhd]
// (pool_dtype), BS = 1 << bs_shift; spool: int8 only, this layer's scale
// pool [NBLK, KV, 2, BS] f32 (else null); tables int32 [B, MAXBLK]; pos int32
// [B]; out [B, KV, G, vhd] f32. cluster: CTAs a (lane, KV head), 1, 2, 4 or
// 8; rows: rows of a ring stage, a power of two <= 16 (>= 4 under int8 where
// BS > rows). Pool and scale pool 16-byte aligned.
LT_EXPORT int lt_paged_attention(const void* q, int in_dtype, const void* pool, int pool_dtype,
                                 const void* spool, const void* tables, const void* pos, int B,
                                 int KV, int G, int nblk, int bs_shift, int maxblk, int hd,
                                 int vhd, float scale, void* out, int cluster, int rows,
                                 void* stream) {
  const bool quant = pool_dtype == LT_I8;
  const int vec = quant ? 16 : 8;
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd < vec || vhd < 8 || hd % vec || vhd % vec ||
      B < 1 || KV < 1 || nblk < 1 || maxblk < 1 || bs_shift < 0 || bs_shift > 20 ||
      static_cast<long>(maxblk) << bs_shift > (1L << 30) || quant != (spool != nullptr) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || rows < 1 ||
      rows > 16 || (rows & (rows - 1)) || (quant && (1 << bs_shift) > rows && rows < 4) ||
      reinterpret_cast<uintptr_t>(pool) % 16 ||
      reinterpret_cast<uintptr_t>(spool) % 16 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ClusterArgs a = {};
  a.q = q;
  a.in_dtype = in_dtype;
  a.cache = pool;
  a.scales = static_cast<const float*>(spool);
  a.tables = static_cast<const int*>(tables);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.vhd = vhd;
  a.bs_shift = bs_shift;
  a.maxblk = maxblk;
  a.cluster = cluster;
  a.rows = rows;
  a.scale = scale;
  return launch_cluster_t<false>(a, pool_dtype, B, static_cast<cudaStream_t>(stream));
}

// The walk kernel: K14 (unfused, fused, stats) and K15 (s_use < S). q [B, KV,
// G, hd] (q_dtype); kv: this layer's cache [B, KV, S, hd + vhd] (cache_dtype:
// f32, bf16 or int8); sc: int8 only, this layer's scale rows [B, KV, 2, S]
// f32 (else null); fused: kvn [B, KV, hd + vhd] (kvn_dtype) written at pos[b]
// first, and under int8 snew [B, KV, 2] f32 into sc; pos int32 [B]; rows per
// pass-1 block, nsplit = ceil(s_use / rows); scratch part_o [B, KV, nsplit,
// G, vhd], part_ml [B, KV, nsplit, G, 2] f32; out [B, KV, G, vhd] f32; m_out,
// l_out [B, KV, G] f32 in stats mode (else null).
LT_EXPORT int lt_attention_walk(const void* q, int q_dtype, const void* kvn, int kvn_dtype,
                                const void* snew, void* kv, int cache_dtype, void* sc,
                                const void* pos, int B, int KV, int G, int S, int s_use, int hd,
                                int vhd, float scale, int rows, int fused, void* part_o,
                                void* part_ml, void* out, void* m_out, void* l_out, int nsplit,
                                void* stream) {
  const int vec = cache_dtype == LT_I8 ? 16 : 8;
  const bool quant = cache_dtype == LT_I8;
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd % vec || vhd % vec || B < 1 || KV < 1 ||
      rows < 1 || s_use < 1 || s_use > S || static_cast<long>(nsplit) * rows < s_use ||
      quant != (sc != nullptr) || (fused && (s_use != S || (quant && snew == nullptr))) ||
      (m_out == nullptr) != (l_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {q, kvn, q_dtype, kv, static_cast<const int*>(pos), B, KV, G, S, hd, vhd, scale,
            static_cast<float*>(part_o), static_cast<float*>(part_ml), static_cast<float*>(out),
            nsplit, rows, s_use, static_cast<float*>(m_out), static_cast<float*>(l_out)};
  WalkArgs w = {a, kvn_dtype, static_cast<const float*>(snew), static_cast<float*>(sc), fused};
  dim3 grid1(nsplit, KV, B);
  const int W = hd + vhd;
  const int err = quant ? launch_walk<int8_t, true>(w, grid1, W, st)
                  : cache_dtype == LT_F32 ? launch_walk<float, false>(w, grid1, W, st)
                                          : launch_walk<__nv_bfloat16, false>(w, grid1, W, st);
  if (err != 0) return err;
  attn_walk_combine_kernel<<<dim3(KV, B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
