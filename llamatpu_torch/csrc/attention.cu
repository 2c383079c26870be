// Decode attention of one layer (T = 1): K6 and K8 (each with its int8
// variant), K14 and K15, all on one cluster kernel body.
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
// ---- K14 and K15: decode attention over a long dense stripe.
//
// K14 replaces `_split_kernel`'s dense callers (`_split_call`,
// pallas_attention.py:349, and `_split_fused_call`, :481): S-tiled
// online-softmax decode attention over the dense packed cache [B, KV, S, W]
// in bf16, f32 or int8 (+ the scale rows [B, KV, 2, S]), unfused, fused (row
// pos written IN PLACE with kv_new, and under int8 its two scales, before it
// is attended) or with the stripe's softmax statistics (m, l) for a
// cross-shard combine. K15 replaces `_full_kernel` (:119): masked attention
// over the first s_use rows, bf16/f32/int8, without the write. Both read
// rows s <= min(pos, s_use - 1) (s_use = S but for K15); numerics as K6's,
// the statistics' m in natural-log units (x ln 2 of the kernel's log2 max).
//
// Bound on the H100: bytes, the live rows once. Llama-3.2-1B, pos 32767, one
// layer, B = 1: bf16 8 heads x 32768 rows x 256 B = 67.1 MB, 20.0 us at
// 3.35 TB/s; int8 8 x 32768 x (128 + 8) B = 35.7 MB, 10.6 us; K15 in f32 at
// pos 3999, 8 x 4000 x 512 B = 16.4 MB, 4.9 us. On the TPU the grid walked
// the S tiles of one head in order, the DMA clamped to the tile holding pos,
// with m, l and acc carried in VMEM scratch.
//
// The first design (the walk kernel) took 0.069 ms at pos 32767 on an H100
// (3.4x the bound, 2.4x SDPA): a grid of ceil(s_use / rows) x KV x B blocks
// walking 64-row chunks with four block barriers each, a two-stage cp.async
// buffer filled 16 bytes a thread, P.V by one thread per (head, V element)
// from shared memory into a shared-memory accumulator, expf, and the
// partials through device memory to a second launch. This design,
// stripe_cluster_kernel, is K6's body with more CTAs to a head:
//   - grid (C * P * KV, B): P clusters of C CTAs per (lane, KV head);
//     ops/attention.py plan_stripe picks C, P and the stage rows R from the
//     shapes and the SM count, never from pos: clusters of 2 (clusters of 4
//     and 8 were placed two CTAs an SM and ran 1.4x slower), a CTA an SM (two
//     where the ring fits an SM twice and the stripe is long). Rank r of
//     cluster p is the head's rank p C + r of C P and takes the R-row units
//     p C + r, p C + r + C P, ... up to min(pos, s_use - 1)
//     (ops/attention.py stripe_shares): one bulk copy a stage, the first
//     issued before pos is read.
//   - a ring of 16 stages (kStripeDepth), two a consumer warp: with K6's 8,
//     a warp's next stage was copied only after it freed its one slot, so
//     every stage paid the copy's full latency (the stream alone took ~29 us
//     at pos 32767, 0.045 ms in all at C 8).
//   - the consumers, and in fused mode the write of row pos, are K6's; each
//     cluster combines its ranks through distributed shared memory, as K6's.
//   - stripe_finish: where more than one cluster holds rows, each cluster's
//     rank 0 stores its (m, l, sums) to scratch [B, KV, P, G, ...] and its
//     thread 0 arrives on the (lane, head)'s counter (after a CTA barrier, an
//     integer atom.add.acq_rel); the last to arrive reads the P states back,
//     combines them in cluster order, writes the output (and in stats mode
//     m and l) and sets the counter back to 0 for the next launch. No float
//     atomics: the same bits on every run. A stripe whose rows one cluster
//     holds (a short pos) skips the scratch.
//   - its arguments beyond K6's are a kernel parameter of their own
//     (StripeArgs): grown by them, ClusterArgs made K6 3 % slower.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 0.0309 ms at pos 32767
// in bf16 (1.5x the bound, 1.08x SDPA), 0.0286 int8; K15 0.0099 f32. What is
// left: ~6.5 us of launch, first copy and combines that nothing overlaps,
// and the consumers' ~3 us past the stream (their rows' latency chains).
// pos outside [0, S) writes nothing and gives NaN (m and l too).
#include "common.cuh"

// layer_fused.cu includes this file inside a namespace of its own, with
// LT_CLUSTER_BODY_ONLY defined, for K3's attention phase: the cluster body
// and its launch templates, without this library's entry points.
#ifndef LT_CLUSTER_BODY_ONLY
LT_DEFINE_ERROR_STRING
#endif

namespace {

constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxW = 256;     // hd + vhd
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

// *p += v at gpu scope, acquiring what the earlier adders released and
// releasing this thread's (and, through a CTA barrier before it, its CTA's)
// writes; returns the old value.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
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
constexpr int kStripeDepth = 16;  // K14, K15: two a consumer warp, its next stage in flight
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

// K14's and K15's further arguments, a kernel parameter of their own (grown
// by them, K6's parameters measured 3 % slower on the H100)
struct StripeArgs {
  int s_use;        // rows s <= min(pos, s_use - 1) are read
  int fused;        // row pos written first (kvn, snew)
  int parts;        // P: clusters a (lane, KV head)
  float* part_o;    // P > 1: the clusters' sums [B, KV, P, G, vhd]
  float* part_ml;   // P > 1: their m (log2 units) and l [B, KV, P, G, 2]
  int* arrived;     // P > 1: clusters done a (lane, KV head) [B, KV], 0 between launches
  float* m_out;     // stats mode: the stripe's max [B, KV, G] (natural-log units), else null
  float* l_out;     // stats mode: its sum [B, KV, G]
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

// Dynamic shared memory: the ring [depth][rows x (hd + vhd)] (each stage on
// a 128-byte boundary; at the end the consumer warps' sums [8][G][vhd] f32
// reuse it), q f32 [GM][N / 4][kMaxW / N][4], this rank's sums [G][vhd] f32,
// in a cluster rank 0's copy of the others' [C][G][vhd] f32, and under paged
// int8 (SCALES) the stages' scales [kPagedDepth][2 * rows] f32.
template <typename CT, bool SCALES, int GM>
size_t cluster_smem(int G, int hd, int vhd, int rows, int cluster, int depth) {
  const size_t pitch = (static_cast<size_t>(rows) * (hd + vhd) * sizeof(CT) + 127) / 128 * 128;
  size_t ring = depth * pitch;
  const size_t red = static_cast<size_t>(kPagedWarps) * G * vhd * sizeof(float);
  ring = ((ring > red ? ring : red) + 127) / 128 * 128;
  return ring +
         (static_cast<size_t>(GM) * kMaxW +
          static_cast<size_t>(G) * vhd * (cluster > 1 ? cluster + 1 : 1)) * sizeof(float) +
         (SCALES ? static_cast<size_t>(kPagedDepth) * 2 * rows * sizeof(float) : 0);
}

// K14's and K15's end, in a cluster's rank 0 (the consumer threads) once its
// ranks' states have arrived (cm, cl [rank][gm] and cacc [rank][G][vhd] of
// ranks 1 .. nranks - 1 beside its own m_s, l_s, accs): the cluster's state,
// as K6's rank 0 adds it up. Where one of the head's clusters holds rows
// (nlive <= 1: a short pos, or P = 1) it is the output (and in stats mode m
// in natural-log units and l). Else it goes to the scratch row of cluster
// `part`, and the last of the head's nlive clusters to arrive on its counter
// (each cluster's stores ordered by its barrier before its thread 0's
// release, acquired by the last one's) combines the states in cluster order
// and sets the counter back to 0.
__device__ __forceinline__ void stripe_finish(const StripeArgs& sa, float* out, long bh, int P,
                                              int part, int C, int G, int vhd, int nranks,
                                              int nlive, bool valid, const float* m_s,
                                              const float* l_s, const float* accs,
                                              const float* cm, const float* cl, int gm,
                                              const float* cacc, int tid, int& last_cluster) {
  constexpr float kLn2 = 0.6931471805599453f;
  nlive = min(P, nlive);
  const bool scratch = nlive > 1;
  const long bhp = (bh * P + part) * G;  // this cluster's scratch row
  const float nan = __int_as_float(0x7fc00000);  // no row attended
  for (int i = tid; i < G * vhd; i += kPagedConsumers) {
    const int g = i / vhd;
    float mx = m_s[g];
    for (int r = 1; r < nranks; ++r) mx = fmaxf(mx, cm[r * gm + g]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < nranks; ++r) {
      const float mr = r == 0 ? m_s[g] : cm[r * gm + g];
      if (mr == kNegInf) continue;  // a rank with no rows
      const float w = ex2(mr - mx);
      den += w * (r == 0 ? l_s[g] : cl[r * gm + g]);
      num += w * (r == 0 ? accs[i] : cacc[r * G * vhd + i]);
    }
    if (scratch) {
      sa.part_o[bhp * vhd + i] = num;
      if (i == g * vhd) {
        sa.part_ml[(bhp + g) * 2] = mx;
        sa.part_ml[(bhp + g) * 2 + 1] = den;
      }
    } else {
      out[i] = valid ? __fdividef(num, den) : nan;
      if (sa.m_out != nullptr && i == g * vhd) {
        sa.m_out[bh * G + g] = valid ? mx * kLn2 : nan;
        sa.l_out[bh * G + g] = valid ? den : nan;
      }
    }
  }
  if (!scratch) return;
  paged_consumer_sync();
  if (tid == 0) last_cluster = atom_add_acq_rel(sa.arrived + bh, 1) == nlive - 1;
  paged_consumer_sync();
  if (!last_cluster) return;
  for (int i = tid; i < G * vhd; i += kPagedConsumers) {
    const int g = i / vhd;
    const float* ml = sa.part_ml + (bh * P * G + g) * 2;  // cluster q's at + 2 q G
    float mx = kNegInf;
    for (int q = 0; q < nlive; ++q) mx = fmaxf(mx, __ldcg(ml + 2 * q * G));
    float num = 0.f, den = 0.f;
    for (int q = 0; q < nlive; ++q) {
      const float mq = __ldcg(ml + 2 * q * G);
      if (mq == kNegInf) continue;
      const float w = ex2(mq - mx);
      den += w * __ldcg(ml + 2 * q * G + 1);
      num += w * __ldcg(sa.part_o + (bh * P + q) * G * vhd + i);
    }
    out[i] = __fdividef(num, den);
    if (sa.m_out != nullptr && i == g * vhd) {
      sa.m_out[bh * G + g] = mx * kLn2;
      sa.l_out[bh * G + g] = den;
    }
  }
  if (tid == 0) sa.arrived[bh] = 0;  // ready for the next launch (stream order)
}

// The body of K8 (DENSE = false: rows through the block tables), K6 (DENSE
// = true: a contiguous stripe, row pos written) and K14 / K15 (DENSE and
// STRIPE: the stripe's rows up to s_use, row pos written in fused mode, P
// clusters a head combined through scratch, the statistics out). GM: G
// rounded up to 1, 4 or 8; NP: V element pairs a lane (vhd <= 64, 128 or
// 256). Together the size of the P.V sums in registers.
template <typename CT, bool QUANT, bool DENSE, bool STRIPE, int GM, int NP>
__device__ __forceinline__ void cluster_attention(const ClusterArgs& a, const StripeArgs& sa) {
  static_assert(DENSE || !STRIPE, "a stripe is dense");
  constexpr int D = STRIPE ? kStripeDepth : kPagedDepth;  // ring stages
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[D], empty[D];
  __shared__ __align__(8) uint64_t pushed;  // rank 0: the other ranks' states have arrived
  __shared__ __align__(16) float pbuf[kPagedWarps][kSub * GM];  // each warp's stage weights
  __shared__ float mw[kPagedWarps][GM], lw[kPagedWarps][GM];  // the consumer warps' m, l
  __shared__ float m_s[GM], l_s[GM];                            // this rank's
  __shared__ float cm[kMaxCluster][GM], cl[kMaxCluster][GM];    // rank 0: the others'
  __shared__ int last_cluster;  // stripe: this cluster arrived last on the head's counter
  __shared__ int tbl[DENSE ? 1 : kTblCache];
  __shared__ __align__(16) unsigned char newrow[DENSE ? kMaxW * sizeof(CT) : 16];  // dense: row pos, cast
  const int C = a.cluster, G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const unsigned rank = cluster_rank();
  // the head's C P CTAs (P = 1 but for a stripe): cluster `part`'s rank r is
  // the head's rank gr = part C + r, which deals the rows
  const int P = STRIPE ? sa.parts : 1, CP = C * P;
  const int h = blockIdx.x / CP, b = blockIdx.y;
  const int gr = STRIPE ? static_cast<int>(blockIdx.x) - h * CP : static_cast<int>(rank);
  const int part = STRIPE ? gr / C : 0;
  const int shift = a.bs_shift, bs = 1 << shift;
  const int R = a.rows;
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
  const int s_lim = STRIPE ? sa.s_use : a.S;  // dense: rows past it are never read
  const bool first_ahead = DENSE && gr * R < s_lim;  // the stage issued before pos

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
        const int j = (((gr + CP * k) * R) >> shift) + t - k * gpu;
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
        const int s0 = gr * R;
        bulk_load(smem, stripe + static_cast<long>(s0) * row_bytes,
                  static_cast<unsigned>(R * row_bytes), &full[0]);
      }
    }
    if constexpr (!DENSE) {
#pragma unroll
      for (int u = 0; u < kTblCache / 32; ++u) tbl[lane + 32 * u] = tv[u];
    }
  }

  // this rank's stages: stage k is the lane's R-row unit u = gr + C P k,
  // rows [u R, min(u R + R, last + 1)) (paged: whole pool blocks, or a piece
  // of one); the cluster's ranks 0 .. nranks - 1 have rows. pos is loaded
  // here and waited for only after q (and, dense, this token's row) are in
  // flight.
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
  const bool write = DENSE && (!STRIPE || sa.fused);  // row pos := this token's
  const CT kv_e = write && tid < W ? f2c<CT>(load_any(a.kvn, a.kvn_dtype, bh * W + tid)) : f2c<CT>(0.f);
  const float sc_e = write && QUANT && tid < 2 ? a.snew[bh * 2 + tid] : 0.f;
  const bool valid = pos >= 0 && pos < (DENSE ? a.S : (a.maxblk << shift));
  const int last = STRIPE ? min(pos, sa.s_use - 1) : pos;  // the last row attended
  const int nu = valid ? last / R + 1 : 0;
  const int nstages = nu > gr ? (nu - gr + CP - 1) / CP : 0;
  const int nranks = STRIPE ? min(max(nu - part * C, 0), C) : nu < C ? nu : C;
  if (rank == 0 && warp == kPagedWarps && lane == 0) {
    mbar_init(&pushed, nranks > 1 ? nranks - 1 : 1);  // one arrive from each other rank with rows
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C > 1) cluster_arrive_relaxed();  // waited for before the combine's stores
  if ((rank != 0 || part != 0) && static_cast<int>(rank) >= nranks) {  // no row: nothing to push
    if (first_ahead && warp == kPagedWarps && lane == 0) mbar_wait(&full[0], 0);  // its copy lands
    return;
  }
  if constexpr (DENSE) {
    // the rank holding pos: row pos := kv_new cast to the cache dtype (and
    // its scales), in the cache and in shared memory for the stage holding it
    if (write && valid && (pos / R) % CP == gr) {
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
          const int s0 = (gr + CP * k) * R;
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
        const int s0 = (gr + CP * k) * R, n = min(R, last + 1 - s0);
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
    const int s0 = (gr + CP * k) * R;
    const int n = min(R, last + 1 - s0);
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
    if (write && pos < s0 + R) {  // the stage holding row pos: the cast row in place of the copy's
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
  if constexpr (STRIPE) {
    stripe_finish(sa, out, bh, P, part, C, G, vhd, nranks, (nu + C - 1) / C, valid, m_s, l_s,
                  accs, &cm[0][0], &cl[0][0], GM, cacc, tid, last_cluster);
    return;
  }
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
  cluster_attention<CT, QUANT, false, false, GM, NP>(a, StripeArgs{});
}

template <typename CT, bool QUANT, int GM, int NP>
__global__ void __launch_bounds__(kPagedThreads, GM * NP <= 16 ? 2 : 1)
    dense_cluster_kernel(ClusterArgs a) {
  cluster_attention<CT, QUANT, true, false, GM, NP>(a, StripeArgs{});
}

template <typename CT, bool QUANT, int GM, int NP>
__global__ void __launch_bounds__(kPagedThreads, GM * NP <= 16 ? 2 : 1)
    stripe_cluster_kernel(ClusterArgs a, StripeArgs s) {
  cluster_attention<CT, QUANT, true, true, GM, NP>(a, s);
}

// KIND: 0 paged (K8), 1 dense (K6), 2 stripe (K14, K15; `s` its further
// arguments).
template <typename CT, bool QUANT, int KIND, int GM, int NP>
int launch_cluster(const ClusterArgs& a, const StripeArgs& s, int B, cudaStream_t st) {
  const void* kernel = nullptr;
  if constexpr (KIND == 2)
    kernel = reinterpret_cast<const void*>(stripe_cluster_kernel<CT, QUANT, GM, NP>);
  else if constexpr (KIND == 1)
    kernel = reinterpret_cast<const void*>(dense_cluster_kernel<CT, QUANT, GM, NP>);
  else
    kernel = reinterpret_cast<const void*>(paged_cluster_kernel<CT, QUANT, GM, NP>);
  const size_t smem = cluster_smem<CT, QUANT && KIND == 0, GM>(
      a.G, a.hd, a.vhd, a.rows, a.cluster, KIND == 2 ? kStripeDepth : kPagedDepth);
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster * a.KV * (KIND == 2 ? s.parts : 1), B, 1);
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
  if constexpr (KIND == 2)
    return static_cast<int>(cudaLaunchKernelEx(&cfg, stripe_cluster_kernel<CT, QUANT, GM, NP>, a, s));
  else if constexpr (KIND == 1)
    return static_cast<int>(cudaLaunchKernelEx(&cfg, dense_cluster_kernel<CT, QUANT, GM, NP>, a));
  else
    return static_cast<int>(cudaLaunchKernelEx(&cfg, paged_cluster_kernel<CT, QUANT, GM, NP>, a));
}

template <typename CT, bool QUANT, int KIND, int GM>
int launch_cluster_v(const ClusterArgs& a, const StripeArgs& s, int B, cudaStream_t st) {
  return a.vhd <= 64 ? launch_cluster<CT, QUANT, KIND, GM, 1>(a, s, B, st)
         : a.vhd <= 128 ? launch_cluster<CT, QUANT, KIND, GM, 2>(a, s, B, st)
                        : launch_cluster<CT, QUANT, KIND, GM, 4>(a, s, B, st);
}

template <typename CT, bool QUANT, int KIND>
int launch_cluster_g(const ClusterArgs& a, const StripeArgs& s, int B, cudaStream_t st) {
  return a.G == 1 ? launch_cluster_v<CT, QUANT, KIND, 1>(a, s, B, st)
         : a.G <= 4 ? launch_cluster_v<CT, QUANT, KIND, 4>(a, s, B, st)
                    : launch_cluster_v<CT, QUANT, KIND, 8>(a, s, B, st);
}

template <int KIND>
int launch_cluster_t(const ClusterArgs& a, const StripeArgs& s, int cache_dtype, int B,
                     cudaStream_t st) {
  if (cache_dtype == LT_I8) return launch_cluster_g<int8_t, true, KIND>(a, s, B, st);
  if (cache_dtype == LT_F32) return launch_cluster_g<float, false, KIND>(a, s, B, st);
  return launch_cluster_g<__nv_bfloat16, false, KIND>(a, s, B, st);
}

}  // namespace

#ifndef LT_CLUSTER_BODY_ONLY
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
  return launch_cluster_t<1>(a, StripeArgs{}, cache_dtype, B, static_cast<cudaStream_t>(stream));
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
  return launch_cluster_t<0>(a, StripeArgs{}, pool_dtype, B, static_cast<cudaStream_t>(stream));
}

// K14 and K15: one launch of stripe_cluster_kernel. q [B, KV, G, hd]
// (in_dtype); kv: this layer's cache [B, KV, S, hd + vhd] (cache_dtype: f32,
// bf16 or int8); sc: int8 only, this layer's scale rows [B, KV, 2, S] f32
// (else null); fused: kvn [B, KV, hd + vhd] (kvn_dtype; int8 under int8)
// written at pos[b] of kv, and under int8 snew [B, KV, 2] f32 into sc (s_use
// = S); else kvn and snew null; pos int32 [B]; rows s <= min(pos, s_use - 1)
// attended; out [B, KV, G, vhd] f32; m_out, l_out [B, KV, G] f32 in stats
// mode (else null). cluster: 1, 2, 4 or 8 CTAs; parts: P clusters a
// (lane, KV head), P > 1 with scratch part_o [B, KV, P, G, vhd], part_ml
// [B, KV, P, G, 2] f32 and arrived int32 [B, KV], zero before the launch
// and left zero after it; rows: rows of a ring stage, dividing 32 and S.
// Cache and scale rows 16-byte aligned.
LT_EXPORT int lt_stripe_attention(const void* q, int in_dtype, const void* kvn, int kvn_dtype,
                                  const void* snew, void* kv, int cache_dtype, void* sc,
                                  const void* pos, int B, int KV, int G, int S, int s_use,
                                  int hd, int vhd, float scale, void* out, void* m_out,
                                  void* l_out, void* part_o, void* part_ml, void* arrived,
                                  int cluster, int parts, int rows, void* stream) {
  const bool quant = cache_dtype == LT_I8;
  const bool fused = kvn != nullptr;
  const int vec = quant ? 16 : 8;
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd < vec || vhd < vec || hd % vec || vhd % vec ||
      B < 1 || B > 65535 || KV < 1 || S < 1 || S > (1 << 30) || s_use < 1 || s_use > S ||
      quant != (sc != nullptr) || (fused && (s_use != S || quant != (snew != nullptr) ||
                                             quant != (kvn_dtype == LT_I8))) ||
      (!fused && snew != nullptr) || (m_out == nullptr) != (l_out == nullptr) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || parts < 1 || static_cast<long>(cluster) * parts * KV > (1L << 30) ||
      (parts > 1 && (part_o == nullptr || part_ml == nullptr || arrived == nullptr)) ||
      rows < 1 || rows > 32 || 32 % rows || S % rows || reinterpret_cast<uintptr_t>(kv) % 16 ||
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
  StripeArgs sa = {};
  sa.s_use = s_use;
  sa.fused = fused;
  sa.parts = parts;
  sa.part_o = static_cast<float*>(part_o);
  sa.part_ml = static_cast<float*>(part_ml);
  sa.arrived = static_cast<int*>(arrived);
  sa.m_out = static_cast<float*>(m_out);
  sa.l_out = static_cast<float*>(l_out);
  return launch_cluster_t<2>(a, sa, cache_dtype, B, static_cast<cudaStream_t>(stream));
}
#endif  // LT_CLUSTER_BODY_ONLY
