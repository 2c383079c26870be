// Decode attention of one layer (T = 1): K6, K8 (with its int8 variant), and
// the walk kernel behind K14, K15 and K6's int8 variant.
//
// ---- K6: fused KV-append + decode attention over the dense packed cache.
//
// Replaces llamatpu/ops/pallas_attention.py `_fused_write_kernel` (through
// `decode_attention_fused_write`): row pos_vec[b] of this layer's packed
// cache [B, KV, S, hd + vhd] is written with this token's K|V row cast to
// the cache dtype, and that same cast row is attended (so the result equals
// write-then-attend); nothing else of the cache changes. Scores are
// (q . k) * scale in f32 over rows s <= pos; softmax; out [B, KV, G, vhd] f32.
//
// Bound on the H100: bytes, (pos + 1) cache rows of (hd + vhd) * 2 bytes per
// KV head (llama32-1b: 8 heads x 256 B per row, ~0.31 us at pos 512), i.e.
// latency-bound at chat lengths. Design: the positions are split across
// blocks, so even a short cache fills many SMs (one block per KV head,
// slice 1's K3 design, used 8 of 132 SMs):
//   1. grid (ceil(S / 64), KV, B): a block takes 64 positions of one KV head
//      (blocks past pos exit at once). It scores its rows for all G query
//      heads of the group, keeps its local max m and sum l of exp(score - m)
//      per head, and writes them with its unnormalized partial output
//      sum_j exp(score_j - m) * V_j. The block whose rows hold pos writes the
//      new row to the cache and uses the cast value in place of the row;
//      no other block reads that row.
//   2. grid (KV, B): the combine pass rescales the partials by
//      exp(m_i - max m) and divides by the rescaled sum.
// The masked rows (s > pos) are left out rather than set to -1e30 as on the
// TPU; exp(-1e30 - m) is exactly 0 in f32, so the two agree.
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
// 1.3 us). On the TPU the grid walked the lane's table block by block in
// order, with the table in scalar prefetch and tiles past pos revisiting the
// last block so no DMA was issued. Here the design is K6's, not the TPU's
// block walk:
//   1. grid (ceil(MAXBLK * BS / 64), KV, B): a block takes 64 logical rows of
//      one lane and KV head and exits at once if its first row lies past
//      pos; it reads its own table entries into shared memory (a row pointer
//      per row) -- there is no scalar prefetch. Scores: four threads per row,
//      each reading a quarter of the K row in 16-byte vectors (8 bf16 or 16
//      int8 values) and dotting it with all G query heads (one read of each
//      K row serves the G heads), the quarters added by warp shuffles. Local
//      max, sum and unnormalized partial output per head as in K6.
//   2. K6's combine pass, with S = MAXBLK * BS.
// Trash-table entries past the lane's allocation lie past pos and are never
// read; a parked lane (every entry the trash block) reads the trash block.
//
// ---- The walk kernel: K14, K15 and K6's int8 variant.
//
// K14 replaces `_split_kernel`'s dense callers (`_split_call`,
// pallas_attention.py:349, and `_split_fused_call`, :481): S-tiled
// online-softmax decode attention over the dense packed cache [B, KV, S, W]
// in bf16, f32 or int8 (+ the scale rows [B, KV, 2, S]), unfused, fused (row
// pos written IN PLACE with kv_new, and under int8 its two scales, before it
// is attended) or with the stripe's softmax statistics (m, l) for a
// cross-shard combine. K15 replaces `_full_kernel` (:119): masked attention
// over the first s_use rows, bf16/f32/int8; it is the same kernel without the
// write, reading rows s <= min(pos, s_use - 1). K6's int8 variant
// (`_fused_write_kernel` with quant=True) is the fused mode at 64 rows per
// block, K6's own split. Numerics of all three: scores (q . k) * scale in f32
// (* k_scale under int8), masking s <= pos, online softmax keeping m and l,
// the partial output adds exp(score - m) (* v_scale) * v, out = acc / l.
//
// Bound on the H100: bytes, the live rows once. Llama-3.2-1B, pos 32767, one
// layer, B = 1: bf16 8 heads x 32768 rows x 256 B = 67.1 MB, 20.0 us at
// 3.35 TB/s; int8 8 x 32768 x (128 + 8) B = 35.7 MB, 10.6 us. On the TPU the
// grid walked the S tiles of one head in order, the DMA clamped to the tile
// holding pos, with m, l and acc carried in VMEM scratch. Here the walk is
// split across blocks so a long stripe fills the SMs:
//   1. grid (ceil(s_use / R), KV, B), R rows per block (the wrapper picks R,
//      a power of two from 64 to 1024, so that about two blocks run per SM
//      at the longest position; K6's int8 variant takes R = 64). A block past
//      min(pos, s_use - 1) exits at once (the clamped DMA's counterpart). The
//      block walks its rows in chunks of 64, each chunk's packed rows (and
//      int8 scales) copied into shared memory by cp.async in 16-byte pieces,
//      two stages, so the next chunk streams in while one is used (read
//      straight from device memory, each chunk waited on its K loads and
//      then on a chain of V loads per thread). Four threads per row score a
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

constexpr int kChunk = 64;     // cache rows per block of K6/K8 pass 1; rows per chunk of the walk
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
  const void* kvn;  // [B, KV, hd + vhd] (in_dtype; the walk: kvn_dtype)
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

template <typename CT>
__global__ void __launch_bounds__(kThreads) attn_split_kernel(Args a) {
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = a.pos[b];
  const int s0 = sp * kChunk;
  if (pos < 0 || pos >= a.S || s0 > pos) return;
  const int G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const int n = min(kChunk, pos + 1 - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  __shared__ float qf[kMaxG * kMaxW];
  __shared__ float newrow[kMaxW];
  __shared__ float p[kMaxG][kChunk];
  const long bh = static_cast<long>(b) * a.KV + h;
  CT* kvh = static_cast<CT*>(a.kv) + bh * a.S * W;

  for (int i = tid; i < G * hd; i += blockDim.x) qf[i] = lt_load(a.q, a.in_dtype, bh * G * hd + i);
  const bool owner = pos < s0 + kChunk;
  for (int e = tid; e < W; e += blockDim.x) {
    const CT c = f2c<CT>(lt_load(a.kvn, a.in_dtype, bh * W + e));  // cast BEFORE attending
    newrow[e] = c2f<CT>(c);
    if (owner) kvh[static_cast<long>(pos) * W + e] = c;
  }
  __syncthreads();

  // scores: a thread per (row, query head); K read in 16-byte vectors
  constexpr int N = 16 / sizeof(CT);
  for (int idx = tid; idx < n * G; idx += blockDim.x) {
    const int j = idx / G, g = idx - j * G;
    const int row = s0 + j;
    const float* qg = qf + g * hd;
    float d = 0.f;
    if (row == pos) {
      for (int e = 0; e < hd; ++e) d += qg[e] * newrow[e];
    } else {
      const CT* kr = kvh + static_cast<long>(row) * W;
      for (int e0 = 0; e0 < hd; e0 += N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + e0);
        const CT* kv8 = reinterpret_cast<const CT*>(&raw);
#pragma unroll
        for (int u = 0; u < N; ++u) d += qg[e0 + u] * c2f<CT>(kv8[u]);
      }
    }
    p[g][j] = d * a.scale;
  }
  __syncthreads();

  // local softmax statistics, a warp per query head
  float* ml = a.part_ml + (bh * a.nsplit + sp) * G * 2;
  for (int g = warp; g < G; g += nwarps) {
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p[g][j]);
    mx = lt_warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[g][j] - mx);
      p[g][j] = e;
      sum += e;
    }
    sum = lt_warp_sum(sum);
    if (lane == 0) {
      ml[g * 2] = mx;
      ml[g * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // partial outputs: a thread per (query head, V element), V rows coalesced
  float* po = a.part_o + (bh * a.nsplit + sp) * G * vhd;
  for (int idx = tid; idx < G * vhd; idx += blockDim.x) {
    const int g = idx / vhd, e = idx - g * vhd;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      const int row = s0 + j;
      const float v = row == pos ? newrow[hd + e] : c2f<CT>(kvh[static_cast<long>(row) * W + hd + e]);
      acc += p[g][j] * v;
    }
    po[idx] = acc;
  }
}

// Pass 2 of every design: rescale the partials by exp(m_i - max m) and divide
// by the rescaled sum; in stats mode also write that max and sum.
__device__ __forceinline__ void combine(const Args& a) {
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

__global__ void __launch_bounds__(kThreads) attn_combine_kernel(Args a) { combine(a); }

// the walk's combine, under its own name so a trace tells K14/K15 from K6/K8
__global__ void __launch_bounds__(kThreads) attn_walk_combine_kernel(Args a) { combine(a); }

// K8 pass 1 (the combine is attn_combine_kernel with S = MAXBLK * BS).
struct PagedArgs {
  Args base;          // q, in_dtype, pos, B, KV, G, S = MAXBLK * BS, hd, vhd, scale, scratch
  const void* pool;   // this layer's pool [NBLK, KV, BS, hd + vhd] (CT)
  const float* spool; // int8: this layer's scale pool [NBLK, KV, 2, BS], else null
  const int* tables;  // [B, MAXBLK]
  int nblk, bs_shift, maxblk;
};

template <typename CT, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(PagedArgs pa) {
  const Args& a = pa.base;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = a.pos[b];
  const int s0 = sp * kChunk;
  if (pos < 0 || pos >= a.S || s0 > pos) return;
  const int G = a.G, hd = a.hd, vhd = a.vhd, W = hd + vhd;
  const int n = min(kChunk, pos + 1 - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bs = 1 << pa.bs_shift;
  __shared__ float qf[kMaxG * kMaxW];
  __shared__ float p[kMaxG][kChunk];
  __shared__ const CT* rows[kChunk];
  __shared__ const float* srows[kChunk];  // int8: the row's K scale (its V scale at + BS)
  const long bh = static_cast<long>(b) * a.KV + h;
  const CT* pool = static_cast<const CT*>(pa.pool);

  for (int j = tid; j < n; j += blockDim.x) {
    const int s = s0 + j;
    const long blk = pa.tables[static_cast<long>(b) * pa.maxblk + (s >> pa.bs_shift)];
    rows[j] = pool + ((blk * a.KV + h) * bs + (s & (bs - 1))) * W;
    if (QUANT) srows[j] = pa.spool + (blk * a.KV + h) * 2 * bs + (s & (bs - 1));
  }
  for (int i = tid; i < G * hd; i += blockDim.x) qf[i] = lt_load(a.q, a.in_dtype, bh * G * hd + i);
  __syncthreads();

  // scores: four threads per row (kThreads == 4 * kChunk), each a quarter of
  // the K row in 16-byte vectors against all G heads; quarters summed by shuffles
  constexpr int N = 16 / sizeof(CT);
  const int j = tid >> 2, quarter = tid & 3;
  float d[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) d[g] = 0.f;
  if (j < n) {
    const CT* kr = rows[j];
    for (int e0 = quarter * N; e0 < hd; e0 += 4 * N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + e0);
      const CT* kv8 = reinterpret_cast<const CT*>(&raw);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const float k = c2f<CT>(kv8[u]);
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
    const float ks = QUANT ? *srows[j] : 1.f;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) p[g][j] = QUANT ? d[g] * a.scale * ks : d[g] * a.scale;
  }
  __syncthreads();

  // local softmax statistics, a warp per query head; under int8 the V scale
  // joins the weights of the partial output, not the sum
  float* ml = a.part_ml + (bh * a.nsplit + sp) * G * 2;
  for (int g = warp; g < G; g += nwarps) {
    float mx = kNegInf;
    for (int jj = lane; jj < n; jj += 32) mx = fmaxf(mx, p[g][jj]);
    mx = lt_warp_max(mx);
    float sum = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float e = expf(p[g][jj] - mx);
      p[g][jj] = QUANT ? e * srows[jj][bs] : e;
      sum += e;
    }
    sum = lt_warp_sum(sum);
    if (lane == 0) {
      ml[g * 2] = mx;
      ml[g * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // partial outputs: a thread per (query head, V element), V rows coalesced
  float* po = a.part_o + (bh * a.nsplit + sp) * G * vhd;
  for (int idx = tid; idx < G * vhd; idx += blockDim.x) {
    const int g = idx / vhd, e = idx - g * vhd;
    float acc = 0.f;
    for (int jj = 0; jj < n; ++jj) acc += p[g][jj] * c2f<CT>(rows[jj][hd + e]);
    po[idx] = acc;
  }
}

// The walk kernel's pass 1 (K14, K15, K6's int8 variant).
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

// K6. q [B, KV, G, hd], kvn [B, KV, hd + vhd] (in_dtype); kv: this layer's cache
// [B, KV, S, hd + vhd] (cache_dtype), written at pos[b]; pos int32 [B] on
// the device; scratch part_o [B, KV, nsplit, G, vhd], part_ml
// [B, KV, nsplit, G, 2] f32; out [B, KV, G, vhd] f32. nsplit = ceil(S / 64).
LT_EXPORT int lt_decode_attention(const void* q, const void* kvn, int in_dtype, void* kv,
                                  int cache_dtype, const void* pos, int B, int KV, int G, int S,
                                  int hd, int vhd, float scale, void* part_o, void* part_ml,
                                  void* out, int nsplit, void* stream) {
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd % 8 || vhd % 8 ||
      nsplit * kChunk < S || B < 1 || KV < 1 || cache_dtype == LT_I8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {q, kvn, in_dtype, kv, static_cast<const int*>(pos), B, KV, G, S, hd, vhd, scale,
            static_cast<float*>(part_o), static_cast<float*>(part_ml), static_cast<float*>(out),
            nsplit, kChunk, S, nullptr, nullptr};
  dim3 grid1(nsplit, KV, B);
  if (cache_dtype == LT_F32)
    attn_split_kernel<float><<<grid1, kThreads, 0, st>>>(a);
  else
    attn_split_kernel<__nv_bfloat16><<<grid1, kThreads, 0, st>>>(a);
  LT_RETURN_IF_ERROR();
  attn_combine_kernel<<<dim3(KV, B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K8 and its int8 variant. q [B, KV, G, hd] (in_dtype); pool: this layer's
// pool [NBLK, KV, BS, hd + vhd] (pool_dtype), BS = 1 << bs_shift; spool:
// int8 only, this layer's scale pool [NBLK, KV, 2, BS] f32 (else null);
// tables int32 [B, MAXBLK]; pos int32 [B]; scratch part_o [B, KV, nsplit, G,
// vhd], part_ml [B, KV, nsplit, G, 2] f32; out [B, KV, G, vhd] f32.
// nsplit = ceil(MAXBLK * BS / 64).
LT_EXPORT int lt_paged_attention(const void* q, int in_dtype, const void* pool, int pool_dtype,
                                 const void* spool, const void* tables, const void* pos, int B,
                                 int KV, int G, int nblk, int bs_shift, int maxblk, int hd,
                                 int vhd, float scale, void* part_o, void* part_ml, void* out,
                                 int nsplit, void* stream) {
  const int S = maxblk << bs_shift;
  const int vec = pool_dtype == LT_I8 ? 16 : 8;
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd % vec || vhd % vec || nsplit * kChunk < S ||
      B < 1 || KV < 1 || nblk < 1 || bs_shift < 0 || (pool_dtype == LT_I8) != (spool != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {q, nullptr, in_dtype, nullptr, static_cast<const int*>(pos), B, KV, G, S, hd, vhd,
            scale, static_cast<float*>(part_o), static_cast<float*>(part_ml),
            static_cast<float*>(out), nsplit, kChunk, S, nullptr, nullptr};
  PagedArgs pa = {a, pool, static_cast<const float*>(spool), static_cast<const int*>(tables),
                  nblk, bs_shift, maxblk};
  dim3 grid1(nsplit, KV, B);
  if (pool_dtype == LT_I8)
    paged_split_kernel<int8_t, true><<<grid1, kThreads, 0, st>>>(pa);
  else if (pool_dtype == LT_F32)
    paged_split_kernel<float, false><<<grid1, kThreads, 0, st>>>(pa);
  else
    paged_split_kernel<__nv_bfloat16, false><<<grid1, kThreads, 0, st>>>(pa);
  LT_RETURN_IF_ERROR();
  attn_combine_kernel<<<dim3(KV, B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The walk kernel: K14 (unfused, fused, stats), K15 (s_use < S), K6's int8
// variant (fused, rows = 64). q [B, KV, G, hd] (q_dtype); kv: this layer's
// cache [B, KV, S, hd + vhd] (cache_dtype: f32, bf16 or int8); sc: int8
// only, this layer's scale rows [B, KV, 2, S] f32 (else null); fused: kvn
// [B, KV, hd + vhd] (kvn_dtype) written at pos[b] first, and under int8 snew
// [B, KV, 2] f32 into sc; pos int32 [B]; rows per pass-1 block, nsplit =
// ceil(s_use / rows); scratch part_o [B, KV, nsplit, G, vhd], part_ml
// [B, KV, nsplit, G, 2] f32; out [B, KV, G, vhd] f32; m_out, l_out
// [B, KV, G] f32 in stats mode (else null).
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
