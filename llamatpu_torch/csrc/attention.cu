// K6: fused KV-append + decode attention of one layer (T = 1).
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
#include "common.cuh"

LT_DEFINE_ERROR_STRING

namespace {

constexpr int kChunk = 64;     // cache rows per block of pass 1
constexpr int kThreads = 256;
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxW = 256;     // hd + vhd
#define kNegInf (-__int_as_float(0x7f800000))  // -inf

template <typename CT>
__device__ __forceinline__ float c2f(CT v);
template <>
__device__ __forceinline__ float c2f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float c2f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename CT>
__device__ __forceinline__ CT f2c(float v);
template <>
__device__ __forceinline__ float f2c<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 f2c<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

struct Args {
  const void* q;    // [B, KV, G, hd] (in_dtype)
  const void* kvn;  // [B, KV, hd + vhd] (in_dtype)
  int in_dtype;
  void* kv;         // this layer's cache [B, KV, S, hd + vhd] (CT)
  const int* pos;   // [B]
  int B, KV, G, S, hd, vhd;
  float scale;
  float* part_o;    // [B, KV, nsplit, G, vhd]
  float* part_ml;   // [B, KV, nsplit, G, 2]: local max, local sum
  float* out;       // [B, KV, G, vhd]
  int nsplit;
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

__global__ void __launch_bounds__(kThreads) attn_combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.G, vhd = a.vhd;
  const long bh = static_cast<long>(b) * a.KV + h;
  const int pos = a.pos[b];
  float* out = a.out + bh * G * vhd;
  if (pos < 0 || pos >= a.S) {  // no row was written: make the fault visible
    for (int idx = threadIdx.x; idx < G * vhd; idx += blockDim.x) out[idx] = __int_as_float(0x7fc00000);
    return;
  }
  const int nvalid = pos / kChunk + 1;
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
  }
}

}  // namespace

// q [B, KV, G, hd], kvn [B, KV, hd + vhd] (in_dtype); kv: this layer's cache
// [B, KV, S, hd + vhd] (cache_dtype), written at pos[b]; pos int32 [B] on
// the device; scratch part_o [B, KV, nsplit, G, vhd], part_ml
// [B, KV, nsplit, G, 2] f32; out [B, KV, G, vhd] f32. nsplit = ceil(S / 64).
LT_EXPORT int lt_decode_attention(const void* q, const void* kvn, int in_dtype, void* kv,
                                  int cache_dtype, const void* pos, int B, int KV, int G, int S,
                                  int hd, int vhd, float scale, void* part_o, void* part_ml,
                                  void* out, int nsplit, void* stream) {
  if (G < 1 || G > kMaxG || hd + vhd > kMaxW || hd % 8 || vhd % 8 ||
      nsplit * kChunk < S || B < 1 || KV < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {q, kvn, in_dtype, kv, static_cast<const int*>(pos), B, KV, G, S, hd, vhd, scale,
            static_cast<float*>(part_o), static_cast<float*>(part_ml), static_cast<float*>(out),
            nsplit};
  dim3 grid1(nsplit, KV, B);
  if (cache_dtype == LT_F32)
    attn_split_kernel<float><<<grid1, kThreads, 0, st>>>(a);
  else
    attn_split_kernel<__nv_bfloat16><<<grid1, kThreads, 0, st>>>(a);
  LT_RETURN_IF_ERROR();
  attn_combine_kernel<<<dim3(KV, B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
