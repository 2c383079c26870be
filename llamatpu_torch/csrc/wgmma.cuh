// The pieces of the port's TMA + wgmma GEMMs shared by gemm.cu (K4, K17) and
// block_matmul.cu (K5, K7 at prefill widths): the persistent walk over
// (tile, K stage) iterations that ops/gemm.py GemmPlan mirrors (whole tiles
// in rounds, then stream-K ranges), the wgmma descriptors of a K-major tile
// in the 128-byte swizzle, the warpgroup fences, and the register-A bf16
// product m64n128k16.
#pragma once

#include "tc_gemv.cuh"

namespace {

// The walk over (tile, K stage) iterations; tile t is rows (t % tiles_m) * BM
// and columns (t / tiles_m) * BN. ops/gemm.py GemmPlan mirrors it.
struct Walk {
  int T, O, K, tiles_m, nk, tiles_dp, ctas;
  long long total_sk;  // iterations of the tiles after the whole-tile rounds
  __device__ long long begin(int c) const { return c * total_sk / ctas; }
  __device__ int owner(long long i) const {
    return static_cast<int>(((i + 1) * ctas - 1) / total_sk);
  }
};

// f(tile, k0, k1, slot) for each segment of CTA blockIdx.x, in order: K
// stages [k0, k1) of the tile; slot -1 when the segment is the whole tile,
// else the CTA's workspace slot (0: the tile its range starts in, 1: the
// tile it ends in).
template <typename F>
__device__ __forceinline__ void for_each_segment(const Walk& w, F&& f) {
  const int c = blockIdx.x;
  for (int t = c; t < w.tiles_dp; t += w.ctas) f(t, 0, w.nk, -1);
  long long i = w.begin(c);
  const long long e = w.begin(c + 1);
  for (int slot = 0; i < e; slot = 1) {
    const int t = w.tiles_dp + static_cast<int>(i / w.nk);
    const int k0 = static_cast<int>(i % w.nk);
    const int k1 = static_cast<int>(min(static_cast<long long>(w.nk), k0 + (e - i)));
    f(t, k0, k1, k0 == 0 && k1 == w.nk ? -1 : slot);
    i += k1 - k0;
  }
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the base 1024-byte aligned; a K step
// inside the row advances the start address).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wg_wait: the accumulators are read only from here on.
__device__ __forceinline__ void fence_reg(int& v) { asm volatile("" : "+r"(v)::"memory"); }
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }
template <typename Acc, int N>
__device__ __forceinline__ void fence_regs(Acc (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, bf16, f32 sums; A from this
// thread's registers (a[0..3]: rows g, g + 8 at k 2t.., then at k 2t + 8..;
// g = lane / 4, t = lane % 4, in the warp's 16 rows), B from shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

}  // namespace
