// Helpers shared by the port's CUDA kernels (built by llamatpu_torch/_build.py
// with nvcc into one shared library per .cu, loaded with ctypes).
//
// Conventions of every exported entry point:
// - a plain C interface: pointers and the stream arrive as void* (ctypes
//   c_void_p), ints as int, scalars as float;
// - the kernel launches on the caller's stream, allocates nothing and does not
//   synchronise;
// - the function returns cudaGetLastError() after each launch (0 = launched);
//   the Python wrapper raises on anything else, with lt_error_string's text.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LT_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes, mirrored by _build.DTYPE_CODES
enum { LT_F32 = 0, LT_BF16 = 1 };

// Each library exports the error text for the codes its functions return.
#define LT_DEFINE_ERROR_STRING                                         \
  LT_EXPORT const char* lt_error_string(int e) {                       \
    return cudaGetErrorString(static_cast<cudaError_t>(e));            \
  }

#define LT_RETURN_IF_ERROR()                                           \
  do {                                                                 \
    cudaError_t lt_e = cudaGetLastError();                             \
    if (lt_e != cudaSuccess) return static_cast<int>(lt_e);            \
  } while (0)

__device__ __forceinline__ float lt_load(const void* p, int dtype, long i) {
  return dtype == LT_F32 ? static_cast<const float*>(p)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void lt_store(void* p, int dtype, long i, float v) {
  if (dtype == LT_F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);  // round to nearest even
}

// Round an f32 value to the working dtype and back (the JAX kernels'
// `.astype(dot_dtype)` before a dot): identity for f32, RNE to bf16 otherwise.
__device__ __forceinline__ float lt_round(float v, int dtype) {
  return dtype == LT_F32 ? v : __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float lt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; `red` is __shared__ scratch of >= 32 floats.
// Every thread gets the result.
__device__ __forceinline__ float lt_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = lt_warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return lt_warp_sum(t);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t lt_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int lt_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}
