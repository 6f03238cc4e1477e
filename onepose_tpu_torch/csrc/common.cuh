// Shared by every kernel library of the port: each .cu includes this once,
// so each shared library exports its own kernel_error_string.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
