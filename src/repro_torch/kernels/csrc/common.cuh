// Shared helpers for the hand-written kernels.  Each kernel source is
// compiled on its own into a shared library with a plain C interface
// (see kernels/_build.py); every entry point returns
// cudaGetLastError() after its launches.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// finite logit floor shared with the plain versions (ref.NEG_INF)
#define RT_NEG_INF (-1e30f)

RT_EXPORT const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of one value per thread (blockDim.x a multiple
// of 32, at most 1024).  Every thread gets the result.  ``scratch``
// holds 33 floats of shared memory.  The order is fixed, so the result
// is deterministic.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  float r = scratch[32];
  __syncthreads();  // scratch may be reused right after
  return r;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
