// Shared helpers for the hand-written kernels.  Each kernel source is
// compiled on its own into a shared library with a plain C interface
// (see kernels/_build.py); every entry point returns
// cudaGetLastError() after its launches.
#pragma once

#include <cuda_bf16.h>
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

// Store rows come as fp32 or as bf16 (the engine's storage_dtype).  A
// kernel's bf16 instance widens each value before it computes with it
// (exact: a bf16 is the high half of an fp32) and does all its
// arithmetic in fp32, so it computes what its fp32 instance computes on
// the widened rows.
typedef __nv_bfloat16 bf16_t;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) {
  return __bfloat162float(v);
}

// the two bf16 halves of a 32-bit word, lower address first
__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// one value of global memory through the read-only path, widened
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16_t* p) {
  return lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Four consecutive values as loaded, not yet widened: one 16-byte load
// of fp32 (a float4) or one 8-byte load of bf16 (a uint2), p aligned to
// four values.  Loads kept in flight in registers stay raw until used:
// widening right after the load would wait for it there.
template <typename T>
struct Raw4 {
  typedef float4 type;
};
template <>
struct Raw4<bf16_t> {
  typedef uint2 type;
};

__device__ __forceinline__ float4 ldg_raw4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 ldg_raw4(const bf16_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y), hi_bf16(u.y));
}

// the same from shared memory
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16_t* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// v rounded to the nearest bf16 (ties to even, as torch's .to(bfloat16)),
// as fp32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
