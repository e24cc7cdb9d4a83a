// Golden aggregate out[b] = sum_j softmax(logits[b])_j * X[idx[b, j]],
// written as acc / max(l, 1e-30) with l the softmax denominator; rows
// are loaded by index straight from the store X [N, D].
//
// Replaces: src/repro/kernels/golden_support_aggregate.py:78
// (golden_support_aggregate / _sagg_kernel :30).  The TPU kernel carries
// an online (max, l, acc) state from one grid step to the next; Hopper
// blocks run in no order, so nothing can be carried between them.
// Bound on the H100: bytes.  Each (query, support slot) pair reads one
// 12 KB row at D=3072 (the distinct rows' bytes are the floor), against
// 2 FLOPs per loaded element.
// Design: a block owns one query and a 128-column slice of D.  It first
// reduces the query's k logits to their max and then to
// l = sum exp(logit - max) (block reductions in a fixed order), then
// its 8 warps walk the support rows, each lane accumulating 4 columns
// (one 16-byte load per row) with weight exp(logit - max) in registers.
// The 8 warp partials are summed in shared memory in a fixed order: no
// atomics, and the result is deterministic.  NEG_INF logits get weight
// exp(NEG_INF - max) = 0; an all-NEG_INF query has max = NEG_INF and
// weight 1 everywhere, which is the uniform mean.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;    // columns of D per block: 32 lanes x 4

__global__ void __launch_bounds__(THREADS)
support_aggregate_kernel(const float* __restrict__ x,
                         const int64_t* __restrict__ idx,
                         const float* __restrict__ logits,
                         float* __restrict__ out, int K, int D, int vec) {
  __shared__ float scratch[33];
  __shared__ float4 part[WARPS][COLS / 4];
  const int b = blockIdx.y;
  const float* lg = logits + (int64_t)b * K;
  const int64_t* ib = idx + (int64_t)b * K;

  // the max starts at NEG_INF as in the TPU kernel, so hard -inf
  // logits get zero weight even when every logit is -inf
  float m = RT_NEG_INF;
  for (int j = threadIdx.x; j < K; j += THREADS) m = fmaxf(m, lg[j]);
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int j = threadIdx.x; j < K; j += THREADS) l += expf(lg[j] - m);
  l = block_reduce<false>(l, scratch);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * COLS + 4 * lane;    // this lane's 4 columns
  const int nc = max(0, min(4, D - c));
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && nc == 4) {
#pragma unroll 4
    for (int j = warp; j < K; j += WARPS) {
      const float w = expf(lg[j] - m);
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + ib[j] * D + c));
      acc.x += w * v.x; acc.y += w * v.y; acc.z += w * v.z; acc.w += w * v.w;
    }
  } else if (nc > 0) {
    for (int j = warp; j < K; j += WARPS) {
      const float w = expf(lg[j] - m);
      const float* xr = x + ib[j] * D + c;
      acc.x += w * __ldg(xr);
      if (nc > 1) acc.y += w * __ldg(xr + 1);
      if (nc > 2) acc.z += w * __ldg(xr + 2);
      if (nc > 3) acc.w += w * __ldg(xr + 3);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();

  if (threadIdx.x < COLS) {
    const int col = blockIdx.x * COLS + threadIdx.x;
    if (col < D) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w)
        s += reinterpret_cast<const float*>(part[w])[threadIdx.x];
      out[(int64_t)b * D + col] = s / fmaxf(l, 1e-30f);
    }
  }
}

}  // namespace

RT_EXPORT int golden_support_aggregate_launch(const float* x,
                                              const int64_t* idx,
                                              const float* logits, float* out,
                                              int B, int K, int D, int vec,
                                              void* stream) {
  if (B > 0 && D > 0) {
    dim3 grid((D + COLS - 1) / COLS, B);
    support_aggregate_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        x, idx, logits, out, K, D, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
