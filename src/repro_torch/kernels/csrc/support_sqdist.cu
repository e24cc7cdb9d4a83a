// Exact re-rank distances d2[b, j] = max(||q_b||^2 + ||x_r||^2 - 2 q_b.x_r, 0)
// with r = idx[b, j]: each query against its own candidate rows, loaded
// by index straight from the store X [N, D].
//
// Replaces: src/repro/kernels/golden_rerank.py:66 (support_sqdist /
// _sqdist_kernel :33).  The JAX op first materializes x[idx]
// (ops.py:166), a [B, m, D] tensor of 2.46 GB at B=16, m=12500, D=3072;
// this kernel never does.
// Bound on the H100: bytes.  Every (query, candidate) pair reads one
// 12 KB row; rows that several queries share are read from HBM once
// at best (the rest hit L2), so the floor is the distinct rows' bytes.
// FLOPs are 2 per loaded element, far below the fp32 rate.
// Design: a block serves one query and a run of 64 candidates.  q_b sits
// in shared memory (D floats, 12 KB at D=3072); each of the 8 warps
// takes one candidate row at a time, its lanes read the row with
// 16-byte coalesced loads (scalar loads when D is not a multiple of 4),
// and a warp shuffle reduces the dot product.  Many small blocks keep
// enough loads in flight to cover HBM latency.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;     // candidates per block

__global__ void __launch_bounds__(THREADS)
support_sqdist_kernel(const float* __restrict__ q,
                      const float* __restrict__ x,
                      const float* __restrict__ x_norms,
                      const int64_t* __restrict__ idx,
                      const float* __restrict__ qn,
                      float* __restrict__ out, int M, int D, int vec) {
  extern __shared__ __align__(16) float qs[];   // [D]
  const int b = blockIdx.y;
  const float* qb = q + (int64_t)b * D;
  for (int c = threadIdx.x; c < D; c += THREADS) qs[c] = qb[c];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j_end = min(M, (int)(blockIdx.x + 1) * ROWS);
  const float qnb = qn[b];
  for (int j = blockIdx.x * ROWS + warp; j < j_end; j += THREADS / 32) {
    const int64_t r = idx[(int64_t)b * M + j];
    const float* xr = x + r * D;
    float acc = 0.f;
    if (vec) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
      for (int c = lane; c < D / 4; c += 32) acc += dot4(__ldg(xr4 + c), q4[c]);
    } else {
      for (int c = lane; c < D; c += 32) acc += __ldg(xr + c) * qs[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float d2 = (qnb + x_norms[r]) - 2.0f * acc;
      out[(int64_t)b * M + j] = fmaxf(d2, 0.f);
    }
  }
}

}  // namespace

RT_EXPORT int support_sqdist_launch(const float* q, const float* x,
                                    const float* x_norms, const int64_t* idx,
                                    const float* qn, float* out, int B, int M,
                                    int D, int vec, void* stream) {
  if (B > 0 && M > 0) {
    const size_t smem = sizeof(float) * (size_t)D;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(support_sqdist_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    dim3 grid((M + ROWS - 1) / ROWS, B);
    support_sqdist_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        q, x, x_norms, idx, qn, out, M, D, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
