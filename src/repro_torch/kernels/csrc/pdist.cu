// Coarse-screen distances d2[b, j] = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0)
// for q [B, d] against every proxy row x [N, d], fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/pdist.py:61 (pdist / _pdist_kernel :25).
// Bound on the H100: bytes.  At B=16, N=50000, d=192 the proxy store is
// 38.4 MB read once and the output 3.2 MB written once, against 0.31
// GFLOP: about 12 us of HBM traffic and 5 us of fp32 FMA work.
// Design: a block owns a 16-query x 64-row output tile.  It stages the
// query tile and the row tile in shared memory, 32 columns of d at a
// time (the row tile transposed and padded against bank conflicts),
// and every thread accumulates four (query, row) dot products in
// registers.  The grid walks N in 64-row tiles, so each proxy row is
// read from HBM once for up to 16 queries.  Ragged B, N and d edges are
// masked in the kernel: no padded copy of the store is made.  +inf norms
// give +inf distances (inf - finite = inf).
#include "common.cuh"

namespace {

constexpr int BQ = 16;   // queries per block
constexpr int BN = 64;   // proxy rows per block
constexpr int BK = 32;   // columns of d staged per step
constexpr int THREADS = 256;
constexpr int QPT = BQ / (THREADS / BN);  // queries per thread (4)

__global__ void __launch_bounds__(THREADS)
pdist_kernel(const float* __restrict__ q, const float* __restrict__ x,
             const float* __restrict__ qn, const float* __restrict__ xn,
             float* __restrict__ out, int B, int N, int d) {
  __shared__ float qs[BQ][BK];
  __shared__ float xs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % BN;            // row within the tile
  const int ty = tid / BN;            // query group within the tile
  const int row0 = blockIdx.x * BN;
  const int q0 = blockIdx.y * BQ;
  float acc[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // stage x[row0:row0+BN, k0:k0+BK] transposed; consecutive threads
    // read consecutive columns of one row (coalesced)
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < N && gk < d) ? x[(int64_t)gr * d + gk] : 0.f;
    }
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int b = e / BK, k = e % BK;
      const int gb = q0 + b, gk = k0 + k;
      qs[b][k] = (gb < B && gk < d) ? q[(int64_t)gb * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float xv = xs[k][tx];
#pragma unroll
      for (int i = 0; i < QPT; ++i) acc[i] += qs[ty * QPT + i][k] * xv;
    }
    __syncthreads();
  }

  const int j = row0 + tx;
  if (j >= N) return;
  const float xnj = xn[j];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int b = q0 + ty * QPT + i;
    if (b < B) {
      const float d2 = (qn[b] + xnj) - 2.0f * acc[i];
      out[(int64_t)b * N + j] = fmaxf(d2, 0.f);
    }
  }
}

}  // namespace

RT_EXPORT int pdist_launch(const float* q, const float* x, const float* qn,
                           const float* xn, float* out, int B, int N, int d,
                           void* stream) {
  if (B > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (B + BQ - 1) / BQ);
    pdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        q, x, qn, xn, out, B, N, d);
  }
  return static_cast<int>(cudaGetLastError());
}
