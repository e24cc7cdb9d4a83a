// IVF level 1: query -> centroid squared distances
// d2[b, j] = max(||q_b||^2 + ||c_j||^2 - 2 q_b.c_j, 0) for the proxy
// queries q [B, d] against the Golden Index's window centroids c [C, d].
//
// Replaces: src/repro/kernels/centroid_scan.py:65 (centroid_scan /
// _centroid_kernel :25).
// Bound on the H100: neither bytes nor FLOPs but launch latency.  At
// B=16, d=192 and C of a few hundred windows the call reads well under
// 1 MB and does about 1.4 MFLOP: a fraction of a microsecond against a
// launch of several.  So the design keeps the work in one wave of few
// blocks instead of copying the TPU's (8, 128) grid: a block owns a
// 16-query x 16-centroid output tile, stages the query rows and the
// centroid rows in shared memory 64 columns at a time (rows padded by
// one float against bank conflicts), and each of its 256 threads keeps
// one (query, centroid) dot product in a register, accumulated with
// fp32 FMAs in ascending column order.  The grid walks C in 16-centroid
// tiles and B in 16-query tiles, so ragged C and d, B > 16 and C = 1
// are masked in the kernel (zero-filled staging adds nothing).
// The epilogue is the plain version's: (qn + cn) - 2 acc, clamped at 0.
// A +inf centroid norm (a padded window) gives +inf whatever acc is;
// no fast-math flag is used, so that holds.
#include "common.cuh"

namespace {

constexpr int BQ = 16;               // queries per block
constexpr int BC = 16;               // centroids per block
constexpr int KC = 64;               // columns of d staged per step
constexpr int THREADS = BQ * BC;     // one thread per output element

__global__ void __launch_bounds__(THREADS)
centroid_scan_kernel(const float* __restrict__ q,
                     const float* __restrict__ c,
                     const float* __restrict__ qn,
                     const float* __restrict__ cn,
                     float* __restrict__ out, int B, int C, int d) {
  __shared__ float qs[BQ][KC + 1];
  __shared__ float cs[BC][KC + 1];
  const int tid = threadIdx.x;
  const int qi = tid / BC;           // query within the tile
  const int cj = tid % BC;           // centroid within the tile
  const int q0 = blockIdx.y * BQ;
  const int c0 = blockIdx.x * BC;
  float acc = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    // consecutive threads read consecutive columns of one row (coalesced)
    for (int e = tid; e < BQ * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int gr = q0 + r, gk = k0 + k;
      qs[r][k] = (gr < B && gk < d) ? q[(int64_t)gr * d + gk] : 0.f;
    }
    for (int e = tid; e < BC * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int gr = c0 + r, gk = k0 + k;
      cs[r][k] = (gr < C && gk < d) ? c[(int64_t)gr * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < KC; ++k) acc = fmaf(qs[qi][k], cs[cj][k], acc);
    __syncthreads();
  }

  const int b = q0 + qi, j = c0 + cj;
  if (b < B && j < C) {
    const float d2 = (qn[b] + cn[j]) - 2.0f * acc;
    out[(int64_t)b * C + j] = fmaxf(d2, 0.f);
  }
}

}  // namespace

RT_EXPORT int centroid_scan_launch(const float* q, const float* c,
                                   const float* qn, const float* cn,
                                   float* out, int B, int C, int d,
                                   void* stream) {
  if (B > 0 && C > 0) {
    dim3 grid((C + BC - 1) / BC, (B + BQ - 1) / BQ);
    centroid_scan_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        q, c, qn, cn, out, B, C, d);
  }
  return static_cast<int>(cudaGetLastError());
}
