// Full-scan posterior mean (paper Eq. 2):
//   out[b] = sum_i softmax_i(max(-d2[b, i] * inv_two_sigma2, NEG_INF)) x_i
// with d2 = max(||q_b||^2 + ||x_i||^2 - 2 q_b.x_i, 0) over every store
// row x [N, D]; keys and values are the same rows.
//
// Replaces: src/repro/kernels/golden_aggregate.py:93 (golden_aggregate /
// _agg_kernel :28).  Kept from the TPU kernel: the finite
// inv_two_sigma2 temperature (computed by the caller), the NEG_INF clamp
// on real rows, no weight for rows past N, fp32 accumulation.
// Bound on the H100: bytes.  At B=16, N=50000, D=3072 the store is
// 614 MB read once (0.18 ms at 3.35 TB/s) against 9.8 GFLOP of fp32
// FMA work (0.15 ms at 67 TFLOP/s), so the two are close.
// Design (flash-decoding): the TPU carries one online-softmax state
// along its sequential grid; Hopper blocks run in parallel in no order,
// so N is split across blocks and a second kernel merges the partial
// states by log-sum-exp.  A block takes a group of BQ queries and a
// contiguous range of rows.  The queries' rows and the block's partial
// accumulator acc[BQ, D] both live in shared memory (2 * BQ * D * 4
// bytes: 192 KB at BQ=8, D=3072, opted in above 48 KB).  Per tile of 32
// rows: (1) each of the 16 warps reads two store rows from HBM with
// 16-byte loads and reduces their dot products with all BQ queries;
// (2) BQ threads update the running (max, l) and turn the logits into
// weights; (3) all threads rescale acc and add the weighted rows, read a
// second time from L2.  The two query groups of one row range sit next
// to each other in the grid so that, at B=16, the second group's store
// reads can hit L2.  That is the design's intent, not a measurement: the
// DRAM bytes one call reads have not been counted.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int R = 2 * WARPS;          // rows per tile: two per warp

size_t partial_smem(int bq, int D) {
  return sizeof(float) * ((size_t)2 * bq * D + (size_t)bq * R + 3 * bq);
}

template <int BQ>
__global__ void __launch_bounds__(THREADS, 1)
full_scan_partial_kernel(const float* __restrict__ q,
                         const float* __restrict__ x,
                         const float* __restrict__ qn,
                         const float* __restrict__ xn, float inv,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l, int B, int N, int D,
                         int rows_per_split, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [BQ][D]
  float* acc_s = q_s + BQ * D;         // [BQ][D]
  float* w_s = acc_s + BQ * D;         // [BQ][R] logits, then weights
  float* scale_s = w_s + BQ * R;       // [BQ]
  float* m_s = scale_s + BQ;           // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running denominator

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, B - q0);
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int b = e / D;
    q_s[e] = b < nq ? q[(int64_t)(q0 + b) * D + (e - b * D)] : 0.f;
    acc_s[e] = 0.f;
  }
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = RT_NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  for (int t0 = row_begin; t0 < row_end; t0 += R) {
    const int rows = min(R, row_end - t0);

    // (1) logits of this warp's two rows against the BQ queries
    const int r0 = 2 * warp;
    if (r0 < rows) {                                 // warp-uniform
      const bool has1 = r0 + 1 < rows;
      const float* x0 = x + (int64_t)(t0 + r0) * D;
      const float* x1 = has1 ? x0 + D : x0;
      float d0[BQ], d1[BQ];
#pragma unroll
      for (int b = 0; b < BQ; ++b) d0[b] = d1[b] = 0.f;
      if (vec) {
        const float4* x04 = reinterpret_cast<const float4*>(x0);
        const float4* x14 = reinterpret_cast<const float4*>(x1);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        const int D4 = D / 4;
        for (int c = lane; c < D4; c += 32) {
          const float4 a = __ldg(x04 + c), a1 = __ldg(x14 + c);
#pragma unroll
          for (int b = 0; b < BQ; ++b) {
            const float4 qv = q4[b * D4 + c];
            d0[b] += dot4(a, qv);
            d1[b] += dot4(a1, qv);
          }
        }
      } else {
        for (int c = lane; c < D; c += 32) {
          const float a = __ldg(x0 + c), a1 = __ldg(x1 + c);
#pragma unroll
          for (int b = 0; b < BQ; ++b) {
            d0[b] += a * q_s[b * D + c];
            d1[b] += a1 * q_s[b * D + c];
          }
        }
      }
      const float xn0 = xn[t0 + r0], xn1 = has1 ? xn[t0 + r0 + 1] : 0.f;
#pragma unroll
      for (int b = 0; b < BQ; ++b) {
        const float s0 = warp_sum(d0[b]), s1 = warp_sum(d1[b]);
        if (lane == 0) {
          const float qnb = b < nq ? qn[q0 + b] : 0.f;
          const float e0 = fmaxf((qnb + xn0) - 2.0f * s0, 0.f);
          w_s[b * R + r0] = fmaxf(-e0 * inv, RT_NEG_INF);
          if (has1) {
            const float e1 = fmaxf((qnb + xn1) - 2.0f * s1, 0.f);
            w_s[b * R + r0 + 1] = fmaxf(-e1 * inv, RT_NEG_INF);
          }
        }
      }
    }
    __syncthreads();

    // (2) online-softmax state per query; logits become weights
    if (threadIdx.x < BQ) {
      const int b = threadIdx.x;
      float* wb = w_s + b * R;
      float mt = m_s[b];
      for (int r = 0; r < rows; ++r) mt = fmaxf(mt, wb[r]);
      const float sc = expf(m_s[b] - mt);
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float p = expf(wb[r] - mt);
        wb[r] = p;
        sum += p;
      }
      l_s[b] = l_s[b] * sc + sum;
      m_s[b] = mt;
      scale_s[b] = sc;
    }
    __syncthreads();

    // (3) acc = acc * scale + weights . rows (rows come back from L2)
    for (int c = threadIdx.x; c < D; c += THREADS) {
      float a[BQ];
#pragma unroll
      for (int b = 0; b < BQ; ++b) a[b] = acc_s[b * D + c] * scale_s[b];
      for (int r = 0; r < rows; ++r) {
        const float xv = __ldg(x + (int64_t)(t0 + r) * D + c);
#pragma unroll
        for (int b = 0; b < BQ; ++b) a[b] += w_s[b * R + r] * xv;
      }
#pragma unroll
      for (int b = 0; b < BQ; ++b) acc_s[b * D + c] = a[b];
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nq * D; e += THREADS) {
    const int b = e / D;
    part_acc[((int64_t)split * B + q0 + b) * D + (e - b * D)] = acc_s[e];
  }
  if (threadIdx.x < nq) {
    part_m[(int64_t)split * B + q0 + threadIdx.x] = m_s[threadIdx.x];
    part_l[(int64_t)split * B + q0 + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Log-sum-exp merge of the per-split states, in split order
// (deterministic): out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
__global__ void merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             float* __restrict__ out, int S, int B, int D) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  float M = RT_NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part_m[(int64_t)s * B + b]);
  if (c >= D) return;
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float e = expf(part_m[(int64_t)s * B + b] - M);
    L += part_l[(int64_t)s * B + b] * e;
    acc += part_acc[((int64_t)s * B + b) * D + c] * e;
  }
  out[(int64_t)b * D + c] = acc / fmaxf(L, 1e-30f);
}

template <int BQ>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                           const float* q, const float* x, const float* qn,
                           const float* xn, float inv, float* part_acc,
                           float* part_m, float* part_l, int B, int N, int D,
                           int rows_per_split, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      full_scan_partial_kernel<BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  full_scan_partial_kernel<BQ><<<grid, THREADS, smem, st>>>(
      q, x, qn, xn, inv, part_acc, part_m, part_l, B, N, D, rows_per_split,
      vec);
  return cudaSuccess;
}

}  // namespace

RT_EXPORT size_t golden_aggregate_smem_bytes(int bq, int D) {
  return partial_smem(bq, D);
}

// part_acc [splits, B, D], part_m / part_l [splits, B]: caller-allocated
// scratch.  Rows [s * rows_per_split, (s + 1) * rows_per_split) go to
// split s; every split must hold at least one row.
RT_EXPORT int golden_aggregate_launch(const float* q, const float* x,
                                      const float* qn, const float* xn,
                                      float inv, float* part_acc,
                                      float* part_m, float* part_l,
                                      float* out, int B, int N, int D, int bq,
                                      int splits, int rows_per_split, int vec,
                                      void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem(bq, D);
  dim3 grid((B + bq - 1) / bq, splits);
  cudaError_t err;
  switch (bq) {
    case 8: err = launch_partial<8>(grid, smem, st, q, x, qn, xn, inv, part_acc, part_m, part_l, B, N, D, rows_per_split, vec); break;
    case 4: err = launch_partial<4>(grid, smem, st, q, x, qn, xn, inv, part_acc, part_m, part_l, B, N, D, rows_per_split, vec); break;
    case 2: err = launch_partial<2>(grid, smem, st, q, x, qn, xn, inv, part_acc, part_m, part_l, B, N, D, rows_per_split, vec); break;
    case 1: err = launch_partial<1>(grid, smem, st, q, x, qn, xn, inv, part_acc, part_m, part_l, B, N, D, rows_per_split, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 mgrid((D + 255) / 256, B);
  merge_kernel<<<mgrid, 256, 0, st>>>(part_acc, part_m, part_l, out, splits,
                                      B, D);
  return static_cast<int>(cudaGetLastError());
}
