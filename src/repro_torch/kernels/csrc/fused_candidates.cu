// Fused GoldDiff candidates: the m nearest rows of each query by PROXY
// distance, in the proxy order (ties to the lowest row), each with its
// EXACT squared distance attached,
//   idx [B, m], d2 [B, m] = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0),
// computed in one pass over the store: every row x_j [D] is read once.
//
// Replaces: src/repro/kernels/fused_step.py:178 (fused_candidates_pallas /
// _fused_kernel :85, _merge_topm_carry :64).  Kept from the TPU kernel:
// the proxy top-m contract of screen_topm (tie order, +inf rows never
// selected), and the carried exact distance follows the proxy
// selection; a slot whose proxy distance is +inf, or past N when m > N,
// carries row 0 and exact d2 = +inf.
// Bound on the H100: bytes.  At B=16, N=50000, D=3072, dp=192 the store
// is 614.4 MB and the proxy 38.4 MB (0.195 ms at 3.35 TB/s), against
// 2 * 16 * 50000 * 3264 = 5.2 GFLOP (0.078 ms of fp32 FMA work).  The
// bf16 instance (store and proxy rows in bf16, the engine's
// storage_dtype) reads half the bytes and widens each value as it loads
// it: the same fp32 arithmetic, the same keys, on the widened rows.
// Design: the proxy selection runs first, as in screen_topm.cu (radix
// passes over the 38.4 MB proxy store, which L2 mostly holds).  Then one
// pass over the whole store: a block takes 128 rows for up to 16
// queries, computes the exact distances of all of them (each row read
// from HBM once for 16 queries, 4x4 register tiles, the next 32-column
// slab prefetched into registers), recomputes the proxy keys
// bit-identically, and writes (proxy key, exact d2) for the selected
// pairs (at most m + 2048 a query).  The shared sort (chunks, then merge
// rounds) orders them by proxy key, carrying the exact d2, and keeps the
// first m.  No [B, N] buffer and no [B, m, D] gather exist; live memory
// is O(B m).
#include "topm_select.cuh"

namespace {

using namespace topm;

template <typename T, bool PVEC, bool XVEC>
__global__ void __launch_bounds__(THREADS)
fused_pass(const float* __restrict__ qp, const T* __restrict__ proxy,
           const float* __restrict__ qpn, const float* __restrict__ pn,
           const float* __restrict__ q, const T* __restrict__ x,
           const float* __restrict__ qn, const float* __restrict__ xn, int B,
           int N, int dp, int D, const State* __restrict__ st,
           int* __restrict__ cnt, u64* __restrict__ keys,
           float* __restrict__ pays, int L) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.y * BQ, row0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[QPT][RPT];
  float ex[QPT][RPT];
  tile_dot<T, XVEC>(q, x, N, D, B, q0, row0, acc, sm, threadIdx.x,
                    0);                                   // exact
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int b = q0 + 4 * warp + i;
    const float qnb = b < B ? qn[b] : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + lane + 32 * r;
      ex[i][r] = row < N ? clamped_d2(qnb, xn[row], acc[i][r]) : 0.f;
    }
  }
  tile_dot<T, PVEC>(qp, proxy, N, dp, B, q0, row0, acc, sm, threadIdx.x,
                    0);                                       // proxy keys
  bool sel[QPT][RPT];
  u64 key[QPT][RPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int b = q0 + 4 * warp + i;
    const bool live = b < B;
    const u64 thr = live ? st[b].thr : 0;
    const float qnb = live ? qpn[b] : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + lane + 32 * r;
      sel[i][r] = false;
      key[i][r] = 0;
      if (live && row < N) {
        key[i][r] = dist_key(clamped_d2(qnb, pn[row], acc[i][r]), row);
        sel[i][r] = key[i][r] <= thr;
      }
    }
  }
  compact_write<true>(sel, key, ex, B, q0, L, cnt, keys, pays);
}

template <typename T, bool PVEC, bool XVEC>
cudaError_t fused(const float* qp, const T* proxy, const float* qpn,
                  const float* pn, const float* q, const T* x,
                  const float* qn, const float* xn, int B, int N, int dp,
                  int D, int m, int cap, const int* passes, int npasses,
                  State* st, int* work, u64* keys, float* pays,
                  cudaStream_t s) {
  cudaError_t err = select_phase<T, PVEC>(qp, proxy, qpn, pn, B, N, dp, m,
                                          cap, passes, npasses, st, work + B,
                                          s);
  if (err != cudaSuccess) return err;
  fused_pass<T, PVEC, XVEC>
      <<<dim3((N + BN - 1) / BN, (B + BQ - 1) / BQ), THREADS, 0, s>>>(
          qp, proxy, qpn, pn, q, x, qn, xn, B, N, dp, D, st, work, keys,
          pays, cap);
  return cudaGetLastError();
}

// the instance for the rows' type T and the two alignments
template <typename T>
cudaError_t launch_rows(const T* proxy, const T* x, const float* qp,
                        const float* qpn, const float* pn, const float* q,
                        const float* qn, const float* xn, int B, int N,
                        int dp, int D, int m, int pvec, int xvec, int cap,
                        const int* passes, int npasses, State* st, int* work,
                        u64* keys, float* pays, cudaStream_t s) {
  if (pvec && xvec)
    return fused<T, true, true>(qp, proxy, qpn, pn, q, x, qn, xn, B, N, dp,
                                D, m, cap, passes, npasses, st, work, keys,
                                pays, s);
  if (pvec)
    return fused<T, true, false>(qp, proxy, qpn, pn, q, x, qn, xn, B, N, dp,
                                 D, m, cap, passes, npasses, st, work, keys,
                                 pays, s);
  if (xvec)
    return fused<T, false, true>(qp, proxy, qpn, pn, q, x, qn, xn, B, N, dp,
                                 D, m, cap, passes, npasses, st, work, keys,
                                 pays, s);
  return fused<T, false, false>(qp, proxy, qpn, pn, q, x, qn, xn, B, N, dp,
                                D, m, cap, passes, npasses, st, work, keys,
                                pays, s);
}

}  // namespace

// Scratch, all from the caller: st [B] State (24 bytes each), work
// [B + npasses * (ceil(B/16) + B * 2112)] int32 (counters, tickets,
// histograms; the entry point clears it), keys [2 * B * cap] uint64 and
// pays [2 * B * cap] fp32.  cap / passes / npasses / chunk: the host's
// plan, as for screen_topm_launch.  proxy and x: both fp32, or both bf16
// when rows_bf16.  pvec / xvec: dp / D % 4 == 0 and proxy / store aligned
// to 4 values.
RT_EXPORT int fused_candidates_launch(
    const float* qp, const void* proxy, const float* qpn, const float* pn,
    const float* q, const void* x, const float* qn, const float* xn,
    int rows_bf16, int B, int N, int dp, int D, int m, int pvec, int xvec,
    int cap, const int* passes, int npasses, int chunk, void* st, int* work,
    void* keys, float* pays, int64_t* idx_out, float* d2_out, void* stream) {
  if (B <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* k = static_cast<u64*>(keys);
  State* state = static_cast<State*>(st);
  cudaMemsetAsync(work, 0, sizeof(int) * (size_t)work_ints(B, npasses), s);
  cudaError_t err = rows_bf16
      ? launch_rows(static_cast<const bf16_t*>(proxy),
                    static_cast<const bf16_t*>(x), qp, qpn, pn, q, qn, xn, B,
                    N, dp, D, m, pvec, xvec, cap, passes, npasses, state,
                    work, k, pays, s)
      : launch_rows(static_cast<const float*>(proxy),
                    static_cast<const float*>(x), qp, qpn, pn, q, qn, xn, B,
                    N, dp, D, m, pvec, xvec, cap, passes, npasses, state,
                    work, k, pays, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sort_emit<true>(k, pays, work, B, cap, chunk, m, idx_out, d2_out, s));
}
