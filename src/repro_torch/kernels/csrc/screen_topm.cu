// Streamed exact coarse screen: the m nearest proxy rows of each query,
//   (idx, d2) [B, m], d2 = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0)
// ascending, ties to the lowest row (lax.top_k's order), with no [B, N]
// distance matrix.
//
// Replaces: src/repro/kernels/screen.py:151 (screen_topm_pallas /
// _screen_kernel :90, _merge_topm :71).  Kept from the TPU kernel: the
// clamped matmul-form fp32 distance, the tie order, and its slot
// semantics: a +inf-norm row never takes a slot from its initial carry,
// so every slot whose distance is +inf (and every slot past N when
// m > N) carries d2 = +inf and row 0.
// Bound on the H100: bytes.  At B=16, N=50000, dp=192 the proxy store is
// 38.4 MB and the outputs 1.6 MB (m=12500), about 12 us at 3.35 TB/s,
// against 0.31 GFLOP (5 us of fp32 FMA work).
// Design: see topm_select.cuh.  The radix select reads the proxy store
// once per pass (4 to 6 passes at N=50000, fewer when every query's
// m-th key is isolated early), so this first kernel reads several times
// the bound's bytes, most of them from L2 (the proxy store fits in the
// 50 MB L2); then one compaction pass, a per-query bitonic sort of the
// m selected keys, and the emit.  Live memory is O(B (m + 256 passes)).
#include "topm_select.cuh"

namespace {

using namespace topm;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
compact_pass(const float* __restrict__ qT, const float* __restrict__ x,
             const float* __restrict__ qn, const float* __restrict__ xn,
             int B, int N, int d, int Bp, const State* __restrict__ st,
             int* __restrict__ cnt, u64* __restrict__ keys, int L) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.y * BQ, row0 = blockIdx.x * BN;
  float acc[QPT][RPT];
  tile_dot<VEC>(qT, x, N, d, Bp, q0, row0, acc, sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool sel[QPT][RPT];
  u64 key[QPT][RPT];
  float unused[QPT][RPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int b = q0 + 4 * warp + i;
    const bool live = b < B;
    const u64 thr = live ? st[b].thr : 0;
    const float qnb = live ? qn[b] : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + lane + 32 * r;
      sel[i][r] = false;
      key[i][r] = 0;
      unused[i][r] = 0.f;
      if (live && row < N) {
        key[i][r] = dist_key(clamped_d2(qnb, xn[row], acc[i][r]), row);
        sel[i][r] = key[i][r] <= thr;
      }
    }
  }
  compact_write<false>(sel, key, unused, B, q0, L, cnt, keys, nullptr);
}

template <bool VEC>
void screen(const float* q, const float* x, const float* qn, const float* xn,
            int B, int N, int d, int m, float* qT, State* st, int* hist,
            int* cnt, u64* keys, int L, cudaStream_t s) {
  select_phase<VEC>(q, x, qn, xn, B, N, d, m, qT, st, hist, s);
  const int Bp = (B + BQ - 1) / BQ * BQ;
  compact_pass<VEC><<<dim3((N + BN - 1) / BN, Bp / BQ), THREADS, 0, s>>>(
      qT, x, qn, xn, B, N, d, Bp, st, cnt, keys, L);
}

}  // namespace

// Scratch, all from the caller: qT [d * ceil(B/16)*16] fp32, st [B]
// State (24 bytes each), hist [MAX_PASSES * B * 256] int32, cnt [B]
// int32, keys [B * L] uint64 with L the power of two >= min(m, N).  The
// entry point clears hist, cnt and keys itself.
RT_EXPORT int screen_topm_launch(const float* q, const float* x,
                                 const float* qn, const float* xn, int B,
                                 int N, int d, int m, int vec, float* qT,
                                 void* st, int* hist, int* cnt, void* keys,
                                 int L, int64_t* idx_out, float* d2_out,
                                 void* stream) {
  if (B <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* k = static_cast<u64*>(keys);
  State* state = static_cast<State*>(st);
  cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)MAX_PASSES * B * 256, s);
  cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)B, s);
  cudaMemsetAsync(k, 0xff, sizeof(u64) * (size_t)B * L, s);
  if (vec)
    screen<true>(q, x, qn, xn, B, N, d, m, qT, state, hist, cnt, k, L, s);
  else
    screen<false>(q, x, qn, xn, B, N, d, m, qT, state, hist, cnt, k, L, s);
  cudaError_t err = sort_keys<false>(k, nullptr, B, L, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  emit<false><<<dim3((m + 255) / 256, B), 256, 0, s>>>(k, nullptr, L, m,
                                                       idx_out, d2_out);
  return static_cast<int>(cudaGetLastError());
}
