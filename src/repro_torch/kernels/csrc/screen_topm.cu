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
// against 0.31 GFLOP (5 us of fp32 FMA work).  The bf16 instance (proxy
// rows in bf16, the engine's storage_dtype) reads 19.2 MB and widens
// each value as it loads it: the same fp32 arithmetic on the same values.
// Design: see topm_select.cuh.  The radix select reads the proxy store
// once per pass (11-bit digits; a query stops as soon as at most
// m + 2048 keys lie at or below its bin: two passes on float data, and
// none when m + 2048 >= N), most of it from L2 (the proxy store fits in
// the 50 MB L2); then one compaction pass, a sort of the at most m + 2048
// selected keys spread over B * ceil((m + 2048) / 2048) CTAs, and merge
// rounds whose last writes the first m.  Live memory is
// O(B (m + 2112 bins a pass)).
#include "topm_select.cuh"

namespace {

using namespace topm;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
compact_pass(const float* __restrict__ q, const T* __restrict__ x,
             const float* __restrict__ qn, const float* __restrict__ xn,
             int B, int N, int d, const State* __restrict__ st,
             int* __restrict__ cnt, u64* __restrict__ keys, int L) {
  __shared__ TileSmem sm;
  const int q0 = blockIdx.y * BQ, row0 = blockIdx.x * BN;
  float acc[QPT][RPT];
  tile_dot<T, VEC>(q, x, N, d, B, q0, row0, acc, sm, threadIdx.x, 0);
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

template <typename T, bool VEC>
cudaError_t screen(const float* q, const T* x, const float* qn,
                   const float* xn, int B, int N, int d, int m, int cap,
                   const int* passes, int npasses, State* st, int* work,
                   u64* keys, cudaStream_t s) {
  cudaError_t err = select_phase<T, VEC>(q, x, qn, xn, B, N, d, m, cap,
                                         passes, npasses, st, work + B, s);
  if (err != cudaSuccess) return err;
  compact_pass<T, VEC><<<dim3((N + BN - 1) / BN, (B + BQ - 1) / BQ),
                          THREADS, 0, s>>>(q, x, qn, xn, B, N, d, st, work,
                                           keys, cap);
  return cudaGetLastError();
}

}  // namespace

// Scratch, all from the caller: st [B] State (24 bytes each), work
// [B + npasses * (ceil(B/16) + B * 2112)] int32 (counters, tickets,
// histograms; the entry point clears it), keys [2 * B * cap] uint64.
// The host's plan: cap, the keys a query may select (screen.select_cap:
// min(m + 2048, N)); passes, npasses (shift, width) pairs in host memory (none
// when cap >= N); chunk, the sort's chunk (screen.radix_plan,
// screen.sort_plan).  x: fp32, or bf16 when x_bf16; vec: d % 4 == 0 and
// x aligned to 4 values.
RT_EXPORT int screen_topm_launch(const float* q, const void* x, int x_bf16,
                                 const float* qn, const float* xn, int B,
                                 int N, int d, int m, int vec, int cap,
                                 const int* passes, int npasses, int chunk,
                                 void* st, int* work, void* keys,
                                 int64_t* idx_out, float* d2_out,
                                 void* stream) {
  if (B <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* k = static_cast<u64*>(keys);
  State* state = static_cast<State*>(st);
  cudaMemsetAsync(work, 0, sizeof(int) * (size_t)work_ints(B, npasses), s);
  const float* xf = static_cast<const float*>(x);
  const bf16_t* xh = static_cast<const bf16_t*>(x);
  cudaError_t err;
  if (x_bf16)
    err = vec ? screen<bf16_t, true>(q, xh, qn, xn, B, N, d, m, cap, passes,
                                     npasses, state, work, k, s)
              : screen<bf16_t, false>(q, xh, qn, xn, B, N, d, m, cap,
                                      passes, npasses, state, work, k, s);
  else
    err = vec ? screen<float, true>(q, xf, qn, xn, B, N, d, m, cap, passes,
                                    npasses, state, work, k, s)
              : screen<float, false>(q, xf, qn, xn, B, N, d, m, cap, passes,
                                     npasses, state, work, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sort_emit<false>(k, nullptr, work, B, cap, chunk,
                                           m, idx_out, d2_out, s));
}
