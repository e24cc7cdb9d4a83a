// The batch's row map, shared by support_sqdist.cu and
// golden_support_aggregate.cu: the set of store rows that at least one
// query of a group names, as an ascending list, so that a row pass
// reads each such row from HBM once for the whole group.
//
// At B=16 the queries of a GoldDiff step share most of their rows
// (200000 re-rank slots name 49988 distinct rows, 80000 golden slots
// 48070), so a kernel that loads rows per (query, slot) reads each row
// 2-4 times.  The map takes three launches and reads no count back to
// the host; every buffer is sized up front by the host's plan
// (golden_rerank.union_plan) from ucap = min(N, min(B, QG) * slots):
//   1. mark (each kernel's own, since each does more in that launch):
//      every (query b, slot) pair sets byte b % QG of its row's 16-byte
//      word in map [G, N] (G = ceil(B / QG) query groups), a plain store;
//   2. union_count: per group and chunk of CHUNK rows, the number of
//      marked rows (__syncthreads_count);
//   3. union_compact: each chunk's CTA sums the earlier chunks' counts
//      and writes its marked rows, in ascending order, with a warp
//      ballot, to rows [G, ucap]; it writes each marked row's slot in
//      that list (its position) into the word's first 4 bytes; the
//      last chunk writes the group's count U to ucount [G].
// The list is the same on every call (no atomics decide a position), so
// a row pass over it sums in a fixed order.  A row pass takes slots
// [0, U) only: it never scans N and skips.
#pragma once

#include "common.cuh"

namespace runion {

constexpr int QG = 16;          // queries a group: the bytes of a map word
constexpr int CHUNK = 512;      // rows one counting / compacting CTA takes
constexpr int CTHREADS = 256;

// The row map: one 16-byte word [G, N] a (group, row), byte b % QG set
// when query b names the row.  Marking is a plain byte store: the
// queries of a group write different bytes of a shared row's word, so no
// atomic is needed and the word does not depend on the order.
__device__ __forceinline__ void mark(uint4* __restrict__ map, int N, int b,
                                     int64_t r) {
  reinterpret_cast<unsigned char*>(map + (int64_t)(b / QG) * N + r)[b % QG] = 1;
}

__device__ __forceinline__ bool marked(uint4 w) {
  return (w.x | w.y | w.z | w.w) != 0u;
}

// A marked row's position in its group's list, once union_compact has
// written it into the word's first 4 bytes.
__device__ __forceinline__ unsigned position(const uint4* __restrict__ map,
                                             int N, int g, int64_t r) {
  return reinterpret_cast<const unsigned*>(map + (int64_t)g * N + r)[0];
}

// Block-wide int sum (CTHREADS threads); every thread gets the result.
__device__ __forceinline__ int block_sum_int(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < CTHREADS / 32; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// ccount[g, c] = marked rows of group g (blockIdx.y) in chunk c
// (blockIdx.x).
__global__ void __launch_bounds__(CTHREADS)
union_count(const uint4* __restrict__ map, int* __restrict__ ccount, int N,
            int chunks) {
  const int g = blockIdx.y, r0 = blockIdx.x * CHUNK;
  const uint4* mg = map + (int64_t)g * N;
  int n = 0;
  for (int r = r0 + threadIdx.x; r < r0 + CHUNK; r += CTHREADS)
    n += __syncthreads_count(r < N && marked(mg[r]));
  if (threadIdx.x == 0) ccount[g * chunks + blockIdx.x] = n;
}

// Write chunk blockIdx.x's marked rows of group blockIdx.y to the
// group's list at their ascending positions, and each one's position
// into its word.
__global__ void __launch_bounds__(CTHREADS)
union_compact(uint4* __restrict__ map, const int* __restrict__ ccount,
              int* __restrict__ rows, int* __restrict__ ucount, int N,
              int ucap, int chunks) {
  __shared__ int scratch[CTHREADS / 32];
  __shared__ int wsum[CTHREADS / 32];
  const int g = blockIdx.y, c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int i = threadIdx.x; i < c; i += CTHREADS) base += ccount[g * chunks + i];
  base = block_sum_int(base, scratch);

  uint4* mg = map + (int64_t)g * N;
  int* rg = rows + (int64_t)g * ucap;
  const int r1 = min(N, (c + 1) * CHUNK);
  for (int r0 = c * CHUNK; r0 < r1; r0 += CTHREADS) {   // uniform
    const int r = r0 + threadIdx.x;
    const bool f = r < r1 && marked(mg[r]);
    const unsigned ball = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wsum[warp] = __popc(ball);
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < CTHREADS / 32; ++w) {
      off += w < warp ? wsum[w] : 0;
      tot += wsum[w];
    }
    if (f) {
      const int s = base + off + __popc(ball & ((1u << lane) - 1u));
      rg[s] = r;
      reinterpret_cast<unsigned*>(mg + r)[0] = (unsigned)s;
    }
    base += tot;
    __syncthreads();              // wsum is rewritten next round
  }
  if (c == chunks - 1 && threadIdx.x == 0) ucount[g] = base;
}

// Launch the count and the compaction (after the caller's mark).
inline void compact(uint4* map, int* ccount, int* rows, int* ucount, int N,
                    int G, int ucap, int chunks, cudaStream_t st) {
  const dim3 grid(chunks, G);
  union_count<<<grid, CTHREADS, 0, st>>>(map, ccount, N, chunks);
  union_compact<<<grid, CTHREADS, 0, st>>>(map, ccount, rows, ucount, N, ucap,
                                           chunks);
}

}  // namespace runion
