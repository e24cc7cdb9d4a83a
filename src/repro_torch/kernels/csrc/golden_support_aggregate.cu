// Golden aggregate out[b] = sum_j softmax(logits[b])_j * X[idx[b, j]],
// written as acc / max(l, 1e-30) with l the softmax denominator; rows
// are loaded by index straight from the store X [N, D].
//
// Replaces: src/repro/kernels/golden_support_aggregate.py:78
// (golden_support_aggregate / _sagg_kernel :30).  The TPU kernel carries
// an online (max, l, acc) state from one grid step to the next; Hopper
// blocks run in no order, so nothing can be carried between them.
// Bound on the H100: bytes.  The floor is the distinct rows' bytes: at
// B=16, k=5000 the 80000 golden slots name 48070 rows (0.59 GB, 0.18 ms
// at 3.35 TB/s), against 2 FLOPs per (query, slot, column).
// Design: the rows a batch names are read once for each group of QG=16
// queries, not once per (query, slot):
//   1. sagg_mark: every slot marks its row (row_union.cuh); block x == 0
//      of each query reduces its k logits to max (starting at NEG_INF,
//      as the TPU kernel) and l = sum exp(logit - max), in a fixed order;
//   2. union_count, union_compact (row_union.cuh): the group's U rows as
//      an ascending list, and each row's position in it;
//   3. sagg_tally, sagg_weigh: each slot's weight exp(logit - max) is
//      computed once and added to W [G, ucap, QG] at (its row's
//      position, its query).  A row that one query names several times
//      (m > N surplus slots, which carry a clamped index; random indices)
//      gets one weight per slot, as the plain version's bmm over x[idx]
//      does.  Exclusive-writer scheme, so the sum does not depend on the
//      order of atomics: the tally counts each (query, row)'s slots;
//      a single slot stores its weight, two slots add theirs with
//      atomicAdd onto 0 (a + b == b + a exactly), and of three or more
//      one slot (the first to bump the tally's visit count) sums all of
//      them in slot order and stores the sum;
//   4. sagg_rows: CTA (slice, tile) takes 512 columns (a float4 a
//      thread) and tile's share of the U list rows, [t U / T, (t+1) U / T)
//      (real rows only); it streams each row's slice from HBM once and
//      accumulates acc[b] += W[b, row] x_row for the group's 16 queries
//      in registers, LOADS rows' loads in flight a thread; the tile's
//      weights and row ids go through shared memory 64 rows at a time.
//      The partial sums go to part [T, B, D];
//   5. sagg_merge: out[b, c] = (sum over tiles in order) / max(l, 1e-30).
// The state entry (golden_support_aggregate_state_launch) runs the same
// passes and writes (acc, m, l) undivided instead: a store shard's
// softmax state, which shards merge by log-sum-exp (the sharded engine).
// NEG_INF logits get weight exp(NEG_INF - max) = 0; an all-NEG_INF query
// has max = NEG_INF and weight 1 everywhere, which is the uniform mean.
// Deterministic: two calls give bit-equal outputs.  The bf16 instance
// (store rows in bf16, the engine's storage_dtype) loads each row slice
// as 4 bf16 (8 bytes) and widens it: half the row bytes, the same fp32
// sums in the same order.
#include "row_union.cuh"

namespace {

using runion::QG;

constexpr int THREADS = 256;     // mark, tally and weigh blocks
constexpr int ROW_THREADS = 128; // a row-pass CTA: 4 columns each
constexpr int SLICE = 4 * ROW_THREADS;   // columns a row-pass CTA
constexpr int BATCH = 64;        // rows whose weights a CTA stages at once
constexpr int LOADS = 8;         // row slices a thread has in flight
typedef unsigned long long u64;

// Mark each slot's row; block x == 0 of query b writes (max, l).
__global__ void __launch_bounds__(THREADS)
sagg_mark(const int64_t* __restrict__ idx, const float* __restrict__ logits,
          uint4* __restrict__ map, float2* __restrict__ stat, int K, int N) {
  __shared__ float scratch[33];
  const int b = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j < K) runion::mark(map, N, b, idx[(int64_t)b * K + j]);
  if (blockIdx.x == 0) {
    const float* lg = logits + (int64_t)b * K;
    float m = RT_NEG_INF;
#pragma unroll 8
    for (int i = threadIdx.x; i < K; i += THREADS) m = fmaxf(m, lg[i]);
    m = block_reduce<true>(m, scratch);
    float l = 0.f;
#pragma unroll 8
    for (int i = threadIdx.x; i < K; i += THREADS) l += expf(lg[i] - m);
    l = block_reduce<false>(l, scratch);
    if (threadIdx.x == 0) stat[b] = make_float2(m, l);
  }
}

// tally[g, pos(r), b % QG] += 1 for each slot: the low 32 bits count the
// (query, row)'s slots, the high 32 bits count sagg_weigh's visits.
__global__ void __launch_bounds__(THREADS)
sagg_tally(const int64_t* __restrict__ idx, const uint4* __restrict__ map,
           u64* __restrict__ tally, int K, int N, int ucap) {
  const int b = blockIdx.y, g = b / QG;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= K) return;
  const int64_t r = idx[(int64_t)b * K + j];
  const int64_t s = runion::position(map, N, g, r);
  atomicAdd(tally + ((int64_t)g * ucap + s) * QG + b % QG, 1ull);
}

// W[g, pos(r), b % QG] = the sum of the weights of query b's slots that
// name r (see the header: one writer, or two commuting adds).
__global__ void __launch_bounds__(THREADS)
sagg_weigh(const int64_t* __restrict__ idx, const float* __restrict__ logits,
           const uint4* __restrict__ map, const float2* __restrict__ stat,
           u64* __restrict__ tally, float* __restrict__ W, int K, int N,
           int ucap) {
  const int b = blockIdx.y, g = b / QG;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= K) return;
  const int64_t* ib = idx + (int64_t)b * K;
  const float* lg = logits + (int64_t)b * K;
  const float m = stat[b].x;
  const int64_t r = ib[j];
  const int64_t e =
      ((int64_t)g * ucap + runion::position(map, N, g, r)) * QG + b % QG;
  const unsigned c = (unsigned)tally[e];       // final: tally has ended
  const float w = expf(lg[j] - m);
  if (c == 1u) {
    W[e] = w;
  } else if (c == 2u) {
    atomicAdd(W + e, w);
  } else if ((atomicAdd(tally + e, 1ull << 32) >> 32) == 0ull) {
    float s = 0.f;
    for (int i = 0; i < K; ++i)
      if (ib[i] == r) s += expf(lg[i] - m);
    W[e] = s;
  }
}

// part[t, b, c..c+3] = sum over the tile's list rows s of
// W[g, s, b] * x[rows[g, s], c..c+3] for the group's queries b.
template <typename XT, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
sagg_rows(const XT* __restrict__ x, const int* __restrict__ rows,
          const int* __restrict__ ucount, const float* __restrict__ W,
          float* __restrict__ part, int B, int D, int ucap) {
  __shared__ float4 ws[BATCH][QG / 4];
  __shared__ int64_t rs[BATCH];
  const int g = blockIdx.z, q0 = g * QG, t = blockIdx.y, T = gridDim.y;
  const int c = blockIdx.x * SLICE + 4 * threadIdx.x;
  const int nc = max(0, min(4, D - c));
  const int64_t U = ucount[g];
  const int s0 = (int)(t * U / T), s1 = (int)((t + 1) * U / T);
  const int* rg = rows + (int64_t)g * ucap;
  const float4* wg = reinterpret_cast<const float4*>(W + (int64_t)g * ucap * QG);

  float4 acc[QG];
#pragma unroll
  for (int i = 0; i < QG; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = s0; base < s1; base += BATCH) {
    const int nb = min(BATCH, s1 - base);
    __syncthreads();              // the last batch's reads are done
    for (int e = threadIdx.x; e < nb * (QG / 4); e += ROW_THREADS)
      ws[e / (QG / 4)][e % (QG / 4)] = __ldg(wg + (int64_t)base * (QG / 4) + e);
    for (int e = threadIdx.x; e < nb; e += ROW_THREADS)
      rs[e] = rg[base + e];
    __syncthreads();
    if (nc == 0) continue;
    for (int u0 = 0; u0 < nb; u0 += LOADS) {
      // LOADS rows' slices in flight at once, as loaded (VEC; widened
      // below, after every load of the batch is issued)
      typename Raw4<XT>::type raw[LOADS];
      float4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        raw[u] = typename Raw4<XT>::type{};
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u0 + u < nb) {
          const XT* xr = x + rs[u0 + u] * D + c;
          if (VEC) {
            raw[u] = ldg_raw4(xr);
          } else {
            v[u].x = ldg1(xr);
            if (nc > 1) v[u].y = ldg1(xr + 1);
            if (nc > 2) v[u].z = ldg1(xr + 2);
            if (nc > 3) v[u].w = ldg1(xr + 3);
          }
        }
      }
      if (VEC)
#pragma unroll
        for (int u = 0; u < LOADS; ++u) v[u] = widen4(raw[u]);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (u0 + u >= nb) break;
#pragma unroll
        for (int i4 = 0; i4 < QG / 4; ++i4) {
          const float4 w = ws[u0 + u][i4];
          const float wi[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float4& a = acc[4 * i4 + k];
            a.x += wi[k] * v[u].x; a.y += wi[k] * v[u].y;
            a.z += wi[k] * v[u].z; a.w += wi[k] * v[u].w;
          }
        }
      }
    }
  }
  if (nc == 0) return;
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    const int b = q0 + i;
    if (b >= B) break;
    float* o = part + ((int64_t)t * B + b) * D + c;
    if (VEC) {
      *reinterpret_cast<float4*>(o) = acc[i];
    } else {
      o[0] = acc[i].x;
      if (nc > 1) o[1] = acc[i].y;
      if (nc > 2) o[2] = acc[i].z;
      if (nc > 3) o[3] = acc[i].w;
    }
  }
}

// out[b, c] = (sum over tiles t in order of part[t, b, c]) / max(l_b, 1e-30);
// the state entry (STATE) writes the sum itself and each query's (max, l)
// to m_out / l_out instead of dividing.
template <bool STATE>
__global__ void sagg_merge(const float* __restrict__ part,
                           const float2* __restrict__ stat,
                           float* __restrict__ out, float* __restrict__ m_out,
                           float* __restrict__ l_out, int B, int D, int T) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t bd = (int64_t)B * D;
  if (e >= bd) return;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += part[t * bd + e];
  if (!STATE) {
    out[e] = s / fmaxf(stat[e / D].y, 1e-30f);
    return;
  }
  out[e] = s;
  if (e % D == 0) {
    m_out[e / D] = stat[e / D].x;
    l_out[e / D] = stat[e / D].y;
  }
}

// the row pass for the rows' type T
template <typename T>
void launch_rows(dim3 grid, cudaStream_t st, int vec, const T* x,
                 const int* rows, const int* ucount, const float* W,
                 float* part, int B, int D, int ucap) {
  if (vec)
    sagg_rows<T, true><<<grid, ROW_THREADS, 0, st>>>(x, rows, ucount, W,
                                                     part, B, D, ucap);
  else
    sagg_rows<T, false><<<grid, ROW_THREADS, 0, st>>>(x, rows, ucount, W,
                                                      part, B, D, ucap);
}

// The whole pipeline; m_out == nullptr: the mean, else the state entry.
int run(const void* x, int x_bf16, const int64_t* idx, const float* logits,
        float* out, float* m_out, float* l_out, int B, int K, int N, int D,
        int vec, int G, int ucap, int chunks, int tiles, void* zero,
        int* work, float* part, cudaStream_t st) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0) {                        // an empty softmax: zeros
    if (m_out != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)B * D, st);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t cells = (size_t)G * ucap * QG;
  u64* tally = static_cast<u64*>(zero);
  float* W = reinterpret_cast<float*>(tally + cells);
  uint4* map = reinterpret_cast<uint4*>(W + cells);
  float2* stat = reinterpret_cast<float2*>(work);
  int* ccount = work + 2 * B;
  int* ucount = ccount + G * chunks;
  int* rows = ucount + G;
  cudaMemsetAsync(zero, 0, cells * (sizeof(u64) + sizeof(float)) +
                               sizeof(uint4) * (size_t)G * N, st);
  const dim3 slots((K + THREADS - 1) / THREADS, B);
  sagg_mark<<<slots, THREADS, 0, st>>>(idx, logits, map, stat, K, N);
  runion::compact(map, ccount, rows, ucount, N, G, ucap, chunks, st);
  sagg_tally<<<slots, THREADS, 0, st>>>(idx, map, tally, K, N, ucap);
  sagg_weigh<<<slots, THREADS, 0, st>>>(idx, logits, map, stat, tally, W, K,
                                        N, ucap);
  const dim3 grid((D + SLICE - 1) / SLICE, tiles, G);
  if (x_bf16)
    launch_rows(grid, st, vec, static_cast<const bf16_t*>(x), rows, ucount,
                W, part, B, D, ucap);
  else
    launch_rows(grid, st, vec, static_cast<const float*>(x), rows, ucount, W,
                part, B, D, ucap);
  const int64_t total = (int64_t)B * D;
  const unsigned mblocks = (unsigned)((total + 255) / 256);
  if (m_out == nullptr)
    sagg_merge<false><<<mblocks, 256, 0, st>>>(part, stat, out, nullptr,
                                               nullptr, B, D, tiles);
  else
    sagg_merge<true><<<mblocks, 256, 0, st>>>(part, stat, out, m_out, l_out,
                                              B, D, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// zero (the host's golden_support_aggregate.scratch_sizes, zeroed here):
// tally [G, ucap, QG] u64, W [G, ucap, QG] fp32, the map [G, N] of
// 16-byte words.
// work (int32): stat [B] (max, l) as fp32 pairs, chunk counts
// [G, chunks], ucount [G], rows [G, ucap].  part: [T, B, D] fp32, T = tiles.
// x: fp32, or bf16 when x_bf16; vec: D % 4 == 0 and x aligned to 4 values.
RT_EXPORT int golden_support_aggregate_launch(
    const void* x, int x_bf16, const int64_t* idx, const float* logits,
    float* out, int B, int K, int N, int D, int vec, int G, int ucap,
    int chunks, int tiles, void* zero, int* work, float* part,
    void* stream) {
  return run(x, x_bf16, idx, logits, out, nullptr, nullptr, B, K, N, D, vec,
             G, ucap, chunks, tiles, zero, work, part,
             static_cast<cudaStream_t>(stream));
}

// The state entry: the same passes, then acc [B, D] (the unnormalized
// weighted sum), m [B] (the max logit, from NEG_INF) and l [B] (the
// softmax denominator) for a log-sum-exp merge across store shards.  K >= 1.
RT_EXPORT int golden_support_aggregate_state_launch(
    const void* x, int x_bf16, const int64_t* idx, const float* logits,
    float* acc, float* m, float* l, int B, int K, int N, int D, int vec,
    int G, int ucap, int chunks, int tiles, void* zero, int* work,
    float* part, void* stream) {
  if (m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, x_bf16, idx, logits, acc, m, l, B, K, N, D, vec, G, ucap,
             chunks, tiles, zero, work, part,
             static_cast<cudaStream_t>(stream));
}
