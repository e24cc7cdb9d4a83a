// Exact top-m selection by composite key, shared by screen_topm.cu and
// fused_candidates.cu.
//
// Every (query b, row j) pair gets the 64-bit key
//   key = (bits(d2) << 32) | j,   d2 = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0)
// For non-negative fp32 the bit pattern is monotone in the value, so the
// m smallest keys of a query are lax.top_k's m nearest rows in its order
// (ties to the lowest row), whatever the tiling.  Rows with a +inf norm
// get d2 = +inf and sort after every finite row.  Keys are unique (the
// row sits in the low 32 bits), so any correct ascending sort gives the
// reference's order: no sort below needs to be stable.
//
// The TPU kernels carry a [bq, m] top-m in VMEM across a sequential grid.
// At m = 12500 that carry is 100-150 KB per query, which Hopper's 227 KB
// of shared memory cannot hold for a block of queries, and Hopper's
// blocks run in parallel with no carry between them.  So the selection
// is a radix select instead, with no [B, N] buffer:
//   1. radix passes (radix_pass): each pass recomputes the tile
//      distances, and every key whose resolved high bits equal the
//      query's prefix adds one to the bin of its next digit, in a
//      privatized 2048-bin histogram per query in shared memory (two
//      16-bit counts a word: 64 KB for 16 queries), one block an SM
//      working on three row tiles at once (391 tiles at N=50000: three
//      an SM, as many as the 128-thread compaction blocks give it).  The
//      digits come from the host's plan (screen.radix_plan): bit 63 is
//      always 0, so three digits of 11, 11 and 9 bits resolve the
//      distance, and one 11-bit digit per 11 bits of N - 1 resolves ties
//      by row.  The last block of each query group to finish (an atomic
//      ticket) picks, from a 64-group coarse histogram and then the 32
//      fine bins of one group, the bin that holds each query's m-th key:
//      one launch a pass.  A pass costs a read of the store, and a sort
//      of a chunk more keys costs far less, so the select over-selects:
//      a query is done as soon as the keys below its bin and in it
//      number at most `cap` (the host's screen.select_cap, m + 2048 at
//      most N), and from then on it selects all of them.  On float data
//      the second pass (22 bits resolved: bins 2^-14 of a power of two
//      wide) is the last.  Later passes skip a done query, a pass whose queries are
//      all done returns at once (so the row passes cost a launch unless
//      a tie spans more than the slack), and when cap reaches N no pass
//      runs at all;
//   2. a compaction pass writes the (at most cap) keys <= the threshold
//      (and, in the fused kernel, the exact distance beside each) into a
//      [B, cap] buffer, in any order;
//   3. the sort (sort_emit) of those keys, of which the first m are the
//      answer: chunks of up to 2048 keys, B * ceil(cap / 2048) CTAs at
//      once (128 at B=16, m=12500: many CTAs a query, so the sort fills
//      the card), each a bitonic network with the stages inside 8
//      consecutive keys in registers and the rest in shared memory; then
//      ceil(log2(chunks)) merge-path rounds, in which every CTA merges one
//      fixed 2048-key slice of the output, found by a warp's 32-way
//      search over the two runs.  The last round computes only the first
//      m slots and writes (idx, d2) directly: no emit launch.
// Distances are recomputed bit-identically in every pass: all passes
// call the same tile_dot and dist_key.
#pragma once

#include "common.cuh"

namespace topm {

typedef unsigned long long u64;

constexpr int BQ = 16;         // queries per tile: 4 per warp
constexpr int BN = 128;        // rows per tile: 4 per lane, strided by 32
constexpr int BK = 32;         // columns staged in shared memory per step
constexpr int THREADS = 128;   // threads per tile
constexpr int QPT = 4;         // queries per thread
constexpr int RPT = 4;         // rows per thread
constexpr int RADIX_BITS = 11;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int GROUP = 32;                  // fine bins per coarse group
constexpr int COARSE = BINS / GROUP;       // 64
constexpr int HIST_STRIDE = BINS + COARSE; // ints of histogram per query
constexpr int STRIPS = 3;      // tiles in flight per radix block
constexpr int RADIX_THREADS = STRIPS * THREADS;
constexpr int HIST_SMEM = BQ * BINS * 2;   // bytes: 16-bit counts
constexpr int MAX_TILES = 65535 / BN - STRIPS;  // tiles a radix block
                                                 // takes at most
constexpr int MAX_PASSES = 6;  // 3 distance digits + up to 3 row digits
constexpr int SORT_CHUNK = 2048;   // keys one CTA sorts in shared memory
constexpr int SORT_ITEMS = 8;      // consecutive keys a sorting thread holds
constexpr int MERGE_TILE = 2048;   // outputs one CTA merges
constexpr int MERGE_THREADS = 256;
constexpr int ITEMS = MERGE_TILE / MERGE_THREADS;
constexpr u64 KEY_PAD = ~0ull;      // empty slot: sorts last
constexpr unsigned INF_BITS = 0x7f800000u;

struct State {      // one per query
  u64 prefix;       // resolved high bits of the m-th key
  u64 thr;          // once done: the query selects every key <= thr
  int need;         // keys still to take inside the prefix's bin
  int done;         // at most cap keys are <= thr, the m smallest among them
};

struct __align__(16) TileSmem {
  float xs[BK][BN + 1];   // row tile, transposed; +1 against bank conflicts
  float qs[BK][BQ + 4];   // query tile, transposed; +4 keeps float4
                          // rows aligned and spreads their stores
};

__device__ __forceinline__ unsigned dist_bits(float d) {
  unsigned u = __float_as_uint(d);
  return u == 0x80000000u ? 0u : u;     // -0.0 sorts as +0.0
}

__device__ __forceinline__ float clamped_d2(float qn, float xn, float dot) {
  return fmaxf((qn + xn) - 2.0f * dot, 0.f);
}

__device__ __forceinline__ u64 dist_key(float d2, int row) {
  return ((u64)dist_bits(d2) << 32) | (unsigned)row;
}

// high bits of a and b above bit s agree (s = 64: nothing resolved yet)
__device__ __forceinline__ bool same_above(u64 a, u64 b, int s) {
  return s >= 64 || (a >> s) == (b >> s);
}

// Barrier of the THREADS threads of one tile: `bar` 0 in a block of
// THREADS threads (where it is __syncthreads), 1 + strip in a radix block.
__device__ __forceinline__ void tile_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(THREADS) : "memory");
}

// acc[i][r] = q[q0 + 4*warp + i] . x[row0 + lane + 32*r] over d columns,
// for the tile's thread tid in [0, THREADS).  q is [B, d] fp32, x [N, d]
// fp32 or bf16 (T; widened as it is loaded); queries past B and rows past
// N read as 0 (their keys are masked by the caller).  VEC: d % 4 == 0
// and x aligned to 4 values, so a row slab is read 4 values a load (16
// bytes of fp32, 8 of bf16), prefetched into registers one slab ahead.
template <typename T, bool VEC>
__device__ __forceinline__ void tile_dot(const float* __restrict__ q,
                                         const T* __restrict__ x, int N,
                                         int d, int B, int q0, int row0,
                                         float (&acc)[QPT][RPT],
                                         TileSmem& sm, int tid, int bar) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[i][r] = 0.f;

  typename Raw4<T>::type xv[8];  // VEC: this thread's share of the next
                                 // row slab, as loaded (widened at store)
  float qv[4];        // its share of the next query slab: 4 queries of
                      // one column
  auto load = [&](int k0) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + THREADS * i, r = e >> 3, c = k0 + 4 * (e & 7);
        const int gr = row0 + r;
        xv[i] = (gr < N && c < d) ? ldg_raw4(x + (int64_t)gr * d + c)
                                  : typename Raw4<T>::type{};
      }
    }
    const int c = k0 + lane;        // a warp reads 32 columns of a row
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = q0 + 4 * warp + u;
      qv[u] = (b < B && c < d) ? __ldg(q + (int64_t)b * d + c) : 0.f;
    }
  };
  auto store = [&](int k0) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + THREADS * i, r = e >> 3, c = 4 * (e & 7);
        const float4 v = widen4(xv[i]);
        sm.xs[c][r] = v.x;
        sm.xs[c + 1][r] = v.y;
        sm.xs[c + 2][r] = v.z;
        sm.xs[c + 3][r] = v.w;
      }
    } else {
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + THREADS * i, r = e >> 5, c = e & 31;
        const int gr = row0 + r, gc = k0 + c;
        sm.xs[c][r] = (gr < N && gc < d) ? ldg1(x + (int64_t)gr * d + gc)
                                         : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&sm.qs[lane][4 * warp]) =
        make_float4(qv[0], qv[1], qv[2], qv[3]);
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    store(k0);
    tile_sync(bar);
    if (k0 + BK < d) load(k0 + BK);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 q4 = *reinterpret_cast<const float4*>(&sm.qs[k][4 * warp]);
      float xr[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) xr[r] = sm.xs[k][lane + 32 * r];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[0][r] += q4.x * xr[r];
        acc[1][r] += q4.y * xr[r];
        acc[2][r] += q4.z * xr[r];
        acc[3][r] += q4.w * xr[r];
      }
    }
    tile_sync(bar);
  }
}

// cap >= N: no radix pass runs, and every row is selected.
__global__ void select_all(State* st, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    st[b].thr = KEY_PAD;
    st[b].done = 1;
  }
}

// Inclusive sum over the warp.
__device__ __forceinline__ int warp_incl(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// One radix pass over bits [shift, shift + width) for one group of BQ
// queries (blockIdx.y): the histogram of the keys inside each live
// query's prefix, then, in the group's last block, the bin of each
// query's m-th key; the query is done once the keys below that bin and
// in it are at most cap.  first: the first pass, which reads no state
// (prefix 0, m keys needed).  hist [B][HIST_STRIDE] (fine bins, then
// coarse groups) and tickets [groups] start at zero.  Each strip of
// THREADS threads takes every STRIPS-th tile; rows per block stay below
// 65536, so a 16-bit count cannot overflow.
template <typename T, bool VEC>
__global__ void __launch_bounds__(RADIX_THREADS)
radix_pass(const float* __restrict__ q, const T* __restrict__ x,
           const float* __restrict__ qn, const float* __restrict__ xn,
           int B, int N, int d, int m, int cap, State* __restrict__ st,
           int* __restrict__ hist, int* __restrict__ tickets, int shift,
           int width, int first) {
  // [BQ][BINS / 2] words of two 16-bit counts, then a TileSmem a strip
  extern __shared__ __align__(16) unsigned hs[];
  TileSmem* sm = reinterpret_cast<TileSmem*>(hs + HIST_SMEM / 4);
  __shared__ u64 pre[BQ];
  __shared__ int live[BQ];
  __shared__ int last;
  const int tid = threadIdx.x, strip = tid / THREADS, ht = tid % THREADS;
  const int lane = tid & 31, hw = ht >> 5;
  const int q0 = blockIdx.y * BQ;
  bool on = false;
  if (tid < BQ) {
    const int b = q0 + tid;
    on = b < B && (first || !st[b].done);
    live[tid] = on;
    pre[tid] = (on && !first) ? st[b].prefix : 0;
  }
  if (!__syncthreads_or(on)) return;          // every query of the group done
  uint4* h4 = reinterpret_cast<uint4*>(hs);
  for (int e = tid; e < HIST_SMEM / 16; e += RADIX_THREADS)
    h4[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int ntiles = (N + BN - 1) / BN, top = shift + width;
  const unsigned mask = (1u << width) - 1u;
  for (int t = STRIPS * blockIdx.x + strip; t < ntiles;
       t += STRIPS * gridDim.x) {
    const int row0 = t * BN;
    float acc[QPT][RPT];
    tile_dot<T, VEC>(q, x, N, d, B, q0, row0, acc, sm[strip], ht,
                     1 + strip);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qi = 4 * hw + i, b = q0 + qi;
      const bool qon = live[qi];
      const u64 prefix = pre[qi];
      const float qnb = qon ? qn[b] : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = row0 + lane + 32 * r;
        int bin = -1;
        if (qon && row < N) {
          const u64 key = dist_key(clamped_d2(qnb, xn[row], acc[i][r]), row);
          if (same_above(key, prefix, top))
            bin = (int)((unsigned)(key >> shift) & mask);
        }
        if (__ballot_sync(0xffffffffu, bin >= 0)) {
          // lanes with the same bin add once
          const unsigned peers = __match_any_sync(0xffffffffu, bin);
          if (bin >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&hs[qi * (BINS / 2) + (bin >> 1)],
                      (unsigned)__popc(peers) << (16 * (bin & 1)));
        }
      }
    }
  }
  __syncthreads();

  // flush: one coarse group (32 bins, 4 uint4) of one query a step
  for (int e = tid; e < BQ * COARSE; e += RADIX_THREADS) {
    const int qi = e / COARSE, g = e % COARSE;
    if (!live[qi]) continue;
    int* hb = hist + (int64_t)(q0 + qi) * HIST_STRIDE;
    const uint4* w = h4 + qi * (BINS / 8) + g * (GROUP / 8);
    int tot = 0;
#pragma unroll
    for (int v = 0; v < GROUP / 8; ++v) {
      const uint4 u = w[v];
      const unsigned ws[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bin = g * GROUP + 8 * v + 2 * k;
        const int lo = (int)(ws[k] & 0xffffu), hi = (int)(ws[k] >> 16);
        if (lo) atomicAdd(&hb[bin], lo);
        if (hi) atomicAdd(&hb[bin + 1], hi);
        tot += lo + hi;
      }
    }
    if (tot) atomicAdd(&hb[BINS + g], tot);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the group's last block: each warp picks the bin of its queries
  const int warp = tid >> 5;
  for (int qi = warp; qi < BQ; qi += RADIX_THREADS / 32) {
    if (!live[qi]) continue;                  // warp-uniform
    const int b = q0 + qi;
    const int* hb = hist + (int64_t)b * HIST_STRIDE;
    const int need = first ? m : st[b].need;
    const int c0 = __ldcg(hb + BINS + 2 * lane);
    const int c1 = __ldcg(hb + BINS + 2 * lane + 1);
    const int incl = warp_incl(c0 + c1), excl = incl - c0 - c1;
    const int src = __ffs(__ballot_sync(0xffffffffu,
                                        excl < need && need <= incl)) - 1;
    int base = __shfl_sync(0xffffffffu, excl, src);
    const int c0s = __shfl_sync(0xffffffffu, c0, src);
    int g = 2 * src;
    if (need > base + c0s) {
      base += c0s;
      ++g;
    }
    const int c = __ldcg(hb + g * GROUP + lane);
    const int fin = base + warp_incl(c), fex = fin - c;
    if (fex < need && need <= fin) {          // exactly one lane
      const int left = need - fex;    // the m-th key's rank in the bin
      const u64 p = pre[qi] | ((u64)(g * GROUP + lane) << shift);
      const bool done = m - left + c <= cap;    // below the bin + in it
      st[b].prefix = p;
      st[b].need = left;
      st[b].done = done;
      st[b].thr = done ? (p | ((1ull << shift) - 1ull)) : KEY_PAD;
    }
  }
}

// Write the selected keys (and payloads) of one (query, 128 rows) tile
// into the query's buffer at positions taken from its counter.  sel and
// key are per (query slot i, row slot r) of the calling thread.
template <bool PAY>
__device__ __forceinline__ void compact_write(
    const bool (&sel)[QPT][RPT], const u64 (&key)[QPT][RPT],
    const float (&pay)[QPT][RPT], int B, int q0, int L,
    int* __restrict__ cnt, u64* __restrict__ keys, float* __restrict__ pays) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int b = q0 + 4 * warp + i;
    unsigned ball[RPT];
    int tot = 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      ball[r] = __ballot_sync(0xffffffffu, sel[i][r]);
      tot += __popc(ball[r]);
    }
    if (tot == 0) continue;                     // warp-uniform
    int base = 0;
    if (lane == 0) base = atomicAdd(&cnt[b], tot);
    base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (sel[i][r]) {
        const int pos = base + __popc(ball[r] & lt);
        if (pos < L) {
          keys[(int64_t)b * L + pos] = key[i][r];
          if (PAY) pays[(int64_t)b * L + pos] = pay[i][r];
        }
      }
      base += __popc(ball[r]);
    }
  }
}

// Slots past the selection (m > N) and slots whose key distance is +inf
// carry d2 = +inf and row 0, as the TPU kernel's initial carry does.
// PAY: the emitted distance is the payload (the exact d2), else the
// key's own distance.
template <bool PAY>
__device__ __forceinline__ void emit_slot(u64 key, float pay,
                                          int64_t* __restrict__ idx_out,
                                          float* __restrict__ d2_out,
                                          int64_t dst) {
  const unsigned u = (unsigned)(key >> 32);
  if (key == KEY_PAD || u == INF_BITS) {
    idx_out[dst] = 0;
    d2_out[dst] = __uint_as_float(INF_BITS);
  } else {
    idx_out[dst] = (int64_t)(unsigned)key;
    d2_out[dst] = PAY ? pay : __uint_as_float(u);
  }
}

// Compare-exchange of the keys in shared-memory slots i < j.
template <bool PAY>
__device__ __forceinline__ void cmpx(u64* k, float* p, int i, int j,
                                     bool asc) {
  const u64 a = k[i], c = k[j];
  if ((a > c) == asc) {
    k[i] = c;
    k[j] = a;
    if (PAY) {
      const float t = p[i];
      p[i] = p[j];
      p[j] = t;
    }
  }
}

// Shared-memory slot of position i in a chunk: each thread's SORT_ITEMS
// consecutive keys, rotated by its index, so that the threads of a warp
// reading their e-th keys hit different banks (a 64-byte stride would
// put 16 of them on one bank); a warp's 32 consecutive positions still
// cover 32 consecutive slots.
__device__ __forceinline__ int slot(int i) {
  return i ^ ((i / SORT_ITEMS) & (SORT_ITEMS - 1));
}

// One stage (pairs J apart) of the bitonic network on the SORT_ITEMS
// consecutive keys a thread holds from position e0; kk: the merge size,
// which sets each pair's direction.
template <bool PAY, int J>
__device__ __forceinline__ void reg_stage(u64 (&k)[SORT_ITEMS],
                                          float (&p)[SORT_ITEMS], int e0,
                                          int kk) {
#pragma unroll
  for (int e = 0; e < SORT_ITEMS; ++e) {
    if ((e & J) == 0) {
      const u64 a = k[e], c = k[e + J];
      const bool sw = (a > c) == (((e0 + e) & kk) == 0);
      k[e] = sw ? c : a;
      k[e + J] = sw ? a : c;
      if (PAY) {
        const float pa = p[e], pc = p[e + J];
        p[e] = sw ? pc : pa;
        p[e + J] = sw ? pa : pc;
      }
    }
  }
}

// Sort one chunk of `chunk` keys (a power of two, 64 to SORT_CHUNK;
// chunk / SORT_ITEMS threads) of query blockIdx.y ascending.  keys /
// pays: [B, cap], of which the first cnt[b] are the query's selection;
// the rest read as KEY_PAD, which sorts last.  A bitonic network: every
// stage whose pairs lie inside a thread's SORT_ITEMS consecutive keys
// runs in registers, the wider ones in shared memory.  The sorted chunk
// goes to (okeys, opays) at the same place, or, when one chunk holds the
// whole query (final), its first m keys straight to the output slots.
template <bool PAY>
__global__ void __launch_bounds__(SORT_CHUNK / SORT_ITEMS)
sort_chunks(const u64* keys, const float* pays, const int* __restrict__ cnt,
            int cap, int chunk, u64* okeys, float* opays, int m, int final_,
            int64_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ u64 sk[SORT_CHUNK];
  __shared__ float sp[PAY ? SORT_CHUNK : 1];
  const int t = threadIdx.x, nt = blockDim.x, b = blockIdx.y;
  const int c0 = blockIdx.x * chunk, n = min(chunk, cap - c0);
  const int valid = min(cnt[b], cap) - c0;
  const int64_t base = (int64_t)b * cap + c0;
  for (int i = t; i < chunk; i += nt) {
    sk[slot(i)] = i < valid ? keys[base + i] : KEY_PAD;
    if (PAY) sp[slot(i)] = i < valid ? pays[base + i] : 0.f;
  }
  __syncthreads();
  const int e0 = SORT_ITEMS * t;
  u64 rk[SORT_ITEMS];
  float rp[SORT_ITEMS];
#pragma unroll
  for (int e = 0; e < SORT_ITEMS; ++e) {
    rk[e] = sk[slot(e0 + e)];
    rp[e] = PAY ? sp[slot(e0 + e)] : 0.f;
  }
  for (int kk = 2; kk <= chunk; kk <<= 1) {
    if (kk >= 2 * SORT_ITEMS) {
      // stages SORT_ITEMS apart or more: through shared memory
#pragma unroll
      for (int e = 0; e < SORT_ITEMS; ++e) {
        sk[slot(e0 + e)] = rk[e];
        if (PAY) sp[slot(e0 + e)] = rp[e];
      }
      __syncthreads();
      for (int j = kk >> 1; j >= SORT_ITEMS; j >>= 1) {
        for (int q = t; q < chunk / 2; q += nt) {
          const int i = 2 * q - (q & (j - 1));
          cmpx<PAY>(sk, sp, slot(i), slot(i + j), (i & kk) == 0);
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < SORT_ITEMS; ++e) {
        rk[e] = sk[slot(e0 + e)];
        if (PAY) rp[e] = sp[slot(e0 + e)];
      }
    }
    if (kk >= 8) reg_stage<PAY, 4>(rk, rp, e0, kk);
    if (kk >= 4) reg_stage<PAY, 2>(rk, rp, e0, kk);
    reg_stage<PAY, 1>(rk, rp, e0, kk);
  }
#pragma unroll
  for (int e = 0; e < SORT_ITEMS; ++e) {      // own slots: no barrier before
    sk[slot(e0 + e)] = rk[e];
    if (PAY) sp[slot(e0 + e)] = rp[e];
  }
  __syncthreads();
  if (final_) {
    for (int i = t; i < m; i += nt)
      emit_slot<PAY>(i < n ? sk[slot(i)] : KEY_PAD,
                     (PAY && i < n) ? sp[slot(i)] : 0.f, idx_out, d2_out,
                     (int64_t)b * m + i);
  } else {
    for (int i = t; i < n; i += nt) {
      okeys[base + i] = sk[slot(i)];
      if (PAY) opays[base + i] = sp[slot(i)];
    }
  }
}

// How many of the first k keys of merge(a[0:la], b[0:lb]) come from a:
// the smallest i in [max(0, k - lb), min(k, la)] with i == min(k, la) or
// a[i] >= b[k - i - 1], so equal keys (only KEY_PAD repeats) come from b
// first, as merge_round's sequential step takes them.  One thread.
__device__ __forceinline__ int merge_split(const u64* a, int la, const u64* b,
                                           int lb, int k) {
  int lo = max(0, k - lb), hi = min(k, la);
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (a[i] < b[k - i - 1]) lo = i + 1;
    else hi = i;
  }
  return lo;
}

// The same split found by one warp over global memory: each step probes
// 32 evenly spaced candidates and keeps the interval between the last
// false and the first true, so a run of w keys takes ~log32(w) steps of
// one load latency each.  Every lane returns the split.
__device__ __forceinline__ int warp_merge_split(const u64* a, int la,
                                                const u64* b, int lb, int k) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, k - lb), hi = min(k, la);
  while (lo < hi) {
    const int step = (hi - lo + 30) / 31;       // lane 31 probes hi
    const int i = min(lo + lane * step, hi);
    const bool t = i == hi || __ldcg(a + i) >= __ldcg(b + k - i - 1);
    const int f = __ffs(__ballot_sync(0xffffffffu, t)) - 1;
    const int nhi = min(lo + f * step, hi);
    if (f > 0) lo = lo + (f - 1) * step + 1;
    hi = nhi;
  }
  return lo;
}

// One merge round: runs of w sorted keys (the last may be short) of
// each query's S = cap keys merge pairwise into runs of 2w.  CTA
// blockIdx.x writes outputs [o0, o0 + MERGE_TILE) of query blockIdx.y:
// warps 0 and 1 find where the slice starts and ends in the two runs, the
// CTA loads those keys into shared memory, and each thread merges ITEMS
// consecutive outputs from its own split.  final: the round that leaves
// one run; only its first m slots are computed, and written to the
// outputs (slots past S, when m > N, as empty).
template <bool PAY>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_round(const u64* __restrict__ keys, const float* __restrict__ pays,
            int S, int w, u64* __restrict__ okeys, float* __restrict__ opays,
            int m, int final_, int64_t* __restrict__ idx_out,
            float* __restrict__ d2_out) {
  __shared__ u64 sk[MERGE_TILE];
  __shared__ float sp[PAY ? MERGE_TILE : 1];
  __shared__ int split[2];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int o0 = blockIdx.x * MERGE_TILE;
  if (o0 >= S) {                  // final only: slots past N
    for (int i = o0 + tid; i < min(m, o0 + MERGE_TILE); i += MERGE_THREADS)
      emit_slot<PAY>(KEY_PAD, 0.f, idx_out, d2_out, (int64_t)b * m + i);
    return;
  }
  const int64_t qb = (int64_t)b * S;
  const int p0 = o0 / (2 * w) * (2 * w);     // the pair's first slot
  const int la = min(w, S - p0), lb = max(0, min(w, S - p0 - w));
  const u64* A = keys + qb + p0;
  const u64* Bk = A + la;                    // lb > 0 only when la == w
  const int k0 = o0 - p0, k1 = min(k0 + MERGE_TILE, la + lb);
  if (tid < 64) {
    const int s = warp_merge_split(A, la, Bk, lb, tid < 32 ? k0 : k1);
    if ((tid & 31) == 0) split[tid >> 5] = s;
  }
  __syncthreads();
  const int a0 = split[0], b0 = k0 - a0;
  const int na = split[1] - a0, n = k1 - k0, nb = n - na;
  for (int i = tid; i < n; i += MERGE_THREADS) {
    const bool fa = i < na;
    const int64_t src = fa ? p0 + a0 + i : p0 + la + b0 + (i - na);
    sk[i] = keys[qb + src];
    if (PAY) sp[i] = pays[qb + src];
  }
  __syncthreads();
  const int kt = min(ITEMS * tid, n);
  int ia = merge_split(sk, na, sk + na, nb, kt), ib = kt - ia;
  u64 rk[ITEMS];
  float rp[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (kt + j < n) {
      const bool ta = ib >= nb || (ia < na && sk[ia] < sk[na + ib]);
      const int s = ta ? ia++ : na + ib++;
      rk[j] = sk[s];
      if (PAY) rp[j] = sp[s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (kt + j < n) {
      sk[kt + j] = rk[j];
      if (PAY) sp[kt + j] = rp[j];
    }
  }
  __syncthreads();
  if (final_) {
    for (int i = tid; i < min(m - o0, MERGE_TILE); i += MERGE_THREADS)
      emit_slot<PAY>(i < n ? sk[i] : KEY_PAD, (PAY && i < n) ? sp[i] : 0.f,
                     idx_out, d2_out, (int64_t)b * m + o0 + i);
  } else {
    for (int i = tid; i < n; i += MERGE_THREADS) {
      okeys[qb + o0 + i] = sk[i];
      if (PAY) opays[qb + o0 + i] = sp[i];
    }
  }
}

// Sort each query's selected keys (the first cnt[b] of its cap slots in
// keys / pays, [B, cap]) and write the first m to the output slots.
// chunk: the host's plan (screen.sort_plan).  keys / pays hold 2 B cap
// slots: the runs alternate between the halves.
template <bool PAY>
cudaError_t sort_emit(u64* keys, float* pays, const int* cnt, int B, int cap,
                      int chunk, int m, int64_t* idx_out, float* d2_out,
                      cudaStream_t s) {
  if (chunk < 8 * SORT_ITEMS || chunk > SORT_CHUNK || (chunk & (chunk - 1)))
    return cudaErrorInvalidValue;
  int rounds = 0;
  for (int w = chunk; w < cap; w <<= 1) ++rounds;
  const int64_t half = (int64_t)B * cap;
  u64* buf_k[2] = {keys, keys + half};
  float* buf_p[2] = {pays, PAY ? pays + half : nullptr};
  const bool one = rounds == 0;
  const int nchunks = (cap + chunk - 1) / chunk;
  sort_chunks<PAY><<<dim3(nchunks, B), chunk / SORT_ITEMS, 0, s>>>(
      keys, pays, cnt, cap, chunk, one ? nullptr : keys,
      one ? nullptr : pays, m, one, idx_out, d2_out);
  int cur = 0, w = chunk;
  for (int r = 1; r <= rounds; ++r, w <<= 1) {
    const bool fin = r == rounds;
    const int tiles = ((fin ? m : cap) + MERGE_TILE - 1) / MERGE_TILE;
    merge_round<PAY><<<dim3(tiles, B), MERGE_THREADS, 0, s>>>(
        buf_k[cur], buf_p[cur], cap, w, fin ? nullptr : buf_k[cur ^ 1],
        fin ? nullptr : buf_p[cur ^ 1], m, fin, idx_out, d2_out);
    cur ^= 1;
  }
  return cudaGetLastError();
}

// The select phase over the proxy rows (x, xn; x fp32 or bf16): the radix
// passes of the host's plan (passes[2 p], passes[2 p + 1] = shift,
// width), or, with no pass (cap >= N), every row.  work: tickets
// [npasses][groups], then hist [npasses][B][HIST_STRIDE], all zero.
template <typename T, bool VEC>
cudaError_t select_phase(const float* q, const T* x, const float* qn,
                         const float* xn, int B, int N, int d, int m, int cap,
                         const int* passes, int npasses, State* st,
                         int* work, cudaStream_t s) {
  if (npasses == 0) {
    select_all<<<(B + 255) / 256, 256, 0, s>>>(st, B);
    return cudaGetLastError();
  }
  if (npasses > MAX_PASSES || cap < m || cap >= N)
    return cudaErrorInvalidValue;
  const int smem = HIST_SMEM + STRIPS * (int)sizeof(TileSmem);
  cudaError_t err = cudaFuncSetAttribute(
      radix_pass<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (B + BQ - 1) / BQ;
  const int ntiles = (N + BN - 1) / BN;
  // one block an SM (its shared memory allows no second), never more
  // blocks than strips of tiles, nor more than MAX_TILES tiles a block
  int gx = sms;
  const int least = (ntiles + MAX_TILES - 1) / MAX_TILES;
  if (gx < least) gx = least;
  if (gx > (ntiles + STRIPS - 1) / STRIPS) gx = (ntiles + STRIPS - 1) / STRIPS;
  int* tickets = work;
  int* hist = work + (int64_t)npasses * groups;
  for (int p = 0; p < npasses; ++p) {
    radix_pass<T, VEC><<<dim3(gx, groups), RADIX_THREADS, smem, s>>>(
        q, x, qn, xn, B, N, d, m, cap, st,
        hist + (int64_t)p * B * HIST_STRIDE, tickets + p * groups,
        passes[2 * p], passes[2 * p + 1], p == 0);
  }
  return cudaGetLastError();
}

// Ints of the zeroed work buffer: counters [B], then select_phase's.
inline int64_t work_ints(int B, int npasses) {
  return B + (int64_t)npasses * ((B + BQ - 1) / BQ + (int64_t)B * HIST_STRIDE);
}

}  // namespace topm
