// Exact top-m selection by composite key, shared by screen_topm.cu and
// fused_candidates.cu.
//
// Every (query b, row j) pair gets the 64-bit key
//   key = (bits(d2) << 32) | j,   d2 = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0)
// For non-negative fp32 the bit pattern is monotone in the value, so the
// m smallest keys of a query are lax.top_k's m nearest rows in its order
// (ties to the lowest row), whatever the tiling.  Rows with a +inf norm
// get d2 = +inf and sort after every finite row.
//
// The TPU kernels carry a [bq, m] top-m in VMEM across a sequential grid.
// At m = 12500 that carry is 100-150 KB per query, which Hopper's 227 KB
// of shared memory cannot hold for a block of queries, and Hopper's
// blocks run in parallel with no carry between them.  So the selection
// is a radix select instead, with no [B, N] buffer:
//   1. histogram passes: each pass recomputes the tile distances, and
//      every key whose resolved high bits equal the query's prefix adds
//      one to the bin of its next 8 bits; a small kernel then picks the
//      bin that holds the query's m-th key.  Four passes resolve the
//      distance bits, and one more per byte of the row index resolves
//      ties.  A query is done as soon as its bin holds exactly the keys
//      it still needs, and later passes skip it;
//   2. a compaction pass writes the m keys <= the threshold (and, in
//      the fused kernel, the exact distance beside each) into a [B, L]
//      buffer, L = the next power of two >= min(m, N), in any order;
//   3. a bitonic sort per query (in shared memory up to 16384 keys,
//      with global merge steps above that), and an emit kernel.
// Distances are recomputed bit-identically in every pass: all passes
// call the same tile_dot and dist_key.
#pragma once

#include "common.cuh"

namespace topm {

typedef unsigned long long u64;

constexpr int BQ = 16;         // queries per block: 4 per warp
constexpr int BN = 128;        // rows per tile: 4 per lane, strided by 32
constexpr int BK = 32;         // columns staged in shared memory per step
constexpr int THREADS = 128;
constexpr int QPT = 4;         // queries per thread
constexpr int RPT = 4;         // rows per thread
constexpr int SORT_CAP = 16384;     // keys one block sorts in shared memory
constexpr int SORT_THREADS = 1024;
constexpr int MAX_PASSES = 8;       // 4 distance bytes + up to 4 index bytes
constexpr u64 KEY_PAD = ~0ull;      // empty slot: sorts last
constexpr unsigned INF_BITS = 0x7f800000u;

struct State {      // one per query
  u64 prefix;       // resolved high bits of the m-th key
  u64 thr;          // once done: the query selects every key <= thr
  int need;         // keys still to take inside the prefix's bin
  int done;
};

struct __align__(16) TileSmem {
  float xs[BK][BN + 1];   // row tile, transposed; +1 against bank conflicts
  float qs[BK][BQ];       // query tile, transposed
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

// acc[i][r] = q[q0 + 4*warp + i] . x[row0 + lane + 32*r] over d columns.
// qT is the query block transposed and zero-padded: [d][Bp], Bp a
// multiple of BQ.  Rows past N read as 0 (their keys are masked by the
// caller).  VEC: d % 4 == 0 and x 16-byte aligned, so a row slab is read
// with float4 loads, prefetched into registers one slab ahead.
template <bool VEC>
__device__ __forceinline__ void tile_dot(const float* __restrict__ qT,
                                         const float* __restrict__ x, int N,
                                         int d, int Bp, int q0, int row0,
                                         float (&acc)[QPT][RPT],
                                         TileSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[i][r] = 0.f;

  float4 xv[8];       // VEC: this thread's share of the next row slab
  float qv[4];        // its share of the next query slab
  auto load = [&](int k0) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + THREADS * i, r = e >> 3, c = k0 + 4 * (e & 7);
        const int gr = row0 + r;
        xv[i] = (gr < N && c < d)
                    ? __ldg(reinterpret_cast<const float4*>(
                          x + (int64_t)gr * d + c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + THREADS * i, c = k0 + (e >> 4);
      qv[i] = c < d ? qT[(int64_t)c * Bp + q0 + (e & 15)] : 0.f;
    }
  };
  auto store = [&](int k0) {
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + THREADS * i, r = e >> 3, c = 4 * (e & 7);
        sm.xs[c][r] = xv[i].x;
        sm.xs[c + 1][r] = xv[i].y;
        sm.xs[c + 2][r] = xv[i].z;
        sm.xs[c + 3][r] = xv[i].w;
      }
    } else {
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + THREADS * i, r = e >> 5, c = e & 31;
        const int gr = row0 + r, gc = k0 + c;
        sm.xs[c][r] = (gr < N && gc < d) ? __ldg(x + (int64_t)gr * d + gc)
                                         : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + THREADS * i;
      sm.qs[e >> 4][e & 15] = qv[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    store(k0);
    __syncthreads();
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
    __syncthreads();
  }
}

// qT[c][b] = q[b][c] for b < B, 0 for the padding queries up to Bp.
__global__ void transpose_queries(const float* __restrict__ q,
                                  float* __restrict__ qT, int B, int d,
                                  int Bp) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)d * Bp) return;
  const int c = (int)(e / Bp), b = (int)(e % Bp);
  qT[e] = b < B ? q[(int64_t)b * d + c] : 0.f;
}

__global__ void init_state(State* st, int B, int m, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  st[b].prefix = 0;
  st[b].thr = KEY_PAD;
  st[b].need = m;
  st[b].done = m >= N;        // every row is selected
}

// Is any query of this block's group still selecting?  (block-uniform)
__device__ __forceinline__ bool group_active(const State* st, int B, int q0,
                                             int* flag) {
  if (threadIdx.x == 0) {
    int any = 0;
    for (int b = q0; b < min(B, q0 + BQ); ++b) any |= !st[b].done;
    *flag = any;
  }
  __syncthreads();
  return *flag != 0;
}

// One radix pass: the histogram of key bits [shift, shift + 8) over the
// keys inside each active query's resolved prefix.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hist_pass(const float* __restrict__ qT, const float* __restrict__ x,
          const float* __restrict__ qn, const float* __restrict__ xn, int B,
          int N, int d, int Bp, const State* __restrict__ st,
          int* __restrict__ hist, int shift) {
  __shared__ TileSmem sm;
  __shared__ int sh[BQ][256];
  __shared__ int flag;
  const int q0 = blockIdx.y * BQ, row0 = blockIdx.x * BN;
  if (!group_active(st, B, q0, &flag)) return;
  for (int e = threadIdx.x; e < BQ * 256; e += THREADS) (&sh[0][0])[e] = 0;
  float acc[QPT][RPT];
  tile_dot<VEC>(qT, x, N, d, Bp, q0, row0, acc, sm);   // syncs sh too
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int qi = 4 * warp + i, b = q0 + qi;
    const bool live = b < B && !st[b].done;
    const u64 prefix = live ? st[b].prefix : 0;
    const float qnb = live ? qn[b] : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + lane + 32 * r;
      int bin = -1;
      if (live && row < N) {
        const u64 key = dist_key(clamped_d2(qnb, xn[row], acc[i][r]), row);
        if (same_above(key, prefix, shift + 8)) bin = (int)((key >> shift) & 255);
      }
      // lanes with the same bin add once
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sh[qi][bin], __popc(peers));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BQ * 256; e += THREADS) {
    const int c = (&sh[0][0])[e], b = q0 + (e >> 8);
    if (c != 0 && b < B) atomicAdd(&hist[(int64_t)b * 256 + (e & 255)], c);
  }
}

// One block of 256 threads per query: the bin of the query's m-th key.
__global__ void __launch_bounds__(256)
select_bin(const int* __restrict__ hist, State* st, int shift) {
  __shared__ int warp_tot[8];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (st[b].done) return;                       // block-uniform
  const int need = st[b].need;     // read by all before any thread writes
  const int c = hist[(int64_t)b * 256 + t];
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[w] = incl;
  __syncthreads();
  for (int i = 0; i < w; ++i) incl += warp_tot[i];
  const int excl = incl - c;
  if (excl < need && need <= incl) {            // exactly one thread
    const u64 prefix = st[b].prefix | ((u64)t << shift);
    const int left = need - excl;
    st[b].prefix = prefix;
    st[b].need = left;
    if (c == left) {
      st[b].thr = prefix | (shift ? ((1ull << shift) - 1) : 0ull);
      st[b].done = 1;
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

// Bitonic sort of each query's L keys (L a power of two), ascending.
// Compare-exchange of the pair (i, i + j) inside merge stage k.
template <bool PAY>
__device__ __forceinline__ void cmpx(u64* k, float* p, int i, int j,
                                     bool asc) {
  const u64 a = k[i], c = k[i + j];
  if ((a > c) == asc) {
    k[i] = c;
    k[i + j] = a;
    if (PAY) {
      const float t = p[i];
      p[i] = p[i + j];
      p[i + j] = t;
    }
  }
}

// One chunk of C keys in shared memory.  kmerge == 0: every stage with
// k <= C (the chunks come out sorted in alternating directions);
// otherwise the stages j = C/2 .. 1 of merge stage kmerge.
template <bool PAY>
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_chunk(u64* __restrict__ keys, float* __restrict__ pays, int L, int C,
              int kmerge) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sk = reinterpret_cast<u64*>(smem);
  float* sp = reinterpret_cast<float*>(sk + C);
  const int b = blockIdx.y, c0 = blockIdx.x * C;
  const int64_t base = (int64_t)b * L + c0;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sk[i] = keys[base + i];
    if (PAY) sp[i] = pays[base + i];
  }
  __syncthreads();
  const int kb = kmerge ? kmerge : 2, ke = kmerge ? kmerge : C;
  for (int k = kb; k <= ke; k <<= 1) {
    for (int j = (kmerge ? C : k) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < C / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        cmpx<PAY>(sk, sp, i, j, ((c0 + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    keys[base + i] = sk[i];
    if (PAY) pays[base + i] = sp[i];
  }
}

template <bool PAY>
__global__ void bitonic_step(u64* __restrict__ keys, float* __restrict__ pays,
                             int L, int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L / 2) return;
  const int64_t base = (int64_t)blockIdx.y * L;
  const int i = 2 * t - (t & (j - 1));
  cmpx<PAY>(keys + base, PAY ? pays + base : nullptr, i, j, (i & k) == 0);
}

template <bool PAY>
cudaError_t sort_keys(u64* keys, float* pays, int B, int L,
                      cudaStream_t s) {
  if (L < 2) return cudaSuccess;
  const int C = L < SORT_CAP ? L : SORT_CAP;
  const size_t smem = (size_t)C * (sizeof(u64) + (PAY ? sizeof(float) : 0));
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_chunk<PAY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = C / 2 < SORT_THREADS ? C / 2 : SORT_THREADS;
  bitonic_chunk<PAY><<<dim3(L / C, B), threads, smem, s>>>(keys, pays, L, C,
                                                            0);
  for (int k = 2 * C; k <= L; k <<= 1) {
    for (int j = k >> 1; j >= C; j >>= 1)
      bitonic_step<PAY><<<dim3((L / 2 + 255) / 256, B), 256, 0, s>>>(
          keys, pays, L, k, j);
    bitonic_chunk<PAY><<<dim3(L / C, B), threads, smem, s>>>(keys, pays, L,
                                                              C, k);
  }
  return cudaGetLastError();
}

// Slots past the selection (m > N) and slots whose key distance is +inf
// carry d2 = +inf and row 0, as the TPU kernel's initial carry does.
// PAY: the emitted distance is the payload (the exact d2), else the
// key's own distance.
template <bool PAY>
__global__ void emit(const u64* __restrict__ keys,
                     const float* __restrict__ pays, int L, int m,
                     int64_t* __restrict__ idx_out,
                     float* __restrict__ d2_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= m) return;
  const int64_t src = (int64_t)b * L + i, dst = (int64_t)b * m + i;
  const u64 key = i < L ? keys[src] : KEY_PAD;
  const unsigned u = (unsigned)(key >> 32);
  if (key == KEY_PAD || u == INF_BITS) {
    idx_out[dst] = 0;
    d2_out[dst] = __uint_as_float(INF_BITS);
  } else {
    idx_out[dst] = (int64_t)(unsigned)key;
    d2_out[dst] = PAY ? pays[src] : __uint_as_float(u);
  }
}

// The byte shifts of the radix passes for N rows: the four distance
// bytes, then the index bytes that N - 1 needs.  Returns the count.
inline int pass_shifts(int N, int* shifts) {
  int p = 0;
  for (int s = 56; s >= 32; s -= 8) shifts[p++] = s;
  int bits = 0;
  for (unsigned v = (unsigned)(N - 1); v; v >>= 1) ++bits;
  for (int s = 8 * ((bits + 7) / 8 - 1); s >= 0; s -= 8) shifts[p++] = s;
  return p;
}

// The select phase over the proxy rows (x, xn): init, then the radix
// passes.  qT is written here from q.  hist holds MAX_PASSES * B * 256
// ints and must be zero.
template <bool VEC>
void select_phase(const float* q, const float* x, const float* qn,
                  const float* xn, int B, int N, int d, int m, float* qT,
                  State* st, int* hist, cudaStream_t s) {
  const int Bp = (B + BQ - 1) / BQ * BQ;
  const int64_t nq = (int64_t)d * Bp;
  transpose_queries<<<(unsigned)((nq + 255) / 256), 256, 0, s>>>(q, qT, B, d,
                                                                  Bp);
  init_state<<<(B + 255) / 256, 256, 0, s>>>(st, B, m, N);
  if (m >= N) return;
  int shifts[MAX_PASSES];
  const int np = pass_shifts(N, shifts);
  const dim3 grid((N + BN - 1) / BN, Bp / BQ);
  for (int p = 0; p < np; ++p) {
    int* h = hist + (int64_t)p * B * 256;
    hist_pass<VEC><<<grid, THREADS, 0, s>>>(qT, x, qn, xn, B, N, d, Bp, st,
                                            h, shifts[p]);
    select_bin<<<B, 256, 0, s>>>(h, st, shifts[p]);
  }
}

}  // namespace topm
