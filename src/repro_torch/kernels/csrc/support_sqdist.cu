// Exact re-rank distances d2[b, j] = max(||q_b||^2 + ||x_r||^2 - 2 q_b.x_r, 0)
// with r = idx[b, j]: each query against its own candidate rows of the
// store X [N, D].
//
// Replaces: src/repro/kernels/golden_rerank.py:66 (support_sqdist /
// _sqdist_kernel :33).  The JAX op first materializes x[idx]
// (ops.py:166), a [B, m, D] tensor of 2.46 GB at B=16, m=12500, D=3072;
// this kernel never does.
// Bound on the H100: bytes.  The floor is the distinct rows' bytes: at
// B=16, m=12500 the 200000 slots name 49988 rows (0.61 GB, 0.18 ms at
// 3.35 TB/s).  All B queries' dot products with a row are 2 B D FLOPs
// (4.9 GFLOP, 0.07 ms of fp32 FMA work), so the row pass stays bound by
// its loads.
// Design: the rows a batch names are read once for each group of QG=16
// queries, not once per (query, slot):
//   1. sqdist_mark: every slot marks its row in the group's map
//      (row_union.cuh); the first block of each query also computes
//      ||q_b||^2;
//   2. union_count, union_compact (row_union.cuh): the group's rows as an
//      ascending list of U rows, and each row's position in it;
//   3. sqdist_dots: a work item is a tile of 128 list rows and one of ks
//      equal shares of D's 32-column slabs, ks = dot_split (enough for
//      ITEMS items a CTA, at most KS_MAX: short lists, as at B=1, still
//      spread over the card).  Each CTA takes items from a counter until
//      none is left.  Slabs of the rows and of the group's queries
//      stream through shared memory with cp.async, STAGES - 1 slabs
//      ahead; each thread holds 4 queries x 4 rows, sums each slab apart
//      and adds the slab sums in order (fp32 error grows with the slab
//      count, not with D).  The dots go to dots [ks, G, ucap, QG] fp32.
//      Its loads bound it: chip_smoke.py prints its rate beside a plain
//      read of the store ([time] row passes);
//   4. sqdist_gather: out[b, j] = max((qn[b] + x_norms[r]) - 2 dot, 0), the
//      ks shares added in order; the plain version's formula and order,
//      so integer data (exact sums) is bit-equal to ref.support_sqdist_ref.
// fp32 throughout (no TF32).  Deterministic: no atomic decides a value.
// The bf16 instance (store rows in bf16, the engine's storage_dtype)
// stages the rows' bf16 slabs (8-byte cp.async copies of 4 values) and
// widens each value as the dot pass reads it: half the bytes, the same
// fp32 sums in the same order.
#include "row_union.cuh"

namespace {

using runion::QG;

constexpr int THREADS = 128;   // a dot CTA's threads: 4 warps
constexpr int BN = 128;        // list rows a tile: 4 a lane, strided by 32
constexpr int BK = 32;         // columns a slab
constexpr int XS = BK + 4;     // a staged row's stride: conflict-free LDS.128
constexpr int STAGES = 3;
constexpr int QPT = 4;         // queries a thread (4 warps x 4 = QG)
constexpr int RPT = BN / 32;   // rows a thread
constexpr int KS_MAX = 8;      // D shares a tile at most
constexpr int ITEMS = 4;       // work items a CTA, at least
constexpr int MARK_THREADS = 256;

template <typename T>
struct __align__(16) Stage {
  T xs[BN][XS];               // a slab of the tile's rows, as stored
  float qs[QG][BK];           // the same columns of the group's queries
};
template <typename T>
constexpr int smem_of() { return STAGES * sizeof(Stage<T>); }

// D shares of each tile for a group of U list rows on a grid of `grid`
// CTAs and `nslab` slabs: enough for ITEMS work items a CTA, at most
// KS_MAX and at most one a slab.
__host__ __device__ __forceinline__ int dot_split(int U, int grid, int nslab) {
  const int tiles = (U + BN - 1) / BN;
  if (tiles == 0) return 1;
  return max(1, min(min(KS_MAX, nslab), (ITEMS * grid + tiles - 1) / tiles));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // L2::256B: a slab reads 128 bytes of a row; the next slab's 128
  // bytes come into L2 with them
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Mark each slot's row; block x == 0 of query b also writes ||q_b||^2.
__global__ void __launch_bounds__(MARK_THREADS)
sqdist_mark(const float* __restrict__ q, const int64_t* __restrict__ idx,
            uint4* __restrict__ map, float* __restrict__ qn, int M, int N,
            int D) {
  __shared__ float scratch[33];
  const int b = blockIdx.y;
  const int j = blockIdx.x * MARK_THREADS + threadIdx.x;
  if (j < M) runion::mark(map, N, b, idx[(int64_t)b * M + j]);
  if (blockIdx.x == 0) {
    const float* qb = q + (int64_t)b * D;
    float s = 0.f;
#pragma unroll 8
    for (int c = threadIdx.x; c < D; c += MARK_THREADS) s += qb[c] * qb[c];
    s = block_reduce<false>(s, scratch);
    if (threadIdx.x == 0) qn[b] = s;
  }
}

// Copy slab k0 of the tile's rows and of the group's queries into a
// stage; rows past nr, queries past B and columns past D read as 0.
// VEC: D % 4 == 0, q 16-byte aligned and x aligned to 4 values (copies
// of 4 values: 16 bytes of fp32, 8 of bf16).
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(Stage<T>& S,
                                          const T* __restrict__ x,
                                          const float* __restrict__ q,
                                          const int64_t* rowid, int nr,
                                          int k0, int D, int B, int q0,
                                          int tid) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < BN * BK / 4 / THREADS; ++i) {
      const int e = tid + THREADS * i, r = e / (BK / 4);
      const int c = 4 * (e % (BK / 4));
      const bool ok = r < nr && k0 + c < D;
      const T* src = ok ? x + rowid[r] * D + k0 + c : x;
      if constexpr (sizeof(T) == 4)
        cp16(&S.xs[r][c], src, ok);
      else
        cp8(&S.xs[r][c], src, ok);
    }
#pragma unroll
    for (int j = 0; j < QG * BK / 4 / THREADS; ++j) {
      const int e = tid + THREADS * j, i = e / (BK / 4);
      const int c = 4 * (e % (BK / 4)), b = q0 + i;
      const bool ok = b < B && k0 + c < D;
      cp16(&S.qs[i][c], ok ? q + (int64_t)b * D + k0 + c : q, ok);
    }
  } else {
    for (int i = 0; i < BN * BK / THREADS; ++i) {
      const int e = tid + THREADS * i, r = e / BK, c = e % BK;
      const bool ok = r < nr && k0 + c < D;
      if constexpr (sizeof(T) == 4)
        cp4(&S.xs[r][c], ok ? x + rowid[r] * D + k0 + c : x, ok);
      else     // no 2-byte cp.async: a plain load and store
        S.xs[r][c] = ok ? x[rowid[r] * D + k0 + c] : T(0.f);
    }
    for (int i = 0; i < QG * BK / THREADS; ++i) {
      const int e = tid + THREADS * i, qi = e / BK, c = e % BK;
      const int b = q0 + qi;
      const bool ok = b < B && k0 + c < D;
      cp4(&S.qs[qi][c], ok ? q + (int64_t)b * D + k0 + c : q, ok);
    }
  }
}

// acc[u][r] += (this slab's dot of query 4 warp + u with row lane + 32 r).
template <typename T>
__device__ __forceinline__ void slab_dot(const Stage<T>& S,
                                         float (&acc)[QPT][RPT], int lane,
                                         int warp) {
  float sl[QPT][RPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u)
#pragma unroll
    for (int r = 0; r < RPT; ++r) sl[u][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 qv[QPT], xv[RPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u)
      qv[u] = *reinterpret_cast<const float4*>(&S.qs[4 * warp + u][kk]);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      xv[r] = lds4(&S.xs[lane + 32 * r][kk]);
#pragma unroll
    for (int u = 0; u < QPT; ++u)
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        sl[u][r] += qv[u].x * xv[r].x;
        sl[u][r] += qv[u].y * xv[r].y;
        sl[u][r] += qv[u].z * xv[r].z;
        sl[u][r] += qv[u].w * xv[r].w;
      }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u)
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[u][r] += sl[u][r];
}

// dots[p, g, s, i] = share p of q[g QG + i] . x[rows[g, s]] for the
// group's list slots s < ucount[g]; queries past B read as 0.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
sqdist_dots(const float* __restrict__ q, const T* __restrict__ x,
            const int* __restrict__ rows, const int* __restrict__ ucount,
            int* __restrict__ next, float* __restrict__ dots, int B, int D,
            int ucap, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* st = reinterpret_cast<Stage<T>*>(smem);
  __shared__ int64_t rowid[BN];
  __shared__ int item;
  const int g = blockIdx.y, q0 = g * QG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int U = ucount[g];
  const int nslab = (D + BK - 1) / BK;
  const int tiles = (U + BN - 1) / BN;
  const int ks = dot_split(U, gridDim.x, nslab);
  const int* rg = rows + (int64_t)g * ucap;

  for (;;) {                        // take work items until none is left
    if (tid == 0) item = atomicAdd(next + g, 1);
    __syncthreads();
    const int w = item;
    if (w >= tiles * ks) break;
    const int t0 = (w / ks) * BN, part = w % ks;
    const int nr = min(BN, U - t0);
    const int sb = part * nslab / ks, n = (part + 1) * nslab / ks - sb;
    for (int i = tid; i < BN; i += THREADS)
      rowid[i] = i < nr ? (int64_t)rg[t0 + i] : 0;
    __syncthreads();

    float acc[QPT][RPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u)
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[u][r] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n)
        load_slab<T, VEC>(st[s], x, q, rowid, nr, (sb + s) * BK, D, B, q0,
                          tid);
      cp_commit();
    }
    for (int i = 0; i < n; ++i) {
      cp_wait<STAGES - 2>();        // slab i has landed
      __syncthreads();              // ... for every thread; slab i - 1 is
                                    // consumed, so its stage is free
      const int nx = i + STAGES - 1;
      if (nx < n)
        load_slab<T, VEC>(st[nx % STAGES], x, q, rowid, nr, (sb + nx) * BK,
                          D, B, q0, tid);
      cp_commit();
      slab_dot(st[i % STAGES], acc, lane, warp);
    }
    float* dp = dots + ((int64_t)part * G + g) * ucap * QG;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int s = t0 + lane + 32 * r;
      if (s < t0 + nr)
        *reinterpret_cast<float4*>(dp + (int64_t)s * QG + 4 * warp) =
            make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
    }
    cp_wait<0>();
    __syncthreads();                // stages and row ids are reused
  }
}

// out[b, j] = max((qn[b] + x_norms[r]) - 2 dot(b, r), 0), r = idx[b, j].
__global__ void sqdist_gather(const int64_t* __restrict__ idx,
                              const float* __restrict__ x_norms,
                              const float* __restrict__ qn,
                              const uint4* __restrict__ map,
                              const int* __restrict__ ucount,
                              const float* __restrict__ dots,
                              float* __restrict__ out, int B, int M, int N,
                              int D, int ucap, int G, int dot_grid) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * M) return;
  const int b = (int)(e / M), g = b / QG;
  const int64_t r = idx[e];
  const int64_t s = runion::position(map, N, g, r);
  const int ks = dot_split(ucount[g], dot_grid, (D + BK - 1) / BK);
  float dot = 0.f;
  for (int p = 0; p < ks; ++p)
    dot += dots[(((int64_t)p * G + g) * ucap + s) * QG + b % QG];
  const float d2 = (qn[b] + x_norms[r]) - 2.0f * dot;
  out[e] = fmaxf(d2, 0.f);
}

// The dot pass for the rows' type T: its shared-memory attribute set
// once a device for the process, then the launch.
template <typename T>
void launch_dots(dim3 grid, cudaStream_t st, int vec, const float* q,
                 const T* x, const int* rows, const int* ucount, int* next,
                 float* dots, int B, int D, int ucap, int G) {
  constexpr int SMEM = smem_of<T>();
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(sqdist_dots<T, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cudaFuncSetAttribute(sqdist_dots<T, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (dev < 64) smem_set[dev] = true;
  }
  if (vec)
    sqdist_dots<T, true><<<grid, THREADS, SMEM, st>>>(q, x, rows, ucount,
                                                      next, dots, B, D, ucap,
                                                      G);
  else
    sqdist_dots<T, false><<<grid, THREADS, SMEM, st>>>(q, x, rows, ucount,
                                                       next, dots, B, D, ucap,
                                                       G);
}

}  // namespace

// work (int32, the host's golden_rerank.sqdist_scratch_sizes): the map
// [G, N] of 16-byte words and the dot pass's item counters [G] (both
// zeroed here), chunk counts [G, chunks], ucount [G], qn [B] (fp32), rows
// [G, ucap].  dots: [KS_MAX, G, ucap, QG] fp32.  dot_ctas: the dot pass's
// grid (golden_rerank.sqdist_plan).  x: fp32, or bf16 when x_bf16.
RT_EXPORT int support_sqdist_launch(const float* q, const void* x,
                                    int x_bf16, const float* x_norms,
                                    const int64_t* idx, float* out, int B,
                                    int M, int N, int D, int vec, int G,
                                    int ucap, int chunks, int dot_ctas,
                                    int* work, float* dots, void* stream) {
  if (B > 0 && M > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    uint4* map = reinterpret_cast<uint4*>(work);
    int* next = work + 4 * (int64_t)G * N;
    int* ccount = next + G;
    int* ucount = ccount + G * chunks;
    float* qn = reinterpret_cast<float*>(ucount + G);
    int* rows = reinterpret_cast<int*>(qn + B);
    cudaMemsetAsync(map, 0, sizeof(uint4) * (size_t)G * N + sizeof(int) * G,
                    st);
    sqdist_mark<<<dim3((M + MARK_THREADS - 1) / MARK_THREADS, B),
                  MARK_THREADS, 0, st>>>(q, idx, map, qn, M, N, D);
    runion::compact(map, ccount, rows, ucount, N, G, ucap, chunks, st);
    const dim3 grid(dot_ctas, G);
    if (x_bf16)
      launch_dots(grid, st, vec, q, static_cast<const bf16_t*>(x), rows,
                  ucount, next, dots, B, D, ucap, G);
    else
      launch_dots(grid, st, vec, q, static_cast<const float*>(x), rows,
                  ucount, next, dots, B, D, ucap, G);
    const int64_t total = (int64_t)B * M;
    sqdist_gather<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        idx, x_norms, qn, map, ucount, dots, out, B, M, N, D, ucap, G,
        dot_ctas);
  }
  return static_cast<int>(cudaGetLastError());
}
