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
//
// Design: one pass over the store.  Each store row is copied from
// device memory into shared memory once per call for a group of up to
// 16 queries, and both products, the logits S = Q X^T and the weighted
// sum O += P X, read it there; nothing re-reads the store from L2.
//  - D is split across a thread block cluster of C CTAs (the host plan,
//    kernels/golden_aggregate.py: C = 1, 2, 4, 8 or 16 so that a CTA's
//    slice is at most 768 columns; 16 is a non-portable cluster size and
//    a card that refuses it fails the launch).  A CTA's 8 warps each own
//    8 KW columns of the slice (KW = slice / 64): the group's queries
//    there as MMA A fragments and the 16 queries' accumulators there as
//    MMA C fragments, both in registers.  The CTA streams its slice of
//    each 16-row tile through a ring of STAGES stages, one TMA bulk copy
//    a row (each warp issues two), completing on the stage's mbarrier.
//  - Both products run on the tensor cores, 3xTF32 (dist_tile.cuh, the
//    stage kernel 1 shares): CUDA-core FMAs at 16 queries wait on
//    shared-memory reads (2 floats a FMA where the SM reads 1 for 4).
//  - Each warp's partial dots of a tile go to shared memory and add in
//    warp order; each CTA sends its sums into every CTA of the cluster
//    with st.async (distributed shared memory), completing on the
//    receiver's mbarrier, and every CTA adds the C ranks' sums in rank
//    order from its own shared memory, so all CTAs of a cluster hold
//    bit-identical logits and so identical softmax states and weights
//    (the debug output checks this).
//  - A relaxed cluster barrier a tile paces the CTAs: a CTA sends tile
//    t + 2 into the buffer and mbarrier of tile t only after every CTA
//    arrived for tile t + 1, which each does after its wait for tile t,
//    so two tiles' sums never mix.  (barrier.cluster.arrive.release, which
//    would order the sums itself, waits every tile for the thread's
//    outstanding memory operations.)
//  - The online softmax runs per query on a half-warp (16 rows, shuffle
//    max and sum).  A CTA adds the previous tile's weighted rows between
//    sending its sums and waiting for the others'; so the ring holds the
//    previous tile, the current one and STAGES - 2 tiles in flight.
//  - N is split across the clusters (the plan sizes the grid to the
//    clusters the card keeps resident); a second kernel merges their
//    (max, l, acc) states by log-sum-exp in split order: two calls are
//    bit-equal.  B > 16 takes one grid row of clusters a group of 16
//    queries, side by side: each group reads the store once.
// What bounds it: the loads, unless the products and the per-tile chain
// (the warps' sum, the ranks' exchange, the softmax) outlast them;
// chip_smoke.py prints the cluster pass's rate beside a plain read of
// the store ([time] golden_aggregate split).
// bf16 store rows (the engine's storage_dtype; 307.2 MB at the shape
// above, 0.092 ms): the ring stages the bf16 rows as they are stored,
// and both products take them widened, exact in TF32, in two MMAs
// (dist_tile.cuh): the same fp32 sums as the fp32 instance on the
// widened rows.  D % 8 == 0 (16-byte rows).
#include <cooperative_groups.h>

#include "dist_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using dtile::Q;
using dtile::R;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(R == 2 * WARPS, "each warp copies two rows of a tile");
constexpr int PS = Q + 4;     // a query's row of weights (A-fragment loads)

constexpr int BARS = 32;      // floats: full[8] and xchg[2] mbarriers

// shared memory of a CTA for a slice of ds columns, `stages` stages of
// rows of `esize` bytes an element and C CTAs a cluster
__host__ __device__ size_t agg_smem(int ds, int stages, int C, int esize) {
  return (size_t)esize * stages * R * dtile::dt_stride(ds)     // ring
         + sizeof(float) * (BARS                // mbarriers
                          + WARPS * Q * R     // warp partials
                          + 2 * C * Q * R     // the ranks' partials
                          + 2 * Q * PS        // weights
                          + 2 * Q);           // rescale factors
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of a shared::cta address in CTA `rank`
__device__ __forceinline__ uint32_t at_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(dtile::smem_addr(p)), "r"(rank));
  return r;
}

// store v at addr (another CTA's shared memory), completing on its
// mbarrier bar (4 bytes)
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// o = o * sc + P X over a staged tile: the warp's KW n-tiles of 8
// columns from column n0, P [16 queries][16 rows] (row stride PS).  The
// MMAs go in passes over 4 n-tiles at a time.
template <typename T, int KW>
__device__ __forceinline__ void weigh_rows(float (&o)[KW][4], const T* xs,
                                           int st, const float* p,
                                           const float* sc, int n0,
                                           int lane) {
  constexpr int JG = 4;
  const int g = lane >> 2, t = lane & 3;
  const float s0 = sc[g], s8 = sc[g + 8];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    o[j][0] *= s0, o[j][1] *= s0;
    o[j][2] *= s8, o[j][3] *= s8;
  }
#pragma unroll
  for (int ks = 0; ks < R / 8; ++ks) {
    uint32_t ph[4], pl[4];
    dtile::split(p[g * PS + 8 * ks + t], ph[0], pl[0]);
    dtile::split(p[(g + 8) * PS + 8 * ks + t], ph[1], pl[1]);
    dtile::split(p[g * PS + 8 * ks + t + 4], ph[2], pl[2]);
    dtile::split(p[(g + 8) * PS + 8 * ks + t + 4], ph[3], pl[3]);
    const T* r0 = dtile::row_at(xs, st, 8 * ks + t) + n0 + g;
    const T* r4 = dtile::row_at(xs, st, 8 * ks + t + 4) + n0 + g;
#pragma unroll
    for (int j0 = 0; j0 < KW; j0 += JG) {
      dtile::BFrag b[JG];
#pragma unroll
      for (int j = j0; j < j0 + JG && j < KW; ++j)
        b[j - j0] = dtile::b_split(r0[8 * j], r4[8 * j]);
#pragma unroll
      for (int j = j0; j < j0 + JG && j < KW; ++j)
        dtile::mma_lo_hi(o[j], pl, b[j - j0]);
      if (!dtile::Rows<T>::kExact)
#pragma unroll
        for (int j = j0; j < j0 + JG && j < KW; ++j)
          dtile::mma_hi_lo(o[j], ph, b[j - j0]);
#pragma unroll
      for (int j = j0; j < j0 + JG && j < KW; ++j)
        dtile::mma_hi_hi(o[j], ph, b[j - j0]);
    }
  }
}

// One cluster of C CTAs, rows [split * rps, (split + 1) * rps) of x, the
// group of queries [16 g, 16 g + 16), this CTA's D slice [rank ds,
// (rank + 1) ds) with ds = 64 KW.  Writes the split's partial state:
// part_acc [splits, B, D] (the slice), part_m, part_l [splits, B] (rank
// 0).  dbg, if not null, [splits, C, G * 16, 2 + R]: each rank's final
// (m, l) and its first tile's weights, for the test that ranks agree.
// Every warp issues the bulk copies of two rows of a tile: the copy
// engine takes them one at a time and the issuing warp waits, so one
// warp issuing all 16 held the CTA's next barrier.
template <typename T, int KW>
__global__ void __launch_bounds__(THREADS, 1)
agg_cluster(const float* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ qn, const float* __restrict__ xn,
            float inv, float* __restrict__ part_acc,
            float* __restrict__ part_m, float* __restrict__ part_l,
            float* __restrict__ dbg, int B, int N, int D, int stages,
            int rps) {
  constexpr int DS = 64 * KW;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = blockIdx.x / C;
  const int q0 = blockIdx.y * Q, nq = min(Q, B - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int ST = dtile::dt_stride(DS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [stages]
  uint64_t* xchg = full + 8;                            // [2] the sums
  T* ring = reinterpret_cast<T*>(smem + BARS);    // [stages][R][ST]
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * R * ST);
                                                  // [WARPS][Q][R]
  float* part = red + WARPS * Q * R;              // [2][C][Q][R]
  float* pw = part + 2 * C * Q * R;               // [2][Q][PS] weights
  float* scl = pw + 2 * Q * PS;                   // [2][Q]

  const int row0 = split * rps;
  const int row1 = min(N, row0 + rps);
  const int ntiles = (row1 - row0 + R - 1) / R;
  const int c0 = rank * DS;            // the slice's first column
  const int cols = min(DS, D - c0);    // columns of the slice in x

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) dtile::mbar_init(full + s, 1);
    dtile::mbar_init(xchg, 1);
    dtile::mbar_init(xchg + 1, 1);
    dtile::fence_barrier_init();
  }
  dtile::zero_smem(reinterpret_cast<float*>(ring),
                   stages * R * ST * (int)sizeof(T) / 4, tid, THREADS);
  cluster.sync();      // every CTA's mbarriers exist before any sum is sent

  // tile t into stage t % stages: thread 0 expects the bytes, and the
  // lanes 0 and 1 of warp w copy the rows 2 w and 2 w + 1
  auto load_tile = [&](int t) {
    if (t >= ntiles) return;
    const int s = t % stages;
    const int r0 = row0 + t * R, nr = min(R, row1 - r0);
    if (tid == 0)
      dtile::mbar_expect(full + s, (uint32_t)sizeof(T) * nr * max(cols, 0));
    const int r = 2 * warp + lane;
    if (lane < 2 && r < nr && cols > 0)
      dtile::bulk_copy(dtile::row_at(ring + (size_t)s * R * ST, ST, r),
                       x + (int64_t)(r0 + r) * D + c0,
                       (uint32_t)sizeof(T) * cols, full + s);
  };
  for (int t = 0; t < stages - 2; ++t) load_tile(t);

  const int n0 = warp * 8 * KW;        // the warp's first column in it
  // the group's queries on the warp's columns, as split A fragments
  uint32_t qh[KW][4], ql[KW][4];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = g + 8 * (e & 1);
      const int c = c0 + n0 + 8 * j + t4 + 4 * (e >> 1);
      const float v = b < nq && c < D ? q[(int64_t)(q0 + b) * D + c] : 0.f;
      dtile::split(v, qh[j][e], ql[j][e]);
    }
  }
  float o[KW][4];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // this thread's query and row in the logits and the softmax
  const int qb = tid >> 4, rr = tid & 15;
  const float qnb = qb < nq ? qn[q0 + qb] : 0.f;
  float m = RT_NEG_INF, l = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const T* xs = ring + (size_t)(t % stages) * R * ST;
    dtile::mbar_wait(full + t % stages, (t / stages) & 1);   // tile t landed
    __syncthreads();              // and every thread is done with tile t - 2
    load_tile(t + stages - 2);
    if (tid == 0) dtile::mbar_expect(xchg + buf, 4u * C * Q * R);
    const int row = row0 + t * R + rr;
    const float xnr = row < row1 ? xn[row] : 0.f;

    // (1) this slice's partial dots: the warps' columns, in warp order
    // (even and odd steps in two sums: four independent MMA chains)
    float s2[2][2][4] = {};
#pragma unroll
    for (int j = 0; j < KW; j += 2) {
      const int j1 = j + 1 < KW ? j + 1 : j;
      dtile::qxt_pair(s2, qh[j], ql[j], qh[j1], ql[j1], j + 1 < KW,
                      dtile::Rows<T>{xs, ST}, 0, n0 + 8 * j, 8, lane);
    }
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[0][n][e] + s2[1][n][e];
    dtile::store_c<2>(s, red + warp * Q * R, R, lane);
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w * Q * R + tid];
    float* slot = part + (buf * C + rank) * Q * R + tid;
    for (int k = 0; k < C; ++k)         // into every rank's slot `rank`
      st_async(at_rank(slot, k), sum, at_rank(xchg + buf, k));
    cluster_arrive();

    // (2) while the cluster arrives: the previous tile's weighted rows
    if (t > 0)
      weigh_rows<T, KW>(o, ring + (size_t)((t - 1) % stages) * R * ST, ST,
                     pw + (buf ^ 1) * Q * PS, scl + (buf ^ 1) * Q, n0, lane);
    cluster_wait();
    dtile::mbar_wait(xchg + buf, (t >> 1) & 1);   // the C ranks' sums

    // (3) the logits: the ranks' partials added in rank order
    float dot = 0.f;
    for (int k = 0; k < C; ++k) dot += part[(buf * C + k) * Q * R + tid];
    float lg = -INFINITY;                      // rows past the split
    if (row < row1) {
      const float d2 = fmaxf((qnb + xnr) - 2.0f * dot, 0.f);
      lg = fmaxf(-d2 * inv, RT_NEG_INF);
    }
    // (4) online softmax of query qb over the tile's 16 rows
    float mt = lg;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float mn = fmaxf(m, mt);
    const float sc = expf(m - mn);
    const float p = expf(lg - mn);
    float ps = p;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * sc + ps;
    m = mn;
    pw[buf * Q * PS + qb * PS + rr] = p;
    if (rr == 0) scl[buf * Q + qb] = sc;
    if (dbg != nullptr && t == 0)
      dbg[((int64_t)(split * C + rank) * gridDim.y * Q + q0 + qb) * (2 + R)
          + 2 + rr] = p;
  }

  // the last tile's weighted rows (every sum sent to this CTA has landed:
  // it may leave when done)
  __syncthreads();
  if (ntiles > 0) {
    const int t = ntiles - 1;
    weigh_rows<T, KW>(o, ring + (size_t)(t % stages) * R * ST, ST,
                   pw + (t & 1) * Q * PS, scl + (t & 1) * Q, n0, lane);
  }

#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = g + 8 * (e >> 1);
      const int c = c0 + n0 + 8 * j + 2 * t4 + (e & 1);
      if (b < nq && c < D)
        part_acc[((int64_t)split * B + q0 + b) * D + c] = o[j][e];
    }
  if (rr == 0 && qb < nq && rank == 0) {
    part_m[(int64_t)split * B + q0 + qb] = m;
    part_l[(int64_t)split * B + q0 + qb] = l;
  }
  if (dbg != nullptr && rr == 0) {
    float* d = dbg + ((int64_t)(split * C + rank) * gridDim.y * Q + q0 + qb)
                         * (2 + R);
    d[0] = m;
    d[1] = l;
  }
}

// Log-sum-exp merge of the per-split states, in split order
// (deterministic): out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30).
// The state entry (STATE) writes the numerator, M and the denominator
// (m_out, l_out [B]) undivided: a store shard's softmax state.
template <bool STATE>
__global__ void merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             float* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out, int S, int B, int D) {
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
  if (!STATE) {
    out[(int64_t)b * D + c] = acc / fmaxf(L, 1e-30f);
    return;
  }
  out[(int64_t)b * D + c] = acc;
  if (c == 0) {
    m_out[b] = M;
    l_out[b] = L;
  }
}

template <typename T>
using Kernel = void (*)(const float*, const T*, const float*, const float*,
                        float, float*, float*, float*, float*, int, int, int,
                        int, int);

// the instance for rows of T and a slice of ds columns (the plan's SLICES)
template <typename T>
Kernel<T> pick(int ds) {
  switch (ds) {
    case 64: return agg_cluster<T, 1>;
    case 128: return agg_cluster<T, 2>;
    case 256: return agg_cluster<T, 4>;
    case 448: return agg_cluster<T, 7>;
    case 768: return agg_cluster<T, 12>;
    default: return nullptr;
  }
}

// The launch configuration of the cluster pass; sets the kernel's
// shared-memory and cluster-size attributes.
template <typename T>
cudaError_t configure(Kernel<T> k, int C, int ds, int stages, int splits,
                      int groups, cudaStream_t st, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem = agg_smem(ds, stages, C, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * splits, groups);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool valid(int C, int ds, int stages) {
  return C >= 1 && C <= 16 && pick<float>(ds) != nullptr && stages >= 3 &&
         stages <= 8;
}

template <typename T>
int active_clusters(int C, int ds, int stages) {
  Kernel<T> k = pick<T>(ds);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(k, C, ds, stages, 1, 1, nullptr, &cfg, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

template <typename T>
cudaError_t launch_cluster(const float* q, const T* x, const float* qn,
                           const float* xn, float inv, float* part_acc,
                           float* part_m, float* part_l, float* dbg, int B,
                           int N, int D, int C, int ds, int stages,
                           int splits, int rps, cudaStream_t st) {
  const int groups = (B + Q - 1) / Q;
  Kernel<T> k = pick<T>(ds);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(k, C, ds, stages, splits, groups, st, &cfg,
                              &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, k, q, x, qn, xn, inv, part_acc, part_m,
                             part_l, dbg, B, N, D, stages, rps);
  return err;
}

}  // namespace

// esize: 4 (fp32 rows) or 2 (bf16 rows)
RT_EXPORT size_t golden_aggregate_smem_bytes(int ds, int stages, int C,
                                             int esize) {
  return agg_smem(ds, stages, C, esize);
}

// Clusters of C CTAs of this configuration (x_bf16: the bf16 instance)
// the card keeps resident at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code.
RT_EXPORT int golden_aggregate_active_clusters(int C, int ds, int stages,
                                               int x_bf16) {
  if (!valid(C, ds, stages)) return -(int)cudaErrorInvalidValue;
  return x_bf16 ? active_clusters<bf16_t>(C, ds, stages)
                : active_clusters<float>(C, ds, stages);
}

namespace {

// the cluster pass and the merge; m_out == nullptr: the mean, else the
// state entry
int run(const float* q, const void* x, int x_bf16, const float* qn,
        const float* xn, float inv, float* part_acc, float* part_m,
        float* part_l, float* out, float* m_out, float* l_out, float* dbg,
        int B, int N, int D, int C, int ds, int stages, int splits, int rps,
        void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (!valid(C, ds, stages) || C * ds < D || D % (x_bf16 ? 8 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || splits < 1 ||
      (int64_t)(splits - 1) * rps >= N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_bf16 ? launch_cluster(q, static_cast<const bf16_t*>(x), qn, xn, inv,
                              part_acc, part_m, part_l, dbg, B, N, D, C, ds,
                              stages, splits, rps, st)
             : launch_cluster(q, static_cast<const float*>(x), qn, xn, inv,
                              part_acc, part_m, part_l, dbg, B, N, D, C, ds,
                              stages, splits, rps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 mgrid((D + 255) / 256, B);
  if (m_out == nullptr)
    merge_kernel<false><<<mgrid, 256, 0, st>>>(part_acc, part_m, part_l, out,
                                               nullptr, nullptr, splits, B, D);
  else
    merge_kernel<true><<<mgrid, 256, 0, st>>>(part_acc, part_m, part_l, out,
                                              m_out, l_out, splits, B, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, D], x [N, D], qn [B], xn [N]; part_acc [splits, B, D], part_m /
// part_l [splits, B]: caller-allocated scratch; out [B, D].  Rows
// [s * rps, (s + 1) * rps) go to split s; every split must hold at
// least one row.  C CTAs a cluster, each a slice of ds columns (C ds >=
// D).  x: fp32, or bf16 when x_bf16; its rows a multiple of 16 bytes (D %
// 4 == 0, or D % 8 == 0 for bf16) and x 16-byte aligned (the bulk copies'
// rows); dbg may be null.
RT_EXPORT int golden_aggregate_launch(const float* q, const void* x,
                                      int x_bf16, const float* qn,
                                      const float* xn,
                                      float inv, float* part_acc,
                                      float* part_m, float* part_l,
                                      float* out, float* dbg, int B, int N,
                                      int D, int C, int ds, int stages,
                                      int splits, int rps, void* stream) {
  return run(q, x, x_bf16, qn, xn, inv, part_acc, part_m, part_l, out,
             nullptr, nullptr, dbg, B, N, D, C, ds, stages, splits, rps,
             stream);
}

// The state entry: the same cluster pass, then the merge writes acc
// [B, D] (the unnormalized weighted sum), m [B] (the max logit, NEG_INF
// on a store of +inf-norm padding alone) and l [B] (the denominator):
// a store shard's softmax state, merged across shards by log-sum-exp.
RT_EXPORT int golden_aggregate_state_launch(
    const float* q, const void* x, int x_bf16, const float* qn,
    const float* xn, float inv, float* part_acc, float* part_m,
    float* part_l, float* acc, float* m, float* l, int B, int N, int D,
    int C, int ds, int stages, int splits, int rps, void* stream) {
  if (m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, x, x_bf16, qn, xn, inv, part_acc, part_m, part_l, acc, m, l,
             nullptr, B, N, D, C, ds, stages, splits, rps, stream);
}
