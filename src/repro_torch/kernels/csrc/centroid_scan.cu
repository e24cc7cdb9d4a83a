// IVF level 1 in one launch: rescaled query -> probed candidate list.
//
// Replaces: src/repro/kernels/centroid_scan.py:65 (centroid_scan /
// _centroid_kernel :25), together with what the reference runs around
// it in ivf_screen (src/repro/kernels/ops.py:376-389: lax.top_k over
// the centroid distances and the CSR window expansion) and in the
// engine (the proxy pooling, index.perm[pos], isfinite(d2)).
//
// Per query b (one thread block cluster of kCluster CTAs):
//   1. pool: the proxy qp_b in downsample_proxy's order (rows of the
//      window, then columns, a left fold from the (0, 0) sample, one
//      divide by f^2; any factor, loads in chunks of 16), or the row
//      itself for non-image stores;
//   2. distances: d2[j] = max((||qp||^2 + cn[j]) - 2 qp.c_j, 0), no FMA
//      contraction in the epilogue (the plain version's rounding); a
//      +inf norm (a padded window) gives +inf.  Rank r owns windows
//      [r rows, (r + 1) rows), one warp a window, lanes over d, a fixed
//      butterfly sum;
//   3. probe list: the key (bits(d2 + 0) << 32) | j is unique per
//      window and orders as a stable ascending sort does (ties to the
//      lowest window: the duplicated centroids of a split cluster);
//      "+ 0" turns -0.0, whose bits sort after +inf, into +0.0.  Every
//      rank writes its keys into every CTA's shared memory (DSMEM);
//      after a cluster barrier each rank counts, for each of its keys,
//      the keys below it (a group of `group` threads a key), and that
//      count is the key's place: places < P go to every CTA's probe
//      list;
//   4. expansion: after a second barrier rank r writes the slots
//      [r chunk, (r + 1) chunk) of the P L candidate slots:
//      raw = offsets[w] + lane, valid = raw < offsets[w + 1] && p <
//      nprobe, pos = min(raw, N - 1), ids = perm[pos], marker 0 / +inf.
//      Every output is optional (a null pointer is not written).
// With P = 0 the launch is the distance stage alone (ops.centroid_scan):
// it writes d2 [B, C] and returns after step 2.
// round_q (an engine with bf16 store rows, storage_dtype): the pooled
// query is rounded to bf16 (ties to even) before step 2, and its norm
// taken from the rounded values, as the reference rounds _proxy_query;
// the centroids stay fp32.
//
// Bound on the H100: one launch's latency.  At B=16 the call reads well
// under 1 MB (the queries, the centroid table per cluster from L2, the
// probed windows' perm entries) and writes B P L (8 + 1) bytes of ids
// and validity: a fraction of a microsecond of HBM time.  What it
// replaces was ~33 launches (pooling adds, norms, the distance kernel,
// a radix sort, the expansion's gathers and compares).  The design
// keeps every intermediate in shared memory and uses two cluster
// barriers; the distances and the slot writes are spread over the
// cluster's CTAs.  Ranking by counting is O(C^2 / threads) a cluster:
// at the cap of 16384 windows that is some 10^5 compares a thread,
// slow but right.  The host plan (kernels/centroid_scan.py: rows,
// group, chunk, shared-memory bytes) is computed in Python.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // CTAs a query (centroid_scan.CLUSTER)
constexpr int kThreads = 512;        // centroid_scan.THREADS
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ivf_probe_kernel(const float* __restrict__ q, int D, int W, int Ch, int f,
                 int dp, const float* __restrict__ cents,
                 const float* __restrict__ cn, int C,
                 const int64_t* __restrict__ offsets,
                 const int64_t* __restrict__ perm, int64_t N, int P, int L,
                 const int64_t* __restrict__ nprobe_ptr, int64_t nprobe_val,
                 int round_q, int rows, int group, int64_t chunk,
                 float* __restrict__ d2_out, int64_t* __restrict__ probe_out,
                 int64_t* __restrict__ pos_out, int64_t* __restrict__ ids_out,
                 bool* __restrict__ valid_out,
                 float* __restrict__ marker_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qn_s;
  float* qp = reinterpret_cast<float*>(smem);
  uint64_t* keys = reinterpret_cast<uint64_t*>(qp + ((dp + 1) & ~1));
  int* probe = reinterpret_cast<int*>(keys + C);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + static_cast<int64_t>(b) * D;
  // a CTA may write into another's shared memory only once every CTA of
  // the cluster runs: arrive now, wait before the first remote store
  if (P > 0) cluster_arrive();
  // this rank's centroid rows and norms (and the CSR offsets) start on
  // their way to L2 while the query is pooled
  const int j0 = rank * rows;
  const int j1 = min(C, j0 + rows);
  {
    const char* rows_at = reinterpret_cast<const char*>(
        cents + static_cast<int64_t>(j0) * dp);
    const int64_t nbytes = static_cast<int64_t>(max(j1 - j0, 0)) * dp * 4;
    for (int64_t off = static_cast<int64_t>(tid) * 128; off < nbytes;
         off += kThreads * 128)
      prefetch_l2(rows_at + off);
    if (tid == 0 && j1 > j0) prefetch_l2(cn + j0);
    if (P > 0 && tid < (C + 16) / 16) prefetch_l2(offsets + 16 * tid);
  }

  // 1. the proxy query, in every CTA (the same code: the same bits).  A
  // window's f^2 samples are read in row-major chunks of kPool, every
  // load of a chunk before its adds (all 16 of factor 4 in flight), and
  // folded left from the (0, 0) sample as downsample_proxy sums them.
  if (f > 0) {
    constexpr int kPool = 16;
    const int ww = W / f, ff = f * f;
    for (int o = tid; o < dp; o += kThreads) {
      const int ch = o % Ch, ij = o / Ch;
      const float* base = qb + (static_cast<int64_t>(ij / ww) * f * W
                                + (ij % ww) * f) * Ch + ch;
      float acc = 0.f;
      const float* row = base;         // the window's row of sample k0 + u
      int dj = 0;                      // and its column
      for (int k0 = 0; k0 < ff; k0 += kPool) {
        float v[kPool];
#pragma unroll
        for (int u = 0; u < kPool; ++u) {
          v[u] = k0 + u < ff ? row[dj * Ch] : 0.f;
          if (++dj == f) {             // no division by the runtime f
            dj = 0;
            row += static_cast<int64_t>(W) * Ch;
          }
        }
#pragma unroll
        for (int u = 0; u < kPool; ++u)   // the first sample as it is (-0.0)
          if (k0 + u < ff) acc = k0 + u == 0 ? v[u] : __fadd_rn(acc, v[u]);
      }
      const float v = __fdiv_rn(acc, static_cast<float>(ff));
      qp[o] = round_q ? round_bf16(v) : v;
    }
  } else {
    for (int o = tid; o < dp; o += kThreads)
      qp[o] = round_q ? round_bf16(qb[o]) : qb[o];
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int e = lane; e < dp; e += 32) s = __fmaf_rn(qp[e], qp[e], s);
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  const float qn = qn_s;

  // 2. this rank's windows: distances, keys into every CTA
  if (P > 0) cluster_wait();
  auto emit = [&](int j, float cnj, float acc) {
    float d2 = __fsub_rn(__fadd_rn(qn, cnj), __fmul_rn(2.f, acc));
    d2 = __fadd_rn(d2 < 0.f ? 0.f : d2, 0.f);   // clamp (NaN stays), -0 -> +0
    if (d2_out != nullptr && lane == 0)
      d2_out[static_cast<int64_t>(b) * C + j] = d2;
    if (P > 0 && lane < kCluster) {
      const uint64_t key = (static_cast<uint64_t>(__float_as_uint(d2)) << 32)
                           | static_cast<uint32_t>(j);
      cluster.map_shared_rank(keys, lane)[j] = key;
    }
  };
  // two windows a warp at a time (j and j + kWarps): twice the loads in
  // flight; each window's sum is the same lane-strided chain either way
  for (int j = j0 + warp; j < j1; j += 2 * kWarps) {
    const int jb = j + kWarps;
    const bool two = jb < j1;
    const float* ca = cents + static_cast<int64_t>(j) * dp;
    const float* cb = cents + static_cast<int64_t>(two ? jb : j) * dp;
    const float cn_a = cn[j], cn_b = cn[two ? jb : j];
    float acc_a = 0.f, acc_b = 0.f;
#pragma unroll 4
    for (int e = lane; e < dp; e += 32) {
      const float x = qp[e];
      acc_a = __fmaf_rn(x, ca[e], acc_a);
      acc_b = __fmaf_rn(x, cb[e], acc_b);
    }
    acc_a = warp_sum(acc_a);
    acc_b = warp_sum(acc_b);
    emit(j, cn_a, acc_a);
    if (two) emit(jb, cn_b, acc_b);
  }
  if (P == 0) return;            // the distance stage alone
  cluster.sync();                // every key in every CTA

  // 3. each key's place = the number of keys below it
  const int ngroups = kThreads / group;
  const int g = tid / group, gi = tid % group;
  for (int k0 = 0; k0 < rows; k0 += ngroups) {     // uniform trip count
    const int j = j0 + k0 + g;
    const bool live = k0 + g < rows && j < C;
    const uint64_t mine = live ? keys[j] : 0;
    unsigned cnt = 0;
    if (live)
      for (int i = gi; i < C; i += group) cnt += keys[i] < mine;
    for (int o = group >> 1; o > 0; o >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (live && gi == 0 && cnt < static_cast<unsigned>(P)) {
      for (int r = 0; r < kCluster; ++r)
        cluster.map_shared_rank(probe, r)[cnt] = j;
      if (probe_out != nullptr)
        probe_out[static_cast<int64_t>(b) * P + cnt] = j;
    }
  }
  cluster.sync();                // the probe list in every CTA

  // 4. this rank's share of the P L slots
  const int64_t S = static_cast<int64_t>(P) * L;
  const int64_t end = (rank + 1) * chunk;
  const int64_t s1 = end < S ? end : S;
  const int64_t live_p = nprobe_ptr != nullptr ? *nprobe_ptr : nprobe_val;
  // kBatch slots a thread at a time, every load before any store, so
  // their perm gathers are in flight together
  constexpr int kBatch = 4;
  for (int64_t s0 = rank * chunk + tid; s0 < s1; s0 += kBatch * kThreads) {
    int64_t pos[kBatch], id[kBatch];
    bool v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t s = s0 + u * kThreads < s1 ? s0 + u * kThreads : s0;
      const int p = static_cast<int>(s / L);
      const int w = probe[p];
      const int64_t raw = offsets[w] + (s - static_cast<int64_t>(p) * L);
      v[u] = raw < offsets[w + 1] && p < live_p;
      pos[u] = raw < N - 1 ? raw : N - 1;
      id[u] = ids_out != nullptr ? perm[pos[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t s = s0 + u * kThreads;
      if (s >= s1) break;
      const int64_t o = static_cast<int64_t>(b) * S + s;
      if (pos_out != nullptr) pos_out[o] = pos[u];
      if (ids_out != nullptr) ids_out[o] = id[u];
      if (valid_out != nullptr) valid_out[o] = v[u];
      if (marker_out != nullptr) marker_out[o] = v[u] ? 0.f : INFINITY;
    }
  }
}

}  // namespace

// q [B, D] fp32; pooled when f > 0 (D = H W Ch, dp = (H/f)(W/f) Ch),
// else dp = D.  P = 0: distances only into d2_out [B, C].  round_q: the
// pooled query rounded to bf16.  The plan (rows, group, chunk, smem)
// comes from kernels/centroid_scan.py.
RT_EXPORT int ivf_probe_launch(
    const float* q, int B, int D, int W, int Ch, int f, int dp,
    const float* cents, const float* cn, int C, const int64_t* offsets,
    const int64_t* perm, long long N, int P, int L,
    const int64_t* nprobe_ptr, long long nprobe_val, int round_q, int rows,
    int group, long long chunk, int smem, float* d2_out, int64_t* probe_out,
    int64_t* pos_out, int64_t* ids_out, bool* valid_out, float* marker_out,
    void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(kCluster, B);
  ivf_probe_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, D, W, Ch, f, dp, cents, cn, C, offsets, perm, N, P, L, nprobe_ptr,
      nprobe_val, round_q, rows, group, chunk, d2_out, probe_out, pos_out,
      ids_out, valid_out, marker_out);
  return static_cast<int>(cudaGetLastError());
}
