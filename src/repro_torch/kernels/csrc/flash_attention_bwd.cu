// The backward of causal (or full) GQA flash attention: given q [B, Hkv,
// G, S, dh], k/v [B, Hkv, S, dh], the forward's output o [B, Hkv, G, S,
// dh], the gradient dO of the loss with respect to o, and the forward's
// row log-sum-exp lse [B, Hkv, G, S] (fp32, from flash_attention.cu or
// flash_attention_sm90.cu), it computes, with scale = dh^-0.5,
//   P  = exp(Q K^T scale - lse)         (the forward's weights, recomputed)
//   D  = rowsum(dO o o)                 (one fp32 number a query row)
//   dS = P o (dO V^T - D)
//   dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO
// over keys j <= i when causal, every key otherwise.  dK and dV of a KV
// head sum over its G query heads.  All sums are fp32; dQ, dK, dV come
// out in the inputs' type (fp32 or bf16).
//
// Replaces no TPU kernel: the reference has no Pallas backward (no
// custom_vjp in src/repro/) and takes this gradient by autodiff of the
// pure-JAX double scan src/repro/models/layers.py:122.  The port's
// forward is kernel 9 (src/repro/kernels/flash_attention.py:85), which
// autograd cannot differentiate, so the training path needs this.
//
// Bound on the H100: operations.  At B=2, Hkv=8, G=3, S=4096, dh=128,
// causal, the gradient needs five [S, S] x dh products a head (S, dP, dQ,
// dK, dV), 515 GFLOP: 0.52 ms at 989 TFLOP/s on the bf16 tensor cores,
// against ~270 MB of bf16 and fp32 in and out (0.08 ms at 3.35 TB/s).
//
// Design: three launches, no float atomics, so two calls are bit-equal.
//   1. bwd_dot_kernel: D, one warp a query row.
//   2. bwd_dkdv_kernel: one block (4 warps) a tile of 64 keys of one
//      (b, KV head), K and V staged once in shared memory; it walks the G
//      query heads and every tile of 32 query positions that the causal
//      mask leaves (from the key tile's start), staging Q, dO, lse and D,
//      and keeps dK and dV of its keys in registers: each warp owns 16
//      keys and computes S^T = K Q^T and dP^T = V dO^T for them, then
//      P^T and dS^T (written to the warp's own rows of shared memory) and
//      dV += P^T dO, dK += dS^T Q.
//   3. bwd_dq_kernel: one block a tile of 64 query positions of one
//      (b, KV head, query head), Q and dO staged once; it walks the key
//      tiles of 64 up to the diagonal, computing S = Q K^T, dP = dO V^T,
//      dS, and dQ += dS K in registers.  The grid starts with the longest
//      rows.
// Together they compute seven [S, S] x dh products where five would do
// (S and dP twice): the price of keeping dQ free of atomics.
// Products are warp tiles of 16 rows in the fragment layout of
// mma.sync m16n8k16: the bf16 instance runs them on the tensor cores
// (bf16 operands, fp32 accumulators; P and dS are rounded to bf16 as
// operands, as the forward's weights are), the fp32 instance on the CUDA
// cores in IEEE fp32 with the same layout (a TF32 tensor-core product
// would miss fp32's tolerance).  Shared rows are padded by 16 bytes so
// the fragment loads hit distinct banks.
// Not here yet: wgmma and TMA, a pipelined load of the next tile.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps, 16 rows of the block's tile each
constexpr int ROWS = 64;       // keys (dK/dV) or query positions (dQ) a block
constexpr int BQ = 32;         // query positions a step of the dK/dV kernel
constexpr int BK = 64;         // keys a step of the dQ kernel

// the stride of a shared row of N elements of T: 16 bytes of padding
template <typename T, int N>
constexpr int LDS = N + 16 / (int)sizeof(T);

template <typename T, int DH>
constexpr size_t dkdv_smem() {
  return sizeof(T) * (2 * ROWS * LDS<T, DH> +
                      2 * BQ * LDS<T, DH> +
                      2 * ROWS * LDS<T, BQ>) +
         sizeof(float) * 2 * BQ;
}

template <typename T, int DH>
constexpr size_t dq_smem() {
  return sizeof(T) * (2 * ROWS * LDS<T, DH> +
                      2 * BK * LDS<T, DH> +
                      ROWS * LDS<T, BK>);
}

// Rows [r0, r0 + n) of a [S, DH] matrix into shared [n][DH + PAD], 16
// bytes a load; rows past S are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int n,
                                      int S) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int CH = DH / PER;
  constexpr int LD = LDS<T, DH>;
  for (int e = threadIdx.x; e < n * CH; e += THREADS) {
    const int r = e / CH, c = (e - r * CH) * PER;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld2(const bf16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(bf16_t lo, bf16_t hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B for a warp's 16 rows: A [16][K] row-major (stride lda); B as
// [n][k] (BKN false) or [k][n] (BKN true), stride ldb; NT tiles of 8
// columns.  Thread lane holds c[nt][0..1] at row lane / 4, columns
// nt * 8 + 2 (lane % 4) + {0, 1}, and c[nt][2..3] eight rows further
// (mma.sync's accumulator layout).  bf16: tensor cores, K a multiple of 16.
template <bool BKN, int NT>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const bf16_t* A,
                                        int lda, const bf16_t* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31, r = lane >> 2, q2 = 2 * (lane & 3);
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = ld2(A + r * lda + k0 + q2);
    a[1] = ld2(A + (r + 8) * lda + k0 + q2);
    a[2] = ld2(A + r * lda + k0 + q2 + 8);
    a[3] = ld2(A + (r + 8) * lda + k0 + q2 + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + r;
      uint32_t b0, b1;
      if constexpr (BKN) {
        b0 = pair(B[(k0 + q2) * ldb + n], B[(k0 + q2 + 1) * ldb + n]);
        b1 = pair(B[(k0 + q2 + 8) * ldb + n], B[(k0 + q2 + 9) * ldb + n]);
      } else {
        b0 = ld2(B + n * ldb + k0 + q2);
        b1 = ld2(B + n * ldb + k0 + q2 + 8);
      }
      mma_bf16(c[nt], a, b0, b1);
    }
  }
}

// The same product in fp32 on the CUDA cores, same layout, k in order.
template <bool BKN, int NT>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
  const int lane = threadIdx.x & 31, r = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[r * lda + k], a1 = A[(r + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + q2;
      const float b0 = BKN ? B[k * ldb + n] : B[n * ldb + k];
      const float b1 = BKN ? B[k * ldb + n + 1] : B[(n + 1) * ldb + k];
      c[nt][0] = fmaf(a0, b0, c[nt][0]);
      c[nt][1] = fmaf(a0, b1, c[nt][1]);
      c[nt][2] = fmaf(a1, b0, c[nt][2]);
      c[nt][3] = fmaf(a1, b1, c[nt][3]);
    }
  }
}

// two neighbouring values of a row, in T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

// D[row] = sum_d dO[row, d] o[row, d] in fp32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dd, int64_t rows, int dh) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < dh; c += 32)
    acc = fmaf(widen(dout[row * dh + c]), widen(o[row * dh + c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) dd[row] = acc;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                T* __restrict__ dk, T* __restrict__ dv, int G, int S,
                int causal, float scale) {
  constexpr int LD = LDS<T, DH>;
  constexpr int LDP = LDS<T, BQ>;
  constexpr int NT = DH / 8, NTQ = BQ / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);       // [ROWS][LD]
  T* v_s = k_s + ROWS * LD;                      // [ROWS][LD]
  T* q_s = v_s + ROWS * LD;                      // [BQ][LD]
  T* do_s = q_s + BQ * LD;                       // [BQ][LD]
  T* p_s = do_s + BQ * LD;                       // [ROWS][LDP]: P^T
  T* ds_s = p_s + ROWS * LDP;                    // [ROWS][LDP]: dS^T
  float* lse_s = reinterpret_cast<float*>(ds_s + ROWS * LDP);   // [BQ]
  float* d_s = lse_s + BQ;                                       // [BQ]

  const int k0 = (int)blockIdx.x * ROWS;         // most query tiles first
  const int bh = blockIdx.y;
  const int64_t kv_base = (int64_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3), wr = warp * 16;

  stage<T, DH>(k_s, k + kv_base, k0, ROWS, S);
  stage<T, DH>(v_s, v + kv_base, k0, ROWS, S);
  float dk_acc[NT][4], dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);

  const int qstart = causal ? k0 / BQ * BQ : 0;  // earlier queries: masked
  for (int g = 0; g < G; ++g) {
    const int64_t qrow = ((int64_t)bh * G + g) * S;    // row of (bh, g, 0)
    for (int q0 = qstart; q0 < S; q0 += BQ) {
      __syncthreads();           // the last step's reads of q_s, do_s done
      stage<T, DH>(q_s, q + qrow * DH, q0, BQ, S);
      stage<T, DH>(do_s, dout + qrow * DH, q0, BQ, S);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lse[qrow + q0 + i] : 0.f;
        d_s[i] = in ? dd[qrow + q0 + i] : 0.f;
      }
      __syncthreads();

      float s[NTQ][4], dp[NTQ][4];
      zero(s);
      zero(dp);
      warp_mm<false>(s, k_s + wr * LD, LD, q_s, LD, DH);     // S^T = K Q^T
      warp_mm<false>(dp, v_s + wr * LD, LD, do_s, LD, DH);   // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr + r + 8 * h, key = k0 + row;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = nt * 8 + q2 + e, pos = q0 + qi;
            const bool ok = key < S && pos < S && (!causal || key <= pos);
            p[e] = ok ? expf(s[nt][2 * h + e] * scale - lse_s[qi]) : 0.f;
            ds[e] = p[e] * (dp[nt][2 * h + e] - d_s[qi]);
          }
          store2(p_s + row * LDP + nt * 8 + q2, p[0], p[1]);
          store2(ds_s + row * LDP + nt * 8 + q2, ds[0], ds[1]);
        }
      __syncwarp();              // the warp reads back only its own rows
      warp_mm<true>(dv_acc, p_s + wr * LDP, LDP, do_s, LD, BQ);  // P^T dO
      warp_mm<true>(dk_acc, ds_s + wr * LDP, LDP, q_s, LD, BQ);  // dS^T Q
      __syncwarp();              // before the next step rewrites the rows
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + wr + r + 8 * h;
      if (key >= S) continue;
      const int64_t at = kv_base + (int64_t)key * DH + nt * 8 + q2;
      store2(dk + at, dk_acc[nt][2 * h] * scale, dk_acc[nt][2 * h + 1] * scale);
      store2(dv + at, dv_acc[nt][2 * h], dv_acc[nt][2 * h + 1]);
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dd,
              T* __restrict__ dq, int G, int S, int causal, float scale) {
  constexpr int LD = LDS<T, DH>;
  constexpr int LDP = LDS<T, BK>;
  constexpr int NT = DH / 8, NTK = BK / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);       // [ROWS][LD]
  T* do_s = q_s + ROWS * LD;                     // [ROWS][LD]
  T* k_s = do_s + ROWS * LD;                     // [BK][LD]
  T* v_s = k_s + BK * LD;                        // [BK][LD]
  T* ds_s = v_s + BK * LD;                       // [ROWS][LDP]

  const int nq = (S + ROWS - 1) / ROWS;
  const int q0 = (nq - 1 - (int)blockIdx.x) * ROWS;   // longest rows first
  const int g = blockIdx.y, bh = blockIdx.z;
  const int64_t qrow = ((int64_t)bh * G + g) * S;
  const int64_t kv_base = (int64_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3), wr = warp * 16;

  stage<T, DH>(q_s, q + qrow * DH, q0, ROWS, S);
  stage<T, DH>(do_s, dout + qrow * DH, q0, ROWS, S);
  int pos[2];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = q0 + wr + r + 8 * h;
    lse_r[h] = pos[h] < S ? lse[qrow + pos[h]] : 0.f;
    d_r[h] = pos[h] < S ? dd[qrow + pos[h]] : 0.f;
  }
  float dq_acc[NT][4];
  zero(dq_acc);

  const int kend = causal ? min(S, q0 + ROWS) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();             // Q staged; the last step's K, V reads done
    stage<T, DH>(k_s, k + kv_base, k0, BK, S);
    stage<T, DH>(v_s, v + kv_base, k0, BK, S);
    __syncthreads();

    float s[NTK][4], dp[NTK][4];
    zero(s);
    zero(dp);
    warp_mm<false>(s, q_s + wr * LD, LD, k_s, LD, DH);        // S = Q K^T
    warp_mm<false>(dp, do_s + wr * LD, LD, v_s, LD, DH);      // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + q2 + e;
          const bool ok =
              pos[h] < S && key < S && (!causal || key <= pos[h]);
          const float p =
              ok ? expf(s[nt][2 * h + e] * scale - lse_r[h]) : 0.f;
          ds[e] = p * (dp[nt][2 * h + e] - d_r[h]);
        }
        store2(ds_s + (wr + r + 8 * h) * LDP + nt * 8 + q2, ds[0], ds[1]);
      }
    __syncwarp();
    warp_mm<true>(dq_acc, ds_s + wr * LDP, LDP, k_s, LD, BK);   // dS K
    __syncwarp();
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pos[h] >= S) continue;
      store2(dq + (qrow + pos[h]) * DH + nt * 8 + q2,
             dq_acc[nt][2 * h] * scale, dq_acc[nt][2 * h + 1] * scale);
    }
}

template <typename T, int DH>
cudaError_t launch(cudaStream_t st, const T* q, const T* k, const T* v,
                   const T* o, const T* dout, const float* lse, float* dd,
                   T* dq, T* dk, T* dv, int BH, int G, int S, int causal,
                   float scale) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem<T, DH>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem<T, DH>());
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int64_t rows = (int64_t)BH * G * S;
  bwd_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, dd,
                                                                rows, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, DH>
      <<<dim3((S + ROWS - 1) / ROWS, BH), THREADS, dkdv_smem<T, DH>(), st>>>(
          q, k, v, dout, lse, dd, dk, dv, G, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, DH>
      <<<dim3((S + ROWS - 1) / ROWS, G, BH), THREADS, dq_smem<T, DH>(), st>>>(
          q, k, v, dout, lse, dd, dq, G, S, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, cudaStream_t st, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const float* lse, float* dd, void* dq, void* dk,
                      void* dv, int BH, int G, int S, int causal, float scale) {
#define BWD_CASE(n)                                                         \
  case n:                                                                   \
    return launch<T, n>(st, static_cast<const T*>(q),                       \
                        static_cast<const T*>(k), static_cast<const T*>(v), \
                        static_cast<const T*>(o),                           \
                        static_cast<const T*>(dout), lse, dd,               \
                        static_cast<T*>(dq), static_cast<T*>(dk),           \
                        static_cast<T*>(dv), BH, G, S, causal, scale);
  switch (dh) {
    BWD_CASE(32) BWD_CASE(64) BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

RT_EXPORT size_t flash_attention_bwd_smem_bytes(int bf16, int dh, int dq) {
  if (bf16) {
    switch (dh) {
      case 32: return dq ? dq_smem<bf16_t, 32>() : dkdv_smem<bf16_t, 32>();
      case 64: return dq ? dq_smem<bf16_t, 64>() : dkdv_smem<bf16_t, 64>();
      default: return dq ? dq_smem<bf16_t, 128>() : dkdv_smem<bf16_t, 128>();
    }
  }
  switch (dh) {
    case 32: return dq ? dq_smem<float, 32>() : dkdv_smem<float, 32>();
    case 64: return dq ? dq_smem<float, 64>() : dkdv_smem<float, 64>();
    default: return dq ? dq_smem<float, 128>() : dkdv_smem<float, 128>();
  }
}

// BH = B * Hkv; every tensor contiguous: q, o, dout, dq [BH, G, S, dh],
// k, v, dk, dv [BH, S, dh], all fp32 (bf16 = 0) or all bf16 (bf16 = 1);
// lse and the scratch dd [BH, G, S] fp32; dh in {32, 64, 128}; pointers
// 16-byte aligned.  Three launches on ``stream``.
RT_EXPORT int flash_attention_bwd_launch(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const float* lse,
                                         float* dd, void* dq, void* dk,
                                         void* dv, int BH, int G, int S,
                                         int dh, int bf16, int causal,
                                         float scale, void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dh<bf16_t>(dh, st, q, k, v, o, dout, lse, dd, dq, dk, dv,
                               BH, G, S, causal, scale)
           : launch_dh<float>(dh, st, q, k, v, o, dout, lse, dd, dq, dk, dv,
                              BH, G, S, causal, scale);
  return static_cast<int>(err);
}
