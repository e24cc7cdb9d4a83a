// The fp32 backward of causal (or full) GQA flash attention on the CUDA
// cores: given q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh], the forward's
// output o [B, Hkv, G, S, dh], the gradient dO of the loss with respect
// to o, and the forward's row log-sum-exp lse [B, Hkv, G, S] (fp32, from
// flash_attention.cu), it computes, with scale = dh^-0.5,
//   P  = exp(Q K^T scale - lse)         (the forward's weights, recomputed)
//   D  = rowsum(dO o o)                 (one fp32 number a query row)
//   dS = P o (dO V^T - D)
//   dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO
// over keys j <= i when causal, every key otherwise.  dK and dV of a KV
// head sum over its G query heads.  All in IEEE fp32 (the --reduced
// configuration's dtype: a TF32 tensor-core product would miss fp32's
// 1e-5).  The bf16 backward, the training path's, is
// flash_attention_bwd_sm90.cu (wgmma on TMA-fed tiles).
//
// Replaces no TPU kernel: the reference has no Pallas backward (no
// custom_vjp in src/repro/) and takes this gradient by autodiff of the
// pure-JAX double scan src/repro/models/layers.py:122.  The port's
// forward is kernel 9 (src/repro/kernels/flash_attention.py:85), which
// autograd cannot differentiate, so the training path needs this.
//
// Bound on the H100: operations, on the fp32 CUDA cores (67 TFLOP/s):
// five [S, S] x dh products a head (S, dP, dQ, dK, dV).
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
// mma.sync m16n8k16's accumulator (rows lane / 4 and + 8, column pairs
// 2 (lane % 4)), computed in fp32 FMAs in order of k.  Shared rows are
// padded by 16 bytes.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps, 16 rows of the block's tile each
constexpr int ROWS = 64;       // keys (dK/dV) or query positions (dQ) a block
constexpr int BQ = 32;         // query positions a step of the dK/dV kernel
constexpr int BK = 64;         // keys a step of the dQ kernel

// the stride of a shared row of N floats: 16 bytes of padding
template <int N>
constexpr int LDS = N + 4;

template <int DH>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * ROWS * LDS<DH> + 2 * BQ * LDS<DH> +
                          2 * ROWS * LDS<BQ> + 2 * BQ);
}

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * ROWS * LDS<DH> + 2 * BK * LDS<DH> +
                          ROWS * LDS<BK>);
}

// Rows [r0, r0 + n) of a [S, DH] matrix into shared [n][DH + PAD], 16
// bytes a load; rows past S are zero.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n, int S) {
  constexpr int PER = 4;
  constexpr int CH = DH / PER;
  constexpr int LD = LDS<DH>;
  for (int e = threadIdx.x; e < n * CH; e += THREADS) {
    const int r = e / CH, c = (e - r * CH) * PER;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// c += A B for a warp's 16 rows: A [16][K] row-major (stride lda); B as
// [n][k] (BKN false) or [k][n] (BKN true), stride ldb; NT tiles of 8
// columns.  Thread lane holds c[nt][0..1] at row lane / 4, columns
// nt * 8 + 2 (lane % 4) + {0, 1}, and c[nt][2..3] eight rows further.
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

// two neighbouring values of a row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

// D[row] = sum_d dO[row, d] o[row, d] in fp32, one warp a row.
__global__ void __launch_bounds__(256)
bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ dd, int64_t rows, int dh) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < dh; c += 32)
    acc = fmaf(dout[row * dh + c], o[row * dh + c], acc);
  acc = warp_sum(acc);
  if (lane == 0) dd[row] = acc;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dk, float* __restrict__ dv, int G, int S,
                int causal, float scale) {
  constexpr int LD = LDS<DH>;
  constexpr int LDP = LDS<BQ>;
  constexpr int NT = DH / 8, NTQ = BQ / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);   // [ROWS][LD]
  float* v_s = k_s + ROWS * LD;                      // [ROWS][LD]
  float* q_s = v_s + ROWS * LD;                      // [BQ][LD]
  float* do_s = q_s + BQ * LD;                       // [BQ][LD]
  float* p_s = do_s + BQ * LD;                       // [ROWS][LDP]: P^T
  float* ds_s = p_s + ROWS * LDP;                    // [ROWS][LDP]: dS^T
  float* lse_s = ds_s + ROWS * LDP;                  // [BQ]
  float* d_s = lse_s + BQ;                           // [BQ]

  const int k0 = (int)blockIdx.x * ROWS;         // most query tiles first
  const int bh = blockIdx.y;
  const int64_t kv_base = (int64_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3), wr = warp * 16;

  stage<DH>(k_s, k + kv_base, k0, ROWS, S);
  stage<DH>(v_s, v + kv_base, k0, ROWS, S);
  float dk_acc[NT][4], dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);

  const int qstart = causal ? k0 / BQ * BQ : 0;  // earlier queries: masked
  for (int g = 0; g < G; ++g) {
    const int64_t qrow = ((int64_t)bh * G + g) * S;    // row of (bh, g, 0)
    for (int q0 = qstart; q0 < S; q0 += BQ) {
      __syncthreads();           // the last step's reads of q_s, do_s done
      stage<DH>(q_s, q + qrow * DH, q0, BQ, S);
      stage<DH>(do_s, dout + qrow * DH, q0, BQ, S);
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

template <int DH>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dd,
              float* __restrict__ dq, int G, int S, int causal, float scale) {
  constexpr int LD = LDS<DH>;
  constexpr int LDP = LDS<BK>;
  constexpr int NT = DH / 8, NTK = BK / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [ROWS][LD]
  float* do_s = q_s + ROWS * LD;                     // [ROWS][LD]
  float* k_s = do_s + ROWS * LD;                     // [BK][LD]
  float* v_s = k_s + BK * LD;                        // [BK][LD]
  float* ds_s = v_s + BK * LD;                       // [ROWS][LDP]

  const int nq = (S + ROWS - 1) / ROWS;
  const int q0 = (nq - 1 - (int)blockIdx.x) * ROWS;   // longest rows first
  const int g = blockIdx.y, bh = blockIdx.z;
  const int64_t qrow = ((int64_t)bh * G + g) * S;
  const int64_t kv_base = (int64_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, q2 = 2 * (lane & 3), wr = warp * 16;

  stage<DH>(q_s, q + qrow * DH, q0, ROWS, S);
  stage<DH>(do_s, dout + qrow * DH, q0, ROWS, S);
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
    stage<DH>(k_s, k + kv_base, k0, BK, S);
    stage<DH>(v_s, v + kv_base, k0, BK, S);
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

template <int DH>
cudaError_t launch(cudaStream_t st, const float* q, const float* k,
                   const float* v, const float* o, const float* dout,
                   const float* lse, float* dd, float* dq, float* dk,
                   float* dv, int BH, int G, int S, int causal, float scale) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem<DH>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem<DH>());
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int64_t rows = (int64_t)BH * G * S;
  bwd_dot_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, dd,
                                                             rows, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<DH>
      <<<dim3((S + ROWS - 1) / ROWS, BH), THREADS, dkdv_smem<DH>(), st>>>(
          q, k, v, dout, lse, dd, dk, dv, G, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<DH>
      <<<dim3((S + ROWS - 1) / ROWS, G, BH), THREADS, dq_smem<DH>(), st>>>(
          q, k, v, dout, lse, dd, dq, G, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// BH = B * Hkv; every tensor contiguous fp32: q, o, dout, dq [BH, G, S,
// dh], k, v, dk, dv [BH, S, dh]; lse and the scratch dd [BH, G, S]; dh
// in {32, 64, 128}; pointers 16-byte aligned.  Three launches on
// ``stream``.
RT_EXPORT int flash_attention_bwd_launch(const float* q, const float* k,
                                         const float* v, const float* o,
                                         const float* dout, const float* lse,
                                         float* dd, float* dq, float* dk,
                                         float* dv, int BH, int G, int S,
                                         int dh, int causal, float scale,
                                         void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32>(st, q, k, v, o, dout, lse, dd, dq, dk, dv, BH, G, S, causal, scale); break;
    case 64: err = launch<64>(st, q, k, v, o, dout, lse, dd, dq, dk, dv, BH, G, S, causal, scale); break;
    case 128: err = launch<128>(st, q, k, v, o, dout, lse, dd, dq, dk, dv, BH, G, S, causal, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
