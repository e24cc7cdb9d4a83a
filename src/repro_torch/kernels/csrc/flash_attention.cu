// Causal (or full) GQA attention with an online softmax (flash attention):
//   out[b, h, g, i] = sum_j softmax_j(q[b, h, g, i] . k[b, h, j] * dh^-0.5) v[b, h, j]
// over keys j <= i when causal, every key otherwise.
// q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh], fp32 -> out [B, Hkv, G, S,
// dh] in fp32, and, given a non-null pointer, the row log-sum-exp of the
// scaled scores lse [B, Hkv, G, S] = m + log l (fp32) that the backward
// (flash_attention_bwd.cu) reads.
//
// Replaces: src/repro/kernels/flash_attention.py:85 (flash_attention /
// _flash_kernel :25).  Kept from the TPU kernel: the fp32 online softmax
// (running max m from NEG_INF, denominator l, accumulator acc), scores
// scaled after the dot product, causal tiles above the diagonal skipped,
// and the final acc / max(l, 1e-30).  The TPU's VMEM tiles (qc, kc) only
// order the sums; this kernel picks its own.
// fp32 inputs only (the --reduced configuration, held to 2e-5, which a
// TF32 tensor-core product would miss); bf16 inputs, the model's dtype,
// go to flash_attention_sm90.cu (wgmma fed by TMA).
// Bound on the H100: operations, at the fp32 rate outside the tensor
// cores (67 TFLOP/s): 4 dh FLOP per (row, key) pair, half of them past
// the diagonal skipped when causal.
// Design: one block per (b * Hkv, tile of BQ query positions); its rows
// are the G * BQ (head, position) pairs of that tile (row r is head
// r / BQ, position q0 + r % BQ), so all G query heads of the KV head
// share every K/V tile, which crosses HBM once per tile of rows and not
// once per head.  Per tile of BK = 64 keys: K is staged in shared memory
// as fp32, each thread computes an RT x 4 patch of the scores (rows
// ty + 16 i, keys tx + 16 j) from shared Q and K, the 16 threads of a
// row group reduce max and sum by shuffles, the weights go to shared
// memory, V replaces K there, and each thread adds P V into its RT rows
// x dh / 16 columns of the accumulator, held in registers.  The loop
// over keys stops at the diagonal when causal, and the grid starts with
// the longest rows.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16: ty picks rows, tx keys / columns
constexpr int BK = 64;         // keys per tile
constexpr int PAD = 4;         // floats of padding per shared row (banks)

template <int DH>
struct Cols {                  // columns of the accumulator per thread
  static constexpr int PER = DH / 16;
  static constexpr int VEC = PER < 4 ? PER : 4;
  static constexpr int NV = PER / VEC;      // chunks of VEC contiguous
};

size_t smem_floats(int rt, int dh) {
  const int r = 16 * rt;
  return (size_t)r * (dh + PAD) + (size_t)BK * (dh + PAD) +
         (size_t)r * (BK + PAD);
}

// Rows [k0, k0 + BK) of a [S, DH] matrix into shared [BK][DH + PAD] as
// fp32; rows past S are zero.
template <int DH>
__device__ __forceinline__ void stage_keys(float* dst, const float* src,
                                           int64_t base, int k0, int S) {
  constexpr int C4 = DH / 4;
  for (int e = threadIdx.x; e < BK * C4; e += THREADS) {
    const int t = e / C4, c = (e - t * C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + t < S)
      val = *reinterpret_cast<const float4*>(src + base +
                                             (int64_t)(k0 + t) * DH + c);
    *reinterpret_cast<float4*>(dst + t * (DH + PAD) + c) = val;
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int RT, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int G, int S, int BQ, int causal,
             float scale) {
  constexpr int R = 16 * RT;
  constexpr int LDQ = DH + PAD, LDP = BK + PAD;
  constexpr int VEC = Cols<DH>::VEC, NV = Cols<DH>::NV;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [R][LDQ]
  float* kv_s = q_s + R * LDQ;        // [BK][LDQ]: K, then V
  float* p_s = kv_s + BK * LDQ;       // [R][LDP] weights of the tile

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int64_t kv_base = (int64_t)blockIdx.y * S * DH;
  const int64_t q_base = (int64_t)blockIdx.y * G * S * DH;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int active = G * BQ;

  constexpr int C4 = DH / 4;
  for (int e = tid; e < R * C4; e += THREADS) {
    const int r = e / C4, c = (e - r * C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < active && q0 + r % BQ < S)
      val = *reinterpret_cast<const float4*>(
          q + q_base + ((int64_t)(r / BQ) * S + q0 + r % BQ) * DH + c);
    *reinterpret_cast<float4*>(q_s + r * LDQ + c) = val;
  }

  int qpos[RT];                        // -1: a row past G * BQ or past S
  float m[RT], l[RT], acc[RT][VEC * NV];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = (r < active && q0 + r % BQ < S) ? q0 + r % BQ : -1;
    m[i] = RT_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC * NV; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                   // Q staged; last tile's V and P read
    stage_keys<DH>(kv_s, k, kv_base, k0, S);
    __syncthreads();

    float s[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * LDQ +
                                                 d);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LDQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += dot4(qq, kk[j]);
      }
    }

    // online softmax; masked keys get -inf, so exp gives them weight 0
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = RT_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok =
            qpos[i] >= 0 && key < S && (!causal || key <= qpos[i]);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float sc = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * sc + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < VEC * NV; ++c) acc[i][c] *= sc;
    }
    __syncthreads();                   // P written; K no longer read
    stage_keys<DH>(kv_s, v, kv_base, k0, S);
    __syncthreads();

#pragma unroll 2
    for (int t = 0; t < BK; t += 4) {
      float4 pp[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        pp[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * LDP + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[VEC * NV];
        const float* vrow = kv_s + (t + u) * LDQ + tx * VEC;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          if constexpr (VEC == 4) {
            const float4 w =
                *reinterpret_cast<const float4*>(vrow + n * 16 * VEC);
            vv[n * 4 + 0] = w.x;
            vv[n * 4 + 1] = w.y;
            vv[n * 4 + 2] = w.z;
            vv[n * 4 + 3] = w.w;
          } else {
#pragma unroll
            for (int c = 0; c < VEC; ++c) vv[n * VEC + c] = vrow[n * 16 * VEC + c];
          }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float p = u == 0 ? pp[i].x
                        : u == 1 ? pp[i].y
                        : u == 2 ? pp[i].z
                                 : pp[i].w;
#pragma unroll
          for (int c = 0; c < VEC * NV; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (qpos[i] < 0) continue;
    const int g = (ty + 16 * i) / BQ;
    const float den = fmaxf(l[i], 1e-30f);
    const int64_t row = q_base + ((int64_t)g * S + qpos[i]) * DH;
    if (lse != nullptr && tx == 0)
      lse[((int64_t)blockIdx.y * G + g) * S + qpos[i]] = m[i] + logf(den);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        out[row + n * 16 * VEC + tx * VEC + c] = acc[i][n * VEC + c] / den;
  }
}

template <int RT, int DH>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* q, const float* k,
                   const float* v, float* out, float* lse, int G, int S, int BQ,
                   int causal, float scale) {
  const size_t smem = sizeof(float) * smem_floats(RT, DH);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<RT, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_kernel<RT, DH><<<grid, THREADS, smem, st>>>(q, k, v, out, lse, G, S,
                                                    BQ, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int rt, dim3 grid, cudaStream_t st, const float* q,
                      const float* k, const float* v, float* out, float* lse,
                      int G, int S, int BQ, int causal, float scale) {
  switch (rt) {
#define RT_CASE(n) \
  case n: return launch<n, DH>(grid, st, q, k, v, out, lse, G, S, BQ, causal, scale);
    RT_CASE(1) RT_CASE(2) RT_CASE(3) RT_CASE(4)
    RT_CASE(5) RT_CASE(6) RT_CASE(7) RT_CASE(8)
#undef RT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

RT_EXPORT size_t flash_attention_smem_bytes(int rt, int dh) {
  return sizeof(float) * smem_floats(rt, dh);
}

// BH = B * Hkv; rows of a block: G * bq (head, position) pairs, which
// must fit in 16 * rt; dh in {32, 64, 128}.  Pointers 16-byte aligned;
// lse [BH, G, S] fp32 or null (nothing written).
RT_EXPORT int flash_attention_launch(const float* q, const float* k,
                                     const float* v, float* out, float* lse,
                                     int BH, int G,
                                     int S, int dh, int bq, int rt,
                                     int causal, float scale,
                                     void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || bq <= 0 || G * bq > 16 * rt)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + bq - 1) / bq, BH);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch_dh<32>(rt, grid, st, q, k, v, out, lse, G, S, bq, causal, scale); break;
    case 64: err = launch_dh<64>(rt, grid, st, q, k, v, out, lse, G, S, bq, causal, scale); break;
    case 128: err = launch_dh<128>(rt, grid, st, q, k, v, out, lse, G, S, bq, causal, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
