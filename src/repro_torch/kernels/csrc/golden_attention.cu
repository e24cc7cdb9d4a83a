// Golden (top-kb block-sparse) GQA decode attention:
//   out[b, h, g] = sum over the valid selected blocks' keys j of
//                  softmax_j(q[b, h, g] . k[b, h, j] / sqrt(dh)) v[b, h, j]
// q [B, Hkv, G, dh] and k/v [B, Hkv, S, dh], each fp32 or bf16 (k and v
// one type), block_idx / valid [B, Hkv, kb] int32 -> out [B, Hkv, G, dh]
// in q's type.
// Block j of (b, h) covers keys [idx * bs, (idx + 1) * bs) with idx
// clamped to [0, S / bs - 1]; it counts only where valid == 1.
//
// Replaces: src/repro/kernels/golden_attention.py:85
// (golden_attention_decode / _gattn_kernel :32).  Kept from the TPU
// kernel: the fp32 online softmax over the valid blocks in their listed
// order (m from NEG_INF, l, acc), no mask inside a block, indices
// clamped into range, and a (b, h) with no valid block giving 0
// (acc = 0, l = 0, 0 / max(0, 1e-30)).
// Bound on the H100: bytes.  The work is the valid blocks' K and V (at
// B=16, Hkv=8, kb=64 blocks of 128 keys, dh=128, bf16: 537 MB, 0.16 ms
// at 3.35 TB/s) against 4 FLOP per key, head and column.
// Design: one block per (b, h), paged-attention style: the block reads
// its own index list and loads each valid block's K and V rows straight
// from the cache by index (no gathered [B, Hkv, kb * bs, dh] copy), and
// all G query heads share each key row.  Per selected block: each warp
// takes every 8th key and reduces its G dot products; one warp per head
// updates (m, l) and turns the scores into weights; then every thread
// adds the weighted V rows into its (head, column) entries of acc.
// Only B * Hkv blocks are in flight and the kb blocks are walked in
// order, so the card is not filled: splitting the kb blocks over
// several CTAs with a log-sum-exp merge is the redesign.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

size_t smem_floats(int G, int dh, int bs) {
  return (size_t)2 * G * dh + (size_t)G * bs + 3 * (size_t)G;
}

__device__ __forceinline__ float ld(const void* base, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
gattn_kernel(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, const int* __restrict__ block_idx,
             const int* __restrict__ valid, void* __restrict__ out, int G,
             int S, int BS, int KB, int q_bf16, int kv_bf16, float scale) {
  constexpr int PER = DH / 32;         // key columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [G][DH]
  float* acc_s = q_s + G * DH;         // [G][DH]
  float* w_s = acc_s + G * DH;         // [G][BS] scores, then weights
  float* m_s = w_s + G * BS;           // [G]
  float* l_s = m_s + G;                // [G]
  float* sc_s = l_s + G;               // [G]

  const int bh = blockIdx.x;
  const int nb = S / BS;
  const int64_t kv_base = (int64_t)bh * S * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < G * DH; e += THREADS) {
    q_s[e] = ld(q, (int64_t)bh * G * DH + e, q_bf16);
    acc_s[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    m_s[g] = RT_NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < KB; ++j) {
    if (valid[(int64_t)bh * KB + j] != 1) continue;       // block-uniform
    const int blk = min(max(block_idx[(int64_t)bh * KB + j], 0), nb - 1);
    const int64_t key0 = kv_base + (int64_t)blk * BS * DH;

    // scores of the block's keys against the G heads
    for (int t = warp; t < BS; t += WARPS) {
      float kr[PER];
#pragma unroll
      for (int c = 0; c < PER; ++c)
        kr[c] = ld(k, key0 + (int64_t)t * DH + lane + 32 * c, kv_bf16);
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < PER; ++c) d += kr[c] * q_s[g * DH + lane + 32 * c];
        d = warp_sum(d);
        if (lane == 0) w_s[g * BS + t] = d * scale;
      }
    }
    __syncthreads();

    // online-softmax state per head; scores become weights
    for (int g = warp; g < G; g += WARPS) {
      float mx = RT_NEG_INF;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, w_s[g * BS + t]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(w_s[g * BS + t] - m_new);
        w_s[g * BS + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float sc = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * sc + sum;
        m_s[g] = m_new;
        sc_s[g] = sc;
      }
    }
    __syncthreads();

    // acc = acc * scale + weights . V rows
    for (int e = threadIdx.x; e < G * DH; e += THREADS) {
      const int g = e / DH, c = e - g * DH;
      const float* w = w_s + g * BS;
      float a = acc_s[e] * sc_s[g];
      for (int t = 0; t < BS; ++t)
        a += w[t] * ld(v, key0 + (int64_t)t * DH + c, kv_bf16);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < G * DH; e += THREADS) {
    const float r = acc_s[e] / fmaxf(l_s[e / DH], 1e-30f);
    const int64_t o = (int64_t)bh * G * DH + e;
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(r);
    else
      static_cast<float*>(out)[o] = r;
  }
}

template <int DH>
cudaError_t launch(int BH, cudaStream_t st, const void* q, const void* k,
                   const void* v, const int* idx, const int* valid, void* out,
                   int G, int S, int BS, int KB, int q_bf16, int kv_bf16,
                   float scale) {
  const size_t smem = sizeof(float) * smem_floats(G, DH, BS);
  cudaError_t err = cudaFuncSetAttribute(
      gattn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gattn_kernel<DH><<<BH, THREADS, smem, st>>>(q, k, v, idx, valid, out, G, S,
                                              BS, KB, q_bf16, kv_bf16, scale);
  return cudaGetLastError();
}

}  // namespace

RT_EXPORT size_t golden_attention_smem_bytes(int G, int dh, int bs) {
  return sizeof(float) * smem_floats(G, dh, bs);
}

// BH = B * Hkv; dh in {32, 64, 128}; S a multiple of bs.
RT_EXPORT int golden_attention_launch(const void* q, const void* k,
                                      const void* v, const int* block_idx,
                                      const int* valid, void* out, int BH,
                                      int G, int S, int dh, int bs, int kb,
                                      int q_bf16, int kv_bf16, float scale,
                                      void* stream) {
  if (BH <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || bs <= 0 || S < bs || S % bs != 0 || kb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32>(BH, st, q, k, v, block_idx, valid, out, G, S, bs, kb, q_bf16, kv_bf16, scale); break;
    case 64: err = launch<64>(BH, st, q, k, v, block_idx, valid, out, G, S, bs, kb, q_bf16, kv_bf16, scale); break;
    case 128: err = launch<128>(BH, st, q, k, v, block_idx, valid, out, G, S, bs, kb, q_bf16, kv_bf16, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
