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
// kernel: the fp32 online softmax over the valid blocks (m from NEG_INF,
// l, acc), no mask inside a block, indices clamped into range, and a
// (b, h) with no valid block giving 0 (acc = 0, l = 0, 0 / max(0,
// 1e-30)).  Only the order of the sums differs: keys are taken by
// several CTAs and lanes at once and merged by log-sum-exp.
// Bound on the H100: bytes.  The work is the valid blocks' K and V (at
// B=16, Hkv=8, kb=64 blocks of 128 keys, dh=128, bf16, 75% valid: ~400
// MB, 0.12 ms at 3.35 TB/s) against 4 FLOP per key, head and column.
// Design: split-kb flash-decoding in two launches.
//  1. gattn_split: one CTA of 4 warps per (b * Hkv, chunk of c selected
//     blocks, group of up to 8 query heads); the wrapper picks c so the
//     grid holds about four CTAs an SM.  Paged-attention style, the CTA
//     reads its own index list and loads each valid block's K and V rows
//     straight from the cache by index (no gathered copy), 16 bytes a
//     lane (8 bf16 or 4 fp32): a row takes DH / 8 (or DH / 4) lanes, a
//     warp takes 32 / that many consecutive rows at once, four times
//     over (all loads issued before use), so a warp's loads are whole
//     contiguous rows.  Each such slot of lanes keeps its own online
//     softmax (m, l, acc) for its heads in registers; a score is a
//     shuffle reduction over the slot's lanes.  No barrier inside the
//     block loop: the slots merge by shuffles and the warps through
//     shared memory once, at the end, into a partial (m, l, acc[dh]) a
//     head in fp32 scratch.  An empty partial is (RT_NEG_INF, 0, 0).
//  2. gattn_merge: one CTA per (b * Hkv): out = sum_i 2^(m_i - M) acc_i
//     / max(sum_i 2^(m_i - M) l_i, 1e-30) over the chunks i, in a fixed
//     order (deterministic; a (b, h) with no valid block gives 0).
// Scores are kept in log2 units (scale * log2 e folded into one multiply).
#include "common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;                   // rows a slot loads per step
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld(const void* base, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

// 16 bytes of a row as VEC floats.
template <bool BF16>
__device__ __forceinline__ void load16(float* dst, const void* src) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  if constexpr (BF16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  } else {
    dst[0] = __uint_as_float(raw.x);
    dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z);
    dst[3] = __uint_as_float(raw.w);
  }
}

// Partials: [BH, NCH, G, DH + 2] fp32; columns DH and DH + 1 hold m, l.
template <int DH, int GM, bool KV_BF16>
__global__ void __launch_bounds__(THREADS)
gattn_split(const void* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, const int* __restrict__ block_idx,
            const int* __restrict__ valid, float* __restrict__ part, int G,
            int S, int BS, int KB, int C, int NCH, int q_bf16,
            float scale_log2) {
  constexpr int VEC = KV_BF16 ? 8 : 4;
  constexpr int LPK = DH / VEC;        // lanes a row
  constexpr int KPW = 32 / LPK;        // rows a warp at once
  constexpr int STEP = WARPS * KPW * U;
  using T = typename std::conditional<KV_BF16, __nv_bfloat16, float>::type;
  __shared__ float m_s[WARPS][GM], l_s[WARPS][GM];
  __shared__ float acc_s[WARPS][GM][DH];

  const int bh = blockIdx.x, ch = blockIdx.y, g0 = blockIdx.z * GM;
  const int ng = min(GM, G - g0);
  const int nb = S / BS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / LPK, col = (lane % LPK) * VEC;
  const T* kc = static_cast<const T*>(k) + (int64_t)bh * S * DH + col;
  const T* vc = static_cast<const T*>(v) + (int64_t)bh * S * DH + col;

  float qr[GM][VEC], acc[GM][VEC], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = RT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < ng ? ld(q, ((int64_t)bh * G + g0 + g) * DH + col + e,
                             q_bf16)
                        : 0.f;
    }
  }

  const int j1 = min(KB, (ch + 1) * C);
  for (int j = ch * C; j < j1; ++j) {
    if (valid[(int64_t)bh * KB + j] != 1) continue;       // CTA-uniform
    const int blk = min(max(block_idx[(int64_t)bh * KB + j], 0), nb - 1);
    const int64_t row0 = (int64_t)blk * BS;
    for (int base = 0; base < BS; base += STEP) {
      float kr[U][VEC], vr[U][VEC];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = base + (u * WARPS + warp) * KPW + slot;
        ok[u] = key < BS;
        if (ok[u]) {
          load16<KV_BF16>(kr[u], kc + (row0 + key) * DH);
          load16<KV_BF16>(vr[u], vc + (row0 + key) * DH);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= ng) break;
        float sc[U];
        float mx = RT_NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kr[u][e], d);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          sc[u] = ok[u] ? d * scale_log2 : -INFINITY;
          mx = fmaxf(mx, sc[u]);
        }
        const float mn = fmaxf(m[g], mx);
        const float cr = exp2f(m[g] - mn);
        m[g] = mn;
        l[g] *= cr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= cr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = exp2f(sc[u] - mn);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
        }
      }
    }
  }

  // merge the warp's slots (lanes LPK apart), then the warps
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), b = exp2f(mo - mn);
      m[g] = mn;
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc_s[warp][g][col + e] = acc[g][e];
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  float* out = part + (((int64_t)bh * NCH + ch) * G + g0) * (DH + 2);
  for (int e = threadIdx.x; e < ng * DH; e += THREADS) {
    const int g = e / DH, c = e - g * DH;
    float mx = RT_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = exp2f(m_s[w][g] - mx);
      num += a * acc_s[w][g][c];
      den += a * l_s[w][g];
    }
    out[g * (DH + 2) + c] = num;
    if (c == 0) {
      out[g * (DH + 2) + DH] = mx;
      out[g * (DH + 2) + DH + 1] = den;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gattn_merge(const float* __restrict__ part, void* __restrict__ out, int G,
            int DH, int NCH, int q_bf16) {
  const int bh = blockIdx.x;
  const float* p = part + (int64_t)bh * NCH * G * (DH + 2);
  for (int e = threadIdx.x; e < G * DH; e += THREADS) {
    const int g = e / DH, c = e - g * DH;
    float mx = RT_NEG_INF;
    for (int i = 0; i < NCH; ++i)
      mx = fmaxf(mx, p[((int64_t)i * G + g) * (DH + 2) + DH]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < NCH; ++i) {
      const float* r = p + ((int64_t)i * G + g) * (DH + 2);
      const float a = exp2f(r[DH] - mx);
      num += a * r[c];
      den += a * r[DH + 1];
    }
    const float res = num / fmaxf(den, 1e-30f);
    const int64_t o = (int64_t)bh * G * DH + e;
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(res);
    else
      static_cast<float*>(out)[o] = res;
  }
}

template <int DH, int GM, bool KV_BF16>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q,
                         const void* k, const void* v, const int* idx,
                         const int* valid, float* part, int G, int S, int BS,
                         int KB, int C, int NCH, int q_bf16, float sl2) {
  gattn_split<DH, GM, KV_BF16><<<grid, THREADS, 0, st>>>(
      q, k, v, idx, valid, part, G, S, BS, KB, C, NCH, q_bf16, sl2);
  return cudaGetLastError();
}

template <int DH, bool KV_BF16>
cudaError_t launch_gm(int G, cudaStream_t st, dim3 grid, const void* q,
                      const void* k, const void* v, const int* idx,
                      const int* valid, float* part, int S, int BS, int KB,
                      int C, int NCH, int q_bf16, float sl2) {
  grid.z = (G + 7) / 8;
  if (G == 1)
    return launch_split<DH, 1, KV_BF16>(grid, st, q, k, v, idx, valid, part, G, S, BS, KB, C, NCH, q_bf16, sl2);
  if (G == 2)
    return launch_split<DH, 2, KV_BF16>(grid, st, q, k, v, idx, valid, part, G, S, BS, KB, C, NCH, q_bf16, sl2);
  if (G <= 4)
    return launch_split<DH, 4, KV_BF16>(grid, st, q, k, v, idx, valid, part, G, S, BS, KB, C, NCH, q_bf16, sl2);
  return launch_split<DH, 8, KV_BF16>(grid, st, q, k, v, idx, valid, part, G, S, BS, KB, C, NCH, q_bf16, sl2);
}

}  // namespace

// BH = B * Hkv; dh in {32, 64, 128}; S a multiple of bs; chunks of c
// blocks, nch = ceil(kb / c) of them (at least 1); part holds BH * nch *
// G * (dh + 2) floats; pointers 16-byte aligned.
RT_EXPORT int golden_attention_launch(const void* q, const void* k,
                                      const void* v, const int* block_idx,
                                      const int* valid, float* part,
                                      void* out, int BH, int G, int S,
                                      int dh, int bs, int kb, int c, int nch,
                                      int q_bf16, int kv_bf16, float scale,
                                      void* stream) {
  if (BH <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || bs <= 0 || S < bs || S % bs != 0 || kb < 0 || c <= 0 ||
      nch <= 0 || (int64_t)nch * c < kb ||
      (int64_t)(nch - 1) * c >= (kb > 0 ? kb : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(BH, nch, 1);
  const float sl2 = scale * LOG2E;
  cudaError_t err;
#define GATTN_DH(D)                                                          \
  case D:                                                                    \
    err = kv_bf16 ? launch_gm<D, true>(G, st, grid, q, k, v, block_idx,      \
                                       valid, part, S, bs, kb, c, nch,       \
                                       q_bf16, sl2)                          \
                  : launch_gm<D, false>(G, st, grid, q, k, v, block_idx,     \
                                        valid, part, S, bs, kb, c, nch,      \
                                        q_bf16, sl2);                        \
    break;
  switch (dh) {
    GATTN_DH(32) GATTN_DH(64) GATTN_DH(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GATTN_DH
  if (err != cudaSuccess) return static_cast<int>(err);
  gattn_merge<<<BH, THREADS, 0, st>>>(part, out, G, dh, nch, q_bf16);
  return static_cast<int>(cudaGetLastError());
}
