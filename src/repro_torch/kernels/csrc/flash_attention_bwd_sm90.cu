// The bf16 backward of causal (or full) GQA flash attention on Hopper's
// tensor cores.  Given q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh], the
// forward's output o and its gradient dO [B, Hkv, G, S, dh], and the
// forward's natural-log row log-sum-exp lse [B, Hkv, G, S] (fp32, from
// flash_attention_sm90.cu), it computes, with scale = dh^-0.5,
//   P  = exp(Q K^T scale - lse)         (the forward's weights, recomputed)
//   D  = rowsum(dO o o)                 (one fp32 number a query row)
//   dS = P o (dO V^T - D)
//   dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO
// over keys j <= i when causal, every key otherwise.  dK and dV of a KV
// head sum over its G query heads.  All sums are fp32; dQ, dK and dV
// come out in bf16.  The fp32 backward stays on the CUDA cores
// (flash_attention_bwd.cu): a TF32 product would miss fp32's tolerance.
//
// Replaces no TPU kernel: the reference has no Pallas backward (no
// custom_vjp in src/repro/) and takes this gradient by autodiff of the
// pure-JAX double scan src/repro/models/layers.py:122.
//
// Bound on the H100: operations.  At B=2, Hkv=8, G=3, S=4096, dh=128,
// causal, the gradient needs five [S, S] x dh products a head (S, dP,
// dQ, dK, dV), 515.5 GFLOP: 0.52 ms at 989 TFLOP/s on the bf16 tensor
// cores, against ~270 MB in and out (0.08 ms at 3.35 TB/s).  This design
// issues seven (S and dP twice, 721.7 GFLOP: 0.73 ms), the price of a
// dQ without float atomics: two calls are bit-equal.
//
// Design: three launches.
//   1. bwd_dot_sm90_kernel: D, one warp a query row.
//   2. bwd_dkdv_sm90_kernel: one CTA per (b * Hkv, tile of 64 NW keys),
//      the tiles with the most query tiles first; NW consumer warpgroups
//      of 64 keys each (wgmma's M) and one producer warp.  K and V of
//      the CTA's keys are loaded once by TMA.  The producer walks the G
//      query heads and, for each, the query tiles of 64 positions from
//      the key tile's diagonal to S, feeding a ring of NST stages: Q and
//      dO by TMA through the forward's 3-D maps over [B Hkv G, S, dh]
//      (a ragged S is zero-filled per head), and the 64 rows' lse (in
//      log2 units) and D by its 32 lanes (0 past S).  Per step a
//      consumer computes
//        S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, both operands
//                                        K-major in shared memory,
//        P^T and dS^T                    on the fp32 accumulator fragments,
//        dV += P^T dO, dK += dS^T Q      wgmma m64n{64,128}k16 with P^T
//                                        and dS^T in registers as A (in
//                                        bf16, the accumulator fragment
//                                        of 16 positions is exactly the A
//                                        fragment of that k16 step) and
//                                        dO, Q as B, MN-major,
//      so P^T and dS^T never touch shared memory.  Step j's dV and dK
//      products run while step j + 1's S^T and dP^T are issued; the
//      stage is released once both have retired.  Causal, warpgroup 1's
//      first tile of a head lies wholly above the diagonal and is
//      computed and masked all the same: skipping it put its products
//      under a branch, which made ptxas serialize every wgmma of the
//      kernel (C7514) and took the launch at [2, 8, 3, 4096, 128] from
//      0.88 to 0.97 ms on an H100.
//   3. bwd_dq_sm90_kernel: one CTA per (b * Hkv, group of W query heads,
//      tile of 64 positions), longest rows first: the forward kernel's
//      grid and warps (W = min(G, 3) consumer warpgroups, one a head,
//      sharing a TMA ring of K and V tiles).  Per key tile up to the
//      diagonal (tiles above it are never loaded): S = Q K^T and dP =
//      dO V^T (SS, K-major), dS in registers, dQ += dS K (RS, K as B
//      MN-major).  Tile j's dQ product runs while tile j + 1's S and dP
//      are issued.
// Only the diagonal tile (causal) and a tile past S are masked; P there
// is 0.  dh = 32 is zero-filled to 64 columns (the forward's maps): the
// score products take dh / 16 steps, the extra output columns are zeros
// and never stored.  Epilogue: the fp32 accumulators times their scale,
// in bf16, into the warpgroup's own K and V (or Q) tile, 16-byte chunks
// XOR-swizzled by row, then 16-byte stores of the rows < S.
// Numerics: P^T and dS (dS^T) are rounded once to bf16 as operands, as
// the mma.sync kernel that this one replaced did.
// Registers: NW = 2 runs 384 threads; setmaxnreg gives the producer
// warpgroup 24 and the consumers 240 (dK, dV: 2 x DH / 2; S^T, dP^T:
// 2 x 32; the bf16 A fragments 2 x 16).  W = 3 as the forward: 24 / 160.
// Not here yet: a single-pass dQ (five products), persistent CTAs.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 64;     // rows a consumer warpgroup: keys (dK/dV), positions (dQ)
constexpr int BN = 64;     // positions a dK/dV step, keys a dQ step
constexpr int NST = 3;     // ring stages
// consumer warpgroups of 64 keys a dK/dV CTA: 2 (128 keys, 384 threads,
// one CTA an SM) took 1.50 ms at the train step's shape where 1 (250
// registers, no setmaxnreg) took 1.62
constexpr int NW = 2;
constexpr float LOG2E = 1.4426950408889634f;

// columns in shared memory (dh = 32 is zero-filled to 64) and the bytes
// of a 64-row tile: variable templates, which device code may read
template <int DH>
constexpr int DH_PAD = DH < 64 ? 64 : DH;
template <int DH>
constexpr int TILE_BYTES = DH_PAD<DH> / 64 * REGION;
__host__ __device__ constexpr int tile_bytes(int dh) {
  return (dh < 64 ? 64 : dh) / 64 * REGION;
}

// Dynamic shared memory, after 1024 bytes of alignment slack.  dK/dV: NW
// K and NW V tiles, NST stages of a Q and a dO tile, NST x (64 lse + 64
// D) floats, 1 + 2 NST mbarriers.  dQ: W Q and W dO tiles, NST K and NST
// V tiles, 1 + 3 NST mbarriers.
constexpr size_t dkdv_smem(int dh) {
  return 1024 + (size_t)(2 * NW + 2 * NST) * tile_bytes(dh) +
         NST * 2 * BN * sizeof(float) + 8 * (1 + 2 * NST);
}
constexpr size_t dq_smem(int w, int dh) {
  return 1024 + (size_t)(2 * w + 2 * NST) * tile_bytes(dh) +
         8 * (1 + 3 * NST);
}

// The bf16 A fragments of a 64 x 64 accumulator: k16 step kk takes
// columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4],
                                        const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// acc += A B over the 64-row tiles at ``a`` and ``b``, both K-major
// (wgmma SS m64n64k16, DH / 16 steps).  Issued, not waited for.
template <int DH>
__device__ __forceinline__ void mm_ss(float (&acc)[32], uint32_t a,
                                      uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk >> 2) * REGION + (kk & 3) * 32;
    wgmma_ss_n64(acc, desc_k(a + off), desc_k(b + off), kk > 0);
  }
}

// d = F B, plus d when ``acc``: F the bf16 fragments of a [64 x 64]
// product, B the 64-row tile at ``b`` read MN-major.  Issued, not waited
// for.
template <int DHP>
__device__ __forceinline__ void mm_rs(float (&d)[DHP / 2],
                                      const uint32_t (&f)[4][4], uint32_t b,
                                      int acc = 1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DHP == 64)
      wgmma_rs_n64(d, f[kk], desc_mn(b + kk * 2048), kk > 0 || acc);
    else
      wgmma_rs_n128(d, f[kk], desc_mn(b + kk * 2048), kk > 0 || acc);
  }
}

// A warpgroup's 64 x DHP fp32 accumulator times ``mul``, in bf16, into
// a 64-row tile of shared memory in the 128-byte swizzle.
template <int DHP>
__device__ __forceinline__ void frag_to_tile(uint8_t* tile,
                                             const float (&acc)[DHP / 2],
                                             float mul, int r0, int cq) {
#pragma unroll
  for (int i = 0; i < DHP / 2; i += 2) {
    const int row = r0 + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + cq;
    const int chunk = (col & 63) >> 3;
    *reinterpret_cast<uint32_t*>(tile + (col >> 6) * REGION + row * 128 +
                                 ((chunk ^ (row & 7)) << 4) +
                                 ((col & 7) << 1)) =
        pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

// Rows row0 + r < S of such a tile to ``out`` (DH columns a row), 16
// bytes a store, by the warpgroup's thread t.
template <int DH>
__device__ __forceinline__ void tile_to_rows(const uint8_t* tile,
                                             bf16_t* out, int row0, int S,
                                             int t) {
  constexpr int CH = DH / 8;                         // 16-byte chunks a row
  for (int e = t; e < BM * CH; e += 128) {
    const int row = e / CH, ch = e - row * CH;
    if (row0 + row >= S) continue;
    *reinterpret_cast<uint4*>(out + (int64_t)(row0 + row) * DH + ch * 8) =
        *reinterpret_cast<const uint4*>(tile + (ch >> 3) * REGION +
                                        row * 128 +
                                        (((ch & 7) ^ (row & 7)) << 4));
  }
}

// D[row] = sum_d dO[row, d] o[row, d] in fp32, one warp a row.
__global__ void __launch_bounds__(256)
bwd_dot_sm90_kernel(const bf16_t* __restrict__ o,
                    const bf16_t* __restrict__ dout, float* __restrict__ dd,
                    int64_t rows, int dh) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = 4 * lane; c < dh; c += 128) {
    const uint2 a = *reinterpret_cast<const uint2*>(dout + row * dh + c);
    const uint2 b = *reinterpret_cast<const uint2*>(o + row * dh + c);
    acc = fmaf(lo_bf16(a.x), lo_bf16(b.x), acc);
    acc = fmaf(hi_bf16(a.x), hi_bf16(b.x), acc);
    acc = fmaf(lo_bf16(a.y), lo_bf16(b.y), acc);
    acc = fmaf(hi_bf16(a.y), hi_bf16(b.y), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) dd[row] = acc;
}

template <int DH>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, bf16_t* __restrict__ dk,
                     bf16_t* __restrict__ dv, int G, int S, int causal,
                     float scale_log2, float scale) {
  constexpr int DHP = DH_PAD<DH>, NC = DHP / 64, TILE = TILE_BYTES<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;    // swizzle needs 1024 B
  const uint32_t v_s = k_s + NW * TILE, q_s = v_s + NW * TILE;
  const uint32_t do_s = q_s + NST * TILE, vec_s = do_s + NST * TILE;
  const uint32_t bar = vec_s + NST * 2 * BN * sizeof(float);
  float* vec = reinterpret_cast<float*>(smem_raw + (vec_s - raw));
  const uint32_t kv_full = bar;
  auto full = [&](int st) { return bar + 8u * (1 + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + NST + st); };

  const int bh = blockIdx.x;
  const int k0 = (int)blockIdx.y * NW * BM;        // most query tiles first
  const int nreal = min(NW, (S - k0 + BM - 1) / BM);   // warpgroups < S
  const int qstart = causal ? k0 : 0;              // earlier rows: masked
  const int nqt = (S - qstart + BN - 1) / BN;      // query tiles a head
  const int nsteps = G * nqt;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1 + 32);     // the TMA's bytes + the warp's lanes
      mbar_init(empty(st), 4 * nreal);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NW) {                                  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid >= NW * 128 + 32) return;              // one warp feeds
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * nreal * TILE);
      for (int i = 0; i < nreal; ++i)
        for (int c = 0; c < NC; ++c) {
          tma_load(k_s + i * TILE + c * REGION, &kmap, kv_full, c * 64,
                   k0 + i * BM, bh);
          tma_load(v_s + i * TILE + c * REGION, &vmap, kv_full, c * 64,
                   k0 + i * BM, bh);
        }
    }
    for (int j = 0; j < nsteps; ++j) {
      const int st = j % NST, g = j / nqt;
      const int q0 = qstart + (j - g * nqt) * BN, plane = bh * G + g;
      if (j >= NST) mbar_wait(empty(st), ((j / NST) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(st), 2 * TILE);
        for (int c = 0; c < NC; ++c) {
          tma_load(q_s + st * TILE + c * REGION, &qmap, full(st), c * 64, q0,
                   plane);
          tma_load(do_s + st * TILE + c * REGION, &domap, full(st), c * 64,
                   q0, plane);
        }
      }
      float* v2 = vec + st * 2 * BN;
      for (int i = lane; i < BN; i += 32) {
        const int pos = q0 + i;
        const int64_t row = (int64_t)plane * S + pos;
        v2[i] = pos < S ? lse[row] * LOG2E : 0.f;
        v2[BN + i] = pos < S ? dd[row] : 0.f;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // consumer warpgroup ``wg``: keys kw .. kw + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  if (wg >= nreal) return;                         // keys past S
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);          // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                   // column within 8
  const int kw = k0 + wg * BM;
  const uint32_t ka = k_s + wg * TILE, va = v_s + wg * TILE;

  float dka[DHP / 2], dva[DHP / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) dka[i] = dva[i] = 0.f;
  uint32_t pa[4][4] = {}, da[4][4] = {};
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));         // the stage is free
  };

  mbar_wait(kv_full, 0);
  for (int j = 0; j < nsteps; ++j) {
    const int st = j % NST, g = j / nqt;
    const int q0 = qstart + (j - g * nqt) * BN;
    const uint32_t qb = q_s + st * TILE, ob = do_s + st * TILE;
    const float* v2 = vec + st * 2 * BN;
    mbar_wait(full(st), (j / NST) & 1);
    wg_fence();
    mm_ss<DH>(s, ka, qb);                          // S^T = K Q^T
    wg_commit();
    mm_ss<DH>(dp, va, ob);                         // dP^T = V dO^T
    wg_commit();
    wg_wait<1>();            // S^T, and step j - 1's dV and dK products
    pin(s);
    pin(dka);
    pin(dva);
    pin(pa);
    pin(da);
    if (j > 0) release((j - 1) % NST);
    // P^T: rows are keys, columns positions; lse in log2 units
    const bool edge = (causal && q0 < kw + BM) || q0 + BN > S || kw + BM > S;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 8 * (i >> 2) + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(v2 + col);
      float p0 = exp2f(fmaf(s[i], scale_log2, -l2.x));
      float p1 = exp2f(fmaf(s[i + 1], scale_log2, -l2.y));
      if (edge) {
        const int key = kw + r0 + ((i & 2) ? 8 : 0), pos = q0 + col;
        if (key >= S || pos >= S || (causal && key > pos)) p0 = 0.f;
        if (key >= S || pos + 1 >= S || (causal && key > pos + 1)) p1 = 0.f;
      }
      s[i] = p0;
      s[i + 1] = p1;
    }
    to_frag(pa, s);
    pin(dva);
    wg_fence();
    mm_rs<DHP>(dva, pa, ob);                       // dV += P^T dO
    wg_commit();
    wg_wait<1>();                                  // dP^T
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 d2 = *reinterpret_cast<const float2*>(
          v2 + BN + 8 * (i >> 2) + cq);
      dp[i] = s[i] * (dp[i] - d2.x);               // dS^T
      dp[i + 1] = s[i + 1] * (dp[i + 1] - d2.y);
    }
    to_frag(da, dp);
    pin(dka);
    wg_fence();
    mm_rs<DHP>(dka, da, qb);                       // dK += dS^T Q
    wg_commit();
  }
  wg_wait<0>();
  pin(dka);
  pin(dva);
  release((nsteps - 1) % NST);

  // epilogue: dK scale and dV in bf16 through this warpgroup's K, V tiles
  uint8_t* ktile = smem_raw + (ka - raw);
  uint8_t* vtile = smem_raw + (va - raw);
  frag_to_tile<DHP>(ktile, dka, scale, r0, cq);
  frag_to_tile<DHP>(vtile, dva, 1.f, r0, cq);
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
  tile_to_rows<DH>(ktile, dk + (int64_t)bh * S * DH, kw, S, t);
  tile_to_rows<DH>(vtile, dv + (int64_t)bh * S * DH, kw, S, t);
}

template <int W, int DH>
__global__ void __launch_bounds__(128 * (W + 1), 1)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, bf16_t* __restrict__ dq,
                   int G, int S, int causal, float scale_log2, float scale) {
  constexpr int DHP = DH_PAD<DH>, NC = DHP / 64, TILE = TILE_BYTES<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;    // swizzle needs 1024 B
  const uint32_t do_s = q_s + W * TILE, k_s = do_s + W * TILE;
  const uint32_t v_s = k_s + NST * TILE, bar = v_s + NST * TILE;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + NST + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + 2 * NST + st); };

  const int bh = blockIdx.x, hg = blockIdx.y;
  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BM;   // longest rows first
  const int nreal = min(W, G - hg * W);              // heads, not padding
  const int kend = causal ? min(S, q0 + BM) : S;
  const int nk = (kend + BN - 1) / BN;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4 * nreal);               // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == W) {                                     // producer warpgroup
    if constexpr (W == 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == W * 128) {
      mbar_expect_tx(q_full, 2 * nreal * TILE);
      for (int i = 0; i < nreal; ++i)
        for (int c = 0; c < NC; ++c) {
          const int plane = bh * G + hg * W + i;
          tma_load(q_s + i * TILE + c * REGION, &qmap, q_full, c * 64, q0,
                   plane);
          tma_load(do_s + i * TILE + c * REGION, &domap, q_full, c * 64, q0,
                   plane);
        }
      for (int j = 0; j < nk; ++j) {
        const int st = j % NST;
        if (j >= NST) mbar_wait(empty(st), ((j / NST) - 1) & 1);
        mbar_expect_tx(k_full(st), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(k_s + st * TILE + c * REGION, &kmap, k_full(st), c * 64,
                   j * BN, bh);
        mbar_expect_tx(v_full(st), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(v_s + st * TILE + c * REGION, &vmap, v_full(st), c * 64,
                   j * BN, bh);
      }
    }
    return;
  }

  // consumer warpgroup ``wg``: rows (head hg * W + wg, positions q0 + 0..63)
  if constexpr (W == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
  if (wg >= nreal) return;                           // padding
  const int plane = bh * G + hg * W + wg;
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);            // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                     // column within 8
  const uint32_t qa = q_s + wg * TILE, oa = do_s + wg * TILE;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;      // rows past S: 0
  if (q0 + r0 < S) {
    l0 = lse[(int64_t)plane * S + q0 + r0] * LOG2E;
    d0 = dd[(int64_t)plane * S + q0 + r0];
  }
  if (q0 + r0 + 8 < S) {
    l1 = lse[(int64_t)plane * S + q0 + r0 + 8] * LOG2E;
    d1 = dd[(int64_t)plane * S + q0 + r0 + 8];
  }

  // dQ starts from the first product (no zeros written into wgmma's
  // accumulator: ptxas serialized every wgmma of the pipeline for them,
  // warning C7515)
  float dqa[DHP / 2], s[32], dp[32];
  uint32_t da[4][4] = {};

  // S = Q K^T and dP = dO V^T of key tile j, issued, not waited for
  auto issue = [&](int j) {
    const int st = j % NST;
    mbar_wait(k_full(st), (j / NST) & 1);
    mbar_wait(v_full(st), (j / NST) & 1);
    wg_fence();
    mm_ss<DH>(s, qa, k_s + st * TILE);
    wg_commit();
    mm_ss<DH>(dp, oa, v_s + st * TILE);
    wg_commit();
  };
  // dS of key tile j in registers, then dQ += dS K, issued
  auto body = [&](int j) {
    const int st = j % NST, k0 = j * BN;
    wg_wait<1>();                        // S, and tile j - 1's dQ product
    pin(s);
    pin(dqa);
    pin(da);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((j - 1) % NST));
    }
    const bool edge = (causal && k0 + BN > q0) || k0 + BN > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(s[i], scale_log2, (i & 2) ? -l1 : -l0));
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int pos = q0 + r0 + ((i & 2) ? 8 : 0);
        if (key >= S || (causal && key > pos)) p = 0.f;
      }
      s[i] = p;
    }
    wg_wait<0>();                                    // dP
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0));
    to_frag(da, dp);
    pin(dqa);
    wg_fence();
    mm_rs<DHP>(dqa, da, k_s + st * TILE, j > 0);     // dQ += dS K
    wg_commit();
  };

  mbar_wait(q_full, 0);
  issue(0);
  for (int j = 0; j + 1 < nk; ++j) {    // the last tile peeled: no wgmma
    body(j);                            // is issued under a condition
    issue(j + 1);
  }
  body(nk - 1);
  wg_wait<0>();
  pin(dqa);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty((nk - 1) % NST));

  // epilogue: dQ scale in bf16 through this warpgroup's Q tile
  uint8_t* tile = smem_raw + (qa - raw);
  frag_to_tile<DHP>(tile, dqa, scale, r0, cq);
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
  tile_to_rows<DH>(tile, dq + (int64_t)plane * S * DH, q0, S, t);
}

template <int DH>
cudaError_t launch_dkdv(dim3 grid, cudaStream_t st, const CUtensorMap& qm,
                        const CUtensorMap& km, const CUtensorMap& vm,
                        const CUtensorMap& dom, const float* lse,
                        const float* dd, void* dk, void* dv, int G, int S,
                        int causal, float scale_log2, float scale) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkdv_smem(DH));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  bwd_dkdv_sm90_kernel<DH><<<grid, 128 * (NW + 1), dkdv_smem(DH), st>>>(
          qm, km, vm, dom, lse, dd, static_cast<bf16_t*>(dk),
          static_cast<bf16_t*>(dv), G, S, causal, scale_log2, scale);
  return cudaGetLastError();
}

template <int W, int DH>
cudaError_t launch_dq(dim3 grid, cudaStream_t st, const CUtensorMap& qm,
                      const CUtensorMap& km, const CUtensorMap& vm,
                      const CUtensorMap& dom, const float* lse,
                      const float* dd, void* dq, int G, int S, int causal,
                      float scale_log2, float scale) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_sm90_kernel<W, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(W, DH));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  bwd_dq_sm90_kernel<W, DH><<<grid, 128 * (W + 1), dq_smem(W, DH), st>>>(
      qm, km, vm, dom, lse, dd, static_cast<bf16_t*>(dq), G, S, causal,
      scale_log2, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int w, int BH, cudaStream_t st,
                      const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, const CUtensorMap& dom,
                      const float* lse, const float* dd, void* dq, void* dk,
                      void* dv, int G, int S, int causal, float scale) {
  const float sl2 = scale * LOG2E;
  const dim3 gkv(BH, (S + NW * BM - 1) / (NW * BM));
  const cudaError_t err = launch_dkdv<DH>(gkv, st, qm, km, vm, dom, lse, dd,
                                          dk, dv, G, S, causal, sl2, scale);
  if (err != cudaSuccess) return err;
  const dim3 gq(BH, (G + w - 1) / w, (S + BM - 1) / BM);
  switch (w) {
    case 1: return launch_dq<1, DH>(gq, st, qm, km, vm, dom, lse, dd, dq, G, S, causal, sl2, scale);
    case 2: return launch_dq<2, DH>(gq, st, qm, km, vm, dom, lse, dd, dq, G, S, causal, sl2, scale);
    default: return launch_dq<3, DH>(gq, st, qm, km, vm, dom, lse, dd, dq, G, S, causal, sl2, scale);
  }
}

}  // namespace

// Consumer warpgroups of 64 keys a dK/dV CTA.
RT_EXPORT int flash_attention_bwd_sm90_dkdv_warpgroups() { return NW; }

// Dynamic shared memory of a CTA: the dQ launch's with w query heads,
// the dK/dV launch's for w = 0.
RT_EXPORT size_t flash_attention_bwd_sm90_smem_bytes(int w, int dh) {
  return w ? dq_smem(w, dh) : dkdv_smem(dh);
}

// BH = B * Hkv; every tensor contiguous bf16: q, o, dout, dq [BH, G, S,
// dh], k, v, dk, dv [BH, S, dh]; lse and the scratch dd [BH, G, S] fp32;
// dh in {32, 64, 128}; w in {1, 2, 3} query heads a dQ CTA (the
// wrapper's plan); pointers 16-byte aligned.  Three launches on
// ``stream``.
RT_EXPORT int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dd, void* dq, void* dk,
    void* dv, int BH, int G, int S, int dh, int w, int causal, float scale,
    void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || w < 1 || w > 3 ||
      (dh != 32 && dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, dh, S, BH * G) || !make_map(&km, k, dh, S, BH) ||
      !make_map(&vm, v, dh, S, BH) || !make_map(&dom, dout, dh, S, BH * G))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)BH * G * S;
  bwd_dot_sm90_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const bf16_t*>(o), static_cast<const bf16_t*>(dout), dd,
      rows, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dh) {
    case 32: err = launch_dh<32>(w, BH, st, qm, km, vm, dom, lse, dd, dq, dk, dv, G, S, causal, scale); break;
    case 64: err = launch_dh<64>(w, BH, st, qm, km, vm, dom, lse, dd, dq, dk, dv, G, S, causal, scale); break;
    default: err = launch_dh<128>(w, BH, st, qm, km, vm, dom, lse, dd, dq, dk, dv, G, S, causal, scale); break;
  }
  return static_cast<int>(err);
}
