// Causal (or full) GQA flash attention in bf16 on Hopper's tensor cores:
//   out[b, h, g, i] = sum_j softmax_j(q[b, h, g, i] . k[b, h, j] * dh^-0.5) v[b, h, j]
// over keys j <= i when causal, every key otherwise.
// q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh], all bf16, dh in {32, 64, 128}
// -> out [B, Hkv, G, S, dh] in bf16; fp32 accumulation; and, given a
// non-null pointer, the row log-sum-exp of the scaled scores lse [B, Hkv,
// G, S] = m + log l in fp32 for the backward (flash_attention_bwd.cu):
// m and log2 l are kept in log2 units here, so lse = (m + log2 l) ln 2.
// The prefill passes null and writes nothing more.  The fp32 route
// stays on the CUDA cores (flash_attention.cu): a tensor-core product in
// TF32 would not hold fp32's tolerance.
//
// Replaces: src/repro/kernels/flash_attention.py:85 (flash_attention /
// _flash_kernel :25).  Kept from the TPU kernel: the fp32 online softmax
// (running max m from NEG_INF, denominator l, accumulator acc), scores
// scaled after the dot product, causal tiles above the diagonal never
// loaded, and acc / max(l, 1e-30) rounded once to bf16.  One numeric
// change: wgmma takes bf16 operands, and the TPU kernel keeps the
// weights P in fp32.  P rounded once to bf16 (8 bits) moved outputs of a
// few units by one bf16 step (0.0156 at [2, 4), over the 1e-2 check), so
// P goes in as two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi)
// (about 16 bits), both multiplied by V: the P V product costs twice,
// the score product once.  l sums the fp32 weights.  Masked keys get
// -inf before the row max, so a row's max is one of its own scores.
// Bound on the H100: operations.  At B=2, Hkv=8, G=3, S=4096, dh=128,
// causal, the work is ~206 GFLOP (0.21 ms at 989 TFLOP/s on the bf16
// tensor cores) against 134 MB of bf16 in and out (0.04 ms at 3.35 TB/s).
//
// Design (tiles: BQ = 64 query positions, BK = 64 keys, NST = 3 stages):
// one CTA per (b * Hkv, group of W query heads, tile of 64 positions),
// with W consumer warpgroups (W = min(G, 3), the wrapper's plan) and one
// producer warpgroup.  Warpgroup w owns the 64 rows (head g0 + w,
// positions q0 .. q0 + 63): wgmma's M.  A head group past G is padding:
// its warpgroup exits at once.  All W heads share every K/V tile, which
// crosses HBM once per tile for the W heads.  The grid's slowest index
// is the query tile, longest causal rows first.
// Loads: one producer thread issues TMA copies through 3-D tensor maps,
// Q [B*Hkv*G, S, dh] and K, V [B*Hkv, S, dh], 64 x 64-column boxes with
// the 128-byte swizzle, so a ragged S is zero-filled per head and never
// reads the next head's rows (dh = 32 is zero-filled to 64 columns: the
// score product takes only dh / 16 steps, the P V product's extra
// columns are zeros and never stored).  Q once; K and V into a ring of
// NST stages, each with a "full" mbarrier per tensor (TMA's transaction
// count) and an "empty" mbarrier that each consumer warp arrives on.
// Descriptors are built on the host in the C entry point
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda)
// and passed as __grid_constant__ parameters.
// S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory,
// K-major, 128-byte swizzle (a descriptor step of 32 bytes per k16 inside
// a 64-column region, a region of 8 KB further for dh = 128).
// Inside a warpgroup, tile j's P V product runs on the tensor cores while
// the softmax of tile j + 1 runs on the CUDA cores (S(j + 1) is issued
// before P(j) V(j); wgmma groups complete in order).
// Softmax on the fp32 accumulator fragments in registers: each thread
// holds rows r and r + 8 of its warp's 16; the row max reduces over the 4
// lanes of a quad by shuffles; l is summed per thread and over the quad
// once at the end.  Scores are kept in log2 units (scale * log2 e folded
// into one multiply, exp2f).
// O += P_hi V + P_lo V: P converted to bf16 in registers is wgmma's A
// operand (the accumulator fragment of k16 step kk is exactly the A
// fragment), V the B operand from shared memory, MN-major (transposed),
// so P never goes through shared memory.  wgmma m64n{64,128}k16.
// Epilogue: O / max(l, 1e-30) in bf16 into the warpgroup's own Q tile
// (16-byte chunks XOR-swizzled by row: no bank conflicts), then 16-byte
// stores of the rows < S.
// Registers: W = 3 runs 512 threads at 128 registers each; setmaxnreg
// gives the producer 24 and the consumers 160.
// Not here yet: persistent CTAs, ping-pong scheduling of the warpgroups,
// fp8.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;              // query positions a warpgroup (wgmma M)
constexpr int BK = 64;              // keys a tile
constexpr int NST = 3;              // K/V ring stages
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory of a CTA: 1024 bytes of alignment slack, W Q
// tiles, NST K and NST V tiles, then the 1 + 3 NST mbarriers.
constexpr size_t smem_bytes(int w, int dh) {
  return 1024 + (size_t)(w + 2 * NST) * ((dh < 64 ? 64 : dh) / 64) * REGION +
         8 * (1 + 3 * NST);
}

template <int W, int DH>
struct Cfg {
  static constexpr int DHP = DH < 64 ? 64 : DH;   // columns in shared memory
  static constexpr int NC = DHP / 64;             // 128-byte column regions
  static constexpr int TILE = NC * REGION;        // bytes of a 64-row tile
  static constexpr int THREADS = 128 * (W + 1);
  static constexpr size_t SMEM = smem_bytes(W, DH);
};

template <int W, int DH>
__global__ void __launch_bounds__(128 * (W + 1), 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int G, int S, int causal, float scale_log2) {
  using C = Cfg<W, DH>;
  constexpr int DHP = C::DHP, NC = C::NC, TILE = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;    // swizzle needs 1024 B
  const uint32_t k_s = q_s + W * TILE, v_s = k_s + NST * TILE;
  const uint32_t bar = v_s + NST * TILE;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + NST + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + 2 * NST + st); };

  const int bh = blockIdx.x, hg = blockIdx.y;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BQ;   // longest rows first
  const int nreal = min(W, G - hg * W);              // heads, not padding
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nk = (kend + BK - 1) / BK;
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
      mbar_expect_tx(q_full, nreal * TILE);
      for (int i = 0; i < nreal; ++i)
        for (int c = 0; c < NC; ++c)
          tma_load(q_s + i * TILE + c * REGION, &qmap, q_full, c * 64, q0,
                   bh * G + hg * W + i);
      for (int j = 0; j < nk; ++j) {
        const int st = j % NST;
        if (j >= NST) mbar_wait(empty(st), ((j / NST) - 1) & 1);
        mbar_expect_tx(k_full(st), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(k_s + st * TILE + c * REGION, &kmap, k_full(st), c * 64,
                   j * BK, bh);
        mbar_expect_tx(v_full(st), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(v_s + st * TILE + c * REGION, &vmap, v_full(st), c * 64,
                   j * BK, bh);
      }
    }
    return;
  }

  // consumer warpgroup ``wg``: rows (head g0 + wg, positions q0 + 0..63)
  if constexpr (W == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
  if (wg >= nreal) return;                           // padding
  const int head = hg * W + wg;
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);            // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                     // column within 8
  const uint32_t qa = q_s + wg * TILE;

  float o[DHP / 2], s[32];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float m0 = RT_NEG_INF, m1 = RT_NEG_INF, l0 = 0.f, l1 = 0.f, c0, c1;
  uint32_t hi[4][4], lo[4][4];

  // S = Q K^T of tile j into s (issued, not waited for)
  auto issue_scores = [&](int j) {
    const uint32_t kb = k_s + (j % NST) * TILE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * REGION + (kk & 3) * 32;
      wgmma_ss_n64(s, desc_k(qa + off), desc_k(kb + off), kk > 0);
    }
    wg_commit();
  };
  // the online softmax of tile j on s: masks, updates m and l, leaves the
  // fp32 weights in s and the rescale factors of o in c0, c1
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int pos = q0 + r0 + ((i & 2) ? 8 : 0);
        if (key >= S || (causal && key > pos)) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    c0 = exp2f(m0 - mn0);
    c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(fmaf(s[i], scale_log2, (i & 2) ? -mn1 : -mn0));
      s[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  };
  // P = P_hi + P_lo in two bf16 terms: the accumulator fragment of keys
  // 16 kk .. 16 kk + 15 is wgmma's A fragment for that k16 step
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
        hi[kk][r] = pack_bf16(a, b);
        const float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]));
        lo[kk][r] = pack_bf16(a - h.x, b - h.y);
      }
  };

  // O += P(j) V(j), issued, not waited for
  auto issue_pv = [&](int j) {
    const int st = j % NST;
    mbar_wait(v_full(st), (j / NST) & 1);
    const uint32_t vb = v_s + st * TILE;
    pin(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn(vb + kk * 2048);
      if constexpr (DHP == 64) {
        wgmma_rs_n64(o, hi[kk], dv);
        wgmma_rs_n64(o, lo[kk], dv);
      } else {
        wgmma_rs_n128(o, hi[kk], dv);
        wgmma_rs_n128(o, lo[kk], dv);
      }
    }
    wg_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % NST));      // the stage is free
  };

  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  issue_scores(0);
  wg_wait<0>();
  pin(s);
  softmax(0);
  split();
  // Tile j's P V product runs while tile j + 1's softmax does: S(j + 1)
  // is issued first, then P(j) V(j); the wait for all but the newest
  // group gives S(j + 1), the wait for both gives O.
  for (int j = 0; j + 1 < nk; ++j) {
    mbar_wait(k_full((j + 1) % NST), ((j + 1) / NST) & 1);
    issue_scores(j + 1);
    issue_pv(j);
    wg_wait<1>();
    pin(s);
    softmax(j + 1);
    wg_wait<0>();
    pin(o);
    pin(hi);                       // read by the P V product until here
    pin(lo);
    release(j);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] *= (i & 2) ? c1 : c0;
    split();
  }
  issue_pv(nk - 1);
  wg_wait<0>();
  pin(o);
  release(nk - 1);

  // epilogue: O / max(l, 1e-30) in bf16 through this warpgroup's Q tile
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    const int64_t row = (int64_t)(bh * G + head) * S + q0 + r0;
    if (q0 + r0 < S) lse[row] = (m0 + log2f(d0)) * LN2;
    if (q0 + r0 + 8 < S) lse[row + 8] = (m1 + log2f(d1)) * LN2;
  }
  uint8_t* tile = smem_raw + (qa - raw);
#pragma unroll
  for (int i = 0; i < DHP / 2; i += 2) {
    const int row = r0 + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + cq;
    const float d = (i & 2) ? d1 : d0;
    const int chunk = (col & 63) >> 3;
    *reinterpret_cast<uint32_t*>(tile + (col >> 6) * REGION + row * 128 +
                                 ((chunk ^ (row & 7)) << 4) +
                                 ((col & 7) << 1)) =
        pack_bf16(o[i] / d, o[i + 1] / d);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
  constexpr int CH = DH / 8;                         // 16-byte chunks a row
  const int64_t plane = (int64_t)(bh * G + head) * S;
  for (int e = t; e < BQ * CH; e += 128) {
    const int row = e / CH, ch = e - row * CH;
    if (q0 + row >= S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (ch >> 3) * REGION + row * 128 + (((ch & 7) ^ (row & 7)) << 4));
    *reinterpret_cast<uint4*>(out + (plane + q0 + row) * DH + ch * 8) = val;
  }
}

template <int W, int DH>
cudaError_t launch(dim3 grid, cudaStream_t st, const CUtensorMap& qm,
                   const CUtensorMap& km, const CUtensorMap& vm, void* out,
                   float* lse, int G, int S, int causal, float scale_log2) {
  using C = Cfg<W, DH>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_sm90_kernel<W, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  flash_sm90_kernel<W, DH><<<grid, C::THREADS, C::SMEM, st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, G, S, causal,
      scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_w(int w, dim3 grid, cudaStream_t st, const CUtensorMap& qm,
                     const CUtensorMap& km, const CUtensorMap& vm, void* out,
                     float* lse, int G, int S, int causal, float scale_log2) {
  switch (w) {
    case 1: return launch<1, DH>(grid, st, qm, km, vm, out, lse, G, S, causal, scale_log2);
    case 2: return launch<2, DH>(grid, st, qm, km, vm, out, lse, G, S, causal, scale_log2);
    case 3: return launch<3, DH>(grid, st, qm, km, vm, out, lse, G, S, causal, scale_log2);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

RT_EXPORT size_t flash_attention_sm90_smem_bytes(int w, int dh) {
  return smem_bytes(w, dh);
}

// BH = B * Hkv; w consumer warpgroups a CTA (1-3, the wrapper's plan:
// heads of a CTA); dh in {32, 64, 128}; bf16 pointers 16-byte aligned;
// lse [BH, G, S] fp32 or null (nothing written).
RT_EXPORT int flash_attention_sm90_launch(const void* q, const void* k,
                                          const void* v, void* out, float* lse,
                                          int BH,
                                          int G, int S, int dh, int w,
                                          int causal, float scale,
                                          void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || w < 1 || w > 3 || (dh != 32 && dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, dh, S, BH * G) || !make_map(&km, k, dh, S, BH) ||
      !make_map(&vm, v, dh, S, BH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = (S + BQ - 1) / BQ;
  dim3 grid(BH, (G + w - 1) / w, nq);
  const float sl2 = scale * LOG2E;
  cudaError_t err;
  switch (dh) {
    case 32: err = launch_w<32>(w, grid, st, qm, km, vm, out, lse, G, S, causal, sl2); break;
    case 64: err = launch_w<64>(w, grid, st, qm, km, vm, out, lse, G, S, causal, sl2); break;
    default: err = launch_w<128>(w, grid, st, qm, km, vm, out, lse, G, S, causal, sl2); break;
  }
  return static_cast<int>(err);
}
