// The distance stage kernels 1 (pdist.cu) and 4 (golden_aggregate.cu)
// share: store rows staged in shared memory by TMA bulk copies, and
// products with them on the tensor cores, in fp32 to within the 3xTF32
// split.
//
// Why tensor cores: a CUDA-core dot tile of 4 queries x 4 rows a thread
// loads 2 floats from shared memory a FMA, and an SM reads 32 floats a
// clock against 128 FMAs, so the FMAs wait on the loads.  mma.sync
// m16n8k8 (TF32 inputs, fp32 sums) does 1024 multiply-adds a warp for 2
// fragment floats a lane of the store operand.
// Why 3xTF32: TF32 keeps 10 mantissa bits.  Each operand a is split
// into hi = a with its 13 low mantissa bits cleared and lo = (a - hi)
// likewise cleared (a - hi is exact), and a.b is taken as lo_a hi_b +
// hi_a lo_b + hi_a hi_b (three MMAs, small terms first).  Each of the
// dropped lo_a lo_b and the two truncations of lo is below 2^-20 of
// |a b|.  The split is two integer ANDs and a subtraction: cvt.rna.tf32
// runs on the conversion pipe, far below the FP32 rate, and each
// staged store float is split twice a tile.  The logits of kernel 4 are
// -d2 / (2 sigma^2) with d2 a cancelling difference, so one TF32 MMA
// would move the weights far beyond the 1e-4 contract
// (tests/test_torch_full_scan.py emulates both).  Integer data below
// 2^11 is exact in TF32 (lo = 0) and its sums below 2^24 are exact: the
// kernels stay bit-equal to the plain versions there.
//
// Layout: a staged row of `cols` columns has a stride of dt_stride(cols)
// floats (8 more than a multiple of 32), and row r starts (r & 4) floats
// later (rows 4-7 of every 8 shift by 16 bytes).  Both fragment patterns
// are then conflict-free: the B operand of Q X^T (lane (g, t) reads row
// g, column t: banks 8 g + 4 [g >= 4] + t) and the B operand of P X (row
// t or t + 4, column g: banks 8 t + g and 8 t + 4 + g), where g = lane / 4
// and t = lane % 4.  Each row stays contiguous, so one TMA bulk copy
// fills it.
//
// Loads: TMA copies into a ring of stages, each completing on its
// stage's mbarrier, which the consumers wait on; no thread stalls on
// per-thread copy requests (16-byte cp.async from every thread held
// each CTA at its next barrier).  Kernel 4 bulk-copies each staged row
// (the layout above; the copy engine takes them one at a time and the
// issuing warp waits, so every warp issues two rows of a tile).
// Kernel 1 copies 32-column boxes through a tensor map with 128-byte
// swizzle (Sw128 below): six copies a 64-row tile instead of 64.  Both
// need rows of a multiple of 16 bytes, 16-byte aligned: the wrappers
// pad fp32 rows when they are not and refuse such bf16 rows
// (kernels/golden_aggregate.py ``rows16``).
//
// bf16 store rows (the engine's storage_dtype): the staged rows are
// bf16, half the bytes, in the same layouts counted in elements (a row's
// shift is still 16 bytes; a swizzled box is 64 columns of 128 bytes).
// A bf16 value is exact in TF32, so a store fragment's lo is 0 and the
// hi_a lo_b product vanishes: the bf16 instances issue two MMAs, lo_a
// hi_b + hi_a hi_b, with the same sums as the three (Rows / Sw128
// kExact).
#pragma once

#include "common.cuh"

namespace dtile {

constexpr int Q = 16;    // queries of a group: the MMA's M
constexpr int R = 16;    // rows of a tile (two MMA n-tiles of 8)

// a staged row's stride in floats for `cols` columns
__host__ __device__ constexpr int dt_stride(int cols) {
  return (cols + 31) / 32 * 32 + 8;
}

// staged row r of a tile at base (rows 4-7 of every 8 shift 16 bytes)
template <typename T>
__device__ __forceinline__ T* row_at(T* base, int stride, int r) {
  return base + r * stride + (r & 4) * (4 / (int)sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

// make the mbarriers' initialization visible to the copy engine
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrive on bar and expect `bytes` more bytes of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Zero n floats of shared memory (a multiple of 4, 16-byte aligned) from
// all threads, then order the writes before the bulk copies.  The rows
// and columns no copy fills (past N, past D, past B) stay 0 or hold
// earlier finite rows.
__device__ __forceinline__ void zero_smem(float* p, int n, int tid,
                                          int nthreads) {
  for (int i = 4 * tid; i < n; i += 4 * nthreads)
    *reinterpret_cast<float4*>(p + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();
}

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 bits

// x = hi + lo to within 2^-20 of |x|, both TF32 (truncated)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment (b0, b1), split: hi in h, lo in l
struct BFrag {
  uint32_t h[2], l[2];
};

__device__ __forceinline__ BFrag b_split(float b0, float b1) {
  BFrag f;
  split(b0, f.h[0], f.l[0]);
  split(b1, f.h[1], f.l[1]);
  return f;
}

// a bf16 pair is exact in TF32: hi is the widened value, lo is 0
__device__ __forceinline__ BFrag b_split(bf16_t b0, bf16_t b1) {
  BFrag f;
  f.h[0] = __float_as_uint(widen(b0));
  f.h[1] = __float_as_uint(widen(b1));
  f.l[0] = f.l[1] = 0u;
  return f;
}

// The three MMAs of the 3xTF32 split, one pass each: callers issue a pass
// over several independent accumulators before the next, so that no MMA
// waits on the one just before it.
__device__ __forceinline__ void mma_lo_hi(float (&d)[4],
                                          const uint32_t (&al)[4],
                                          const BFrag& b) {
  mma(d, al, b.h[0], b.h[1]);
}
__device__ __forceinline__ void mma_hi_lo(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const BFrag& b) {
  mma(d, ah, b.l[0], b.l[1]);
}
__device__ __forceinline__ void mma_hi_hi(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const BFrag& b) {
  mma(d, ah, b.h[0], b.h[1]);
}

// Staged rows as laid out above (kernel 4's bulk copies), of fp32 or
// bf16 (kExact: lo fragments are 0).
template <typename T>
struct Rows {
  static constexpr bool kExact = sizeof(T) == 2;
  const T* base;
  int stride;
  __device__ __forceinline__ const T* at(int r, int c) const {
    return row_at(base, stride, r) + c;
  }
};

// Staged rows as a TMA tensor copy with 128-byte swizzle lays them out
// (kernel 1): boxes of `rows` rows x 128 bytes (BC = 32 fp32 or 64 bf16
// columns), box b at b rows BC elements; the 16-byte chunk j (E = 4 fp32
// or 8 bf16) of row r of a box sits at chunk j ^ (r % 8).  Conflict-free
// for Q X^T's fragments of fp32 (row g: chunk j ^ g).
template <typename T>
struct Sw128 {
  static constexpr bool kExact = sizeof(T) == 2;
  static constexpr int E = 16 / sizeof(T), BC = 128 / sizeof(T);
  const T* base;
  int rows;
  __device__ __forceinline__ const T* at(int r, int c) const {
    return base + (c / BC) * rows * BC + r * BC +
           ((((c / E) & 7) ^ (r & 7)) * E) + (c % E);
  }
};

// The A fragment (rows g, g + 8; columns k0 + t, k0 + t + 4) of 16 staged
// query rows, split.
template <class L>
__device__ __forceinline__ void a_frag(const L& s, int k0, int lane,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane >> 2, t = lane & 3;
  split(*s.at(g, k0 + t), hi[0], lo[0]);
  split(*s.at(g + 8, k0 + t), hi[1], lo[1]);
  split(*s.at(g, k0 + t + 4), hi[2], lo[2]);
  split(*s.at(g + 8, k0 + t + 4), hi[3], lo[3]);
}

// acc[u][n] += Q[16, k_u:k_u+8] X[rows r0 + 8 n + (0..7), k_u:k_u+8]^T for
// two steps k_0 = k0, k_1 = k0 + dk (the second only if `two`; A
// fragments (ah0, al0) and (ah1, al1)) and the two n-tiles of the 16
// staged rows from r0 (r0 % 8 == 0): four independent sums.
template <class L>
__device__ __forceinline__ void qxt_pair(float (&acc)[2][2][4],
                                         const uint32_t (&ah0)[4],
                                         const uint32_t (&al0)[4],
                                         const uint32_t (&ah1)[4],
                                         const uint32_t (&al1)[4], bool two,
                                         const L& xs, int r0, int k0, int dk,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  BFrag b[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int r = r0 + 8 * n + g, c = k0 + dk * u + t;
      b[u][n] = u == 0 || two ? b_split(*xs.at(r, c), *xs.at(r, c + 4))
                              : BFrag{};
    }
#pragma unroll
  for (int n = 0; n < 2; ++n) mma_lo_hi(acc[0][n], al0, b[0][n]);
  if (two)
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_lo_hi(acc[1][n], al1, b[1][n]);
  if (!L::kExact) {
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_hi_lo(acc[0][n], ah0, b[0][n]);
    if (two)
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_hi_lo(acc[1][n], ah1, b[1][n]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) mma_hi_hi(acc[0][n], ah0, b[0][n]);
  if (two)
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_hi_hi(acc[1][n], ah1, b[1][n]);
}

// Store a warp's [16, 8 NT] C fragments as red[q * ld + r] (float2s).
template <int NT>
__device__ __forceinline__ void store_c(const float (&acc)[NT][4], float* red,
                                        int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(red + g * ld + 8 * n + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(red + (g + 8) * ld + 8 * n + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

}  // namespace dtile
