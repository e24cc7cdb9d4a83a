// Coarse-screen distances d2[b, j] = max(||q_b||^2 + ||x_j||^2 - 2 q_b.x_j, 0)
// for q [B, d] against every proxy row x [N, d], on the tensor cores in
// fp32 to within the 3xTF32 split (dist_tile.cuh).
//
// Replaces: src/repro/kernels/pdist.py:61 (pdist / _pdist_kernel :25).
// Bound on the H100: bytes.  At B=16, N=50000, d=192 the proxy store is
// 38.4 MB read once and the output 3.2 MB written once, against 0.31
// GFLOP: about 12 us of HBM traffic and 5 us of fp32 FMA work.
// Design: persistent CTAs, one an SM, walk 64-row tiles of the store
// (tile k of the CTA is blockIdx.x + k gridDim.x) for one group of 16
// queries.  Each tile streams through a ring of STAGES stages as TMA
// tensor copies of 64-row x 32-column boxes (one a 32 columns, 128-byte
// swizzle, zeros past N and d), issued from one warp and completing on
// the stage's mbarrier, STAGES - 1 tiles ahead of the products.  d up to
// 256 columns is one slab, and the group's queries, copied once, stay
// resident for the CTA's whole walk; a wider d streams in slabs of 256
// columns, each with its slab of the queries.  (Per-row bulk copies, 64
// a tile, ran at the copy engine's rate per copy, not at the bytes'.)
// The dots run on the tensor cores, 3xTF32 (dist_tile.cuh, shared with
// kernel 4): warp w takes the 16 rows 16 (w % 4) over every other
// 8-column step of the slab, and the two halves add in order.  The
// finished [16, 64] tile goes out with 16-byte stores (N % 4 == 0), 16
// lanes a query row.  The wrapper pads d to a multiple of 4 (a tensor
// map's row pitch is a multiple of 16 bytes).  +inf norms give +inf
// distances (inf - finite = inf).  Integer data is exact in TF32 and
// sums exactly in any order, so it is bit-equal to ref.pdist_ref.
// bf16 proxy rows (the engine's storage_dtype; 19.2 MB at the shape
// above): a bf16 tensor map whose boxes are 64 columns (still 128 bytes,
// the same swizzle), the queries' map fp32 as before, and two MMAs a
// product (a bf16 value is exact in TF32: dist_tile.cuh).  The wrapper
// refuses bf16 rows whose d is not a multiple of 8.
#include <cuda.h>

#include "dist_tile.cuh"

namespace {

using dtile::Q;

constexpr int THREADS = 256;
constexpr int TILE = 64;          // store rows a tile
constexpr int BOX = 32;           // fp32 columns a box (128 bytes)
constexpr int BOXB = 128;         // bytes a box row, fp32 or bf16
constexpr int SLAB = 8 * BOX;     // columns a slab at most
constexpr int XBOXB = TILE * BOXB;  // bytes of a store box
constexpr int QBOXB = Q * BOXB;     // bytes of a query box (fp32)
constexpr int LD = TILE + 4;      // row stride of the finished tile
constexpr int SLACK = 1024;       // bytes: aligns the boxes to 1024 bytes
constexpr int BARS = 16;          // floats for the stages' mbarriers (<= 8)

// columns a store box of T holds (32 fp32, 64 bf16)
template <typename T>
__host__ __device__ constexpr int box_cols() {
  return BOXB / (int)sizeof(T);
}

struct Plan {
  int nxbox, nqbox, nslab, resident, stage;   // resident, stage: bytes
};

// esize: bytes of a store element (4 fp32, 2 bf16)
__host__ __device__ inline Plan plan_of(int d, int esize) {
  Plan p;
  const int xcols = BOXB / esize;
  p.nslab = d > SLAB ? (d + SLAB - 1) / SLAB : 1;
  p.nqbox = p.nslab == 1 ? (d + BOX - 1) / BOX : SLAB / BOX;
  p.nxbox = p.nslab == 1 ? (d + xcols - 1) / xcols : SLAB / xcols;
  // one slab: the queries stay resident; more: each stage has its slab
  p.resident = p.nslab == 1 ? p.nqbox * QBOXB : 0;
  p.stage = p.nxbox * XBOXB + (p.nslab > 1 ? p.nqbox * QBOXB : 0);
  return p;
}

__host__ __device__ inline size_t pdist_smem(int d, int stages, int esize) {
  const Plan p = plan_of(d, esize);
  return SLACK + p.resident + (size_t)stages * p.stage +
         sizeof(float) * (2 * Q * LD + BARS);
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dtile::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(dtile::smem_addr(bar)) : "memory");
}

// T: the store rows' type (fp32 or bf16).  NK: the slab's 8-column steps
// (4 an fp32 box).  QREG: one slab, whose query fragments each warp
// splits once into registers (its NK / 2 steps); else the queries' slab
// comes with each item and is read from the stage.
template <typename T, int NK, bool QREG>
__global__ void __launch_bounds__(THREADS, 1)
pdist_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap qmap,
             const float* __restrict__ qn, const float* __restrict__ xn,
             float* __restrict__ out, int B, int N, int d, int stages,
             int vec_out) {
  constexpr int BC = box_cols<T>();
  constexpr int NQBOX = NK / 4, NXBOX = (8 * NK + BC - 1) / BC;
  constexpr int HALF = NK / 2;
  extern __shared__ __align__(16) float smem_raw[];
  const Plan p = plan_of(d, sizeof(T));
  const int nslab = p.nslab;
  char* qres = reinterpret_cast<char*>(smem_raw) +
               ((SLACK - (dtile::smem_addr(smem_raw) & (SLACK - 1))) &
                (SLACK - 1));                        // 1024-byte aligned
  char* ring = qres + p.resident;                   // [stages][stage]
  float* red = reinterpret_cast<float*>(ring + (size_t)stages * p.stage);
                                                    // [2][Q][LD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 2 * Q * LD);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * Q, nq = min(Q, B - q0);
  const int ntiles = (N + TILE - 1) / TILE;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int mine = ntiles > bx ? (ntiles - 1 - bx) / gx + 1 : 0;
  const int items = mine * nslab;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) dtile::mbar_init(bar + s, 1);
    dtile::fence_barrier_init();
  }
  __syncthreads();
  // from warp 0: item i (tile i / nslab, slab i % nslab) into its stage,
  // a box a lane; the resident queries come with item 0
  auto load = [&](int i) {
    if (i >= items) return;
    char* s = ring + (size_t)(i % stages) * p.stage;
    uint64_t* b = bar + i % stages;
    const int r0 = (bx + (i / nslab) * gx) * TILE;
    const int k0 = (i % nslab) * SLAB;
    const bool with_q = nslab > 1 || i == 0;
    if (lane == 0)
      dtile::mbar_expect(b, NXBOX * XBOXB + (with_q ? NQBOX * QBOXB : 0));
    __syncwarp();
    if (lane < NXBOX) tma_2d(s + lane * XBOXB, &xmap, k0 + lane * BC, r0, b);
    if (with_q && lane < NQBOX)
      tma_2d((nslab > 1 ? s + NXBOX * XBOXB : qres) + lane * QBOXB, &qmap,
             k0 + lane * BOX, q0, b);
  };
  if (warp == 0)
    for (int i = 0; i < stages - 1; ++i) load(i);

  const int rb = warp & 3, h = warp >> 2;
  const int b = tid >> 4, j = 4 * (tid & 15);    // finishing: query, rows
  // this half's steps k = h + 2 u (u < HALF), in pairs u, u + 1
  uint32_t qh[QREG ? HALF : 2][4], ql[QREG ? HALF : 2][4];
  float acc[2][2][4] = {};     // [step parity][n-tile]
  for (int i = 0; i < items; ++i) {
    dtile::mbar_wait(bar + i % stages, (i / stages) & 1);   // item i landed
    __syncthreads();              // and every thread is done with item i - 1
    if (warp == 0) load(i + stages - 1);
    const bool last = i % nslab == nslab - 1;
    const int row = (bx + (i / nslab) * gx) * TILE + j;
    float xv[4] = {};
    if (last && b < nq)           // this thread's norms, early
      for (int e = 0; e < 4; ++e)
        if (row + e < N) xv[e] = xn[row + e];
    const char* s = ring + (size_t)(i % stages) * p.stage;
    const dtile::Sw128<T> xs{reinterpret_cast<const T*>(s), TILE};
    const dtile::Sw128<float> qs{
        reinterpret_cast<const float*>(QREG ? qres : s + NXBOX * XBOXB), Q};
    if (QREG && i == 0) {
#pragma unroll
      for (int u = 0; u < (QREG ? HALF : 0); ++u)
        dtile::a_frag(qs, 8 * (h + 2 * u), lane, qh[u], ql[u]);
    }
#pragma unroll
    for (int u = 0; u < HALF; u += 2) {
      const int k = h + 2 * u;
      if (QREG) {
        dtile::qxt_pair(acc, qh[u], ql[u], qh[u + 1], ql[u + 1], true, xs,
                        rb * dtile::R, 8 * k, 16, lane);
      } else {
        dtile::a_frag(qs, 8 * k, lane, qh[0], ql[0]);
        dtile::a_frag(qs, 8 * k + 16, lane, qh[1], ql[1]);
        dtile::qxt_pair(acc, qh[0], ql[0], qh[1], ql[1], true, xs,
                        rb * dtile::R, 8 * k, 16, lane);
      }
    }
    if (!last) continue;

    // the tile is done: halves to shared memory, then out
    float sum[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[n][e] = acc[0][n][e] + acc[1][n][e];
        acc[0][n][e] = acc[1][n][e] = 0.f;
      }
    dtile::store_c<2>(sum, red + h * Q * LD + rb * dtile::R, LD, lane);
    __syncthreads();
    if (b < nq && row < N) {
      const float qnb = qn[q0 + b];
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dot = red[b * LD + j + e] + red[Q * LD + b * LD + j + e];
        o[e] = fmaxf((qnb + xv[e]) - 2.0f * dot, 0.f);
      }
      float* dst = out + (int64_t)(q0 + b) * N + row;
      if (vec_out && row + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (row + e < N) dst[e] = o[e];
      }
    }
  }
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const float*,
                        const float*, float*, int, int, int, int, int);

// the instance for rows of T and d columns: one slab of 1..8 fp32 boxes'
// columns, or slabs of 8
template <typename T>
Kernel pick(int d) {
  if (d > SLAB) return pdist_kernel<T, 32, false>;
  switch ((d + BOX - 1) / BOX) {
    case 1: return pdist_kernel<T, 4, true>;
    case 2: return pdist_kernel<T, 8, true>;
    case 3: return pdist_kernel<T, 12, true>;
    case 4: return pdist_kernel<T, 16, true>;
    case 5: return pdist_kernel<T, 20, true>;
    case 6: return pdist_kernel<T, 24, true>;
    case 7: return pdist_kernel<T, 28, true>;
    default: return pdist_kernel<T, 32, true>;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [rows, cols] fp32 (cols % 4 == 0) or bf16 (cols % 8 == 0), boxes of
// box_rows x 128 bytes (32 or 64 columns), 128-byte swizzle; reads past
// rows or cols give zeros.
bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int cols,
              int rows, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const int esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(BOXB / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// esize: 4 (fp32 rows) or 2 (bf16 rows)
RT_EXPORT size_t pdist_smem_bytes(int d, int stages, int esize) {
  return pdist_smem(d, stages, esize);
}

// ctas: the persistent CTAs of each group of 16 queries (grid x);
// stages in [2, 8].  x: fp32, or bf16 when x_bf16.  d % 4 == 0 (d % 8
// == 0 for bf16) and q, x 16-byte aligned (the tensor maps' rows);
// vec_out: N % 4 == 0 and out 16-byte aligned.
RT_EXPORT int pdist_launch(const float* q, const void* x, int x_bf16,
                           const float* qn, const float* xn, float* out,
                           int B, int N, int d, int ctas, int stages,
                           int vec_out, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || d % (x_bf16 ? 8 : 4) != 0 || ctas < 1 || stages < 2 ||
      stages > 8 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, qm;
  if (!make_map(&xm, x, x_bf16, d, N, TILE) ||
      !make_map(&qm, q, false, d, B, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = x_bf16 ? pick<bf16_t>(d) : pick<float>(d);
  const size_t smem = pdist_smem(d, stages, x_bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ctas, (B + Q - 1) / Q);
  k<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xm, qm, qn, xn, out, B, N, d, stages, vec_out);
  return static_cast<int>(cudaGetLastError());
}
