// Bitmap-gated block GEMMs, for Hopper (sm_90a): the gated, the
// compacted-grid and the two-sided-gate variants of the SparCE GEMM.
//
// The gated kernel replaces the TPU kernel repro/kernels/sparce_gemm.py:
// sparce_gemm_gated (Pallas). y = x @ w with f32 accumulation over k
// tiles, cast once to the output dtype, dropping every tile product whose
// bit is 1: with gate = lhs the bit of x's (bm, bk) tile [i, k], with
// gate = rhs the bit of w's (bk, bn) tile [k, j]. The bit decides, not
// the values: a tile with bit 1 is dropped even when it is nonzero.
//
// Unlike the TPU kernel, which fetches every tile and predicates only the
// MXU op, this one reads the bits before it loads an operand: a gated
// tile is never loaded. One block computes a 16 x 128 output sub-tile
// and walks the k tiles in order. For each k tile it first reads the
// bits of its rows (lhs) or columns (rhs); when all of them are gated it
// loads neither operand's tile and multiplies nothing. Otherwise it
// stages only the ungated rows of x (lhs) or ungated columns of w (rhs),
// zeros in place of the rest, so a gated tile is still never read.
//
// Dims need not be multiples of the blocks: rows, columns and depth past
// M, N and K are masked in the kernel (the weight is not padded), and
// the bit grids are ceil(M/bm) x ceil(K/bk) (lhs) or ceil(K/bk) x
// ceil(N/bn) (rhs). The result equals the zero-padded product's [:M, :N].
//
// What bounds it on this card: at decode shapes (8 x 1536 @ 1536 x 576)
// bytes -- the ungated k-stripes of w stream once per 16-row block, ~1
// flop per weight byte per row -- but the grid is only 5 x 1 blocks, so
// it is latency-bound first. This first version runs SIMT f32 FMAs (each
// of 256 threads owns a 1x8 patch); split-K, tensor cores (wgmma) and
// TMA are later work.
#include "tile_gemm.cuh"

namespace {

using sparce::from_f;
using sparce::NT;
using sparce::TN;
using sparce::XS_LD;
using sparce::to_f;
using sparce::KC;

constexpr int RM = 1;
constexpr int TM = 16 * RM;

template <typename T>
__device__ __forceinline__ void store_patch(const float (&acc)[RM][8],
                                            T* __restrict__ y, int N,
                                            int row0, int col0, int rlim,
                                            int clim) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty * RM + i, c = tx + 16 * j;
      if (r < rlim && c < clim)
        y[(size_t)(row0 + r) * N + col0 + c] = from_f<T>(acc[i][j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(NT) gated_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ bits, T* __restrict__ y, int M, int K, int N,
    int bm, int bk, int bn, int rhs) {
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
  const int gk = (K + bk - 1) / bk, gn = (N + bn - 1) / bn;
  const int rlim = min(TM, M - row0), clim = min(TN, N - col0);
  __shared__ float xs[TM * XS_LD];
  __shared__ float ws[KC * TN];
  __shared__ int live_s[TN];  // per row (lhs) or per column (rhs)
  const int tid = threadIdx.x;
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < gk; ++kt) {
    // The bits first: nothing of this k tile is loaded before them.
    int live = 0;
    if (!rhs && tid < TM) {
      live = tid < rlim && bits[(size_t)((row0 + tid) / bm) * gk + kt] == 0;
      live_s[tid] = live;
    } else if (rhs && tid < TN) {
      live = tid < clim && bits[(size_t)kt * gn + (col0 + tid) / bn] == 0;
      live_s[tid] = live;
    }
    if (!__syncthreads_or(live)) continue;  // gated for the whole block
    const int k_lo = kt * bk, depth = min(bk, K - k_lo);
    sparce::gemm_patch_acc<RM>(
        acc, depth,
        [&](int r, int k) {
          return (r < rlim && (rhs || live_s[r]))
                     ? to_f(x[(size_t)(row0 + r) * K + k_lo + k])
                     : 0.f;
        },
        [&](int k, int c) {
          return (c < clim && (!rhs || live_s[c]))
                     ? to_f(w[(size_t)(k_lo + k) * N + col0 + c])
                     : 0.f;
        },
        xs, ws);
  }
  store_patch<T>(acc, y, N, row0, col0, rlim, clim);
}

// ---------------------------------------------------------------------
// The compacted-grid and two-sided-gate kernels.
//
// compacted_gemm_kernel replaces the TPU kernel sparce_gemm.py:
// sparce_gemm_compacted: y = x @ w, lhs gate, where each row tile walks
// only its nonzero k tiles (the TPU kernel builds the list, nnz and idx,
// in its wrapper and chases idx in its index maps so a dead tile is
// never fetched; a row tile with nnz == 0 writes exact zeros). Here each
// block builds its row tile's list itself: warp 0 reads the tile's bit
// row and compacts the live k indices, in ascending order, into shared
// memory with a ballot (no host sync, no extra launch). Then the block
// walks the list: it loads only the x and w tiles of live k tiles, so
// no operand byte of a dead tile is read, and nnz == 0 leaves the
// accumulators at exact zeros.
//
// gated_both_gemm_kernel replaces sparce_gemm.py:sparce_gemm_gated_both:
// a tile product is dropped when EITHER operand's bit is 1 (the paper's
// SpRFCondition Ra | Rb). For each k tile the block reads both bits
// before it loads any operand; when either is 1 it loads neither tile.
//
// In both, a block never straddles a tile boundary: it serves min(16,
// bm) rows of one bm-row tile (a 168- or 256-row tile is served by 11 or
// 16 blocks, one 16-row chunk each) and, in the two-sided kernel,
// min(128, bn) columns of one bn-column tile. So the skip decision is the
// same for every row and column of a block, and a dropped product's
// tiles are never read even when they hold NaN. The cost: at bm = 8 half
// of the block's 16 thread rows idle. The tile products go through
// gemm_patch_acc in ascending k order like the gated kernel's, so on the
// same bits the compacted kernel's output equals the gated kernel's bit
// for bit (where the gated kernel's 16-row block spans two 8-row tiles,
// a row whose tile is gated adds 0 * w = +-0 to its sum, which leaves
// it unchanged). Ragged M, K and N are masked in the kernels; only the
// bit grids are padded (with 1s) by the wrapper.
//
// What bounds them on this card: bytes. At the AlexNet shapes (m 1 to
// 169, k up to 9216, n up to 4096, f32) the live w tiles stream once per
// row block at ~2 flops per byte; fc6-fc8 (m = 1) use 1 of 16 thread
// rows for the FMAs and only n / 128 = 8 to 32 blocks. Tensor cores,
// wider grids (split-K) and TMA are later work.

// The longest live-k list a block holds: 1024 k tiles (4 KB of shared
// memory), K up to 131072 at bk = 128. The wrapper refuses longer ones.
constexpr int MAX_K_TILES = 1024;

// Rows of the block: one chunk of min(16, bm) rows of row tile ti.
struct RowChunk {
  int ti, row0, rlim;
};
__device__ __forceinline__ RowChunk row_chunk(int by, int M, int bm) {
  const int rb = min(TM, bm), cpt = (bm + rb - 1) / rb;
  const int ti = by / cpt, ch = by - ti * cpt;
  const int row0 = ti * bm + ch * rb;
  return {ti, row0, min(min(rb, bm - ch * rb), M - row0)};
}

// The block's share of the tile product of k tile kt: rows rc of x,
// columns [col0, col0 + clim) of w, added to acc. Only this k tile's
// rows and columns of the block are loaded.
template <typename T>
__device__ __forceinline__ void chunk_product(
    float (&acc)[RM][8], const T* __restrict__ x, const T* __restrict__ w,
    const RowChunk& rc, int col0, int clim, int K, int N, int kt, int bk,
    float* xs, float* ws) {
  const int k_lo = kt * bk, depth = min(bk, K - k_lo);
  sparce::gemm_patch_acc<RM>(
      acc, depth,
      [&](int r, int k) {
        return r < rc.rlim ? to_f(x[(size_t)(rc.row0 + r) * K + k_lo + k])
                           : 0.f;
      },
      [&](int k, int c) {
        return c < clim ? to_f(w[(size_t)(k_lo + k) * N + col0 + c]) : 0.f;
      },
      xs, ws);
}

template <typename T>
__global__ void __launch_bounds__(NT) compacted_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ bits, T* __restrict__ y, int M, int K, int N,
    int bm, int bk) {
  const RowChunk rc = row_chunk(blockIdx.y, M, bm);
  const int col0 = blockIdx.x * TN, clim = min(TN, N - col0);
  if (rc.rlim <= 0) return;  // the same for every thread of the block
  const int gk = (K + bk - 1) / bk;
  __shared__ int idx_s[MAX_K_TILES];  // the live k tiles, ascending
  __shared__ int nnz_s;
  __shared__ float xs[TM * XS_LD];
  __shared__ float ws[KC * TN];
  if (threadIdx.x < 32) {  // warp 0 compacts the bit row, ascending
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < gk; base += 32) {
      const int kt = base + lane;
      const bool live = kt < gk && bits[(size_t)rc.ti * gk + kt] == 0;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) idx_s[count + __popc(mask & ((1u << lane) - 1u))] = kt;
      count += __popc(mask);
    }
    if (lane == 0) nnz_s = count;
  }
  __syncthreads();
  const int nnz = nnz_s;
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nnz; ++t)
    chunk_product<T>(acc, x, w, rc, col0, clim, K, N, idx_s[t], bk, xs, ws);
  store_patch<T>(acc, y, N, rc.row0, col0, rc.rlim, clim);
}

template <typename T>
__global__ void __launch_bounds__(NT) gated_both_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ lbits, const int32_t* __restrict__ rbits,
    T* __restrict__ y, int M, int K, int N, int bm, int bk, int bn) {
  const RowChunk rc = row_chunk(blockIdx.y, M, bm);
  const int cb = min(TN, bn), cpt = (bn + cb - 1) / cb;
  const int tj = blockIdx.x / cpt, cc = blockIdx.x - tj * cpt;
  const int col0 = tj * bn + cc * cb;
  const int clim = min(min(cb, bn - cc * cb), N - col0);
  if (rc.rlim <= 0 || clim <= 0) return;  // uniform over the block
  const int gk = (K + bk - 1) / bk, gn = (N + bn - 1) / bn;
  __shared__ float xs[TM * XS_LD];
  __shared__ float ws[KC * TN];
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < gk; ++kt) {
    // Both bits first; the decision is the block's (it spans one tile
    // of each operand), so either bit set loads neither tile.
    if (lbits[(size_t)rc.ti * gk + kt] != 0 ||
        rbits[(size_t)kt * gn + tj] != 0)
      continue;
    chunk_product<T>(acc, x, w, rc, col0, clim, K, N, kt, bk, xs, ws);
  }
  store_patch<T>(acc, y, N, rc.row0, col0, rc.rlim, clim);
}

// Blocks along M: every bm-row tile in chunks of min(16, bm) rows.
inline unsigned row_blocks(int M, int bm) {
  const int rb = bm < TM ? bm : TM;
  return (unsigned)(((M + bm - 1) / bm) * ((bm + rb - 1) / rb));
}

template <typename T>
int launch_compacted(const void* x, const void* w, const void* bits, void* y,
                     int M, int K, int N, int bm, int bk,
                     cudaStream_t stream) {
  if ((K + bk - 1) / bk > MAX_K_TILES) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, row_blocks(M, bm));
  compacted_gemm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(bits), static_cast<T*>(y), M, K, N, bm, bk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_both(const void* x, const void* w, const void* lbits,
                const void* rbits, void* y, int M, int K, int N, int bm,
                int bk, int bn, cudaStream_t stream) {
  const int cb = bn < TN ? bn : TN;
  const dim3 grid((unsigned)(((N + bn - 1) / bn) * ((bn + cb - 1) / cb)),
                  row_blocks(M, bm));
  gated_both_gemm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(lbits), static_cast<const int32_t*>(rbits),
      static_cast<T*>(y), M, K, N, bm, bk, bn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* bits, void* y, int M,
           int K, int N, int bm, int bk, int bn, int rhs,
           cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  gated_gemm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(bits), static_cast<T*>(y), M, K, N, bm, bk,
      bn, rhs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it). rhs: 0 gates
// on x's tiles, 1 on w's. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int sparce_gemm_gated(const void* x, const void* w,
                                 const void* bits, void* y, int M, int K,
                                 int N, int bm, int bk, int bn, int rhs,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, w, bits, y, M, K, N, bm, bk, bn, rhs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bits, y, M, K, N, bm, bk, bn, rhs, s);
  return (int)cudaErrorInvalidValue;
}

// The compacted-grid GEMM (lhs gate): bits int32 (ceil(M/bm),
// ceil(K/bk)), ceil(K/bk) <= MAX_K_TILES (else cudaErrorInvalidValue,
// nothing launched). Same dtype ids and return value as
// sparce_gemm_gated.
extern "C" int sparce_gemm_compacted(const void* x, const void* w,
                                     const void* bits, void* y, int M, int K,
                                     int N, int bm, int bk, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch_compacted<float>(x, w, bits, y, M, K, N, bm, bk, s);
  if (dtype == 1)
    return launch_compacted<__nv_bfloat16>(x, w, bits, y, M, K, N, bm, bk,
                                           s);
  return (int)cudaErrorInvalidValue;
}

// The two-sided gate: lbits int32 (ceil(M/bm), ceil(K/bk)) over x's
// tiles, rbits int32 (ceil(K/bk), ceil(N/bn)) over w's; a tile product
// is dropped when either bit is 1.
extern "C" int sparce_gemm_gated_both(const void* x, const void* w,
                                      const void* lbits, const void* rbits,
                                      void* y, int M, int K, int N, int bm,
                                      int bk, int bn, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch_both<float>(x, w, lbits, rbits, y, M, K, N, bm, bk, bn, s);
  if (dtype == 1)
    return launch_both<__nv_bfloat16>(x, w, lbits, rbits, y, M, K, N, bm, bk,
                                      bn, s);
  return (int)cudaErrorInvalidValue;
}
