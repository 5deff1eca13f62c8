// Bitmap-gated block GEMMs, for Hopper (sm_90a): the gated, the
// compacted-grid and the two-sided-gate variants of the SparCE GEMM.
//
// gated_gemm_kernel replaces the TPU kernel repro/kernels/sparce_gemm.py:
// sparce_gemm_gated (Pallas). y = x @ w with f32 accumulation over k
// tiles, cast once to the output dtype, dropping every tile product whose
// bit is 1: with gate = lhs the bit of x's (bm, bk) tile [i, k], with
// gate = rhs the bit of w's (bk, bn) tile [k, j]. The bit decides, not
// the values: a tile with bit 1 is dropped even when it is nonzero.
//
// compacted_gemm_kernel replaces sparce_gemm.py:sparce_gemm_compacted:
// the same product under an lhs gate, where each row tile walks only its
// nonzero k tiles (the TPU kernel builds the list, nnz and idx, in its
// wrapper and chases idx in its index maps so a dead tile is never
// fetched; a row tile with nnz == 0 writes exact zeros).
//
// All three run on one core, skip_gemm.cuh: a block computes a
// 64-column by 8- to 64-row slab over one fixed chunk of k tiles, on the
// tensor cores (bf16 mma.sync m16n8k16; f32 split-TF32 m16n8k8), with its
// operands streamed by cp.async through a 3-stage ring. The grid is
// column slabs x row slabs x k chunks; with more than one chunk the
// blocks write f32 partials to scratch and chunk_reduce_kernel adds them
// in ascending chunk order (deterministic, no atomics). The gated and
// compacted kernels differ only in their rows: a gated block serves any
// 8-64 consecutive rows and walks the k tiles on which any of them (lhs)
// or of its columns (rhs) is live, with the gated rows or columns
// zero-filled, never loaded; a compacted block serves min(64, bm) rows of one
// row tile, so its walk is exactly that tile's live list within the chunk,
// built on the device by a ballot over the bits. On the same bits the two
// give the same output bit for bit (skip_gemm.cuh says why). Dims need not be
// multiples of the blocks: rows, columns and depth past M, N and K are
// masked in the kernels (the weight is not padded), and the bit grids
// are ceil(M/bm) x ceil(K/bk) (lhs) or ceil(K/bk) x ceil(N/bn) (rhs).
//
// What bounds them on this card: bytes at the decode and fc shapes (1-8
// rows: each live w tile is read once per row slab at ~2 flops per byte
// per row), operations only at conv shapes in f32 (split-TF32 spends 3
// tensor-core products per product). The old design's limits -- SIMT
// FMAs, scalar staging behind two barriers per 32-deep chunk, and grids
// of 5 to 66 blocks on 132 SMs -- are what the core removes: tensor
// cores, 16-byte asynchronous copies in flight during the products, and
// a grid split over k chunks (e.g. 9 x 1 x 6 blocks at the relu decode
// shape, 64 x 1 x 8 at AlexNet fc6).
//
// gated_both_gemm_kernel replaces sparce_gemm.py:sparce_gemm_gated_both:
// a tile product is dropped when EITHER operand's bit is 1 (the paper's
// SpRFCondition Ra | Rb). Its block is the compacted kernel's -- up to
// 64 rows of one row tile, 64 columns, one k chunk (chunk_tiles(K, bk))
// -- with both bit grids: a k tile is walked when the row tile's lbit is
// 0 and some column tile of the slab has its rbit at 0, and within it
// the columns with rbit 1 are zero-filled, never loaded -- which drops
// exactly the products with Ra | Rb. At deepcomp fc6 (1 x 9216 @ 9216 x
// 4096) that is 64 x 1 x 8 blocks, each walking at most 9 k tiles; bytes
// bound it there.
#include "skip_gemm.cuh"

namespace {

// Kinds of launch: the gated kernel (one gate), the compacted kernel, the
// two-sided kernel.
enum Kind { GATED = 0, COMPACTED = 1, BOTH = 2 };

// Rows of a block that serves one chunk of min(rows, bm) rows of row
// tile ti (the compacted and two-sided kernels).
struct RowChunk {
  int ti, row0, rlim;
};
__device__ __forceinline__ RowChunk row_chunk(int by, int M, int bm,
                                              int rows) {
  const int rb = min(rows, bm), cpt = (bm + rb - 1) / rb;
  const int ti = by / cpt, ch = by - ti * cpt;
  const int row0 = ti * bm + ch * rb;
  return {ti, row0, min(min(rb, bm - ch * rb), M - row0)};
}

// Blocks along M: every bm-row tile in chunks of min(rows, bm) rows.
inline unsigned row_blocks(int M, int bm, int rows) {
  const int rb = bm < rows ? bm : rows;
  return (unsigned)(((M + bm - 1) / bm) * ((bm + rb - 1) / rb));
}

// ------------------------------ the gated, compacted and two-sided GEMMs
// The slab of a gated or two-sided block: 8 * NT8 consecutive rows, 64
// columns, chunk blockIdx.z.
template <int NT8>
__device__ __forceinline__ skip::Slab gated_slab(int M, int N, int gk,
                                                 int S) {
  skip::Slab s;
  s.row0 = blockIdx.y * 8 * NT8;
  s.rlim = min(8 * NT8, M - s.row0);
  s.col0 = blockIdx.x * skip::SLAB_N;
  s.clim = min(skip::SLAB_N, N - s.col0);
  s.t_lo = blockIdx.z * S;
  s.t_hi = min(gk, s.t_lo + S);
  return s;
}

// One gate: bits over x's tiles (rhs == 0) or over w's.
template <typename T, int NT8>
__global__ void __launch_bounds__(skip::THREADS) gated_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ bits, T* __restrict__ y,
    float* __restrict__ partial, int M, int K, int N, int bm, int bk, int bn,
    int rhs, int S, int nchunks, int vec_x, int vec_w) {
  const int gk = (K + bk - 1) / bk, gn = (N + bn - 1) / bn;
  const skip::Gate g{bits, rhs, bm, bn, gk, gn, nullptr};
  skip::skip_gemm<T, NT8, false>(x, w, g, gated_slab<NT8>(M, N, gk, S), y,
                                 partial, M, K, N, bk, nchunks, vec_x,
                                 vec_w);
}

// Both gates: a tile product is dropped when either bit is 1. A block
// serves rows of one row tile, as the compacted kernel's does, so its
// walk follows that tile's lbits exactly.
template <typename T, int NT8>
__global__ void __launch_bounds__(skip::THREADS) gated_both_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ lbits, const int32_t* __restrict__ rbits,
    T* __restrict__ y, float* __restrict__ partial, int M, int K, int N,
    int bm, int bk, int bn, int S, int nchunks, int vec_x, int vec_w) {
  const RowChunk rc = row_chunk(blockIdx.y, M, bm, 8 * NT8);
  if (rc.rlim <= 0) return;  // the same for every thread of the block
  const int gk = (K + bk - 1) / bk, gn = (N + bn - 1) / bn;
  skip::Slab s = gated_slab<NT8>(M, N, gk, S);
  s.row0 = rc.row0;
  s.rlim = rc.rlim;
  const skip::Gate g{lbits, 0, bm, bn, gk, gn, rbits};
  skip::skip_gemm<T, NT8, true>(x, w, g, s, y, partial, M, K, N, bk,
                                nchunks, vec_x, vec_w);
}

template <typename T, int NT8>
__global__ void __launch_bounds__(skip::THREADS) compacted_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int32_t* __restrict__ bits, T* __restrict__ y,
    float* __restrict__ partial, int M, int K, int N, int bm, int bk, int S,
    int nchunks, int vec_x, int vec_w) {
  const RowChunk rc = row_chunk(blockIdx.y, M, bm, 8 * NT8);
  if (rc.rlim <= 0) return;  // the same for every thread of the block
  const int gk = (K + bk - 1) / bk;
  skip::Slab s;
  s.row0 = rc.row0;
  s.rlim = rc.rlim;
  s.col0 = blockIdx.x * skip::SLAB_N;
  s.clim = min(skip::SLAB_N, N - s.col0);
  s.t_lo = blockIdx.z * S;
  s.t_hi = min(gk, s.t_lo + S);
  const skip::Gate g{bits, 0, bm, 1, gk, 1, nullptr};
  skip::skip_gemm<T, NT8, false>(x, w, g, s, y, partial, M, K, N, bk,
                                 nchunks, vec_x, vec_w);
}

// One launch of the core kernel at NT8 row tiles of 8, then the chunk
// reduction when there are several chunks. bits: the gate (the
// two-sided kernel's lhs grid); rbits: the two-sided kernel's rhs grid,
// else null; rhs: the gated kernel's side. Errors of either launch are
// returned.
template <typename T, int NT8>
int launch_skip(Kind kind, const void* x, const void* w, const void* bits,
                const void* rbits, void* y, void* partial, int M, int K,
                int N, int bm, int bk, int bn, int rhs, int S,
                cudaStream_t stream) {
  const int gk = (K + bk - 1) / bk;
  const int nchunks = gk > 0 ? (gk + S - 1) / S : 1;
  if (nchunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = skip::smem_bytes<T>(NT8);
  const unsigned rows =
      kind == GATED ? (unsigned)((M + 8 * NT8 - 1) / (8 * NT8))
                    : row_blocks(M, bm, 8 * NT8);
  if (rows > 65535u) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((N + skip::SLAB_N - 1) / skip::SLAB_N, rows, nchunks);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int32_t* bt = static_cast<const int32_t*>(bits);
  const int32_t* rb = static_cast<const int32_t*>(rbits);
  T* yt = static_cast<T*>(y);
  float* pt = static_cast<float*>(partial);
  const int vx = skip::vec_ok<T>(x, K, bk);
  const int vw = skip::vec_ok<T>(w, N, skip::SLAB_N);
  cudaError_t err;
  if (kind == COMPACTED) {
    static size_t allowed = 48 * 1024;
    err = sparce::allow_smem(compacted_gemm_kernel<T, NT8>, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    compacted_gemm_kernel<T, NT8><<<grid, skip::THREADS, smem, stream>>>(
        xt, wt, bt, yt, pt, M, K, N, bm, bk, S, nchunks, vx, vw);
  } else if (kind == BOTH) {
    static size_t allowed = 48 * 1024;
    err = sparce::allow_smem(gated_both_gemm_kernel<T, NT8>, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    gated_both_gemm_kernel<T, NT8><<<grid, skip::THREADS, smem, stream>>>(
        xt, wt, bt, rb, yt, pt, M, K, N, bm, bk, bn, S, nchunks, vx, vw);
  } else {
    static size_t allowed = 48 * 1024;
    err = sparce::allow_smem(gated_gemm_kernel<T, NT8>, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    gated_gemm_kernel<T, NT8><<<grid, skip::THREADS, smem, stream>>>(
        xt, wt, bt, yt, pt, M, K, N, bm, bk, bn, rhs, S, nchunks, vx, vw);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  return (int)skip::launch_chunk_reduce<T>(pt, yt, (size_t)M * N, nchunks,
                                           stream);
}

// The row slab fitted to the rows a block has to serve: the compacted
// and two-sided kernels' min(bm, M) rows of one row tile, the gated
// kernel's M.
template <typename T>
int launch(Kind kind, const void* x, const void* w, const void* bits,
           const void* rbits, void* y, void* partial, int M, int K, int N,
           int bm, int bk, int bn, int rhs, int S, cudaStream_t stream) {
  if (S < 1 || bm < 1 || bk < 1 || bn < 1) return (int)cudaErrorInvalidValue;
  switch (skip::nt8_for(kind == GATED ? M : (bm < M ? bm : M))) {
    case 1:
      return launch_skip<T, 1>(kind, x, w, bits, rbits, y, partial, M, K, N,
                               bm, bk, bn, rhs, S, stream);
    case 2:
      return launch_skip<T, 2>(kind, x, w, bits, rbits, y, partial, M, K, N,
                               bm, bk, bn, rhs, S, stream);
    case 4:
      return launch_skip<T, 4>(kind, x, w, bits, rbits, y, partial, M, K, N,
                               bm, bk, bn, rhs, S, stream);
    default:
      return launch_skip<T, skip::MAX_NT8>(kind, x, w, bits, rbits, y,
                                           partial, M, K, N, bm, bk, bn, rhs,
                                           S, stream);
  }
}

// dtype 0 = float32, 1 = bfloat16.
int dispatch(Kind kind, const void* x, const void* w, const void* bits,
             const void* rbits, void* y, void* partial, int M, int K, int N,
             int bm, int bk, int bn, int rhs, int S, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch<float>(kind, x, w, bits, rbits, y, partial, M, K, N, bm,
                         bk, bn, rhs, S, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(kind, x, w, bits, rbits, y, partial, M, K,
                                 N, bm, bk, bn, rhs, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it). rhs: 0 gates
// on x's tiles, 1 on w's. S: k tiles per chunk (the wrapper's
// chunk_tiles(K, bk)); partial: f32 scratch of ceil(ceil(K/bk)/S) x M x
// N when that is more than one chunk, else unused. Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int sparce_gemm_gated(const void* x, const void* w,
                                 const void* bits, void* y, void* partial,
                                 int M, int K, int N, int bm, int bk, int bn,
                                 int rhs, int S, int dtype, void* stream) {
  return dispatch(GATED, x, w, bits, nullptr, y, partial, M, K, N, bm, bk,
                  bn, rhs, S, dtype, stream);
}

// The compacted-grid GEMM (lhs gate): bits int32 (ceil(M/bm),
// ceil(K/bk)). Same S, scratch, dtype ids and return value as
// sparce_gemm_gated.
extern "C" int sparce_gemm_compacted(const void* x, const void* w,
                                     const void* bits, void* y,
                                     void* partial, int M, int K, int N,
                                     int bm, int bk, int S, int dtype,
                                     void* stream) {
  return dispatch(COMPACTED, x, w, bits, nullptr, y, partial, M, K, N, bm,
                  bk, 1, 0, S, dtype, stream);
}

// The two-sided gate: lbits int32 (ceil(M/bm), ceil(K/bk)) over x's
// tiles, rbits int32 (ceil(K/bk), ceil(N/bn)) over w's; a tile product
// is dropped when either bit is 1. Same S, scratch, dtype ids and return
// value as sparce_gemm_gated.
extern "C" int sparce_gemm_gated_both(const void* x, const void* w,
                                      const void* lbits, const void* rbits,
                                      void* y, void* partial, int M, int K,
                                      int N, int bm, int bk, int bn, int S,
                                      int dtype, void* stream) {
  return dispatch(BOTH, x, w, lbits, rbits, y, partial, M, K, N, bm, bk, bn,
                  0, S, dtype, stream);
}

// Dynamic shared memory of the core kernels' block at nt8 x 8 rows (1,
// 2, 4 or 8), dtype id as above: the operand ring.
extern "C" int sparce_gemm_smem_bytes(int dtype, int nt8) {
  return (int)(dtype == 0 ? skip::smem_bytes<float>(nt8)
                          : skip::smem_bytes<__nv_bfloat16>(nt8));
}
