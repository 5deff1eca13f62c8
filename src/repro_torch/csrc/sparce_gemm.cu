// Bitmap-gated block GEMM, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sparce_gemm.py:
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
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
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
