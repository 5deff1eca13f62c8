// Fused SparCE MLP for relu-family activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sparce_mlp.py: sparce_mlp_fused
// (Pallas). Same contract: x (M, K), w_in (K, F), w_out (F, N),
// M % bm == 0 and F % bf == 0; returns y (M, N) in x's dtype and int32
// bits (M/bm, F/bf). Per (row tile i, f-stripe f): h = x @ w_in[:, f] in
// f32, a = relu(h) (relu2: a * a on the f32 value), a rounded through
// the input dtype (as the unfused pipeline's writeback would), and the
// SpRF bit at that writeback: bit = 1 iff every a == 0. A live tile adds
// a @ w_out[f, :]; a dead tile's w_out stripe is never addressed. The
// w_in stripe is always read: it is the producer of the bit.
//
// The TPU kernel carries an f32 accumulator across a sequential f grid.
// Thread blocks here run in parallel in no order, so the work is split
// in two passes, like the gated-GLU kernel:
//   1. grid (F/bf, ceil((M/bm) / g)): one block per f-stripe and group of
//      g row tiles, g = max(1, 16 / bm), so a block always covers at
//      least 16 rows (at bm = 1 a decode tick of 8 slots is one group).
//      The block computes the activated tiles into shared memory and one
//      bit per tile. If every tile of the group is dead it returns: the
//      stripe's w_out rows are never addressed. Otherwise it computes the
//      partial down-projection a @ w_out[f, :] of its 16-row sub-tiles
//      that hold a live tile (a sub-tile of dead tiles only is skipped)
//      and writes each live tile's (bm, N) partial in f32 to scratch.
//   2. one thread per output element sums the live partials of its row
//      tile in fixed f order (run-to-run deterministic) and casts to the
//      output dtype. This pass reads bits and scratch only.
//
// What bounds it on this card: at decode shapes (8 rows) bytes -- w_in
// always streams (1.8 MB in bf16) and the live w_out stripes follow, at
// ~1 flop per weight byte per row; at a 256-row prefill bucket the
// products. This first version is the simple correct one: SIMT f32 FMAs
// over 16x128 register-blocked sub-tiles (each of 256 threads owns a
// 1x8 patch). Tensor cores (wgmma), TMA and splitting K across blocks
// (the decode grid has only 12 blocks) are later work.
#include "tile_gemm.cuh"

namespace {

using sparce::KC;
using sparce::NT;
using sparce::TN;
using sparce::XS_LD;
using sparce::round_t;
using sparce::to_f;

constexpr int RM = 1;        // rows per thread: 1 x 8 patches
constexpr int TM = 16 * RM;  // sub-tile rows
constexpr int MAX_G = 16;    // row tiles per block at most (bm = 1)

template <typename T>
__global__ void __launch_bounds__(NT) mlp_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ w_in,
    const T* __restrict__ w_out, int32_t* __restrict__ bits,
    float* __restrict__ partial, int M, int K, int F, int N, int bm, int bf,
    int g, int relu2) {
  const int tf = blockIdx.x, nf = gridDim.x;
  const int ti0 = blockIdx.y * g;  // first row tile of this block
  const int ntiles = min(g, M / bm - ti0);
  const int rows = ntiles * bm;
  const int row0 = ti0 * bm, col0 = tf * bf;
  extern __shared__ float smem[];
  float* a_s = smem;                // rows x bf: the activated tiles
  float* xs = a_s + g * bm * bf;    // TM x XS_LD
  float* ws = xs + TM * XS_LD;      // KC x TN
  __shared__ int tile_live[MAX_G];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  if (tid < MAX_G) tile_live[tid] = 0;
  __syncthreads();
  float acc[RM][8];

  // -- 1. up-projection over the full K; activation; writeback rounding;
  // a tile turns live on its first nonzero (every writer stores 1).
  for (int r0 = 0; r0 < rows; r0 += TM) {
    const int rlim = min(TM, rows - r0);
    for (int c0 = 0; c0 < bf; c0 += TN) {
      const int clim = min(TN, bf - c0);
      sparce::gemm_patch<RM>(
          acc, K,
          [&](int r, int k) {
            return r < rlim ? to_f(x[(size_t)(row0 + r0 + r) * K + k]) : 0.f;
          },
          [&](int k, int c) {
            return c < clim ? to_f(w_in[(size_t)k * F + col0 + c0 + c]) : 0.f;
          },
          xs, ws);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = ty * RM + i, c = tx + 16 * j;
          if (r < rlim && c < clim) {
            const float h = acc[i][j];
            float a = h < 0.f ? 0.f : h;  // relu; NaN propagates
            if (relu2) a = a * a;
            a = round_t<T>(a);
            a_s[(r0 + r) * bf + c0 + c] = a;
            if (a != 0.f) tile_live[(r0 + r) / bm] = 1;
          }
        }
    }
  }
  __syncthreads();

  // -- SpRF bits at the activation's writeback.
  if (tid < ntiles)
    bits[(size_t)(ti0 + tid) * nf + tf] = tile_live[tid] ? 0 : 1;
  int any_live = 0;
  for (int t = 0; t < ntiles; ++t) any_live |= tile_live[t];
  if (!any_live) return;  // the stripe's w_out rows are never addressed

  // -- 2. partial down-projection a @ w_out[stripe rows, :] (f32) of the
  // sub-tiles holding a live tile; each live tile's rows go to
  // partial[tile, tf].
  for (int r0 = 0; r0 < rows; r0 += TM) {
    const int rlim = min(TM, rows - r0);
    int sub_live = 0;
    for (int t = r0 / bm; t <= (r0 + rlim - 1) / bm; ++t)
      sub_live |= tile_live[t];
    if (!sub_live) continue;  // uniform across the block
    for (int n0 = 0; n0 < N; n0 += TN) {
      sparce::gemm_patch<RM>(
          acc, bf,
          [&](int r, int k) {
            return r < rlim ? a_s[(r0 + r) * bf + k] : 0.f;
          },
          [&](int k, int c) {
            return n0 + c < N ? to_f(w_out[(size_t)(col0 + k) * N + n0 + c])
                              : 0.f;
          },
          xs, ws);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + ty * RM + i, c = n0 + tx + 16 * j;
          if (ty * RM + i < rlim && c < N) {
            const int t = r / bm;
            if (tile_live[t])
              partial[(((size_t)(ti0 + t) * nf + tf) * bm + (r - t * bm)) *
                          N + c] = acc[i][j];
          }
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_in, const void* w_out, void* y,
           void* bits, void* partial, int M, int K, int F, int N, int bm,
           int bf, int relu2, cudaStream_t stream) {
  const int nm = M / bm, nf = F / bf;
  const int g = bm >= MAX_G ? 1 : MAX_G / bm;
  const size_t smem =
      (size_t)(g * bm * bf + TM * XS_LD + KC * TN) * sizeof(float);
  cudaError_t e = sparce::allow_smem(mlp_tile_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  mlp_tile_kernel<T><<<dim3(nf, (nm + g - 1) / g), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_out), static_cast<int32_t*>(bits),
      static_cast<float*>(partial), M, K, F, N, bm, bf, g, relu2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sparce::launch_live_partial_reduce<T>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(bits),
      static_cast<T*>(y), M, N, bm, nf, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y share it).
// relu2: 0 relu, 1 relu squared. partial: f32 scratch of
// (M/bm) * (F/bf) * bm * N floats. Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int sparce_mlp(const void* x, const void* w_in, const void* w_out,
                          void* y, void* bits, void* partial, int M, int K,
                          int F, int N, int bm, int bf, int relu2, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, w_in, w_out, y, bits, partial, M, K, F, N, bm,
                         bf, relu2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_in, w_out, y, bits, partial, M, K, F,
                                 N, bm, bf, relu2, s);
  return (int)cudaErrorInvalidValue;
}
