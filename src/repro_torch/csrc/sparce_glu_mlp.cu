// Gated-GLU SparCE MLP with two-sided stripe skipping, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sparce_glu_mlp.py:
// sparce_glu_mlp_fused (Pallas). Same contract: x (M, K), w_gate and
// w_in (K, F), w_out (F, N), M % bm == 0 and F % bf == 0; returns
// y (M, N) in x's dtype and int32 bits (M/bm, F/bf). Per (row tile i,
// f-stripe f) the gate runs first; g and act(g) are rounded through the
// input dtype; bit = all(|act(g)| <= tau) ("<=" so tau = 0 is the exact
// all-zero test). A live tile computes h = x @ w_in[:, stripe] (rounded
// through the input dtype), a = round(act(g) * h) and a @ w_out[stripe,:].
// A dead tile loads neither its w_in stripe nor its w_out stripe.
//
// The TPU kernel carries the f32 accumulator across a sequential grid.
// Thread blocks here run in parallel in no order, so the work is split
// in two passes:
//   1. grid (F/bf, M/bm): gate tile over the full K, bit, and for a live
//      tile only, the up-projection and the partial down-projection
//      a @ w_out[stripe, :] written in f32 to a scratch slab
//      partial[i, f] of shape (bm, N). A dead tile returns right after
//      writing its bit: its w_in and w_out rows are never addressed.
//   2. one thread per output element sums the live partials of its row
//      tile in fixed f order (run-to-run deterministic) and casts to the
//      output dtype. This pass reads bits and scratch only, never a
//      weight.
//
// What bounds it on this card: at decode shapes (a few rows) bytes --
// the gate weights always stream and the live stripes of w_in and w_out
// follow, ~1 flop per weight byte per row; at prefill shapes the
// products. This first version is the simple correct one: SIMT f32
// FMAs over 64x128 register-blocked sub-tiles staged through shared
// memory (each of 256 threads owns a 4x8 patch). Tensor cores (wgmma),
// TMA and splitting K across more blocks (the decode grid has only
// F/bf x M/bm blocks) are later work.
#include "tile_gemm.cuh"

namespace {

using sparce::NT;
using sparce::TN;
using sparce::KC;
using sparce::XS_LD;
using sparce::to_f;
using sparce::round_t;

constexpr int RM = 4;        // rows per thread: 4 x 8 patches
constexpr int TM = 16 * RM;  // sub-tile rows

// The reference's f32 gate activations; gelu is the tanh approximation.
__device__ __forceinline__ float gate_act(float g, int act) {
  switch (act) {
    case 0:
      return g / (1.f + expf(-g));  // silu
    case 1:
      return 0.5f * g *
             (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
    case 2:
      return fmaxf(g, 0.f);  // relu
    default: {
      const float r = fmaxf(g, 0.f);  // relu2
      return r * r;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) glu_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ w_gate,
    const T* __restrict__ w_in, const T* __restrict__ w_out,
    int32_t* __restrict__ bits, float* __restrict__ partial, int K, int F,
    int N, int bm, int bf, int act, float tau) {
  const int tf = blockIdx.x, ti = blockIdx.y, nf = gridDim.x;
  const int row0 = ti * bm, col0 = tf * bf;
  extern __shared__ float smem[];
  float* a_s = smem;                // bm*bf: act(g), then a = act(g)*h
  float* xs = a_s + bm * bf;        // TM*XS_LD
  float* ws = xs + TM * XS_LD;      // KC*TN
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[RM][8];

  // -- 1. gate first: the predictor runs before the work it may cancel.
  int live = 0;
  for (int r0 = 0; r0 < bm; r0 += TM) {
    const int rlim = min(TM, bm - r0);
    for (int c0 = 0; c0 < bf; c0 += TN) {
      const int clim = min(TN, bf - c0);
      sparce::gemm_patch<RM>(
          acc, K,
          [&](int r, int k) {
            return r < rlim ? to_f(x[(size_t)(row0 + r0 + r) * K + k]) : 0.f;
          },
          [&](int k, int c) {
            return c < clim ? to_f(w_gate[(size_t)k * F + col0 + c0 + c])
                            : 0.f;
          },
          xs, ws);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = ty * RM + i, c = tx + 16 * j;
          if (r < rlim && c < clim) {
            const float g = round_t<T>(acc[i][j]);
            const float ga = round_t<T>(gate_act(g, act));
            a_s[(r0 + r) * bf + c0 + c] = ga;
            live |= !(fabsf(ga) <= tau);
          }
        }
    }
  }
  // -- SpRF bit at the gate's writeback.
  live = __syncthreads_or(live);
  if (tid == 0) bits[ti * nf + tf] = live ? 0 : 1;
  if (!live) return;  // dead: w_in and w_out stripes are never addressed

  // -- 2. up-projection for the live stripe; a = round(act(g) * round(h)).
  // Every thread rewrites exactly the a_s entries it wrote in step 1
  // (same sub-tile order, same patch), so no barrier is needed here.
  for (int r0 = 0; r0 < bm; r0 += TM) {
    const int rlim = min(TM, bm - r0);
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
            float* slot = &a_s[(r0 + r) * bf + c0 + c];
            *slot = round_t<T>(*slot * round_t<T>(acc[i][j]));
          }
        }
    }
  }
  __syncthreads();

  // -- 3. partial down-projection of this stripe: a (bm x bf) @
  // w_out[stripe rows, :] (bf x N), f32, into partial[ti, tf].
  float* out = partial + ((size_t)ti * nf + tf) * bm * N;
  for (int n0 = 0; n0 < N; n0 += TN) {
    for (int r0 = 0; r0 < bm; r0 += TM) {
      const int rlim = min(TM, bm - r0);
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
          const int r = ty * RM + i, c = n0 + tx + 16 * j;
          if (r < rlim && c < N) out[(size_t)(r0 + r) * N + c] = acc[i][j];
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_gate, const void* w_in,
           const void* w_out, void* y, void* bits, void* partial, int M,
           int K, int F, int N, int bm, int bf, int act, float tau,
           cudaStream_t stream) {
  const int nm = M / bm, nf = F / bf;
  const size_t smem =
      (size_t)(bm * bf + TM * XS_LD + KC * TN) * sizeof(float);
  cudaError_t e = sparce::allow_smem(glu_tile_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  glu_tile_kernel<T><<<dim3(nf, nm), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_gate),
      static_cast<const T*>(w_in), static_cast<const T*>(w_out),
      static_cast<int32_t*>(bits), static_cast<float*>(partial), K, F, N,
      bm, bf, act, tau);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sparce::launch_live_partial_reduce<T>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(bits),
      static_cast<T*>(y), M, N, bm, nf, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y share it).
// act: 0 silu, 1 gelu (tanh), 2 relu, 3 relu2. partial: f32 scratch of
// (M/bm) * (F/bf) * bm * N floats. Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int sparce_glu_mlp(const void* x, const void* w_gate,
                              const void* w_in, const void* w_out, void* y,
                              void* bits, void* partial, int M, int K, int F,
                              int N, int bm, int bf, int act, float tau,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, w_gate, w_in, w_out, y, bits, partial, M, K, F,
                         N, bm, bf, act, tau, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_gate, w_in, w_out, y, bits, partial, M,
                                 K, F, N, bm, bf, act, tau, s);
  return (int)cudaErrorInvalidValue;
}
