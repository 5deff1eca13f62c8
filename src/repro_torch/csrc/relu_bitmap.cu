// ReLU with the SpRF tile bit fused at its writeback, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/relu_bitmap.py: relu_bitmap
// (Pallas). Same contract: x (R, C) with R % br == 0 and C % bc == 0;
// returns y = max(x, 0) in x's dtype and int32 bits (R/br, C/bc), bit 1
// when no element of the tile is > 0 (the paper's isSparse at writeback:
// the zero check costs no extra pass over the activation).
//
// One thread block per tile: its threads stride over the tile's
// elements (neighbouring threads on neighbouring columns), write y and
// OR their "> 0" flags into one bit with __syncthreads_or. What bounds
// it on this card: bytes (read x once, write y once, ~0 flops per
// byte). At the decode shape (8 x 1536, tile 1 x 128) the grid is 96
// blocks of 128 elements each, so it is launch- and latency-bound; wider
// loads and several tiles per block are later work.
#include "tile_gemm.cuh"

namespace {

using sparce::from_f;
using sparce::to_f;

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) relu_bitmap_kernel(
    const T* __restrict__ x, T* __restrict__ y, int32_t* __restrict__ bits,
    int C, int br, int bc) {
  const int tc = blockIdx.x, tr = blockIdx.y, nc = gridDim.x;
  const int n = br * bc;
  int live = 0;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int rr = e / bc;
    const size_t idx =
        (size_t)(tr * br + rr) * C + (size_t)tc * bc + (e - rr * bc);
    const T v = x[idx];
    const float f = to_f(v);
    y[idx] = f < 0.f ? from_f<T>(0.f) : v;  // NaN propagates, as max does
    live |= f > 0.f;
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) bits[tr * nc + tc] = live ? 0 : 1;
}

template <typename T>
int launch(const void* x, void* y, void* bits, int R, int C, int br, int bc,
           cudaStream_t stream) {
  relu_bitmap_kernel<T><<<dim3(C / bc, R / br), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int32_t*>(bits), C, br, bc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int relu_bitmap(const void* x, void* y, void* bits, int R, int C,
                           int br, int bc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  if (dtype == 0) return launch<float>(x, y, bits, R, C, br, bc, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, bits, R, C, br, bc, s);
  return (int)cudaErrorInvalidValue;
}
