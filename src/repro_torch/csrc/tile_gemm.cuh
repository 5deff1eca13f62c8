// Device helpers shared by the SparCE MLP and GEMM kernels (sm_90a):
// dtype conversions, a register-blocked SIMT tile product staged
// through shared memory, and the fixed-order reduction of live f32
// partials that the two-pass MLP kernels end with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sparce {

constexpr int TN = 128;  // sub-tile columns: 16 threads x 8 columns
constexpr int KC = 32;   // depth staged per shared-memory round
constexpr int NT = 256;  // threads: 16 (rows) x 16 (columns)
constexpr int XS_LD = KC + 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
// Round an f32 value through T and back, as a writeback in T would.
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// acc[RM][8] += A (16*RM x depth) @ B (depth x TN) for this thread's
// patch: rows ty*RM + i, columns tx + 16*j. load_a(r, k) / load_b(k, c)
// return the operand value (0 where the caller masks it); staging goes
// through xs (16*RM x XS_LD) and ws (KC x TN) in shared memory. Every
// thread of the block must call it (it synchronises).
template <int RM, typename LoadA, typename LoadB>
__device__ __forceinline__ void gemm_patch_acc(float (&acc)[RM][8], int depth,
                                               LoadA load_a, LoadB load_b,
                                               float* xs, float* ws) {
  constexpr int TM = 16 * RM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < depth; k0 += KC) {
    for (int e = tid; e < TM * KC; e += NT) {
      const int r = e / KC, kk = e - r * KC;
      xs[r * XS_LD + kk] = (k0 + kk < depth) ? load_a(r, k0 + kk) : 0.f;
    }
    for (int e = tid; e < KC * TN; e += NT) {
      const int kk = e / TN, c = e - kk * TN;
      ws[e] = (k0 + kk < depth) ? load_b(k0 + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[RM], b[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[(ty * RM + i) * XS_LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk * TN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc = A @ B (see gemm_patch_acc).
template <int RM, typename LoadA, typename LoadB>
__device__ __forceinline__ void gemm_patch(float (&acc)[RM][8], int depth,
                                           LoadA load_a, LoadB load_b,
                                           float* xs, float* ws) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gemm_patch_acc<RM>(acc, depth, load_a, load_b, xs, ws);
}

// y[m, n] = sum over live stripes f (bits[m/bm, f] == 0), in fixed f
// order, of partial[m/bm, f, m%bm, n]; one thread per output element.
// Deterministic run to run; reads bits and scratch only, never a weight.
template <typename T>
__global__ void live_partial_reduce_kernel(const float* __restrict__ partial,
                                           const int32_t* __restrict__ bits,
                                           T* __restrict__ y, int M, int N,
                                           int bm, int nf) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * N) return;
  const int m = (int)(idx / N), n = (int)(idx - (size_t)m * N);
  const int ti = m / bm, rr = m - ti * bm;
  float s = 0.f;
  for (int f = 0; f < nf; ++f)
    if (bits[ti * nf + f] == 0)
      s += partial[(((size_t)ti * nf + f) * bm + rr) * N + n];
  y[idx] = from_f<T>(s);
}

template <typename T>
cudaError_t launch_live_partial_reduce(const float* partial,
                                       const int32_t* bits, T* y, int M,
                                       int N, int bm, int nf,
                                       cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  live_partial_reduce_kernel<T>
      <<<blocks, threads, 0, stream>>>(partial, bits, y, M, N, bm, nf);
  return cudaGetLastError();
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sparce
