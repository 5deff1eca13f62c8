// ReLU, and its backward, with the SpRF tile bit fused at the
// writeback, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/relu_bitmap.py: relu_bitmap
// (Pallas). Same contract, without the padding: x (R, C) of any shape;
// returns y = max(x, 0) in x's dtype (y = x < 0 ? 0 : x, so NaN and -0.0
// pass through) and int32 bits (ceil(R/br), ceil(C/bc)), bit 1 when no
// element of the tile is > 0 (the paper's isSparse at writeback: the zero
// check costs no extra pass over the activation). Elements past the edge
// count as 0, which is not > 0, so the bits equal those of the reference's
// zero-padded operand.
//
// What bounds it on this card: bytes (read x once, write y once, ~0 flops
// per byte), and at decode sizes (8 x 1536) the launch. The design: each
// thread moves 16 bytes at a time (8 bf16 or 4 f32 values), with scalar
// loads for a row's ragged tail or a row start that is not 16-byte
// aligned. A tile's row segment (bc columns of one row) belongs to a group
// of lps lanes of one warp (lps: bc / V rounded up to a power of two, at
// most 32), whose "> 0" flags a ballot ORs; a tile one row tall takes its
// bit from that, a taller tile ORs its segments' flags in shared memory.
// A CTA takes tpc tiles side by side of one tile row (grid: tile rows x
// bands of tpc tiles), tpc a function of the shapes
// (kernels/relu_bitmap.py: relu_bitmap_grid): the tiles one 16-byte
// vector a thread covers, so one-row tiles need no division by a runtime
// value to find their row and column. Decode 8 x 1536 bf16 at tile
// (1, 128): 16 CTAs of up to 8 tiles (one CTA a tile made 96); a 256-row
// prefill: 512 CTAs (one a tile made 3072). 128 threads a CTA: at the
// decode shape 16 CTAs of 128 threads finish ~0.1 us before 8 of 256
// (tools/relu_bitmap_probe.py), and a kernel that returns at once takes
// ~0.8 us of the ~1.4 us, so the rest is the body's chain of one load
// and one store, not the launch.
#include "dtype.cuh"

namespace {

using sparce::from_f;
using sparce::to_f;

constexpr int THREADS = 128;  // the backward's blocks
constexpr int RB_THREADS = 128;

// y and the live flag of n <= V elements at x + i: one 16-byte load and
// store when vec, else element by element.
template <typename T>
__device__ __forceinline__ int relu_vector(const T* __restrict__ x,
                                           T* __restrict__ y, size_t i, int n,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  int live = 0;
  if (vec && n == V) {
    uint4 u = *reinterpret_cast<const uint4*>(x + i);
    T* v = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = to_f(v[k]);
      live |= f > 0.f;
      if (f < 0.f) v[k] = from_f<T>(0.f);  // NaN and -0.0 pass, as max does
    }
    *reinterpret_cast<uint4*>(y + i) = u;
  } else {
    for (int k = 0; k < n; ++k) {
      const T v = x[i + k];
      const float f = to_f(v);
      live |= f > 0.f;
      y[i + k] = f < 0.f ? from_f<T>(0.f) : v;
    }
  }
  return live;
}

// CTA (blockIdx.x, blockIdx.y): tile row blockIdx.x of the (gr, gc) bit
// grid, gr = ceil(R / br), gc = ceil(C / bc), and its tiles [tpc *
// blockIdx.y, + tpc). vec: x and y are 16-byte aligned (a segment still
// goes element by element where its row offset is not a multiple of V).
template <typename T>
__global__ void __launch_bounds__(RB_THREADS) relu_bitmap_kernel(
    const T* __restrict__ x, T* __restrict__ y, int32_t* __restrict__ bits,
    int R, int C, int br, int bc, int gc, int tpc, int lps, int vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ int flag_s[];  // tpc flags, for tiles taller than a row
  const int tr = blockIdx.x, tc0 = blockIdx.y * tpc;
  const int ntc = min(tpc, gc - tc0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpw = 32 / lps, grp = lane / lps, gl = lane - grp * lps;
  const unsigned gmask = (lps == 32 ? 0xffffffffu : (1u << lps) - 1u)
                         << (grp * lps);
  if (br > 1) {
    for (int i = threadIdx.x; i < ntc; i += RB_THREADS) flag_s[i] = 0;
    __syncthreads();
  }
  const int nseg = ntc * br;  // row segments: ntc tiles of each row
  // Every lane of a warp runs the same iterations (the ballot needs all).
  for (int q0 = warp * gpw; q0 < nseg; q0 += (RB_THREADS / 32) * gpw) {
    const int q = q0 + grp;
    int rr = 0, tcl = q;  // row of the tile row, tile of the band
    if (br > 1) rr = q / ntc, tcl = q - rr * ntc;
    int live = 0;
    if (q < nseg) {
      const int r = tr * br + rr, cs = (tc0 + tcl) * bc;
      if (r < R) {
        const int n = min(bc, C - cs);
        const size_t base = (size_t)r * C + cs;
        const bool v_ok = vec && base % V == 0;
        for (int e = gl * V; e < n; e += lps * V)
          live |= relu_vector<T>(x, y, base + e, min(V, n - e), v_ok);
      }
    }
    const bool any = (__ballot_sync(0xffffffffu, live) & gmask) != 0;
    if (gl == 0 && q < nseg) {
      if (br == 1)
        bits[(size_t)tr * gc + tc0 + tcl] = any ? 0 : 1;
      else if (any)
        flag_s[tcl] = 1;  // the same value from every writer
    }
  }
  if (br > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < ntc; i += RB_THREADS)
      bits[(size_t)tr * gc + tc0 + i] = flag_s[i] ? 0 : 1;
  }
}

// The relu backward with the error bitmap fused at its writeback.
// Replaces repro/kernels/relu_bitmap.py: relu_bwd_bitmap (Pallas): gx =
// where(x > 0, g, 0) in g's dtype (a NaN in g passes where x > 0) and
// one bit per tile, 1 when no element of gx is != 0 (a NaN is != 0,
// -0.0 is not): the error sparsity the backward GEMMs gate on. Same
// shape as the forward kernel: one block per tile, one pass, the flags
// ORed with __syncthreads_or. Bytes bound it (read x and g, write gx).
template <typename T>
__global__ void __launch_bounds__(THREADS) relu_bwd_bitmap_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ gx,
    int32_t* __restrict__ bits, int C, int br, int bc) {
  const int tc = blockIdx.x, tr = blockIdx.y, nc = gridDim.x;
  const int n = br * bc;
  int live = 0;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int rr = e / bc;
    const size_t idx =
        (size_t)(tr * br + rr) * C + (size_t)tc * bc + (e - rr * bc);
    const T v = to_f(x[idx]) > 0.f ? g[idx] : from_f<T>(0.f);
    gx[idx] = v;
    live |= to_f(v) != 0.f;  // true for NaN, false for -0.0
  }
  live = __syncthreads_or(live);
  if (threadIdx.x == 0) bits[tr * nc + tc] = live ? 0 : 1;
}

template <typename T>
int launch(const void* x, void* y, void* bits, int R, int C, int br, int bc,
           int tpc, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int gr = (R + br - 1) / br, gc = (C + bc - 1) / bc;
  const int bands = (gc + tpc - 1) / tpc;
  if (bands > 65535 || (br > 1 && tpc > 1024))
    return (int)cudaErrorInvalidValue;
  int lps = 1;  // lanes of a row segment: bc / V rounded up, at most 32
  while (lps < 32 && lps * V < bc) lps <<= 1;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  relu_bitmap_kernel<T><<<dim3((unsigned)gr, (unsigned)bands), RB_THREADS,
                          br > 1 ? tpc * sizeof(int) : 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int32_t*>(bits), R, C, br, bc, gc, tpc, lps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Any R and C;
// tpc: tiles of a tile row per CTA (>= 1; <= 1024 when br > 1; at most
// 65535 CTAs along a tile row). Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int relu_bitmap(const void* x, void* y, void* bits, int R, int C,
                           int br, int bc, int tpc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  if (br < 1 || bc < 1 || tpc < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, y, bits, R, C, br, bc, tpc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, bits, R, C, br, bc, tpc, s);
  return (int)cudaErrorInvalidValue;
}

// x, g and gx share the dtype (0 = float32, 1 = bfloat16); R % br == 0
// and C % bc == 0. Returns cudaGetLastError() after the launch.
extern "C" int relu_bwd_bitmap(const void* x, const void* g, void* gx,
                               void* bits, int R, int C, int br, int bc,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  const dim3 grid(C / bc, R / br);
  if (dtype == 0) {
    relu_bwd_bitmap_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(gx), static_cast<int32_t*>(bits), C, br, bc);
  } else if (dtype == 1) {
    relu_bwd_bitmap_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(gx), static_cast<int32_t*>(bits), C, br,
        bc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
