// ReLU, and its backward, with the SpRF tile bit fused at the
// writeback, for Hopper (sm_90a): one kernel body, a template over the
// element operation.
//
// Replaces the TPU kernels repro/kernels/relu_bitmap.py: relu_bitmap and
// relu_bwd_bitmap (Pallas). Same contracts, without the padding: x (R, C)
// of any shape, and int32 bits (ceil(R/br), ceil(C/bc)), one per tile.
// - ReluFwd: y = max(x, 0) in x's dtype (y = x < 0 ? 0 : x, so NaN and
//   -0.0 pass through); bit 1 when no element of the tile is > 0 (the
//   paper's isSparse at writeback: the zero check costs no extra pass
//   over the activation).
// - ReluBwd: gx = where(x > 0, g, 0) in g's dtype (a NaN in g passes
//   where x > 0, is dropped where x <= 0); bit 1 when no element of the
//   gx tile is != 0 (a NaN is != 0, -0.0 is not): the error sparsity the
//   backward GEMMs gate on.
// Elements past the edge count as 0 (neither > 0 nor != 0), so the bits
// equal those of the reference's zero-padded operands.
//
// What bounds it on this card: bytes (read x (and g) once, write y once,
// ~0 flops per byte), and at decode sizes (8 x 1536) the launch. The
// design: each thread moves 16 bytes at a time (8 bf16 or 4 f32 values),
// with scalar loads for a row's ragged tail or a row start that is not
// 16-byte aligned. A tile's row segment (bc columns of one row) belongs
// to a group of lps lanes of one warp (lps: bc / V rounded up to a power
// of two, at most 32), whose live flags a ballot ORs; a tile one row
// tall takes its bit from that, a taller tile ORs its segments' flags in
// shared memory. A CTA covers the elements one 16-byte vector a thread
// reaches (kernels/relu_bitmap.py: relu_bitmap_grid, a function of the
// shapes): tpc tiles side by side of one tile row when a tile is
// smaller, so one-row tiles need no division by a runtime value to find
// their row and column; else a slab of rpc rows of one tile, and a tile
// split over several slabs gathers its bit across CTAs: the caller fills
// the bits with 1 and a slab with a live element stores 0 (the same
// value from every writer). A tall tile in one CTA is a chain of
// dependent row segments a warp: alexnet conv1's output (3025 x 96 f32,
// tile (256, 128)) took 12 CTAs and 0.0335 ms on an H100
// (tools/kernel_ab.py); in slabs of 4 rows it takes 768 CTAs. Grid:
// (tile rows x slabs) x bands of tpc tiles. Decode 8 x 1536 bf16 at
// tile (1, 128): 16 CTAs of up to 8 tiles (one CTA a tile made 96); a
// 256-row prefill: 512 CTAs (one a tile made 3072). 128 threads a CTA: at the
// decode shape 16 CTAs of 128 threads finish ~0.1 us before 8 of 256
// (tools/relu_bitmap_probe.py), and a kernel that returns at once takes
// ~0.8 us of the ~1.4 us, so the rest is the body's chain of one load
// and one store, not the launch.
#include "dtype.cuh"

namespace {

using sparce::from_f;
using sparce::to_f;

constexpr int RB_THREADS = 128;

// The element operations. apply(x, g) returns the output element and ORs
// its live flag into `live`; GRAD: the operation reads g.
struct ReluFwd {
  static constexpr bool GRAD = false;
  template <typename T>
  static __device__ __forceinline__ T apply(T x, T, int& live) {
    const float f = to_f(x);
    live |= f > 0.f;
    return f < 0.f ? from_f<T>(0.f) : x;  // NaN and -0.0 pass, as max does
  }
};

struct ReluBwd {
  static constexpr bool GRAD = true;
  template <typename T>
  static __device__ __forceinline__ T apply(T x, T g, int& live) {
    const T v = to_f(x) > 0.f ? g : from_f<T>(0.f);
    live |= to_f(v) != 0.f;  // true for NaN, false for -0.0
    return v;
  }
};

// The outputs and the live flag of n <= V elements at offset i: one
// 16-byte load of x (and of g) and one store when vec, else element by
// element.
template <typename T, typename Op>
__device__ __forceinline__ int tile_vector(const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           T* __restrict__ y, size_t i,
                                           int n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  int live = 0;
  if (vec && n == V) {
    uint4 u = *reinterpret_cast<const uint4*>(x + i);
    uint4 w = u;
    if constexpr (Op::GRAD) w = *reinterpret_cast<const uint4*>(g + i);
    T* v = reinterpret_cast<T*>(&u);
    const T* gv = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = Op::apply(v[k], gv[k], live);
    *reinterpret_cast<uint4*>(y + i) = u;
  } else {
    for (int k = 0; k < n; ++k) {
      const T xv = x[i + k];
      T gv = xv;
      if constexpr (Op::GRAD) gv = g[i + k];
      y[i + k] = Op::apply(xv, gv, live);
    }
  }
  return live;
}

// CTA (blockIdx.x, blockIdx.y): slab blockIdx.x % splits (rows [rpc *
// slab, + rpc) of the tile row; splits = ceil(br / rpc), 1 unless a
// tile is split) of tile row blockIdx.x / splits of the (gr, gc) bit
// grid, gr = ceil(R / br), gc = ceil(C / bc), and its tiles [tpc *
// blockIdx.y, + tpc). y = Op(x, g); g is read only by ReluBwd. vec: x,
// g and y are 16-byte aligned (a segment still goes element by element
// where its row offset is not a multiple of V).
template <typename T, typename Op>
__global__ void __launch_bounds__(RB_THREADS) relu_bitmap_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
    int32_t* __restrict__ bits, int R, int C, int br, int bc, int gc,
    int tpc, int rpc, int splits, int lps, int vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ int flag_s[];  // tpc flags, for tiles taller than a row
  // Tile row, first row and rows of the slab; the division by a runtime
  // value only where a tile is split (a one-row tile's CTA pays none).
  int tr = blockIdx.x, r0 = 0, nr = br;
  if (splits > 1) {
    tr = blockIdx.x / splits;
    r0 = (blockIdx.x - tr * splits) * rpc;
    nr = min(rpc, br - r0);
  }
  const int tc0 = blockIdx.y * tpc, ntc = min(tpc, gc - tc0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpw = 32 / lps, grp = lane / lps, gl = lane - grp * lps;
  const unsigned gmask = (lps == 32 ? 0xffffffffu : (1u << lps) - 1u)
                         << (grp * lps);
  if (br > 1) {
    for (int i = threadIdx.x; i < ntc; i += RB_THREADS) flag_s[i] = 0;
    __syncthreads();
  }
  const int nseg = ntc * nr;  // row segments: ntc tiles of each row
  // Every lane of a warp runs the same iterations (the ballot needs all).
  for (int q0 = warp * gpw; q0 < nseg; q0 += (RB_THREADS / 32) * gpw) {
    const int q = q0 + grp;
    int rr = 0, tcl = q;  // row of the slab, tile of the band
    if (br > 1) rr = q / ntc, tcl = q - rr * ntc;
    int live = 0;
    if (q < nseg) {
      const int r = tr * br + r0 + rr, cs = (tc0 + tcl) * bc;
      if (r < R) {
        const int n = min(bc, C - cs);
        const size_t base = (size_t)r * C + cs;
        const bool v_ok = vec && base % V == 0;
        for (int e = gl * V; e < n; e += lps * V)
          live |= tile_vector<T, Op>(x, g, y, base + e, min(V, n - e), v_ok);
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
    for (int i = threadIdx.x; i < ntc; i += RB_THREADS) {
      if (splits == 1)
        bits[(size_t)tr * gc + tc0 + i] = flag_s[i] ? 0 : 1;
      else if (flag_s[i])
        bits[(size_t)tr * gc + tc0 + i] = 0;  // filled with 1 by the caller
    }
  }
}

template <typename T, typename Op>
int launch(const void* x, const void* g, void* y, void* bits, int R, int C,
           int br, int bc, int tpc, int rpc, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int gr = (R + br - 1) / br, gc = (C + bc - 1) / bc;
  const int bands = (gc + tpc - 1) / tpc;
  const int splits = (br + rpc - 1) / rpc;
  const long long slabs = (long long)gr * splits;
  if (bands > 65535 || slabs > 0x7fffffff || (br > 1 && tpc > 1024) ||
      (rpc < br && tpc > 1))
    return (int)cudaErrorInvalidValue;
  int lps = 1;  // lanes of a row segment: bc / V rounded up, at most 32
  while (lps < 32 && lps * V < bc) lps <<= 1;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                  (uintptr_t)g % 16 == 0;
  relu_bitmap_kernel<T, Op><<<dim3((unsigned)slabs, (unsigned)bands),
                              RB_THREADS, br > 1 ? tpc * sizeof(int) : 0,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y),
      static_cast<int32_t*>(bits), R, C, br, bc, gc, tpc, rpc, splits, lps,
      vec);
  return (int)cudaGetLastError();
}

template <typename Op>
int dispatch(const void* x, const void* g, void* y, void* bits, int R, int C,
             int br, int bc, int tpc, int rpc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  if (br < 1 || bc < 1 || tpc < 1 || rpc < 1 || rpc > br)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, Op>(x, g, y, bits, R, C, br, bc, tpc, rpc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, Op>(x, g, y, bits, R, C, br, bc, tpc, rpc,
                                     s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of a call shares it).
// Any R and C; tpc: tiles of a tile row per CTA (>= 1; <= 1024 when
// br > 1; at most 65535 CTAs along a tile row); rpc: rows of a tile per
// CTA (1..br; below br, tpc must be 1 and bits must hold 1 on entry).
// Each returns cudaGetLastError() after the launch (0 = success).
extern "C" int relu_bitmap(const void* x, void* y, void* bits, int R, int C,
                           int br, int bc, int tpc, int rpc, int dtype,
                           void* stream) {
  return dispatch<ReluFwd>(x, nullptr, y, bits, R, C, br, bc, tpc, rpc,
                           dtype, stream);
}

extern "C" int relu_bwd_bitmap(const void* x, const void* g, void* gx,
                               void* bits, int R, int C, int br, int bc,
                               int tpc, int rpc, int dtype, void* stream) {
  return dispatch<ReluBwd>(x, g, gx, bits, R, C, br, bc, tpc, rpc, dtype,
                           stream);
}
