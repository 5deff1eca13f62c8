// The tensor-core core of the gated, compacted and two-sided SparCE
// GEMMs (sm_90a), and the MMA and copy primitives the gated-GLU kernel
// (sparce_glu_mlp.cu) builds on.
//
// A block computes one output slab -- SLAB_N columns of w by RB rows of
// x -- over one chunk of the plan's k tiles, [c*S, (c+1)*S) with S a
// function of (K, block_k) only (the wrapper's chunk_tiles). Within the
// chunk it walks only the k tiles the slab has live: some row with its
// lhs bit at 0 (lhs gate), some column with its rhs bit at 0 (rhs gate),
// or both of these (the two-sided gate, where a tile product is dropped
// when either bit is 1). Warp by warp, a ballot over 32 k tiles at a
// time turns the bits into a mask of live tiles, so the list is built
// on the device and needs no storage. A row whose lhs bit is 1 and a
// column whose rhs bit is 1 are zero-filled in shared memory; a gated
// tile is never loaded. With both gates that zeroes exactly the
// products for which Ra | Rb holds.
//
// The product is transposed: w's columns are the MMA's M dimension (16
// per warp), x's rows its N dimension (8 per n-tile), so at decode and
// fc shapes (1 to 8 rows) no MMA row is padding. bf16 runs
// mma.sync.m16n8k16 with f32 accumulation; f32 runs split-TF32 (each
// operand a TF32 "big" part plus a TF32 residual, small*big, big*small
// and big*big per step with mma.sync.m16n8k8, into three accumulators
// added at the end), within f32 rounding of the full-precision product.
// Separate accumulators (bf16: one per k-step parity) keep consecutive
// MMAs independent; with one accumulator each MMA waited on the last. A stage holds KB of one k tile's depth
// (128 bytes of a row) and a k step never spans two k tiles: a tile's
// ragged end (or a block_k below the step) is zero-filled.
//
// Operands stream through a ring of STAGES shared-memory buffers by
// cp.async.cg (16 bytes a thread, neighbouring threads on neighbouring
// addresses), so the next live steps are in flight while the current one
// is multiplied. Ragged edges, unaligned rows and gate changes inside a
// vector fall back to scalar loads; bits are always read before the
// operand they gate.
//
// The sum over chunks is deterministic: with one chunk the block writes
// y; with several it writes its f32 partial to scratch[chunk] and
// chunk_reduce_kernel adds the chunks in ascending order. Both start
// from +0, so both give y = 0 + p0 + p1 + ... bit for bit.
//
// Bit equality of the two kernels: for a given (row, column) the MMA
// steps of its live tiles are the same instructions on the same values
// in the same order in both, into the same accumulator sets, since S,
// the stages and the steps (and a step's set, by its place in the stage)
// depend on (K, block_k) and the dtype only. The gated kernel adds steps
// in which the row's operand is zero, which leave an f32 accumulator
// unchanged (it starts at +0 and never becomes -0: x + (+-0) == x for
// x != -0).
#pragma once

#include "dtype.cuh"

namespace skip {

using sparce::from_f;
using sparce::to_f;

constexpr int SLAB_N = 64;  // w columns per block: 4 warps x 16
constexpr int THREADS = 128;
constexpr int STAGES = 3;         // buffers in the cp.async ring
constexpr int W_LD = SLAB_N + 8;  // shared row of w: banks 8 apart per k
constexpr int MAX_NT8 = 8;        // at most 64 rows of x per block

// KB: depth of a stage (128 bytes of a row); KS: the MMA's k step; V:
// elements in 16 bytes; X_LD: shared row of x (144 bytes, conflict free).
template <typename T> struct Cfg;
// NACC: accumulator sets (f32: big*big, small*big, big*small; bf16: even
// and odd k steps of a stage), so consecutive MMAs do not wait on each
// other; they are added once, at the end of the chunk.
template <> struct Cfg<float> {
  static constexpr int KB = 32, KS = 8, V = 4, X_LD = KB + 4;
  static constexpr int NACC = 3;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int KB = 64, KS = 16, V = 8, X_LD = KB + 8;
  static constexpr int NACC = 2;
};

template <typename T>
constexpr size_t smem_bytes(int nt8) {
  return (size_t)STAGES *
         (Cfg<T>::KB * W_LD + 8 * nt8 * Cfg<T>::X_LD) * sizeof(T);
}

// The block's output slab and chunk.
struct Slab {
  int row0, rlim;  // rows [row0, row0 + rlim) of x and y
  int col0, clim;  // columns [col0, col0 + clim) of w and y
  int t_lo, t_hi;  // k tiles [t_lo, t_hi)
};

// The bit grids, 1 == gated. bits: one gate's grid, lhs (rhs == 0)
// ceil(M/bm) x gk over x's tiles or rhs gk x gn over w's. The two-sided
// gate (TWO below, a compile-time switch) passes its lhs grid as bits and
// its rhs grid as rbits. (Kept in this shape on purpose: holding an lhs
// and an rhs grid pointer, one of them null, slowed the compacted f32
// kernel through its code generation alone.)
struct Gate {
  const int32_t* bits;
  int rhs, bm, bn, gk, gn;
  const int32_t* rbits;
};

// One stage: k tile kt, depth [k0, k0 + d) of K (d <= KB).
struct Step {
  int kt, k0, d;
};

// Mask of the k tiles [base, base + 32) of the chunk that the slab has
// live: some row (lhs) or column (rhs) of the slab with its bit at 0 and,
// with TWO, also some column with its rbits bit at 0. Every lane of the
// warp calls it.
template <bool TWO>
__device__ __forceinline__ unsigned live_window(const Gate& g, const Slab& s,
                                                int base) {
  const int kt = base + (threadIdx.x & 31);
  bool live = false;
  if (kt < s.t_hi) {
    if (!g.rhs) {
      const int tl = (s.row0 + s.rlim - 1) / g.bm;
      for (int t = s.row0 / g.bm; t <= tl; ++t)
        live |= g.bits[(size_t)t * g.gk + kt] == 0;
    } else {
      const int jl = (s.col0 + s.clim - 1) / g.bn;
      for (int j = s.col0 / g.bn; j <= jl; ++j)
        live |= g.bits[(size_t)kt * g.gn + j] == 0;
    }
    if (TWO && live) {
      live = false;
      const int jl = (s.col0 + s.clim - 1) / g.bn;
      for (int j = s.col0 / g.bn; j <= jl; ++j)
        live |= g.rbits[(size_t)kt * g.gn + j] == 0;
    }
  }
  return __ballot_sync(0xffffffffu, live);
}

// The live stages of the chunk in ascending k, one k tile after another.
// Uniform over the block: every warp computes the same masks.
struct Walk {
  int base, kt, koff, depth;
  unsigned mask;

  template <bool TWO>
  __device__ bool next(const Gate& g, const Slab& s, int K, int bk, int kb,
                       Step& st) {
    if (kt >= 0 && koff + kb < depth) {
      koff += kb;
    } else {
      while (mask == 0) {
        base += 32;
        if (base >= s.t_hi) return false;
        mask = live_window<TWO>(g, s, base);
      }
      kt = base + __ffs(mask) - 1;
      mask &= mask - 1;
      koff = 0;
      depth = min(bk, K - kt * bk);
    }
    st = {kt, kt * bk + koff, min(kb, depth - koff)};
    return true;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Stage st's tiles into shared memory: w (KB x SLAB_N) and x (RB x KB),
// zeros for gated rows (lhs bit 1) and columns (rhs bit 1), ragged depth
// and edges.
// vec_x / vec_w: 16-byte copies are aligned (rows and k tiles multiples
// of 16 bytes). Two passes: first every bit this thread's vectors need,
// so the reads are in flight together, then the copies.
template <typename T, int RB, bool TWO>
__device__ __forceinline__ void load_stage(T* ws, T* xs,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const Gate& g, const Slab& s,
                                           const Step& st, int K, int N,
                                           int vec_x, int vec_w) {
  using C = Cfg<T>;
  constexpr int V = C::V, WV = SLAB_N / V, XV = C::KB / V;
  constexpr int W_IT = C::KB * WV / THREADS;
  constexpr int X_IT = (RB * XV + THREADS - 1) / THREADS;
  static_assert(C::KB * WV % THREADS == 0, "w vectors per thread");
  const T zero = from_f<T>(0.f);
  // w vector state: 0 copy, 1 zero (past the depth or N, or gated), 2
  // scalar (ragged edge or unaligned), 3 one bit per column.
  int wmode[W_IT];
#pragma unroll
  for (int it = 0; it < W_IT; ++it) {
    const int e = threadIdx.x + it * THREADS, kr = e / WV;
    const int c = (e - kr * WV) * V, n_in = min(V, s.clim - c);
    wmode[it] = (kr >= st.d || n_in <= 0) ? 1 : (vec_w && n_in == V) ? 0 : 2;
    if ((TWO || g.rhs) && wmode[it] != 1) {
      const int jf = (s.col0 + c) / g.bn, jl = (s.col0 + c + n_in - 1) / g.bn;
      if (jf != jl)
        wmode[it] = 3;
      else if ((TWO ? g.rbits : g.bits)[(size_t)st.kt * g.gn + jf] != 0)
        wmode[it] = 1;
    }
  }
  bool xlive[X_IT];
#pragma unroll
  for (int it = 0; it < X_IT; ++it) {
    const int e = threadIdx.x + it * THREADS, r = e / XV;
    const int kk = (e - r * XV) * V;
    xlive[it] = e < RB * XV && r < s.rlim && kk < st.d &&
                (g.rhs ||
                 g.bits[(size_t)((s.row0 + r) / g.bm) * g.gk + st.kt] == 0);
  }
#pragma unroll
  for (int it = 0; it < W_IT; ++it) {
    const int e = threadIdx.x + it * THREADS, kr = e / WV;
    const int c = (e - kr * WV) * V;
    T* dst = ws + kr * W_LD + c;
    const T* src = w + (size_t)(st.k0 + kr) * N + s.col0 + c;
    if (wmode[it] == 0) {
      cp_async16(dst, src);
    } else if (wmode[it] == 1) {
      zero16(dst);
    } else {
      const int n_in = min(V, s.clim - c);
      for (int i = 0; i < V; ++i) {
        const bool live =
            i < n_in &&
            (wmode[it] == 2 ||
             (TWO ? g.rbits : g.bits)[(size_t)st.kt * g.gn +
                                      (s.col0 + c + i) / g.bn] == 0);
        dst[i] = live ? src[i] : zero;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < X_IT; ++it) {
    const int e = threadIdx.x + it * THREADS, r = e / XV;
    if (e >= RB * XV) break;
    const int kk = (e - r * XV) * V;
    T* dst = xs + r * C::X_LD + kk;
    const T* src = x + (size_t)(s.row0 + r) * K + st.k0 + kk;
    if (!xlive[it]) {
      zero16(dst);
    } else if (vec_x && kk + V <= st.d) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = kk + i < st.d ? src[i] : zero;
    }
  }
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(v - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[.][j] (16 columns at m0 of the stage x rows 8j..8j+7) += the
// stage's product. A = w^T (m = column, k): ws holds KB k rows of wld
// columns; B = x^T (k, n = row): xs holds rows of xld. A step's
// accumulator set depends on its place in the stage only.
template <int NT8>
__device__ __forceinline__ void mma_stage(float (&acc)[3][NT8][4],
                                          const float* ws, int wld, int m0,
                                          const float* xs, int xld) {
  constexpr int KSTEPS = Cfg<float>::KB / Cfg<float>::KS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* wp = ws + m0 + g;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k0 = ks * Cfg<float>::KS;
    uint32_t ab[4], as[4];
    split_tf32(wp[(k0 + t) * wld], ab[0], as[0]);
    split_tf32(wp[(k0 + t) * wld + 8], ab[1], as[1]);
    split_tf32(wp[(k0 + t + 4) * wld], ab[2], as[2]);
    split_tf32(wp[(k0 + t + 4) * wld + 8], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const float* xp = xs + (8 * j + g) * xld + k0 + t;
      uint32_t bb[2], bs[2];
      split_tf32(xp[0], bb[0], bs[0]);
      split_tf32(xp[4], bb[1], bs[1]);
      mma_tf32(acc[1][j], as, bb);
      mma_tf32(acc[2][j], ab, bs);
      mma_tf32(acc[0][j], ab, bb);
    }
  }
}

template <int NT8>
__device__ __forceinline__ void mma_stage(float (&acc)[2][NT8][4],
                                          const __nv_bfloat16* ws, int wld,
                                          int m0, const __nv_bfloat16* xs,
                                          int xld) {
  constexpr int KS = Cfg<__nv_bfloat16>::KS;
  constexpr int KSTEPS = Cfg<__nv_bfloat16>::KB / KS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i = lane & 7, q = lane >> 3;
  // ldmatrix .trans: lanes 8q..8q+7 address the 8 k rows of matrix q
  // (q & 1: columns +8, q >> 1: k +8), giving the row-major A fragment.
  const __nv_bfloat16* wp = ws + (i + (q >> 1) * 8) * wld + m0 + (q & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k0 = ks * KS;
    uint32_t a[4];
    const unsigned addr = (unsigned)__cvta_generic_to_shared(wp + k0 * wld);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr)
        : "memory");
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const __nv_bfloat16* xp = xs + (8 * j + g) * xld + k0 + 2 * t;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(xp),
                             *reinterpret_cast<const uint32_t*>(xp + 8)};
      mma_bf16(acc[ks & 1][j], a, b);
    }
  }
}

// The slab's sums: y (one chunk) or scratch[chunk] (several), each the
// accumulator sets added in a fixed order. The accumulator of (column m,
// row n) sits in lane 4 * (m % 8) + n % 8 / 2.
template <typename T, int NT8>
__device__ __forceinline__ void store_slab(
    const float (&acc)[Cfg<T>::NACC][NT8][4], T* __restrict__ y,
    float* __restrict__ partial, int nchunks, int M, int N, const Slab& s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cw = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int col = cw + g + (h >> 1) * 8, row = 8 * j + 2 * t + (h & 1);
      if (row >= s.rlim || col >= s.clim) continue;
      float v;
      if constexpr (Cfg<T>::NACC == 3)
        v = acc[0][j][h] + (acc[1][j][h] + acc[2][j][h]);
      else
        v = acc[0][j][h] + acc[1][j][h];
      const size_t o = (size_t)(s.row0 + row) * N + s.col0 + col;
      if (nchunks == 1)
        y[o] = from_f<T>(0.f + v);  // as chunk_reduce_kernel adds
      else
        partial[(size_t)blockIdx.z * M * N + o] = v;
    }
}

// The block's slab over its chunk (blockIdx.z): walk the live stages
// through the cp.async ring, multiply each on the tensor cores, store.
// TWO: the two-sided gate (g.bits over x's tiles, g.rbits over w's).
template <typename T, int NT8, bool TWO>
__device__ __forceinline__ void skip_gemm(const T* __restrict__ x,
                                          const T* __restrict__ w,
                                          const Gate& g, const Slab& s,
                                          T* __restrict__ y,
                                          float* __restrict__ partial, int M,
                                          int K, int N, int bk, int nchunks,
                                          int vec_x, int vec_w) {
  using C = Cfg<T>;
  constexpr int RB = 8 * NT8;
  constexpr int WS = C::KB * W_LD, XS = RB * C::X_LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* xs = ws + STAGES * WS;
  float acc[C::NACC][NT8][4];
#pragma unroll
  for (int a = 0; a < C::NACC; ++a)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[a][j][h] = 0.f;
  Walk walk{s.t_lo - 32, -1, 0, 0, 0u};
  Step st;
  int issued = 0;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (walk.template next<TWO>(g, s, K, bk, C::KB, st)) {
      const int slot = issued % STAGES;
      load_stage<T, RB, TWO>(ws + slot * WS, xs + slot * XS, x, w, g, s, st, K,
                        N, vec_x, vec_w);
      ++issued;
    }
    cp_async_commit();
  }
  for (int i = 0; i < issued; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    if (walk.template next<TWO>(g, s, K, bk, C::KB, st)) {
      const int slot = issued % STAGES;
      load_stage<T, RB, TWO>(ws + slot * WS, xs + slot * XS, x, w, g, s, st, K,
                        N, vec_x, vec_w);
      ++issued;
    }
    cp_async_commit();
    const int slot = i % STAGES;
    mma_stage<NT8>(acc, ws + slot * WS, W_LD, (threadIdx.x >> 5) * 16,
                   xs + slot * XS, C::X_LD);  // each warp its 16 columns
  }
  store_slab<T, NT8>(acc, y, partial, nchunks, M, N, s);
}

// y[i] = 0 + partial[0][i] + partial[1][i] + ..., in chunk order.
template <typename T>
__global__ void chunk_reduce_kernel(const float* __restrict__ partial,
                                    T* __restrict__ y, size_t total,
                                    int nchunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += partial[(size_t)c * total + i];
  y[i] = from_f<T>(s);
}

template <typename T>
cudaError_t launch_chunk_reduce(const float* partial, T* y, size_t total,
                                int nchunks, cudaStream_t stream) {
  const int threads = 256;
  chunk_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads),
                           threads, 0, stream>>>(partial, y, total, nchunks);
  return cudaGetLastError();
}

// Rows of x a block serves: 8, 16, 32 or 64 (n-tiles of the MMA).
inline int nt8_for(int rows) {
  return rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : MAX_NT8;
}

// 16-byte copies of a row-major (rows x cols) operand are aligned when
// its base and row pitch are, and (for x) each k tile starts on 16 bytes.
template <typename T>
inline int vec_ok(const void* p, int cols, int tile) {
  constexpr int V = Cfg<T>::V;
  return ((uintptr_t)p % 16 == 0) && cols % V == 0 && tile % V == 0;
}

}  // namespace skip
