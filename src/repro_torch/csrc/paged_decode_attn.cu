// Paged grouped-query decode attention straight out of the KV pool, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attn.py:
// paged_gqa_decode_attn (Pallas). Same contract: q (B, KV, G, D), pools
// (nb, bs, KV, D), int32 block tables (B, max_blocks), int32 per-slot
// lengths (B,), output (B, KV, G, D) in q's dtype; scores in f32 with the
// scale applied after the dot, positions at or past the length masked to
// -1e30, an online softmax in f32 whose p is rounded to the value dtype
// before the PV product while the normaliser sums the unrounded p, a
// 1e-30 floor on the normaliser, zeros for a length-0 slot.
//
// What bounds it on this card: bytes (~4 G D flops per cached row against
// 4 D bytes of K and V per KV head in bf16: ~3 flop/byte at G 3, far
// under the H100's ~295), and at decode sizes (under 1 MB) the latency
// of a chain of dependent reads -- the length, then the table entries,
// then the blocks. The design:
//   * Grid (head group, slot, chunk). A slot's table is cut into S chunks
//     of E entries, S and E functions of the shapes only
//     (kernels/paged_decode_attn.py: gqa_chunks), so no host reads the
//     lengths and the call can be captured in a CUDA graph. Chunk-major
//     launch order: the live chunks, a prefix of each slot's, start
//     first.
//   * Skip contract (the paper's skip-before-fetch): a chunk at or past
//     the slot's live count min(ceil(len / bs), max_blocks) returns before
//     it reads a table entry or a block (chunk 0 of a length-0 slot writes
//     its zeros); a live chunk reads only its live entries, and of their
//     blocks only the rows before the length (the rest of a step is
//     zero-filled and masked).
//   * A CTA covers a group of up to 4 KV heads -- all of them when KV <= 4,
//     as at smollm (3) -- one warp per head. Why not a CTA per head: a pool
//     row holds every KV head side by side, so the warps of one CTA
//     together read each live block as one contiguous run of bs * KV * D
//     elements (6 KB at smollm) and read the length and the table entries
//     once for all heads, where CTAs per head would read three 128-byte
//     pieces of each row from three CTAs at three times, each CTA paying
//     the chain of dependent reads on its own. Each warp still streams
//     only its head's row slices, through a private ring of STAGES
//     shared-memory buffers by 16-byte cp.async copies, so the loop has
//     no CTA barrier: a warp waits on its own copies and syncs with
//     __syncwarp. K and V stay in their own dtype in shared memory.
//   * Tensor cores, the product transposed: a step's 16 cached rows are
//     the MMA's M, the G (<= 8) query rows of the head its N, D the depth.
//     bf16 runs mma.sync.m16n8k16 with f32 accumulation; f32 runs
//     split-TF32 m16n8k8 (three products, as skip_gemm.cuh does), which
//     holds the f32 tolerance of 1e-5. The online softmax works on the
//     score fragment in registers: a column's max and sum over the 16
//     rows take three shuffles. PV is O^T = V^T P with D as M: p, rounded
//     to the value dtype, becomes P's B fragment by two movmatrix
//     transposes (f32: by shuffles), so it never touches shared memory,
//     and the O accumulators stay in registers.
//   * A slot with one live chunk writes its output directly. Otherwise
//     each live chunk writes (O, m, l) in f32 to scratch, staged through
//     the warp's idle ring and stored in 16-byte vectors, and the last CTA
//     of the slot's head group to arrive (an int32 arrival counter, reset
//     to 0 by that CTA) merges the live chunks in ascending order:
//     m* = max m_c, l = sum l_c e^(m_c - m*), O = sum O_c e^(m_c - m*),
//     out = O / max(l, 1e-30). The order is fixed, whichever CTA arrives
//     last, so repeated calls give equal bits; no atomic touches a value.
//     The same merge as a second launch (as the MLA kernel does) timed
//     slower at every chunk size, by its start and its reads of the
//     lengths, and was removed.
#include "skip_gemm.cuh"

namespace {

using sparce::from_f;
using sparce::to_f;

constexpr float kNegInf = -1e30f;
constexpr int TR = 16;      // cached rows a step: the MMA's M
constexpr int GN = 8;       // query rows of a head: the MMA's N (G <= 8)
constexpr int MAX_HPC = 4;  // KV heads (warps) per CTA

// V: elements in 16 bytes; PAD: elements that make a shared row 16 bytes
// past a multiple of 128 (conflict-free fragment loads); STAGES: ring
// buffers of a warp, one multiplied and the rest in flight (f32 rows are
// twice as wide).
template <typename T> struct GqaCfg;
template <> struct GqaCfg<float> {
  static constexpr int V = 4, PAD = 4, STAGES = 2;
};
template <> struct GqaCfg<__nv_bfloat16> {
  static constexpr int V = 8, PAD = 8, STAGES = 4;
};

// The launch's geometry, a function of the shapes (and E, S, which the
// wrapper derives from the shapes).
struct Geo {
  int B, KV, G, D, BS, max_blocks;
  int E, S;  // table entries per chunk; chunks per slot
  int HPC;   // KV heads per CTA, one warp each
  int DP;    // D rounded up to 16: the scores' depth, the PV's M
  int LD;    // shared row (elements)
  int RS;    // scratch row: O (D rounded up to 8), m, l, pads: 32 bytes
  float scale;
};

template <typename T>
Geo make_geo(int B, int KV, int G, int D, int BS, int max_blocks, int E,
             int S, float scale) {
  Geo g{};
  g.B = B, g.KV = KV, g.G = G, g.D = D, g.BS = BS;
  g.max_blocks = max_blocks, g.E = E, g.S = S, g.scale = scale;
  const int groups = (KV + MAX_HPC - 1) / MAX_HPC;
  g.HPC = (KV + groups - 1) / groups;
  g.DP = (D + 15) / 16 * 16;
  g.LD = g.DP + GqaCfg<T>::PAD;
  g.RS = (D + 7) / 8 * 8 + 8;
  return g;
}

// A warp's shared rows: its head's G query rows (GN rows), then STAGES
// buffers of TR rows of K and TR rows of V.
template <typename T>
__host__ __device__ constexpr int warp_rows() {
  return GN + GqaCfg<T>::STAGES * 2 * TR;
}

// Shared floats merge_chunks needs: each (head, query row)'s m_c, then
// weights, and l_c over the chunks, and its m*.
__host__ __device__ inline size_t merge_floats(int rows, int nchunks) {
  return (size_t)rows * (2 * nchunks + 1);
}

// The front of shared memory: the warps' rows in T -- or, once they are
// idle, the merge's floats -- rounded up to 16 bytes.
template <typename T>
__host__ __device__ inline size_t front_bytes(const Geo& g) {
  const size_t rows = sizeof(T) * (size_t)g.HPC * warp_rows<T>() * g.LD;
  const size_t merge = 4 * merge_floats(g.HPC * g.G, g.S);
  return ((rows > merge ? rows : merge) + 15) / 16 * 16;
}

// The front, then the chunk's table entries and the arrival flag.
template <typename T>
size_t smem_bytes(const Geo& g) {
  return front_bytes<T>(g) + 4 * ((size_t)g.E + 1);
}

__device__ __forceinline__ int live_blocks(int len, const Geo& g) {
  return len > 0 ? min((len + g.BS - 1) / g.BS, g.max_blocks) : 0;
}

// Zeros wherever an MMA reads and no copy writes: columns [D, DP) of every
// shared row of the warp, and the query rows past G.
template <typename T>
__device__ __forceinline__ void zero_pads(const Geo& g, T* rows_s) {
  const int lane = threadIdx.x & 31, gap = g.DP - g.D;
  const T zero = from_f<T>(0.f);
  for (int e = lane; e < warp_rows<T>() * gap; e += 32)
    rows_s[(e / gap) * g.LD + g.D + e % gap] = zero;
  for (int e = lane; e < (GN - g.G) * g.D; e += 32)
    rows_s[(g.G + e / g.D) * g.LD + e % g.D] = zero;
}

// Chunk rows [r0, r0 + TR) of head h into ks (K) and ks + TR * LD (V):
// chunk row r is row r % BS of the block named by the chunk's table entry
// r / BS (tbl_s); rows at or past `live` (the chunk's rows before the
// length) are zero-filled, never read. vec: 16-byte copies.
template <typename T>
__device__ __forceinline__ void load_step(const Geo& g,
                                          const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int* tbl_s, int h, int r0,
                                          int live, T* ks, int vec) {
  constexpr int V = GqaCfg<T>::V;
  const int lane = threadIdx.x & 31;
  T* vs = ks + TR * g.LD;
  const int w = vec ? g.D / V : g.D;  // copies a row
  for (int e = lane; e < TR * w; e += 32) {
    const int rr = e / w, col = (e - rr * w) * (vec ? V : 1), r = r0 + rr;
    T* kd = ks + rr * g.LD + col;
    T* vd = vs + rr * g.LD + col;
    if (r < live) {
      const int ent = r / g.BS;
      const size_t off =
          (((size_t)tbl_s[ent] * g.BS + (r - ent * g.BS)) * g.KV + h) * g.D +
          col;
      if (vec) {
        skip::cp_async16(kd, k_pool + off);
        skip::cp_async16(vd, v_pool + off);
      } else {
        *kd = k_pool[off];
        *vd = v_pool[off];
      }
    } else if (vec) {
      skip::zero16(kd);
      skip::zero16(vd);
    } else {
      *kd = *vd = from_f<T>(0.f);
    }
  }
}

// The head's G query rows into q_s.
template <typename T>
__device__ __forceinline__ void load_q(const Geo& g, const T* __restrict__ qh,
                                       T* q_s, int vec) {
  constexpr int V = GqaCfg<T>::V;
  const int lane = threadIdx.x & 31;
  const int w = vec ? g.D / V : g.D;
  for (int e = lane; e < g.G * w; e += 32) {
    const int r = e / w, col = (e - r * w) * (vec ? V : 1);
    if (vec)
      skip::cp_async16(q_s + r * g.LD + col, qh + (size_t)r * g.D + col);
    else
      q_s[r * g.LD + col] = qh[(size_t)r * g.D + col];
  }
}

// s (rows gq, gq + 8 x query rows 2t, 2t + 1 of the step) = K Q^T over the
// depth: A = the step's K rows (row-major), B = the queries.
template <int DT>
__device__ __forceinline__ void scores(float (&s)[4],
                                       const __nv_bfloat16* q_s,
                                       const __nv_bfloat16* ks, int ld,
                                       int dp) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < DT; ++kt) {
    if (16 * kt >= dp) break;
    // ldmatrix: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k + 8.
    uint32_t a[4];
    const unsigned addr = (unsigned)__cvta_generic_to_shared(
        ks + (lane & 15) * ld + 16 * kt + (lane >> 4) * 8);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr)
        : "memory");
    const __nv_bfloat16* qp = q_s + gq * ld + 16 * kt + 2 * t;
    const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(qp),
                           *reinterpret_cast<const uint32_t*>(qp + 8)};
    skip::mma_bf16(s, a, b);
  }
}

template <int DT>
__device__ __forceinline__ void scores(float (&s)[4], const float* q_s,
                                       const float* ks, int ld, int dp) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < 16 * DT; k0 += 8) {
    if (k0 >= dp) break;
    const float* kp = ks + gq * ld + k0 + t;
    uint32_t ab[4], as[4];
    skip::split_tf32(kp[0], ab[0], as[0]);
    skip::split_tf32(kp[8 * ld], ab[1], as[1]);
    skip::split_tf32(kp[4], ab[2], as[2]);
    skip::split_tf32(kp[8 * ld + 4], ab[3], as[3]);
    const float* qp = q_s + gq * ld + k0 + t;
    uint32_t bb[2], bs[2];
    skip::split_tf32(qp[0], bb[0], bs[0]);
    skip::split_tf32(qp[4], bb[1], bs[1]);
    skip::mma_tf32(s, as, bb);
    skip::mma_tf32(s, ab, bs);
    skip::mma_tf32(s, ab, bb);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// o[mt] (depth columns 16 mt + gq (+ 8) x query rows 2t, 2t + 1) += V^T P
// over the step's 16 rows. p is the score fragment's probabilities.
template <int DT>
__device__ __forceinline__ void context(float (&o)[DT][4],
                                        const float (&p)[4],
                                        const __nv_bfloat16* vs, int ld,
                                        int dp) {
  const int lane = threadIdx.x & 31;
  // P (rows x query rows) as the col-major B operand: the fragment, p
  // rounded to bf16, holds rows gq and gq + 8 at columns 2t, 2t + 1; the
  // transposed 8x8 halves hold rows 2t, 2t + 1 (and + 8) at column gq.
  uint32_t b[2];
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
      : "=r"(b[0])
      : "r"(pack_bf16(p[0], p[1])));
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
      : "=r"(b[1])
      : "r"(pack_bf16(p[2], p[3])));
  // ldmatrix .trans: lanes 8q..8q+7 address the 8 rows of matrix q (q & 1:
  // depth +8, q >> 1: rows +8), giving the row-major A fragment of V^T.
  const int i = lane & 7, qd = lane >> 3;
  const __nv_bfloat16* vp = vs + (i + (qd >> 1) * 8) * ld + (qd & 1) * 8;
#pragma unroll
  for (int mt = 0; mt < DT; ++mt) {
    if (16 * mt >= dp) break;
    uint32_t a[4];
    const unsigned addr = (unsigned)__cvta_generic_to_shared(vp + 16 * mt);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr)
        : "memory");
    skip::mma_bf16(o[mt], a, b);
  }
}

template <int DT>
__device__ __forceinline__ void context(float (&o)[DT][4],
                                        const float (&p)[4], const float* vs,
                                        int ld, int dp) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  // P[row][column gq] for rows t, t + 4 (k step 0) and 8 + t, 12 + t (k
  // step 1): the fragment holds row r < 8 at lane 4 r + column / 2 (p[0],
  // p[1] by column parity), row r + 8 beside it (p[2], p[3]).
  const int src = 4 * t + (gq >> 1), odd = gq & 1;
  float x[4], y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = __shfl_sync(0xffffffffu, p[k], src);
    y[k] = __shfl_sync(0xffffffffu, p[k], src + 16);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t bb[2], bs[2];
    skip::split_tf32(odd ? x[2 * ks + 1] : x[2 * ks], bb[0], bs[0]);
    skip::split_tf32(odd ? y[2 * ks + 1] : y[2 * ks], bb[1], bs[1]);
#pragma unroll
    for (int mt = 0; mt < DT; ++mt) {
      if (16 * mt >= dp) break;
      const float* vp = vs + (8 * ks + t) * ld + 16 * mt + gq;
      uint32_t ab[4], as[4];
      skip::split_tf32(vp[0], ab[0], as[0]);
      skip::split_tf32(vp[8], ab[1], as[1]);
      skip::split_tf32(vp[4 * ld], ab[2], as[2]);
      skip::split_tf32(vp[4 * ld + 8], ab[3], as[3]);
      skip::mma_tf32(o[mt], as, bb);
      skip::mma_tf32(o[mt], ab, bs);
      skip::mma_tf32(o[mt], ab, bb);
    }
  }
}

// n elements from shared src to global dst by the warp, in 16-byte vectors
// where dst and n allow them.
template <typename U>
__device__ __forceinline__ void copy_out(const U* src, U* __restrict__ dst,
                                         int n) {
  constexpr int V = 16 / sizeof(U);
  const int lane = threadIdx.x & 31;
  if ((uintptr_t)dst % 16 == 0 && n % V == 0) {
    for (int e = lane; e < n / V; e += 32)
      reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
  } else {
    for (int e = lane; e < n; e += 32) dst[e] = src[e];
  }
}

// Eight consecutive output elements (n of them in range), in one 16-byte
// store (bf16) or two (f32) where they are aligned.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8], int n) {
  if (n == 8 && (uintptr_t)dst % 16 == 0) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  } else {
    for (int k = 0; k < n; ++k) dst[k] = from_f<T>(v[k]);
  }
}

// out[b, h0 .. h0 + nh) from the slot's nchunks live chunks of scratch in
// ascending order: m* = max m_c, l = sum l_c e^(m_c - m*), O = sum O_c
// e^(m_c - m*), out = O / max(l, 1e-30). Every load of a phase is
// independent of the others, so they are in flight together: the m_c and
// l_c of all rows and chunks at once, then each thread's eight columns of
// a row over eight chunks at a time. ms_s: merge_floats shared floats.
// Scratch is read through L2 (other CTAs wrote it).
template <typename T>
__device__ void merge_chunks(const float* __restrict__ scratch,
                             T* __restrict__ out, float* ms_s, const Geo& g,
                             int b, int h0, int nh, int nchunks) {
  const int rows = nh * g.G;  // (head, query row) pairs
  const int n = rows * nchunks;
  float* w_s = ms_s;      // [row][chunk] m_c, then e^(m_c - m*)
  float* l_s = w_s + n;   // [row][chunk] l_c
  float* mx_s = l_s + n;  // [row] m*
  const size_t cstep = (size_t)g.KV * g.G * g.RS;  // one chunk
  const float* base = scratch + ((size_t)b * g.S * g.KV + h0) * g.G * g.RS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rw = i / nchunks, c = i - rw * nchunks;
    const float* p = base + c * cstep + (size_t)rw * g.RS + g.D;
    w_s[i] = __ldcg(p);
    l_s[i] = __ldcg(p + 1);
  }
  __syncthreads();
  for (int rw = threadIdx.x; rw < rows; rw += blockDim.x) {
    float ms = kNegInf;
    for (int c = 0; c < nchunks; ++c) ms = fmaxf(ms, w_s[rw * nchunks + c]);
    mx_s[rw] = ms;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    w_s[i] = expf(w_s[i] - mx_s[i / nchunks]);
  __syncthreads();
  const int ng = (g.D + 7) / 8;  // groups of 8 columns
  for (int it = threadIdx.x; it < rows * ng; it += blockDim.x) {
    const int rw = it / ng, d0 = (it - rw * ng) * 8;
    const float* p = base + (size_t)rw * g.RS + d0;
    const float* w = w_s + rw * nchunks;
    const float* lc = l_s + rw * nchunks;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, l = 0.f;
#pragma unroll 8
    for (int c = 0; c < nchunks; ++c) {
      const float4* v = reinterpret_cast<const float4*>(p + c * cstep);
      const float4 lo = __ldcg(v), hi = __ldcg(v + 1);
      const float wc = w[c];
      l += lc[c] * wc;
      acc[0] += lo.x * wc;
      acc[1] += lo.y * wc;
      acc[2] += lo.z * wc;
      acc[3] += lo.w * wc;
      acc[4] += hi.x * wc;
      acc[5] += hi.y * wc;
      acc[6] += hi.z * wc;
      acc[7] += hi.w * wc;
    }
    const float den = fmaxf(l, 1e-30f);
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = acc[k] / den;
    store8<T>(out + ((size_t)(b * g.KV + h0) * g.G + rw) * g.D + d0, o,
              min(8, g.D - d0));
  }
}

// One CTA: chunk blockIdx.z of slot blockIdx.y's table, KV heads
// [HPC * blockIdx.x, + HPC), one warp each. DT: 16-column depth tiles.
template <typename T, int DT>
__global__ void __launch_bounds__(32 * MAX_HPC) gqa_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ scratch, int32_t* __restrict__ counts, const Geo g,
    int vec) {
  using C = GqaCfg<T>;
  const int c = blockIdx.z, b = blockIdx.y;
  const int h0 = blockIdx.x * g.HPC, nh = min(g.HPC, g.KV - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int nblk = live_blocks(len, g);
  const int nchunks = (nblk + g.E - 1) / g.E;  // live chunks of the slot
  if (c >= nchunks) {  // nothing of this chunk is read
    if (c == 0) {      // a length-0 slot: zeros
      T* o = out + (size_t)(b * g.KV + h0) * g.G * g.D;
      for (int e = tid; e < nh * g.G * g.D; e += blockDim.x)
        o[e] = from_f<T>(0.f);
    }
    return;
  }
  const int j0 = c * g.E, nent = min(j0 + g.E, nblk) - j0;
  // The chunk's rows before the length (a length past the table's reach
  // keeps every row of the table live).
  const int live = min(nent * g.BS, len - j0 * g.BS);
  const int nsteps = (live + TR - 1) / TR;

  // The warps' rows, reused by the merge; the table entries; the flag.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows_s = reinterpret_cast<T*>(smem_raw) + warp * warp_rows<T>() * g.LD;
  int* tbl_s = reinterpret_cast<int*>(smem_raw + front_bytes<T>(g));
  int* last_s = tbl_s + g.E;
  for (int e = tid; e < nent; e += blockDim.x)
    tbl_s[e] = tables[(size_t)b * g.max_blocks + j0 + e];
  __syncthreads();  // tbl_s is in place

  if (warp < nh) {
    const int h = h0 + warp;
    T* q_s = rows_s;
    T* ring = rows_s + GN * g.LD;
    constexpr int SB = 2 * TR;  // rows of a ring buffer: K, then V
    zero_pads<T>(g, rows_s);
    load_q<T>(g, q + (size_t)(b * g.KV + h) * g.G * g.D, q_s, vec);
    int issued = 0;
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
      if (issued < nsteps) {
        load_step<T>(g, k_pool, v_pool, tbl_s, h, TR * issued, live,
                     ring + (issued % C::STAGES) * SB * g.LD, vec);
        ++issued;
      }
      skip::cp_async_commit();  // the queries ride in the first group
    }
    const int gq = lane >> 2, t = lane & 3;
    // Running max and normaliser of query rows 2t and 2t + 1 (every lane
    // of a column holds the same), and the O^T accumulators.
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float o[DT][4];
#pragma unroll
    for (int mt = 0; mt < DT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

#pragma unroll 1
    for (int i = 0; i < nsteps; ++i) {
      skip::cp_async_wait<C::STAGES - 2>();
      __syncwarp();  // step i landed; step i - 1's buffer is free
      if (issued < nsteps) {
        load_step<T>(g, k_pool, v_pool, tbl_s, h, TR * issued, live,
                     ring + (issued % C::STAGES) * SB * g.LD, vec);
        ++issued;
      }
      skip::cp_async_commit();
      const T* ks = ring + (i % C::STAGES) * SB * g.LD;

      float s[4] = {0.f, 0.f, 0.f, 0.f};
      scores<DT>(s, q_s, ks, g.LD, g.DP);
      // Rows TR i + gq and + 8 of the chunk; every step has a live row 0.
      const bool lo = TR * i + gq < live, hi = TR * i + gq + 8 < live;
      s[0] = lo ? s[0] * g.scale : kNegInf;
      s[1] = lo ? s[1] * g.scale : kNegInf;
      s[2] = hi ? s[2] * g.scale : kNegInf;
      s[3] = hi ? s[3] * g.scale : kNegInf;
      float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], d));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], d));
      }
      float corr[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float m_new = fmaxf(m_run[k], mx[k]);
        corr[k] = expf(m_run[k] - m_new);
        m_run[k] = m_new;
      }
      const float p[4] = {expf(s[0] - m_run[0]), expf(s[1] - m_run[1]),
                          expf(s[2] - m_run[0]), expf(s[3] - m_run[1])};
      float sum[2] = {p[0] + p[2], p[1] + p[3]};  // p unrounded
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], d);
        sum[1] += __shfl_xor_sync(0xffffffffu, sum[1], d);
      }
      l_run[0] = l_run[0] * corr[0] + sum[0];
      l_run[1] = l_run[1] * corr[1] + sum[1];
#pragma unroll
      for (int mt = 0; mt < DT; ++mt) {
        o[mt][0] *= corr[0];
        o[mt][1] *= corr[1];
        o[mt][2] *= corr[0];
        o[mt][3] *= corr[1];
      }
      context<DT>(o, p, ks + TR * g.LD, g.LD, g.DP);
    }
    skip::cp_async_wait<0>();
    __syncwarp();  // the ring is idle

    // The head's G x D tile through the warp's ring: the output, normalised,
    // in T for a slot with one live chunk; else O in f32 beside m and l.
    if (nchunks == 1) {
      T* st = ring;
#pragma unroll
      for (int mt = 0; mt < DT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * mt + gq + 8 * (e >> 1), r = 2 * t + (e & 1);
          if (d < g.D && r < g.G)
            st[r * g.D + d] =
                from_f<T>(o[mt][e] / fmaxf(l_run[e & 1], 1e-30f));
        }
      __syncwarp();
      copy_out<T>(st, out + (size_t)(b * g.KV + h) * g.G * g.D, g.G * g.D);
    } else {
      float* st = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int mt = 0; mt < DT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * mt + gq + 8 * (e >> 1), r = 2 * t + (e & 1);
          if (d < g.D && r < g.G) st[r * g.RS + d] = o[mt][e];
        }
      if (gq == 0)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (2 * t + k < g.G) {
            st[(2 * t + k) * g.RS + g.D] = m_run[k];
            st[(2 * t + k) * g.RS + g.D + 1] = l_run[k];
          }
      __syncwarp();
      copy_out<float>(
          st, scratch + (((size_t)b * g.S + c) * g.KV + h) * g.G * g.RS,
          g.G * g.RS);
    }
  }
  if (nchunks == 1) return;

  // The last CTA of the slot's head group to arrive merges its chunks.
  __threadfence();  // this CTA's partials are visible before it counts
  __syncthreads();
  if (tid == 0) {
    int32_t* cnt = counts + (size_t)b * gridDim.x + blockIdx.x;
    const int last = atomicAdd(cnt, 1) == nchunks - 1;
    if (last) *cnt = 0;  // ready for the next call
    *last_s = last;
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  merge_chunks<T>(scratch, out, reinterpret_cast<float*>(smem_raw), g, b,
                  h0, nh, nchunks);
}

template <typename T, int DT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, void* scratch,
           void* counts, const Geo& g, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(g);
  static size_t allowed = 48 * 1024;
  cudaError_t err = sparce::allow_smem(gqa_chunk_kernel<T, DT>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = GqaCfg<T>::V;
  const auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = aligned(q) && aligned(k_pool) && aligned(v_pool) &&
                  g.D % V == 0;
  const unsigned groups = (unsigned)((g.KV + g.HPC - 1) / g.HPC);
  // Chunk-major: chunk 0 of every slot first.
  const dim3 grid(groups, (unsigned)g.B, (unsigned)g.S);
  gqa_chunk_kernel<T, DT><<<grid, 32 * g.HPC, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(scratch), static_cast<int32_t*>(counts), g, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* lengths, void* out,
             void* scratch, void* counts, int B, int KV, int G, int D,
             int BS, int max_blocks, int E, int S, float scale,
             cudaStream_t s) {
  const Geo g = make_geo<T>(B, KV, G, D, BS, max_blocks, E, S, scale);
  if (g.DP <= 64)
    return launch<T, 4>(q, k_pool, v_pool, tables, lengths, out, scratch,
                        counts, g, s);
  return launch<T, 8>(q, k_pool, v_pool, tables, lengths, out, scratch,
                      counts, g, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output share it).
// G <= 8, D <= 128, BS >= 1. E: table entries per chunk (<= 256), S:
// chunks per slot (S * E >= max_blocks). scratch: f32 (B, S, KV, G, RS),
// RS = D rounded up to a multiple of 8, plus 8 -- each chunk's O, m and l --
// read only for slots with more than one live chunk. counts: int32 (B,
// head groups), zero before the call; a call that runs to its end leaves
// it zero, so calls that share it must not overlap (one stream, or one
// captured graph). Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int paged_gqa_decode_attn(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* scratch, void* counts, int B,
    int KV, int G, int D, int BS, int max_blocks, int E, int S, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0) return 0;
  if (G < 1 || G > GN || D < 1 || D > 128 || BS < 1 || E < 1 || E > 256 ||
      S < 1 || (long)S * E < max_blocks || B > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, tables, lengths, out, scratch,
                           counts, B, KV, G, D, BS, max_blocks, E, S, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                   scratch, counts, B, KV, G, D, BS,
                                   max_blocks, E, S, scale, s);
  return (int)cudaErrorInvalidValue;
}
