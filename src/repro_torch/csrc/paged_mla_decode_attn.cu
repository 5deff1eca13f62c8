// Paged MLA (DeepSeek multi-head latent attention) absorbed decode
// straight out of the latent KV pools, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attn.py:
// paged_mla_decode_attn (Pallas). Same contract: wuk-absorbed queries
// q_lat (B, H, R) and rope queries q_rope (B, H, ROPE), the latent pool
// (nb, bs, R) and the shared rope-key pool (nb, bs, ROPE), int32 block
// tables (B, max_blocks) and per-slot lengths (B,); output (B, H, R) in
// q_lat's dtype, still in the latent space (the caller decompresses it
// with wuv). Per pool block: s = (q_lat . ckv + q_rope . kr) * scale
// with f32 accumulation (both dots in one accumulator before the
// scale), positions at or past the length masked to -1e30, an f32
// online softmax whose p is rounded to the pool dtype before the
// context product while the normaliser sums the unrounded p, a 1e-30
// floor on the normaliser, zeros for a length-0 slot. The masked tail
// rows of the last live block are multiplied by p = 0, as in the TPU
// kernel.
//
// What bounds it on this card: bytes (~242 flop per latent byte at H
// 128, R 512, ROPE 64 in bf16, under the H100's ~295), and at decode
// sizes (a few MB) the latency of a chain of dependent steps. The
// design:
//   * Grid (chunk, head group of HG = 32 heads, slot). A slot's table is
//     cut into S chunks of E entries, S and E functions of the shapes
//     only (kernels/paged_decode_attn.py: mla_chunks), so no host reads
//     the lengths and the call can be captured in a CUDA graph; at the
//     DeepSeek decode shape (8 slots, 128 heads, 32 entries of 16 rows)
//     that is 8 x 4 x 8 = 256 CTAs, and no CTA walks more than 4 blocks.
//   * Skip contract (the paper's skip-before-fetch): a chunk at or past
//     the slot's live count ceil(min(len, max_blocks * bs) / bs) returns
//     before it reads a table entry or a block (chunk 0 of a length-0
//     slot writes its zeros); a live chunk walks only its live entries.
//   * Pool blocks stream in their own dtype through a ring of STAGES
//     shared-memory buffers of 16-row pieces by 16-byte cp.async copies
//     (ckv and kr side by side in one row, so the depth R + ROPE is one
//     product); the head group's queries sit in shared memory once.
//   * Scores on the tensor cores: bf16 mma.sync.m16n8k16, f32 split-TF32
//     m16n8k8 (three products), heads as M and cached rows as N; the 8
//     warps take the depth's k steps in turn and their partial sums are
//     added in warp order. The online softmax runs 8 threads per head.
//     p, rounded to the pool dtype, is the A operand of P . ckv, whose O
//     accumulators stay in registers, split over the warps by latent
//     columns.
//   * A slot with one live chunk writes its output directly. Otherwise
//     each chunk writes (O, m, l) in f32 to scratch and
//     mla_combine_kernel merges the live chunks in ascending order:
//     m* = max m_c, l = sum l_c e^(m_c - m*), O = sum O_c e^(m_c - m*),
//     out = O / max(l, 1e-30). Fixed orders throughout, no atomics.
#include "skip_gemm.cuh"

namespace {

using sparce::from_f;
using sparce::to_f;

constexpr float kNegInf = -1e30f;
constexpr int HG = 32;      // heads per CTA: two 16-row m-tiles
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TR = 16;      // pool rows per step (a piece of a block)
constexpr int RLD = TR + 1; // shared row of the warps' partial scores

// KS: the MMA's k step; V: elements in 16 bytes; PAD: elements that make
// a shared row 16 bytes past a multiple of 128 (conflict-free fragment
// loads); PLD: shared row of p; STAGES: ring buffers, one multiplied and
// the rest in flight (bf16: a chunk of 4 blocks is in flight at once;
// f32's rows are twice as wide, so two fit beside the queries).
template <typename T> struct MlaCfg;
template <> struct MlaCfg<float> {
  static constexpr int KS = 8, V = 4, PAD = 4, PLD = TR + 4, STAGES = 2;
};
template <> struct MlaCfg<__nv_bfloat16> {
  static constexpr int KS = 16, V = 8, PAD = 8, PLD = TR + 8, STAGES = 4;
};

// The launch's geometry, a function of the shapes (and E, S, which the
// wrapper derives from the shapes).
struct Geo {
  int B, H, R, ROPE, BS, max_blocks;
  int E, S;   // table entries per chunk; chunks per slot
  int RP;     // R rounded up to KS: where kr starts in a shared row
  int DP;     // the depth, RP + ROPE rounded up to KS
  int LD;     // shared row (elements)
  int PPB;    // pieces of TR rows per pool block
  int RS;     // scratch row: O (R), m, l, rounded up to 16 bytes
  float scale;
};

template <typename T>
Geo make_geo(int B, int H, int R, int ROPE, int BS, int max_blocks, int E,
             int S, float scale) {
  constexpr int KS = MlaCfg<T>::KS;
  Geo g{};
  g.B = B, g.H = H, g.R = R, g.ROPE = ROPE, g.BS = BS;
  g.max_blocks = max_blocks, g.E = E, g.S = S, g.scale = scale;
  g.RP = (R + KS - 1) / KS * KS;
  g.DP = g.RP + (ROPE + KS - 1) / KS * KS;
  g.LD = g.DP + MlaCfg<T>::PAD;
  g.PPB = (BS + TR - 1) / TR;
  g.RS = (R + 2 + 3) / 4 * 4;
  return g;
}

// Queries, the ring and p in T; the warps' partial scores, the
// rescales and the final (m, l) in f32; the chunk's table entries.
template <typename T>
size_t smem_bytes(const Geo& g) {
  return sizeof(T) * ((size_t)(HG + MlaCfg<T>::STAGES * TR) * g.LD +
                      HG * MlaCfg<T>::PLD) +
         4 * ((size_t)WARPS * HG * RLD + 3 * HG + g.E);
}

__device__ __forceinline__ int live_blocks(int len, const Geo& g) {
  return len > 0 ? min((len + g.BS - 1) / g.BS, g.max_blocks) : 0;
}

// Step i of the chunk into a ring buffer: piece i % PPB of the pool
// block named by the chunk's table entry i / PPB (tbl_s), ckv at columns
// [0, R) and kr at [RP, RP + ROPE) of each row; rows past the block's
// end zeroed (zero_pads keeps the columns between and after them zero).
template <typename T>
__device__ __forceinline__ void load_step(
    const Geo& g, const T* __restrict__ ckv_pool,
    const T* __restrict__ kr_pool, const int* tbl_s, int i, T* buf,
    int vec) {
  constexpr int V = MlaCfg<T>::V;
  const int r0 = (i % g.PPB) * TR;
  const int nrows = min(TR, g.BS - r0);
  const size_t blk = (size_t)tbl_s[i / g.PPB];
  const T* cs = ckv_pool + (blk * g.BS + r0) * g.R;
  const T* ks = kr_pool + (blk * g.BS + r0) * g.ROPE;
  if (vec) {
    const int rv = g.R / V, vpr = rv + g.ROPE / V;
    for (int e = threadIdx.x; e < nrows * vpr; e += THREADS) {
      const int r = e / vpr, v = e - r * vpr;
      if (v < rv)
        skip::cp_async16(buf + r * g.LD + v * V, cs + (size_t)r * g.R + v * V);
      else
        skip::cp_async16(buf + r * g.LD + g.RP + (v - rv) * V,
                         ks + (size_t)r * g.ROPE + (v - rv) * V);
    }
  } else {
    const int w = g.R + g.ROPE;
    for (int e = threadIdx.x; e < nrows * w; e += THREADS) {
      const int r = e / w, c = e - r * w;
      buf[r * g.LD + (c < g.R ? c : g.RP + c - g.R)] =
          c < g.R ? cs[(size_t)r * g.R + c] : ks[(size_t)r * g.ROPE + c - g.R];
    }
  }
  const T zero = from_f<T>(0.f);
  for (int e = threadIdx.x; e < (TR - nrows) * g.LD; e += THREADS)
    buf[nrows * g.LD + e] = zero;
}

// Zeros wherever an MMA reads and no copy writes: columns [R, RP) and
// [RP + ROPE, DP) of every shared row of the queries and the ring, and
// the query rows of heads past H (nh heads are live).
template <typename T>
__device__ __forceinline__ void zero_pads(const Geo& g, T* rows_s, int nh) {
  const T zero = from_f<T>(0.f);
  const int gap = g.RP - g.R, w = gap + g.DP - g.RP - g.ROPE;
  const int rows = HG + MlaCfg<T>::STAGES * TR;
  for (int e = threadIdx.x; e < rows * w; e += THREADS) {
    const int r = e / w, c = e - r * w;
    rows_s[r * g.LD + (c < gap ? g.R + c : g.RP + g.ROPE + c - gap)] = zero;
  }
  for (int e = threadIdx.x; e < (HG - nh) * g.DP; e += THREADS)
    rows_s[(nh + e / g.DP) * g.LD + e % g.DP] = zero;
}

// sacc[mi][nj] += the scores of heads 16 mi.. and rows 8 nj.. over k step
// [k0, k0 + KS): Q (heads x depth) times the piece's rows (rows x depth).
__device__ __forceinline__ void score_step(float (&sacc)[2][2][4],
                                           const __nv_bfloat16* q_s,
                                           const __nv_bfloat16* ks, int ld,
                                           int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    // ldmatrix: lanes 0-15 address heads 0-15 at k0, lanes 16-31 at k0 + 8.
    const unsigned addr = (unsigned)__cvta_generic_to_shared(
        q_s + (16 * mi + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[mi][0]), "=r"(a[mi][1]), "=r"(a[mi][2]), "=r"(a[mi][3])
        : "r"(addr)
        : "memory");
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const __nv_bfloat16* kp = ks + (8 * nj + g) * ld + k0 + 2 * t;
    const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kp),
                           *reinterpret_cast<const uint32_t*>(kp + 8)};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) skip::mma_bf16(sacc[mi][nj], a[mi], b);
  }
}

__device__ __forceinline__ void score_step(float (&sacc)[2][2][4],
                                           const float* q_s, const float* ks,
                                           int ld, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const float* qp = q_s + (16 * mi + g) * ld + k0 + t;
    skip::split_tf32(qp[0], ab[mi][0], as[mi][0]);
    skip::split_tf32(qp[8 * ld], ab[mi][1], as[mi][1]);
    skip::split_tf32(qp[4], ab[mi][2], as[mi][2]);
    skip::split_tf32(qp[8 * ld + 4], ab[mi][3], as[mi][3]);
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const float* kp = ks + (8 * nj + g) * ld + k0 + t;
    uint32_t bb[2], bs[2];
    skip::split_tf32(kp[0], bb[0], bs[0]);
    skip::split_tf32(kp[4], bb[1], bs[1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      skip::mma_tf32(sacc[mi][nj], as[mi], bb);
      skip::mma_tf32(sacc[mi][nj], ab[mi], bs);
      skip::mma_tf32(sacc[mi][nj], ab[mi], bb);
    }
  }
}

// o[mi][jn] += p (heads 16 mi.. x the piece's 16 rows) times the rows'
// latent columns 8 (nt0 + jn).. for the warp's n-tiles below ntiles.
template <int NTW>
__device__ __forceinline__ void context_step(float (&o)[2][NTW][4],
                                             const __nv_bfloat16* p_s,
                                             const __nv_bfloat16* vs, int ld,
                                             int nt0, int ntiles) {
  constexpr int PLD = MlaCfg<__nv_bfloat16>::PLD;
  const int lane = threadIdx.x & 31;
  uint32_t a[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(
        p_s + (16 * mi + (lane & 15)) * PLD + (lane >> 4) * 8);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[mi][0]), "=r"(a[mi][1]), "=r"(a[mi][2]), "=r"(a[mi][3])
        : "r"(addr)
        : "memory");
  }
#pragma unroll
  for (int jn = 0; jn < NTW; ++jn) {
    if (nt0 + jn >= ntiles) break;
    // ldmatrix .trans: lanes 0-7 address rows 0-7, lanes 8-15 rows 8-15
    // of the n-tile's 8 columns: the col-major B fragment of rows x cols.
    uint32_t b[2];
    const unsigned addr = (unsigned)__cvta_generic_to_shared(
        vs + (lane & 15) * ld + 8 * (nt0 + jn));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(b[0]), "=r"(b[1])
        : "r"(addr)
        : "memory");
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) skip::mma_bf16(o[mi][jn], a[mi], b);
  }
}

template <int NTW>
__device__ __forceinline__ void context_step(float (&o)[2][NTW][4],
                                             const float* p_s,
                                             const float* vs, int ld,
                                             int nt0, int ntiles) {
  constexpr int PLD = MlaCfg<float>::PLD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < TR; k0 += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* pp = p_s + (16 * mi + g) * PLD + k0 + t;
      skip::split_tf32(pp[0], ab[mi][0], as[mi][0]);
      skip::split_tf32(pp[8 * PLD], ab[mi][1], as[mi][1]);
      skip::split_tf32(pp[4], ab[mi][2], as[mi][2]);
      skip::split_tf32(pp[8 * PLD + 4], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int jn = 0; jn < NTW; ++jn) {
      if (nt0 + jn >= ntiles) break;
      const float* vp = vs + (k0 + t) * ld + 8 * (nt0 + jn) + g;
      uint32_t bb[2], bs[2];
      skip::split_tf32(vp[0], bb[0], bs[0]);
      skip::split_tf32(vp[4 * ld], bb[1], bs[1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        skip::mma_tf32(o[mi][jn], as[mi], bb);
        skip::mma_tf32(o[mi][jn], ab[mi], bs);
        skip::mma_tf32(o[mi][jn], ab[mi], bb);
      }
    }
  }
}

// The CTA's (heads x R) tile from the O accumulators to dst (rows ld
// apart; nh live heads): staged through shared memory (o_s, over the
// queries and the idle ring), then written row by row in 16-byte
// vectors where the rows allow it, else element by element, so a warp's
// stores cover whole sectors. norm: divide each head's row by its
// max(l, 1e-30) (l_s) first.
template <typename U, int NTW>
__device__ __forceinline__ void store_tile(const float (&o)[2][NTW][4],
                                           const float* l_s, bool norm,
                                           U* o_s, U* __restrict__ dst,
                                           int ld, int nh, int R, int nt0) {
  constexpr int V = 16 / sizeof(U);
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int old = (R + V - 1) / V * V + V;  // shared row, 16-byte aligned
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int hl = 16 * mi + gq + 8 * h2;
      const float inv = norm ? 1.f / fmaxf(l_s[hl], 1e-30f) : 1.f;
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (nt0 + jn) + 2 * tq + e;
          if (col < R)
            o_s[hl * old + col] = from_f<U>(o[mi][jn][2 * h2 + e] * inv);
        }
    }
  __syncthreads();
  if (R % V == 0 && ld % V == 0 && (uintptr_t)dst % 16 == 0) {
    const int vpr = R / V;
    for (int e = threadIdx.x; e < nh * vpr; e += THREADS) {
      const int r = e / vpr, v = e - r * vpr;
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + v * V) =
          *reinterpret_cast<const uint4*>(o_s + r * old + v * V);
    }
  } else {
    for (int e = threadIdx.x; e < nh * R; e += THREADS) {
      const int r = e / R, col = e - r * R;
      dst[(size_t)r * ld + col] = o_s[r * old + col];
    }
  }
}

// One CTA: chunk blockIdx.z of slot blockIdx.y's table, heads
// [HG * blockIdx.x, + HG). NTW: latent n-tiles (8 columns) per warp.
template <typename T, int NTW>
__global__ void __launch_bounds__(THREADS) mla_chunk_kernel(
    const T* __restrict__ q_lat, const T* __restrict__ q_rope,
    const T* __restrict__ ckv_pool, const T* __restrict__ kr_pool,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ scratch, const Geo g, int vec) {
  using C = MlaCfg<T>;
  const int c = blockIdx.z, h0 = blockIdx.x * HG, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int nblk = live_blocks(len, g);
  const int nchunks = (nblk + g.E - 1) / g.E;  // live chunks of the slot
  if (c >= nchunks) {  // nothing of this chunk is read
    if (c == 0)        // a length-0 slot: zeros
      for (int e = tid; e < HG * g.R; e += THREADS) {
        const int h = h0 + e / g.R;
        if (h < g.H)
          out[((size_t)b * g.H + h) * g.R + e % g.R] = from_f<T>(0.f);
      }
    return;
  }
  const int j0 = c * g.E, nent = min(j0 + g.E, nblk) - j0;
  const int nsteps = nent * g.PPB;
  const int nh = min(HG, g.H - h0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* ring = q_s + HG * g.LD;
  T* p_s = ring + C::STAGES * TR * g.LD;
  float* red_s = reinterpret_cast<float*>(p_s + HG * C::PLD);
  float* corr_s = red_s + WARPS * HG * RLD;
  float* ml_s = corr_s + HG;                        // final m, then l
  int* tbl_s = reinterpret_cast<int*>(ml_s + 2 * HG);  // live entries
  {
    constexpr int V = C::V;
    const T* ql = q_lat + ((size_t)b * g.H + h0) * g.R;
    const T* qr = q_rope + ((size_t)b * g.H + h0) * g.ROPE;
    if (vec) {
      const int rv = g.R / V, vpr = rv + g.ROPE / V;
      for (int e = tid; e < nh * vpr; e += THREADS) {
        const int h = e / vpr, v = e - h * vpr;
        if (v < rv)
          skip::cp_async16(q_s + h * g.LD + v * V,
                           ql + (size_t)h * g.R + v * V);
        else
          skip::cp_async16(q_s + h * g.LD + g.RP + (v - rv) * V,
                           qr + (size_t)h * g.ROPE + (v - rv) * V);
      }
    } else {
      const int w = g.R + g.ROPE;
      for (int e = tid; e < nh * w; e += THREADS) {
        const int h = e / w, col = e - h * w;
        q_s[h * g.LD + (col < g.R ? col : g.RP + col - g.R)] =
            col < g.R ? ql[(size_t)h * g.R + col]
                      : qr[(size_t)h * g.ROPE + col - g.R];
      }
    }
  }
  for (int e = tid; e < nent; e += THREADS)
    tbl_s[e] = tables[(size_t)b * g.max_blocks + j0 + e];
  zero_pads<T>(g, q_s, nh);
  __syncthreads();  // tbl_s is in place
  int issued = 0;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (issued < nsteps) {
      load_step<T>(g, ckv_pool, kr_pool, tbl_s, issued,
                   ring + (issued % C::STAGES) * TR * g.LD, vec);
      ++issued;
    }
    skip::cp_async_commit();  // the queries ride in the first group
  }

  // The online softmax: thread tid owns head tid / 8 and rows tid % 8 and
  // tid % 8 + 8 of each piece; the 8 threads of a head hold the same m, l.
  const int sh = tid >> 3, sq = tid & 7;
  float m_run = kNegInf, l_run = 0.f;
  const int ntiles = (g.R + 7) / 8, nt0 = warp * NTW;
  float o[2][NTW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
      for (int h = 0; h < 4; ++h) o[mi][jn][h] = 0.f;
  const int gq = lane >> 2, tq = lane & 3;
  const int nks = g.DP / C::KS;

#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    skip::cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // step i landed; step i - 1's buffer and p are free
    if (issued < nsteps) {
      load_step<T>(g, ckv_pool, kr_pool, tbl_s, issued,
                   ring + (issued % C::STAGES) * TR * g.LD, vec);
      ++issued;
    }
    skip::cp_async_commit();
    const T* ks = ring + (i % C::STAGES) * TR * g.LD;

    // -- scores: this warp's k steps, all 32 heads x 16 rows.
    float sacc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 4; ++h) sacc[mi][nj][h] = 0.f;
    for (int kk = warp; kk < nks; kk += WARPS)
      score_step(sacc, q_s, ks, g.LD, kk * C::KS);
    float* red = red_s + warp * HG * RLD;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          red[(16 * mi + gq + 8 * (h >> 1)) * RLD + 8 * nj + 2 * tq +
              (h & 1)] = sacc[mi][nj][h];
    __syncthreads();

    // -- the online softmax over the piece's rows, per head.
    {
      const int j = j0 + i / g.PPB, r0 = (i % g.PPB) * TR;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = sq + 8 * u;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += red_s[(w * HG + sh) * RLD + r];
        const bool live = r0 + r < g.BS && j * g.BS + r0 + r < len;
        s[u] = live ? v * g.scale : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int d = 1; d < 8; d <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float sum = p0 + p1;  // the normaliser takes p unrounded
#pragma unroll
      for (int d = 1; d < 8; d <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      l_run = l_run * corr + sum;
      m_run = m_new;
      p_s[sh * C::PLD + sq] = from_f<T>(p0);  // p in the pool dtype
      p_s[sh * C::PLD + sq + 8] = from_f<T>(p1);
      if (sq == 0) corr_s[sh] = corr;
    }
    __syncthreads();

    // -- context: rescale this warp's O, then add p . ckv.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float c_lo = corr_s[16 * mi + gq], c_hi = corr_s[16 * mi + gq + 8];
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn) {
        o[mi][jn][0] *= c_lo;
        o[mi][jn][1] *= c_lo;
        o[mi][jn][2] *= c_hi;
        o[mi][jn][3] *= c_hi;
      }
    }
    context_step<NTW>(o, p_s, ks, g.LD, nt0, ntiles);
  }
  skip::cp_async_wait<0>();

  if (sq == 0) {
    ml_s[sh] = m_run;
    ml_s[HG + sh] = l_run;
  }
  __syncthreads();  // the ring is idle; m and l are in place
  // A slot with one live chunk: the output, normalised, in T; otherwise
  // the chunk's O in f32 beside its m and l.
  const size_t row = (size_t)b * g.H + h0;
  if (nchunks == 1) {
    store_tile<T, NTW>(o, ml_s + HG, true, reinterpret_cast<T*>(q_s),
                       out + row * g.R, g.R, nh, g.R, nt0);
  } else {
    float* sc = scratch + ((size_t)b * g.S + c) * g.H * g.RS + h0 * g.RS;
    store_tile<float, NTW>(o, ml_s + HG, false,
                           reinterpret_cast<float*>(q_s), sc, g.RS, nh,
                           g.R, nt0);
    if (tid < nh) {
      sc[(size_t)tid * g.RS + g.R] = ml_s[tid];
      sc[(size_t)tid * g.RS + g.R + 1] = ml_s[HG + tid];
    }
  }
}

// out[b, h] from the slot's live chunks in ascending order, for a slot
// with more than one (the others were written by mla_chunk_kernel);
// one block per (head, slot). Reads lengths and scratch only. The
// chunks' weights e^(m_c - m*) are computed once, in shared memory, so
// the loads of a column's chunks are independent of each other.
template <typename T>
__global__ void mla_combine_kernel(const int32_t* __restrict__ lengths,
                                   const float* __restrict__ scratch,
                                   T* __restrict__ out, const Geo g) {
  extern __shared__ float w_s[];  // m_c, then e^(m_c - m*)
  const int h = blockIdx.x, b = blockIdx.y;
  const int nchunks = (live_blocks(lengths[b], g) + g.E - 1) / g.E;
  if (nchunks <= 1) return;
  const size_t row = (size_t)g.RS, step = (size_t)g.H * row;
  const float* sc = scratch + ((size_t)b * g.S * g.H + h) * row;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x)
    w_s[c] = sc[c * step + g.R];
  __syncthreads();
  float ms = kNegInf;
  for (int c = 0; c < nchunks; ++c) ms = fmaxf(ms, w_s[c]);
  __syncthreads();  // every thread has read the m_c
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x)
    w_s[c] = expf(w_s[c] - ms);
  __syncthreads();
  float l = 0.f;
#pragma unroll 4
  for (int c = 0; c < nchunks; ++c) l += sc[c * step + g.R + 1] * w_s[c];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int col = threadIdx.x; col < g.R; col += blockDim.x) {
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) o += sc[c * step + col] * w_s[c];
    out[((size_t)b * g.H + h) * g.R + col] = from_f<T>(o * inv);
  }
}

template <typename T, int NTW>
int launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
           const void* kr_pool, const void* tables, const void* lengths,
           void* out, void* scratch, const Geo& g, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(g);
  static size_t allowed = 48 * 1024;
  cudaError_t err =
      sparce::allow_smem(mla_chunk_kernel<T, NTW>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = MlaCfg<T>::V;
  const auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = aligned(q_lat) && aligned(q_rope) && aligned(ckv_pool) &&
                  aligned(kr_pool) && g.R % V == 0 && g.ROPE % V == 0;
  // Chunk-major: chunk 0 of every slot first, so the live chunks (a
  // prefix of each slot's) are scheduled before the dead ones.
  const dim3 grid((unsigned)((g.H + HG - 1) / HG), (unsigned)g.B,
                  (unsigned)g.S);
  mla_chunk_kernel<T, NTW><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv_pool), static_cast<const T*>(kr_pool),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      static_cast<float*>(scratch), g, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.S == 1) return (int)err;
  mla_combine_kernel<T>
      <<<dim3((unsigned)g.H, (unsigned)g.B), 128,
         (size_t)g.S * sizeof(float), stream>>>(
          static_cast<const int32_t*>(lengths),
          static_cast<const float*>(scratch), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q_lat, const void* q_rope, const void* ckv_pool,
             const void* kr_pool, const void* tables, const void* lengths,
             void* out, void* scratch, int B, int H, int R, int ROPE, int BS,
             int max_blocks, int E, int S, float scale, cudaStream_t s) {
  const Geo g = make_geo<T>(B, H, R, ROPE, BS, max_blocks, E, S, scale);
#define MLA_LAUNCH(NTW) \
  return launch<T, NTW>(q_lat, q_rope, ckv_pool, kr_pool, tables, lengths, \
                        out, scratch, g, s)
  // Latent n-tiles of 8 columns over the 8 warps.
  if (R <= 64) MLA_LAUNCH(1);
  if (R <= 128) MLA_LAUNCH(2);
  if (R <= 256) MLA_LAUNCH(4);
  if (R <= 512) MLA_LAUNCH(8);
#undef MLA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output share it).
// R <= 512, ROPE <= 128, BS >= 1. E: table entries per chunk, S: chunks
// per slot (S * E >= max_blocks). scratch: f32 (B, S, H, RS), RS = R + 2
// rounded up to a multiple of 4 -- each chunk's O, m and l -- read only
// for slots with more than one live chunk. Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int paged_mla_decode_attn(
    const void* q_lat, const void* q_rope, const void* ckv_pool,
    const void* kr_pool, const void* tables, const void* lengths, void* out,
    void* scratch, int B, int H, int R, int ROPE, int BS, int max_blocks,
    int E, int S, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (R <= 0 || ROPE < 0 || ROPE > 128 || BS < 1 || E < 1 || S < 1 ||
      (long)S * E < max_blocks || B > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q_lat, q_rope, ckv_pool, kr_pool, tables, lengths,
                           out, scratch, B, H, R, ROPE, BS, max_blocks, E, S,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q_lat, q_rope, ckv_pool, kr_pool, tables,
                                   lengths, out, scratch, B, H, R, ROPE, BS,
                                   max_blocks, E, S, scale, s);
  return (int)cudaErrorInvalidValue;
}
