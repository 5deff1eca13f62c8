// The thread block cluster design of the port's two MLP kernels, the
// gated GLU (sparce_glu_mlp.cu) and the fused relu MLP (sparce_mlp.cu),
// for Hopper (sm_90a). Both compute y = a @ w_out with a per (row tile,
// f-stripe) activation that is known first (the GLU's gate, the relu
// MLP's up-projection) and whose all-dead tiles skip their stripe.
//
//   * One thread block cluster of C <= 8 CTAs per (row group, stripe):
//     at the decode shape 12 stripes x 8 CTAs = 96 CTAs stream the
//     weights; with more row groups C shrinks, so that about 8 CTAs per
//     stripe stream x, unless a CTA's columns of the row group's
//     activation would then overflow shared memory (then C grows, and
//     after it the chunks of rows shrink). Each CTA computes the first
//     product for its CW columns of the stripe over the full K, so
//     every value has one fixed summation order; the CTAs OR
//     their live flags through distributed shared memory (or_flags),
//     and a stripe dead in every row tile of the group exits in every
//     CTA before a w_out (GLU: or w_in) address is formed. A live
//     stripe: each CTA pushes its slice of a into every CTA's shared
//     memory, and after a cluster barrier computes a @ w_out[stripe, its
//     N slice] into the f32 partial of the stripe (down_chunk).
//   * Tensor cores with the product transposed, as in skip_gemm.cuh:
//     weight columns are the MMA's M dimension, x's rows its N dimension
//     (8 per n-tile), so 8 decode rows are not padded to block_m. bf16
//     runs mma.sync.m16n8k16, f32 split-TF32 m16n8k8. A block of the
//     product has 1, 2, 4 or 8 m-tiles (16 columns each); the 8 warps
//     split it by m-tile and take its 64-deep (f32 32-deep) sub-stages in
//     turn, then add their sums in warp order.
//   * Operands stream through a ring of 4 slots of 16-byte cp.async
//     copies, three in flight while one is multiplied. A slot holds as many
//     64-deep (bf16; f32 32-deep) sub-stages as the ring allows, so at
//     decode a K of 576 takes two steps: with one CTA per SM little
//     hides a step's fixed cost (barrier, waits, address arithmetic), so
//     the steps are few, their address arithmetic is set up once per
//     block, and 8 warps share them. Ragged edges and unaligned rows fall
//     back to scalar loads, masked in the kernel.
//   * stripe_reduce_kernel adds the live stripes' partials in ascending
//     stripe order (deterministic: fixed orders throughout, no atomics).
//     Adding them in the kernel's last CTA per row group and column
//     slice, found by an arrival counter, was tried: its serial tail
//     cost more than the second launch, at decode and more at prefill.
// A row group is 64 rows of whole row tiles (block_m <= 64) or one row
// tile (block_m > 64, walked in chunks of at most 64 rows). Rows past M
// and columns past F are activations of 0, which can only vote "dead".
#pragma once

#include <cooperative_groups.h>

#include "skip_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using skip::Cfg;
using sparce::from_f;
using sparce::round_t;
using sparce::to_f;

constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_C = 8;       // CTAs per cluster: the portable limit
constexpr int ROWS = 64;       // rows of a chunk at most (8 n-tiles)
constexpr int MAX_TILES = 64;  // row tiles of a row group at most
constexpr int SLOTS = 4;       // ring slots: one multiplied, 3 in flight
constexpr int RED_SETS = 8;    // warps' partial sums a block adds
constexpr int SMEM_MAX = 232448;
// Shared memory a block aims at (two fit on an SM); the ring takes what
// the rest leaves.
constexpr int SMEM_AIM = 110 * 1024;

// The launch's geometry, a function of the shapes and the dtype only
// (make_geo); every block reads it.
struct Geo {
  int M, K, F, N, bm, bf, nf;
  int C;      // CTAs per cluster: one cluster per (row group, stripe)
  int CW;     // stripe columns per CTA, a multiple of 16
  int TPG;    // row tiles per row group
  int GR;     // rows per row group
  int RB;     // rows per chunk: 8 x NT8
  int NCH;    // chunks of a row group at most
  int NMT;    // 16-column m-tiles of N, split over the cluster
  int AS_LD;  // shared row of a (the stripe's columns, zero-padded)
  int ring;   // elements of the cp.async ring
};

// The widest column block of mtt m-tiles: 8, or mtt rounded up to 1, 2,
// 4 or 8 (a block's columns past its CTA's are zeros, never loaded).
__host__ __device__ inline int widest(int mtt) {
  return mtt > 4 ? 8 : mtt > 2 ? 4 : mtt > 1 ? 2 : 1;
}

// Bytes of shared memory besides the ring: the activation of the CTA's
// columns for the row group, a of the stripe for one chunk, the warps'
// partial sums, the live flags (the CTA's and the cluster's).
template <typename T>
size_t smem_rest(const Geo& g) {
  return sizeof(T) * ((size_t)g.NCH * g.RB * g.CW + (size_t)g.RB * g.AS_LD) +
         4 * (RED_SETS * 16 * (size_t)g.RB + MAX_TILES * (1 + MAX_C));
}

// The geometry with clusters of at most c CTAs and chunks of at most rb
// rows.
template <typename T>
Geo geo_at(int M, int K, int F, int N, int bm, int bf, int c, int rb) {
  Geo g{};
  g.M = M, g.K = K, g.F = F, g.N = N, g.bm = bm, g.bf = bf;
  g.nf = (F + bf - 1) / bf;
  g.TPG = bm >= ROWS ? 1 : ROWS / bm;
  g.GR = g.TPG * bm;
  const int mt_f = (bf + 15) / 16;
  g.C = mt_f < c ? mt_f : c;
  g.CW = (mt_f + g.C - 1) / g.C * 16;
  const int rows = g.GR < M ? g.GR : M;
  g.RB = 8 * skip::nt8_for(rows < rb ? rows : rb);
  g.NCH = (rows + g.RB - 1) / g.RB;
  g.NMT = (N + 15) / 16;
  constexpr int KB = Cfg<T>::KB, EV = 16 / sizeof(T);
  g.AS_LD = (g.C * g.CW + KB - 1) / KB * KB + (sizeof(T) == 2 ? 8 : 4);
  // The ring holds SLOTS sub-stages of the widest job at least (Job::plan
  // deepens the steps when it holds more).
  const int sub_up = KB * (16 * widest(g.CW / 16) + 8) +
                     g.RB * Cfg<T>::X_LD;
  const int sub_down = KB * (16 * widest((g.NMT + g.C - 1) / g.C) + 8);
  const long need = (long)SLOTS * (sub_up > sub_down ? sub_up : sub_down);
  const long fit =
      ((long)SMEM_AIM - (long)smem_rest<T>(g)) / (long)sizeof(T) / EV * EV;
  g.ring = (int)(fit > need ? fit : need);
  return g;
}

// Dynamic shared memory: the ring first, then the rest.
template <typename T>
size_t smem_bytes(const Geo& g) {
  return sizeof(T) * (size_t)g.ring + smem_rest<T>(g);
}

template <typename T>
Geo make_geo(int M, int K, int F, int N, int bm, int bf) {
  // About 8 CTAs per stripe in all: 8 for one row group (decode), fewer
  // per cluster as row groups add up, so that each CTA's x rows are
  // streamed by fewer CTAs.
  const int gr = bm >= ROWS ? bm : ROWS / bm * bm;
  const int groups = (M + gr - 1) / gr;
  int c = MAX_C;
  while (c > 1 && c * groups > MAX_C) c /= 2;
  int rb = ROWS;
  Geo g = geo_at<T>(M, K, F, N, bm, bf, c, rb);
  // A tall row tile keeps the activation of a wide stripe in shared
  // memory (256 x 512 tiles over 16 row groups: 470 KB in one CTA);
  // there the cluster widens, each CTA keeping fewer of its columns,
  // and then (f32) the chunks shorten, until it fits. Geometries that
  // fit as they are do not change.
  while (smem_bytes<T>(g) > (size_t)SMEM_MAX && (c < MAX_C || rb > 8)) {
    if (c < MAX_C)
      c *= 2;
    else
      rb /= 2;
    g = geo_at<T>(M, K, F, N, bm, bf, c, rb);
  }
  return g;
}

// One product of a CTA: columns [c0, c0 + cw) of W in blocks of 128
// columns, the last one 16, 32, 64 or 128 wide, over the depth in
// sub-stages of KB rows, for each chunk of streamed rows of x (or for the
// rows of a B resident in shared memory). plan() sizes its steps: G
// sub-stages each, as many as SLOTS slots of the ring hold, so few rows
// (decode) take few, deep steps.
template <typename T>
struct Job {
  const T* w;      // W row-major: depth d is row wk0 + d, ldw columns
  int ldw, wk0;
  int d_valid;     // depth that exists; zeros past it
  int c0, cw;      // this CTA's columns, cw a multiple of 16
  int c_lim;       // zeros at columns >= c_lim (<= c0 + cw)
  int nch;         // chunks
  const T* x;      // streamed B: x[(row0 + r) * ldx + d]; null: resident
  int ldx, row0, rows;
  const T* bs;     // resident B: bs[r * ldb + d]
  int ldb;
  int vec_w, vec_x;  // 16-byte copies are aligned
  // plan():
  int ncb;         // column blocks per chunk
  int wld;         // shared row of w: the widest block + 8
  int sub;         // elements of a sub-stage: w (KB x wld), x (RB x X_LD)
  int nsub, G, ns;  // sub-stages per block, per step; steps per block

  __device__ void plan(int ring, int RB) {
    constexpr int KB = Cfg<T>::KB;
    const int mtt = cw / 16;
    ncb = mtt / 8 + (mtt % 8 != 0);
    wld = 16 * widest(mtt) + 8;
    sub = KB * wld + (x != nullptr ? RB * Cfg<T>::X_LD : 0);
    nsub = (d_valid + KB - 1) / KB;
    const int gmax = max(1, ring / (SLOTS * sub));
    ns = (nsub + gmax - 1) / gmax;
    G = ns > 0 ? (nsub + ns - 1) / ns : 0;
  }
};

struct Blk {
  int ch;          // chunk
  int col, mt;     // columns [col, col + 16 * mt), mt 1, 2, 4 or 8
  int row0, rlim;  // rows of the chunk
};

// Block b: chunk b / ncb; its columns in blocks of 8 m-tiles, the last
// one widest(the rest) wide.
template <typename T>
__device__ __forceinline__ Blk block_of(const Job<T>& j, int b, int RB) {
  Blk k;
  k.ch = b / j.ncb;
  const int cb = b - k.ch * j.ncb, mtt = j.cw / 16;
  k.mt = cb < mtt / 8 ? 8 : widest(mtt % 8);
  k.col = j.c0 + 128 * cb;
  k.row0 = j.row0 + k.ch * RB;
  k.rlim = min(RB, j.rows - k.ch * RB);
  return k;
}

// Step s of block k into a ring slot: the w vectors of its sub-stages
// (KB rows of the block's 16 mt columns each) and, streamed, the x
// vectors (RB rows of KB each), spread over every thread of the block;
// zeros past the depth, the columns and the rows. The counts per
// sub-stage are powers of two, so a vector's place is shifts and masks.
template <typename T, int NT8>
__device__ __forceinline__ void load_step(const Job<T>& j, const Blk& k,
                                          int s, T* slot) {
  using C = Cfg<T>;
  constexpr int V = C::V;
  constexpr int XSH = NT8 == 1 ? 6 : NT8 == 2 ? 7 : NT8 == 4 ? 8 : 9;
  const T zero = from_f<T>(0.f);
  const int u0 = s * j.G, ng = min(j.G, j.nsub - u0);
  // 16 mt / V vectors per row of w, KB rows: 128 mt vectors per sub-stage.
  const int lmt = k.mt == 1 ? 0 : k.mt == 2 ? 1 : k.mt == 4 ? 2 : 3;
  const int vsh = lmt + (V == 8 ? 1 : 2), wsh = lmt + 7;
  for (int e = threadIdx.x; e < (ng << wsh); e += THREADS) {
    const int g = e >> wsh, v = e & ((1 << wsh) - 1);
    const int kr = v >> vsh, c = (v & ((1 << vsh) - 1)) * V;
    T* dst = slot + g * j.sub + kr * j.wld + c;
    const int d = (u0 + g) * C::KB + kr, col = k.col + c;
    const int n_in = min(V, j.c_lim - col);
    if (d >= j.d_valid || n_in <= 0) {
      skip::zero16(dst);
      continue;
    }
    const T* src = j.w + (size_t)(j.wk0 + d) * j.ldw + col;
    if (j.vec_w && n_in == V) {
      skip::cp_async16(dst, src);
    } else {
      for (int i = 0; i < V; ++i) dst[i] = i < n_in ? src[i] : zero;
    }
  }
  if (j.x == nullptr) return;
  // KB / V = 8 vectors per row of x, RB rows: 64 NT8 per sub-stage.
  for (int e = threadIdx.x; e < (ng << XSH); e += THREADS) {
    const int g = e >> XSH, v = e & ((1 << XSH) - 1);
    const int r = v >> 3, kk = (v & 7) * V;
    T* dst = slot + g * j.sub + C::KB * j.wld + r * C::X_LD + kk;
    const int d = (u0 + g) * C::KB + kk;
    if (r >= k.rlim || d >= j.d_valid) {
      skip::zero16(dst);
      continue;
    }
    const T* src = j.x + (size_t)(k.row0 + r) * j.ldx + d;
    if (j.vec_x && d + V <= j.d_valid) {
      skip::cp_async16(dst, src);
    } else {
      for (int i = 0; i < V; ++i) dst[i] = d + i < j.d_valid ? src[i] : zero;
    }
  }
}

// A warp's part in a block of mt m-tiles (1, 2, 4 or 8): m-tile wm and
// k-part kp of KP = 8 / mt -- the KP warps that share an m-tile take its
// sub-stages in turn (sub-stage u goes to k-part u % KP).
struct Role {
  int wm, kp, KP;
  __device__ explicit Role(int mt) {
    const int w = threadIdx.x >> 5;
    KP = 8 / mt;
    wm = w & (mt - 1);
    kp = w / mt;
  }
};

// The end of block k: each warp adds its accumulator sets into red_s,
// then every thread takes elements of the block, adds the k-parts' sums
// in warp order and hands the element to epi(k, row, column, value) --
// so all 8 warps share the epilogue. Every thread calls it.
template <typename T, int NT8, typename Epi>
__device__ __forceinline__ void finish(float (&acc)[Cfg<T>::NACC][NT8][4],
                                       const Blk& k, const Role& ro,
                                       float* red_s, Epi& epi) {
  constexpr int SET = NT8 * 128;  // floats of one warp's sums
  const int lane = threadIdx.x & 31;
  float* own = red_s + (ro.kp * k.mt + ro.wm) * SET;
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if constexpr (Cfg<T>::NACC == 3)
        own[(j * 4 + h) * 32 + lane] =
            acc[0][j][h] + (acc[1][j][h] + acc[2][j][h]);
      else
        own[(j * 4 + h) * 32 + lane] = acc[0][j][h] + acc[1][j][h];
#pragma unroll
      for (int a = 0; a < Cfg<T>::NACC; ++a) acc[a][j][h] = 0.f;
    }
  __syncthreads();
  // Element (m-tile wm, n-tile j, slot h, lane l) of a warp's sums is
  // column 16 wm + l / 4 + 8 (h / 2), row 8 j + 2 (l % 4) + h % 2.
  for (int e = threadIdx.x; e < k.mt * SET; e += THREADS) {
    const int wm = e / SET, rem = e - wm * SET, jh = rem >> 5;
    const int l = rem & 31;
    float v = red_s[wm * SET + rem];
    for (int q = 1; q < ro.KP; ++q) v += red_s[(q * k.mt + wm) * SET + rem];
    epi(k, 8 * (jh >> 2) + 2 * (l & 3) + (jh & 1),
        k.col + 16 * wm + (l >> 2) + ((jh & 3) >> 1) * 8, v);
  }
}

// Run job j through the cp.async ring: every (block, step) in order, the
// next SLOTS - 1 steps in flight while one is multiplied; after a
// block's last step, finish() hands its sums to epi. Every thread calls
// it; it ends with the ring idle and the block synchronised.
template <typename T, int NT8, typename Epi>
__device__ __forceinline__ void stream(Job<T> j, const Geo& geo, T* ring,
                                       float* red_s, Epi epi) {
  using C = Cfg<T>;
  constexpr int RB = 8 * NT8;
  j.plan(geo.ring, RB);
  const int nb = j.nch * j.ncb, slot = j.G * j.sub;
  float acc[C::NACC][NT8][4];
#pragma unroll
  for (int a = 0; a < C::NACC; ++a)
#pragma unroll
    for (int jj = 0; jj < NT8; ++jj)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[a][jj][h] = 0.f;
  // The issuing side runs SLOTS - 1 steps ahead of the multiplying side.
  int ib = 0, is = 0, ring_i = 0;
  Blk ik{};
  if (nb > 0) ik = block_of(j, 0, RB);
  auto issue = [&]() {
    if (ib < nb) {
      load_step<T, NT8>(j, ik, is, ring + ring_i * slot);
      ring_i = ring_i + 1 == SLOTS ? 0 : ring_i + 1;
      if (++is == j.ns) {
        is = 0;
        if (++ib < nb) ik = block_of(j, ib, RB);
      }
    }
    skip::cp_async_commit();
  };
#pragma unroll 1
  for (int p = 0; p < SLOTS - 1; ++p) issue();
  int ci = 0;  // the slot being multiplied
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const Blk k = block_of(j, b, RB);
    const Role ro(k.mt);
#pragma unroll 1
    for (int s = 0; s < j.ns; ++s) {
      skip::cp_async_wait<SLOTS - 2>();
      __syncthreads();  // this step landed; the last step's slot is free
      issue();
      const T* st = ring + ci * slot;
      ci = ci + 1 == SLOTS ? 0 : ci + 1;
      for (int g = 0; g < j.G; ++g) {
        const int u = s * j.G + g;
        if (u >= j.nsub) break;
        if ((u & (ro.KP - 1)) != ro.kp) continue;
        const T* ws = st + g * j.sub;
        if (j.x != nullptr)
          skip::mma_stage<NT8>(acc, ws, j.wld, ro.wm * 16,
                               ws + C::KB * j.wld, C::X_LD);
        else
          skip::mma_stage<NT8>(acc, ws, j.wld, ro.wm * 16, j.bs + u * C::KB,
                               j.ldb);
      }
    }
    finish<T, NT8>(acc, k, ro, red_s, epi);
  }
  skip::cp_async_wait<0>();
  __syncthreads();
}

// A CTA of the cluster of (row group blockIdx.y, stripe blockIdx.x / C):
// its place, and its carve of the dynamic shared memory.
template <typename T>
struct Cta {
  int rank, f, grp;
  int f0, f_lim;    // the stripe's columns
  int row0, grows;  // the row group's rows
  int ntiles, nch;  // its row tiles; its chunks of RB rows
  int c0, c_end;    // this CTA's columns of the stripe
  T* ring;
  T* ga_s;       // the activation of this CTA's columns, whole row group
  T* a_s;        // a of the whole stripe for one chunk
  float* red_s;  // the warps' partial sums
  int* live_s;   // row tiles' live flags: the CTA's, then the cluster's
  int* all_s;    // every CTA's flags
};

// A CTA's entry: arrive at the cluster barrier (or_flags waits on it
// before the first write into another CTA's shared memory, so every CTA
// has started), place it, carve its shared memory, clear its flags and
// its a (a past the stripe's columns stays zero: nothing pushes it).
template <typename T, int NT8>
__device__ __forceinline__ Cta<T> enter(const Geo& geo, int rank) {
  constexpr int RB = 8 * NT8;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  Cta<T> c;
  c.rank = rank;
  c.f = blockIdx.x / geo.C, c.grp = blockIdx.y;
  c.f0 = c.f * geo.bf, c.f_lim = min(geo.F, c.f0 + geo.bf);
  c.row0 = c.grp * geo.GR, c.grows = min(geo.GR, geo.M - c.row0);
  c.ntiles = (c.grows + geo.bm - 1) / geo.bm;
  c.nch = (c.grows + RB - 1) / RB;
  c.c0 = c.f0 + rank * geo.CW;
  c.c_end = min(c.f_lim, c.c0 + geo.CW);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  c.ring = reinterpret_cast<T*>(smem_raw);
  c.ga_s = c.ring + geo.ring;
  c.a_s = c.ga_s + geo.NCH * RB * geo.CW;
  c.red_s = reinterpret_cast<float*>(c.a_s + RB * geo.AS_LD);
  c.live_s = reinterpret_cast<int*>(c.red_s + RED_SETS * 16 * RB);
  c.all_s = c.live_s + MAX_TILES;
  for (int t = threadIdx.x; t < MAX_TILES; t += THREADS) c.live_s[t] = 0;
  uint4* p = reinterpret_cast<uint4*>(c.a_s);
  const int nvec = RB * geo.AS_LD * (int)sizeof(T) / 16;
  for (int e = threadIdx.x; e < nvec; e += THREADS)
    p[e] = make_uint4(0u, 0u, 0u, 0u);
  return c;
}

// SpRF bits at the first product's writeback: the OR of the cluster's
// flags per row tile, pushed into every CTA's all_s; rank 0 writes the
// bits. Returns whether some row tile of the group is live in the
// stripe: the same answer in every CTA, so a dead stripe exits in all of
// them before a w_out address is formed.
template <typename T>
__device__ __forceinline__ bool or_flags(cg::cluster_group& cluster,
                                         const Geo& geo, const Cta<T>& c,
                                         int32_t* __restrict__ bits) {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < geo.C * MAX_TILES; e += THREADS) {
    const int dst = e / MAX_TILES, t = e - dst * MAX_TILES;
    cluster.map_shared_rank(c.all_s, dst)[c.rank * MAX_TILES + t] =
        c.live_s[t];
  }
  cluster.sync();
  for (int t = threadIdx.x; t < c.ntiles; t += THREADS) {
    int live = 0;
    for (int q = 0; q < geo.C; ++q) live |= c.all_s[q * MAX_TILES + t];
    c.live_s[t] = live;
    if (c.rank == 0)
      bits[(size_t)(c.grp * geo.TPG + t) * geo.nf + c.f] = live ? 0 : 1;
  }
  __syncthreads();
  int any = 0;
  for (int t = 0; t < c.ntiles; ++t) any |= c.live_s[t];
  return any != 0;
}

// This CTA's columns of N in the down-projection, [n0, n0 + nw) (whole
// m-tiles, split evenly over the cluster), zeros from n_end. Computed
// once per CTA, before the chunk loop (inside it, the GLU kernel's
// 8-row instantiation spilled registers).
struct NSlice {
  int n0, nw, n_end;
};
template <typename T>
__device__ __forceinline__ NSlice n_slice(const Geo& geo, const Cta<T>& c) {
  const int mt_lo = c.rank * geo.NMT / geo.C;
  const int mt_hi = (c.rank + 1) * geo.NMT / geo.C;
  const int n0 = 16 * mt_lo, nw = 16 * (mt_hi - mt_lo);
  return NSlice{n0, nw, min(geo.N, n0 + nw)};
}

// Chunk ch of a live stripe, once every CTA has pushed its slice of a:
// a @ w_out[stripe, the CTA's columns ns of N] into partial[f].
template <typename T, int NT8>
__device__ __forceinline__ void down_chunk(cg::cluster_group& cluster,
                                           const Geo& geo, const Cta<T>& c,
                                           const NSlice& ns,
                                           const T* __restrict__ w_out,
                                           float* __restrict__ partial,
                                           int ch, int vec_n) {
  constexpr int RB = 8 * NT8;
  const int r0 = c.row0 + ch * RB, rlim = min(RB, c.grows - ch * RB);
  const int n0 = ns.n0, nw = ns.nw, n_end = ns.n_end;
  cluster.sync();  // a of the whole stripe is in every CTA
  const Job<T> down{w_out, geo.N, c.f0, c.f_lim - c.f0, n0, nw, n_end, 1,
                    nullptr, 0, r0, rlim, c.a_s, geo.AS_LD, vec_n, 0};
  stream<T, NT8>(down, geo, c.ring, c.red_s,
                 [&](const Blk&, int r, int col, float v) {
    if (r < rlim && col < n_end)
      partial[((size_t)c.f * geo.M + r0 + r) * geo.N + col] = v;
  });
  if (ch + 1 < c.nch) cluster.sync();  // every CTA is done with this a
}

// y[m, n] = 0 + the partials of the stripes live in m's row tile, in
// ascending stripe order; one thread per output element. Reads bits and
// scratch only, never a weight. A dead stripe's scratch (never written)
// is read beside its bit, so the loads do not wait on the bits, and
// selected away.
template <typename T>
__global__ void stripe_reduce_kernel(const float* __restrict__ partial,
                                     const int32_t* __restrict__ bits,
                                     T* __restrict__ y, int M, int N, int bm,
                                     int nf) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * N) return;
  const int32_t* b = bits + (size_t)((int)(idx / N) / bm) * nf;
  float s = 0.f;
#pragma unroll 4
  for (int f = 0; f < nf; ++f) {
    const float p = partial[(size_t)f * M * N + idx];
    if (b[f] == 0) s += p;
  }
  y[idx] = from_f<T>(s);
}

// Launch `kernel` over (stripes x C, row groups) in clusters of g.C CTAs,
// then stripe_reduce_kernel. `allowed` is the kernel's shared-memory
// limit so far (sparce::allow_smem); `args` are the kernel's arguments.
template <typename T, typename... P, typename... A>
int launch_clusters(void (*kernel)(P...), const Geo& g, size_t& allowed,
                    T* y, const int32_t* bits, const float* partial,
                    cudaStream_t stream, A... args) {
  const size_t smem = smem_bytes<T>(g);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = sparce::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const unsigned groups = (unsigned)((g.M + g.GR - 1) / g.GR);
  if (groups > 65535u) return (int)cudaErrorInvalidValue;  // gridDim.y
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.nf * g.C), groups, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)g.M * g.N;
  const int threads = 256;
  stripe_reduce_kernel<T>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
          partial, bits, y, g.M, g.N, g.bm, g.nf);
  return (int)cudaGetLastError();
}

// 16-byte copies of a row-major operand are aligned: its base is, and
// its rows are whole vectors (cols % V == 0).
template <typename T>
inline bool vec_rows(const void* p, int cols) {
  return (uintptr_t)p % 16 == 0 && cols % Cfg<T>::V == 0;
}

// The launch's grid for these shapes: out = {CTAs along stripes (nf x
// cluster), row groups, CTAs per cluster, rows per chunk, dynamic shared
// memory bytes}. A function of the shapes and dtype only.
inline int grid_of(int M, int K, int F, int N, int bm, int bf, int dtype,
                   int* out) {
  if (M <= 0 || F <= 0 || N <= 0 || bm < 1 || bf < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Geo g = dtype == 0 ? make_geo<float>(M, K, F, N, bm, bf)
                           : make_geo<__nv_bfloat16>(M, K, F, N, bm, bf);
  out[0] = g.nf * g.C;
  out[1] = (M + g.GR - 1) / g.GR;
  out[2] = g.C;
  out[3] = g.RB;
  out[4] = (int)(dtype == 0 ? smem_bytes<float>(g)
                            : smem_bytes<__nv_bfloat16>(g));
  return 0;
}

}  // namespace
