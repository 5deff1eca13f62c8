// Gated-GLU SparCE MLP with two-sided stripe skipping, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sparce_glu_mlp.py:
// sparce_glu_mlp_fused (Pallas). Same contract, at any M and F: x (M,
// K), w_gate and w_in (K, F), w_out (F, N); returns y (M, N) in x's dtype
// and int32 bits (ceil(M/bm), ceil(F/bf)). Per (row tile i, f-stripe f)
// the gate runs first; g and act(g) are rounded through the input dtype;
// bit = all(|act(g)| <= tau) ("<=" so tau = 0 is the exact all-zero
// test). Rows past M and columns past F count as act(0) = 0, so they can
// only vote "dead": the bits are the zero-padded reference's. A live
// tile computes h = x @ w_in[:, stripe] (rounded through the input
// dtype), a = round(act(g) * h) and a @ w_out[stripe, :]. A dead stripe
// loads neither its w_in columns nor its w_out rows; nothing is padded.
//
// What bounds it on this card: bytes at decode (8 rows: the 5.3 MB of
// bf16 weights stream at ~1 flop per byte per row), the products at
// prefill. The design:
//   * One thread block cluster of C <= 8 CTAs per (row group, stripe):
//     at the decode shape 12 stripes x 8 CTAs = 96 CTAs stream the
//     weights; with more row groups C shrinks, so that about 8 CTAs per
//     stripe stream x. Each CTA computes the gate for its CW columns of
//     the stripe over the full K, so every g
//     has one fixed summation order; the CTAs OR their live flags through
//     distributed shared memory, and a stripe dead in every row tile of
//     the group exits in every CTA before a w_in or w_out address is
//     formed. A live stripe: each CTA computes its columns of h and a,
//     pushes its slice of a into every CTA's shared memory, and after a
//     cluster barrier computes a @ w_out[stripe, its N slice] into the
//     f32 partial of the stripe.
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
//     decode the gate's K = 576 takes two steps: with one CTA per SM
//     little hides a step's fixed cost (barrier, waits, address
//     arithmetic), so the steps are few, their address arithmetic is set
//     up once per block, and 8 warps share them. Ragged edges and
//     unaligned rows fall back to scalar loads, masked in the kernel.
//   * stripe_reduce_kernel adds the live stripes' partials in ascending
//     stripe order (deterministic: fixed orders throughout, no atomics).
//     Adding them in the kernel's last CTA per row group and column
//     slice, found by an arrival counter, was tried: its serial tail
//     cost more than the second launch, at decode and more at prefill.
// A row group is 64 rows of whole row tiles (block_m <= 64) or one row
// tile (block_m > 64, walked in chunks of 64 rows).
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

// Bytes of shared memory besides the ring: act(g) of the CTA's columns
// for the row group, a of the stripe for one chunk, the warps' partial
// sums, the live flags (the CTA's and the cluster's).
template <typename T>
size_t smem_rest(const Geo& g) {
  return sizeof(T) * ((size_t)g.NCH * g.RB * g.CW + (size_t)g.RB * g.AS_LD) +
         4 * (RED_SETS * 16 * (size_t)g.RB + MAX_TILES * (1 + MAX_C));
}

template <typename T>
Geo make_geo(int M, int K, int F, int N, int bm, int bf) {
  Geo g{};
  g.M = M, g.K = K, g.F = F, g.N = N, g.bm = bm, g.bf = bf;
  g.nf = (F + bf - 1) / bf;
  g.TPG = bm >= ROWS ? 1 : ROWS / bm;
  g.GR = g.TPG * bm;
  // About 8 CTAs per stripe in all: 8 for one row group (decode), fewer
  // per cluster as row groups add up, so that each CTA's x rows are
  // streamed by fewer CTAs.
  const int groups = (M + g.GR - 1) / g.GR, mt_f = (bf + 15) / 16;
  int c = MAX_C;
  while (c > 1 && c * groups > MAX_C) c /= 2;
  g.C = mt_f < c ? mt_f : c;
  g.CW = (mt_f + g.C - 1) / g.C * 16;
  const int rows = g.GR < M ? g.GR : M;
  g.RB = 8 * skip::nt8_for(rows);
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

// One CTA of the cluster of (row group blockIdx.y, stripe blockIdx.x / C).
template <typename T, int NT8>
__global__ void __launch_bounds__(THREADS) glu_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ w_gate,
    const T* __restrict__ w_in, const T* __restrict__ w_out,
    int32_t* __restrict__ bits, float* __restrict__ partial, const Geo geo,
    int act, float tau, int vec_x, int vec_f, int vec_n) {
  constexpr int RB = 8 * NT8;
  cg::cluster_group cluster = cg::this_cluster();
  // Every CTA of the cluster has started before one writes into another's
  // shared memory: the wait is before the first push.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.x / geo.C, grp = blockIdx.y;
  const int f0 = f * geo.bf, f_lim = min(geo.F, f0 + geo.bf);
  const int row0 = grp * geo.GR, grows = min(geo.GR, geo.M - row0);
  const int ntiles = (grows + geo.bm - 1) / geo.bm;
  const int nch = (grows + RB - 1) / RB;
  const int c0 = f0 + rank * geo.CW;  // this CTA's columns of the stripe

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* ga_s = ring + geo.ring;
  T* a_s = ga_s + geo.NCH * RB * geo.CW;
  float* red_s = reinterpret_cast<float*>(a_s + RB * geo.AS_LD);
  int* live_s = reinterpret_cast<int*>(red_s + RED_SETS * 16 * RB);
  int* all_s = live_s + MAX_TILES;
  for (int t = threadIdx.x; t < MAX_TILES; t += THREADS) live_s[t] = 0;
  {  // a past the stripe's columns stays zero: nothing pushes it
    uint4* p = reinterpret_cast<uint4*>(a_s);
    const int nvec = RB * geo.AS_LD * (int)sizeof(T) / 16;
    for (int e = threadIdx.x; e < nvec; e += THREADS)
      p[e] = make_uint4(0u, 0u, 0u, 0u);
  }

  // -- 1. the gate first, over the full K: the predictor runs before the
  // work it may cancel. act(g) of this CTA's columns is kept; a row tile
  // with an element above tau is flagged live.
  const int c_end = min(f_lim, c0 + geo.CW);  // this CTA's columns
  const Job<T> gate{w_gate, geo.F, 0, geo.K, c0, geo.CW, c_end, nch, x,
                    geo.K, row0, grows, nullptr, 0, vec_f, vec_x};
  stream<T, NT8>(gate, geo, ring, red_s,
                 [&](const Blk& k, int r, int col, float v) {
    if (col - c0 >= geo.CW) return;  // another CTA's column
    const int gr = k.ch * RB + r;
    float ga = 0.f;
    if (r < k.rlim && col < f_lim) {
      ga = round_t<T>(gate_act(round_t<T>(v), act));
      if (!(fabsf(ga) <= tau)) live_s[gr / geo.bm] = 1;
    }
    ga_s[gr * geo.CW + col - c0] = from_f<T>(ga);
  });

  // -- 2. SpRF bits at the gate's writeback: the OR of the cluster's flags
  // per row tile, pushed into every CTA's all_s.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < geo.C * MAX_TILES; e += THREADS) {
    const int dst = e / MAX_TILES, t = e - dst * MAX_TILES;
    cluster.map_shared_rank(all_s, dst)[rank * MAX_TILES + t] = live_s[t];
  }
  cluster.sync();
  for (int t = threadIdx.x; t < ntiles; t += THREADS) {
    int live = 0;
    for (int c = 0; c < geo.C; ++c) live |= all_s[c * MAX_TILES + t];
    live_s[t] = live;
    if (rank == 0)
      bits[(size_t)(grp * geo.TPG + t) * geo.nf + f] = live ? 0 : 1;
  }
  __syncthreads();
  int any = 0;
  for (int t = 0; t < ntiles; ++t) any |= live_s[t];
  if (!any) return;  // dead: no w_in or w_out address is ever formed

  // -- 3. per chunk of rows: h and a = round(act(g) * round(h)) for this
  // CTA's columns (zero in dead row tiles), a pushed into every CTA, then
  // a @ w_out[stripe, this CTA's columns of N] into partial[f].
  const int mt_lo = rank * geo.NMT / geo.C;
  const int mt_hi = (rank + 1) * geo.NMT / geo.C;
  const int n0 = 16 * mt_lo, nw = 16 * (mt_hi - mt_lo);
  const int n_end = min(geo.N, n0 + nw);
  const int sw = f_lim - f0;  // the stripe's columns
  constexpr int EV = 16 / sizeof(T);
  const int vpr = geo.CW / EV;  // 16-byte vectors of a row of the slice
  for (int ch = 0; ch < nch; ++ch) {
    const int r0 = row0 + ch * RB, rlim = min(RB, grows - ch * RB);
    const Job<T> up{w_in, geo.F, 0, geo.K, c0, geo.CW, c_end, 1, x, geo.K,
                    r0, rlim, nullptr, 0, vec_f, vec_x};
    stream<T, NT8>(up, geo, ring, red_s,
                   [&](const Blk&, int r, int col, float v) {
      if (col - c0 >= geo.CW) return;  // another CTA's column
      const int gr = ch * RB + r;
      float a = 0.f;
      if (r < rlim && col < f_lim && live_s[gr / geo.bm])
        a = round_t<T>(to_f(ga_s[gr * geo.CW + col - c0]) * round_t<T>(v));
      a_s[r * geo.AS_LD + col - f0] = from_f<T>(a);
    });
    for (int e = threadIdx.x; e < (geo.C - 1) * RB * vpr; e += THREADS) {
      const int q = e / (RB * vpr), rem = e - q * RB * vpr;
      const int r = rem / vpr, vv = rem - r * vpr;
      const size_t off = (size_t)r * geo.AS_LD + rank * geo.CW + vv * EV;
      *reinterpret_cast<uint4*>(
          cluster.map_shared_rank(a_s, q < rank ? q : q + 1) + off) =
          *reinterpret_cast<const uint4*>(a_s + off);
    }
    cluster.sync();  // a of the whole stripe is in every CTA
    const Job<T> down{w_out, geo.N, f0, sw, n0, nw, n_end, 1, nullptr, 0,
                      r0, rlim, a_s, geo.AS_LD, vec_n, 0};
    stream<T, NT8>(down, geo, ring, red_s,
                   [&](const Blk&, int r, int col, float v) {
      if (r < rlim && col < n_end)
        partial[((size_t)f * geo.M + r0 + r) * geo.N + col] = v;
    });
    if (ch + 1 < nch) cluster.sync();  // every CTA is done with this a
  }
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

template <typename T, int NT8>
int launch_nt8(const Geo& g, const T* x, const T* wg, const T* wi,
               const T* wo, T* y, int32_t* bits, float* partial, int act,
               float tau, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(g);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  cudaError_t err =
      sparce::allow_smem(glu_cluster_kernel<T, NT8>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const unsigned groups = (unsigned)((g.M + g.GR - 1) / g.GR);
  if (groups > 65535u) return (int)cudaErrorInvalidValue;  // gridDim.y
  constexpr int V = Cfg<T>::V;
  const auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec_x = aligned(x) && g.K % V == 0;
  const int vec_f = aligned(wg) && aligned(wi) && g.F % V == 0 &&
                    g.bf % V == 0;
  const int vec_n = aligned(wo) && g.N % V == 0;
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
  err = cudaLaunchKernelEx(&cfg, glu_cluster_kernel<T, NT8>, x, wg, wi, wo,
                           bits, partial, g, act, tau, vec_x, vec_f, vec_n);
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

template <typename T>
int launch(const void* x, const void* w_gate, const void* w_in,
           const void* w_out, void* y, void* bits, void* partial, int M,
           int K, int F, int N, int bm, int bf, int act, float tau,
           cudaStream_t stream) {
  if (bm < 1 || bf < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo<T>(M, K, F, N, bm, bf);
  const T* xt = static_cast<const T*>(x);
  const T* wg = static_cast<const T*>(w_gate);
  const T* wi = static_cast<const T*>(w_in);
  const T* wo = static_cast<const T*>(w_out);
  T* yt = static_cast<T*>(y);
  int32_t* bt = static_cast<int32_t*>(bits);
  float* pt = static_cast<float*>(partial);
  switch (g.RB / 8) {
    case 1:
      return launch_nt8<T, 1>(g, xt, wg, wi, wo, yt, bt, pt, act, tau,
                              stream);
    case 2:
      return launch_nt8<T, 2>(g, xt, wg, wi, wo, yt, bt, pt, act, tau,
                              stream);
    case 4:
      return launch_nt8<T, 4>(g, xt, wg, wi, wo, yt, bt, pt, act, tau,
                              stream);
    default:
      return launch_nt8<T, 8>(g, xt, wg, wi, wo, yt, bt, pt, act, tau,
                              stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y share it).
// act: 0 silu, 1 gelu (tanh), 2 relu, 3 relu2. bits: int32
// (ceil(M/bm), ceil(F/bf)). partial: f32 scratch of ceil(F/bf) x M x N
// floats. Returns cudaGetLastError() after the launches (0 = success;
// cudaErrorInvalidValue when the tile needs more shared memory than a
// block has).
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

// The launch's grid for these shapes: out = {CTAs along stripes (nf x
// cluster), row groups, CTAs per cluster, rows per chunk, dynamic shared
// memory bytes}. A function of the shapes and dtype only.
extern "C" int sparce_glu_mlp_grid(int M, int K, int F, int N, int bm,
                                   int bf, int dtype, int* out) {
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
