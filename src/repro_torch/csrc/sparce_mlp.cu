// Fused SparCE MLP for relu-family activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sparce_mlp.py: sparce_mlp_fused
// (Pallas). Same contract, at any M and F: x (M, K), w_in (K, F), w_out
// (F, N); returns y (M, N) in x's dtype and int32 bits (ceil(M/bm),
// ceil(F/bf)). Per (row tile i, f-stripe f): h = x @ w_in[:, f] in f32,
// a = relu(h) (relu2: a * a on the f32 value), then a rounded through
// the input dtype (as the unfused pipeline's writeback would), and the
// SpRF bit at that writeback: bit = 1 iff every a == 0 (NaN is live).
// Rows past M and columns past F count as a = 0, so they can only vote
// "dead": the bits are the zero-padded reference's. A live tile adds
// a @ w_out[f, :]; a stripe dead in a row tile adds nothing to its rows,
// and a stripe dead in every row tile of a row group never has a w_out
// address formed. The w_in stripe is always read: it produces the bit.
//
// What bounds it on this card: bytes at decode (8 rows: w_in streams
// 1.8 MB in bf16 and the live w_out stripes follow, at ~1 flop per
// weight byte per row), the products at prefill. The design is
// cluster_mlp.cuh's -- the gated GLU's without its up-projection: the
// cluster's CTAs split the stripe's columns of h = x @ w_in over the
// full K, keep a = act(h) for the row group, OR the flags, and per
// chunk of rows push their slice of a (zero in dead row tiles) into
// every CTA before the down-projection. stripe_reduce_kernel then adds,
// per row, only the stripes live in that row's tile: at block_m = 1 a
// stripe live for one row and dead for another gives the dead row a
// product of zeros with w_out that is never added.
//
// At training row counts (bf16, 64-row tiles, 128-wide stripes, at least
// 1024 rows; tall_mlp::ok, the wrapper's tall_path) mlp_tall_kernel below
// runs instead: no cluster, no per-stripe partials and no
// stripe_reduce_kernel launch. Decode, the 256-row prefill and f32 keep
// the cluster design.
#include "cluster_mlp.cuh"
#include "tall_gemm.cuh"

namespace {

// One CTA of the cluster of (row group blockIdx.y, stripe blockIdx.x / C).
template <typename T, int NT8>
__global__ void __launch_bounds__(THREADS) mlp_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ w_in,
    const T* __restrict__ w_out, int32_t* __restrict__ bits,
    float* __restrict__ partial, const Geo geo, int relu2, int vec_x,
    int vec_f, int vec_n) {
  constexpr int RB = 8 * NT8;
  cg::cluster_group cluster = cg::this_cluster();
  const Cta<T> c = enter<T, NT8>(geo, (int)cluster.block_rank());

  // -- 1. the up-projection of this CTA's columns over the full K; the
  // activation on the f32 value, then the writeback rounding; a row tile
  // with a nonzero (or NaN) a is flagged live.
  const Job<T> up{w_in, geo.F, 0, geo.K, c.c0, geo.CW, c.c_end, c.nch, x,
                  geo.K, c.row0, c.grows, nullptr, 0, vec_f, vec_x};
  stream<T, NT8>(up, geo, c.ring, c.red_s,
                 [&](const Blk& k, int r, int col, float v) {
    if (col - c.c0 >= geo.CW) return;  // another CTA's column
    const int gr = k.ch * RB + r;
    float a = 0.f;
    if (r < k.rlim && col < c.f_lim) {
      a = v < 0.f ? 0.f : v;  // relu; NaN stays NaN
      if (relu2) a = a * a;
      a = round_t<T>(a);
      if (a != 0.f) c.live_s[gr / geo.bm] = 1;
    }
    c.ga_s[gr * geo.CW + col - c.c0] = from_f<T>(a);
  });

  // -- 2. SpRF bits at the activation's writeback; a stripe dead in every
  // row tile exits: no w_out address is ever formed.
  if (!or_flags(cluster, geo, c, bits)) return;

  // -- 3. per chunk of rows: this CTA's slice of a (zero in dead row
  // tiles) into every CTA, then a @ w_out[stripe, this CTA's columns of
  // N] into partial[f].
  constexpr int EV = 16 / sizeof(T);
  const int vpr = geo.CW / EV;  // 16-byte vectors of a row of the slice
  const NSlice ns = n_slice(geo, c);
  for (int ch = 0; ch < c.nch; ++ch) {
    for (int e = threadIdx.x; e < geo.C * RB * vpr; e += THREADS) {
      const int q = e / (RB * vpr), rem = e - q * RB * vpr;
      const int r = rem / vpr, vv = rem - r * vpr;
      const int gr = ch * RB + r;
      const uint4 v =
          c.live_s[gr / geo.bm]
              ? *reinterpret_cast<const uint4*>(c.ga_s + gr * geo.CW +
                                                vv * EV)
              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(c.a_s, q) +
                                (size_t)r * geo.AS_LD + c.rank * geo.CW +
                                vv * EV) = v;
    }
    down_chunk<T, NT8>(cluster, geo, c, ns, w_out, partial, ch, vec_n);
  }
}

template <typename T, int NT8>
int launch_nt8(const Geo& g, const T* x, const T* wi, const T* wo, T* y,
               int32_t* bits, float* partial, int relu2,
               cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int vec_x = vec_rows<T>(x, g.K);
  const int vec_f = vec_rows<T>(wi, g.F) && g.bf % Cfg<T>::V == 0;
  const int vec_n = vec_rows<T>(wo, g.N);
  return launch_clusters(mlp_cluster_kernel<T, NT8>, g, allowed, y, bits,
                         partial, stream, x, wi, wo, bits, partial, g,
                         relu2, vec_x, vec_f, vec_n);
}

template <typename T>
int launch(const void* x, const void* w_in, const void* w_out, void* y,
           void* bits, void* partial, int M, int K, int F, int N, int bm,
           int bf, int relu2, cudaStream_t stream) {
  if (bm < 1 || bf < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo<T>(M, K, F, N, bm, bf);
  const T* xt = static_cast<const T*>(x);
  const T* wi = static_cast<const T*>(w_in);
  const T* wo = static_cast<const T*>(w_out);
  T* yt = static_cast<T*>(y);
  int32_t* bt = static_cast<int32_t*>(bits);
  float* pt = static_cast<float*>(partial);
  switch (g.RB / 8) {
    case 1:
      return launch_nt8<T, 1>(g, xt, wi, wo, yt, bt, pt, relu2, stream);
    case 2:
      return launch_nt8<T, 2>(g, xt, wi, wo, yt, bt, pt, relu2, stream);
    case 4:
      return launch_nt8<T, 4>(g, xt, wi, wo, yt, bt, pt, relu2, stream);
    default:
      return launch_nt8<T, 8>(g, xt, wi, wo, yt, bt, pt, relu2, stream);
  }
}

}  // namespace

// ------------------------------------------------------------ tall path
// A CTA owns one 64-row tile (the gate tile: block_m 64) and NS = 288
// columns of y, and walks the 128-wide stripes in ascending order. Its
// two consumer warpgroups each compute, for the tile's 64 rows, one
// 64-column half of the stripe's h = x @ w_in[:, stripe] with wgmma into
// registers, apply the activation to the f32 value and round it through
// bf16 exactly as the cluster design does, and store their half of a to
// shared memory (the A operand of the down-projection, 128-byte
// swizzle). A barrier over both warpgroups ORs the tile's flags: that is
// the stripe's bit (NaN live). If the tile is live, each warpgroup adds
// a (64 x 128) @ w_out[stripe, its 144 columns] to its y accumulator
// (72 registers a thread), which stays in registers across the stripes
// and is written once, at the end.
//
// Registers are the design's limit: y for 64 rows x 576 columns is 288
// f32 a thread of one warpgroup, so the two CTAs of a row tile (N = 576 =
// 2 x 288) each recompute the up-projection, which doubles its share of
// the products (2 x 7.25 of 21.7 GFLOP at a training step) but keeps
// every CTA independent. Splitting h's columns over a cluster of those
// two CTAs instead, a pushed to both through distributed shared memory
// behind one cluster-scope barrier a stripe (cluster_mlp.cuh's way), was
// built and measured on the card: 1.3-1.4x slower at 2048 and 4096 rows,
// with a separate ring and producer for w_out too; with half the h
// columns a CTA its loads were latency-bound (64 rows give each weight
// byte only 64 flops, and a 32-column h step is too small to hide a
// load's latency in the bytes the ring holds). x's 64 rows stay in
// shared memory (K <= 640), so only the weights stream, through a ring
// of six 18 KB slots: w_in's stripe (two 64 x 64 boxes a 64-deep step)
// always -- it produces the bit -- and w_out's stripe rows (a
// warpgroup's 144 columns of 64 rows a slot) only after the bit says
// live (a producer warp waits for it, one stripe behind: it loads the
// next stripe's w_in first, then the live stripe's w_out, in the order
// the consumers take them). A stripe
// dead in the tile never has a w_out box requested. Ragged M, K, F and N
// rely on TMA's zero fill: rows past M and columns past F give a = 0,
// dead votes, so the bits are the zero-padded reference's.
namespace tall_mlp {

using namespace tall;

constexpr int THREADS = tall::THREADS;  // not the cluster design's
constexpr int NW = 144;           // y columns of a consumer warpgroup
constexpr int NS = 2 * NW;        // y columns of a CTA
constexpr int ROWS = 64;          // rows of a CTA: one gate tile
constexpr int BF = 128;           // the stripe: two 64-column halves
constexpr int MIN_ROWS = 1024;
constexpr int MAX_K = 640;        // x's rows stay in shared memory
constexpr int RING = 6;           // slots of the weights' ring
constexpr int WBOX = 16 * 64 * 2;  // a 64-row x 16-column box of w_out
constexpr int NBOX = NW / 16;      // w_out boxes of a warpgroup's columns
// A slot: an up stage (w_in's two 64 x 64 boxes of a 64-deep step) or a
// down stage of one warpgroup (its 9 boxes of 64 w_out rows).
constexpr int SLOT = NBOX * WBOX;
constexpr int ABUF = 2 * BOX;      // a: 64 rows x two 64-deep halves

// The rule of the tall path (kernels/sparce_mlp.py: tall_path adds the
// dtype, bf16).
inline bool ok(int M, int K, int F, int N, int bm, int bf) {
  return M >= MIN_ROWS && bm == ROWS && bf == BF && K > 0 && K <= MAX_K &&
         K % 8 == 0 && F > 0 && F % 8 == 0 && N > 0 && N % 8 == 0;
}

inline size_t smem_bytes(int K) {
  const int nk = (K + KS - 1) / KS;
  return 1024 + (size_t)nk * BOX + (size_t)RING * SLOT + 2 * ABUF +
         8 * (2 * RING + 3) + 8;
}

// A warp's place in the ring (every consumer warp and the producer keep
// their own, in step).
struct Ring {
  uint32_t slots, full, empty;
  int slot;
  uint32_t phase;
  __device__ uint32_t at() const { return slots + slot * SLOT; }
  __device__ void advance() {
    if (++slot == RING) slot = 0, phase ^= 1u;
  }
};

// Consumer side: wait for the current slot's data and move on; returns
// the slot. release() frees a slot taken earlier (every consumer warp
// arrives once a slot).
__device__ __forceinline__ int take(Ring& r) {
  mbar_wait(r.full + 8 * r.slot, r.phase);
  const int s = r.slot;
  r.advance();
  return s;
}
__device__ __forceinline__ void release(const Ring& r, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * slot);
}

// The OR of v over the 256 consumer threads (named barrier 1).
__device__ __forceinline__ bool consumers_any(bool v) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, 256, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"((uint32_t)v)
      : "memory");
  return out != 0;
}

// Down-projection steps of stripe f: 64 rows of w_out each, those that
// start before F.
__device__ __forceinline__ int down_steps(int f, int F) {
  return min(2, (F - f * BF + KS - 1) / KS);
}

__global__ void __launch_bounds__(THREADS, 1) mlp_tall_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wimap,
    const __grid_constant__ CUtensorMap womap, int32_t* __restrict__ bits,
    __nv_bfloat16* __restrict__ y, int M, int K, int F, int N, int relu2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);  // generic address of `base`
  const int nk = (K + KS - 1) / KS, nf = (F + BF - 1) / BF;
  const uint32_t xs = base, slots = xs + nk * BOX;
  const uint32_t as = slots + RING * SLOT;
  const uint32_t full = as + 2 * ABUF, empty = full + 8 * RING;
  const uint32_t flag = empty + 8 * RING, xbar = flag + 16;
  volatile int* live_s = reinterpret_cast<volatile int*>(gen + (xbar + 8 - base));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x, tile = blockIdx.y, row0 = tile * ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(flag, 1);
    mbar_init(flag + 8, 1);
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring{slots, full, empty, 0, 0u};

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wimap);
      prefetch_map(&womap);
      mbar_expect_tx(xbar, nk * BOX);
    }
    __syncwarp();
    for (int kk = lane; kk < nk; kk += 32)
      tma_load(xs + kk * BOX, &xmap, xbar, kk * KS, row0);
    auto up = [&](int f) {
      for (int kk = 0; kk < nk; ++kk) {
        if (lane == 0) {
          const uint32_t s = ring.at(), fb = full + 8 * ring.slot;
          mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1u);
          mbar_expect_tx(fb, 2 * BOX);
          tma_load(s, &wimap, fb, f * BF, kk * KS);
          tma_load(s + BOX, &wimap, fb, f * BF + 64, kk * KS);
        }
        __syncwarp();
        ring.advance();
      }
    };
    up(0);
    for (int f = 0; f < nf; ++f) {
      if (f + 1 < nf) up(f + 1);
      mbar_wait(flag + 8 * (f & 1), (f >> 1) & 1);
      if (!live_s[f & 1]) continue;  // no w_out address of a dead stripe
      for (int j = 0; j < 2 * down_steps(f, F); ++j) {
        // step j / 2, warpgroup j % 2's columns
        const uint32_t s = ring.at(), fb = full + 8 * ring.slot;
        if (lane == 0) {
          mbar_wait(empty + 8 * ring.slot, ring.phase ^ 1u);
          mbar_expect_tx(fb, SLOT);
        }
        __syncwarp();
        if (lane < NBOX)
          tma_load(s + lane * WBOX, &womap, fb,
                   q * NS + (j % 2) * NW + lane * 16, f * BF + KS * (j / 2));
        __syncwarp();
        ring.advance();
      }
    }
    return;
  }

  // A consumer warpgroup: half of h, then its 144 columns of y.
  const int wg = warp >> 2;
  const int r = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
  float yacc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) yacc[i] = 0.f;
  uint32_t apk[16];  // a of the next stripe, bf16 pairs (acc order)
  mbar_wait(xbar, 0);

  // h for the next stripe's half wg: x (resident) @ w_in boxes; then the
  // activation on the f32 value and the bf16 rounding into apk. Returns
  // whether any of this thread's a is nonzero (or NaN).
  auto up = [&]() -> bool {
    float h[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = 0.f;
    int prev = -1;
    for (int kk = 0; kk < nk; ++kk) {  // a step's products run during
      const int sl = take(ring);        // the next one's issue
      const uint32_t s = ring.slots + sl * SLOT;
      wgmma_fence();
#pragma unroll
      for (int k4 = 0; k4 < KS / 16; ++k4)
        wgmma<64>(h, desc_a(xs + kk * BOX, k4), desc_b128(s + wg * BOX, k4));
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(ring, prev);
      prev = sl;
    }
    wgmma_wait<0>();
    fence_regs(h);
    release(ring, prev);
    bool any = false;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float a0 = h[2 * i] < 0.f ? 0.f : h[2 * i];  // relu; NaN stays NaN
      float a1 = h[2 * i + 1] < 0.f ? 0.f : h[2 * i + 1];
      if (relu2) a0 *= a0, a1 *= a1;
      const __nv_bfloat162 p = __floats2bfloat162_rn(a0, a1);
      any |= __low2float(p) != 0.f || __high2float(p) != 0.f;
      apk[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return any;
  };
  // apk into half wg of a's buffer f % 2 (K-major, 128-byte swizzle), then the
  // stripe's bit: published to the producer and, by the first column
  // slice, to bits.
  auto publish = [&](int f, bool any) -> bool {
    uint8_t* half = gen + (as - base) + (f & 1) * ABUF + wg * BOX;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r + 8 * hh;
        *reinterpret_cast<uint32_t*>(half + swz128(row, j, t)) =
            apk[2 * j + hh];
      }
    fence_async_smem();
    const bool live = consumers_any(any);
    if (threadIdx.x == 0) {
      if (q == 0) bits[(size_t)tile * nf + f] = live ? 0 : 1;
      live_s[f & 1] = live;
      mbar_arrive(flag + 8 * (f & 1));
    }
    return live;
  };

  bool live = publish(0, up());
  for (int f = 0; f < nf; ++f) {
    const bool next = f + 1 < nf;
    const bool any = next && up();
    if (live) {
      const uint32_t a = as + (f & 1) * ABUF;
      for (int j = 0; j < 2 * down_steps(f, F); ++j) {
        const int sl = take(ring);  // the other warpgroup's step: free it
        if (j % 2 == wg) {          // once its data landed
          const uint32_t s = ring.slots + sl * SLOT;
          wgmma_fence();
#pragma unroll
          for (int k4 = 0; k4 < KS / 16; ++k4)
            wgmma<NW>(yacc, desc_a(a + (j / 2) * BOX, k4),
                      desc(s + 512 * k4, WBOX, 256, SW32));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(yacc);
        }
        release(ring, sl);
      }
    }
    if (next) live = publish(f + 1, any);
  }

  const int row_a = row0 + r, col_a = q * NS + wg * NW + 2 * t;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = col_a + 8 * j;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row_a + 8 * hh;
      if (row < M && col < N)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(0.f + yacc[4 * j + 2 * hh],
                                  0.f + yacc[4 * j + 2 * hh + 1]);
    }
  }
}

inline dim3 grid(int M, int N) {
  return dim3((unsigned)((N + NS - 1) / NS), (unsigned)((M + ROWS - 1) / ROWS));
}

int launch(const void* x, const void* w_in, const void* w_out, void* y,
           void* bits, int M, int K, int F, int N, int relu2,
           cudaStream_t stream) {
  CUtensorMap xm, wim, wom;
  int err = bf16_map(&xm, x, K, M, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = bf16_map(&wim, w_in, F, K, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = bf16_map(&wom, w_out, N, F, 16, 64, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err) return err;
  const dim3 g = grid(M, N);
  if (g.y > 65535u) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const size_t smem = smem_bytes(K);
  cudaError_t e = sparce::allow_smem(mlp_tall_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  mlp_tall_kernel<<<g, THREADS, smem, stream>>>(
      xm, wim, wom, static_cast<int32_t*>(bits),
      static_cast<__nv_bfloat16*>(y), M, K, F, N, relu2);
  return (int)cudaGetLastError();
}

}  // namespace tall_mlp

// The tall path (bf16): y and bits as sparce_mlp's, with no scratch.
// Refuses (cudaErrorInvalidValue) shapes outside tall_mlp::ok and
// operands TMA cannot address. Returns cudaGetLastError() after the
// launch.
extern "C" int sparce_mlp_tall(const void* x, const void* w_in,
                               const void* w_out, void* y, void* bits, int M,
                               int K, int F, int N, int bm, int bf, int relu2,
                               void* stream) {
  if (!tall_mlp::ok(M, K, F, N, bm, bf) || !tall::tma_ok(x, K) ||
      !tall::tma_ok(w_in, F) || !tall::tma_ok(w_out, N))
    return (int)cudaErrorInvalidValue;
  return tall_mlp::launch(x, w_in, w_out, y, bits, M, K, F, N, relu2,
                          static_cast<cudaStream_t>(stream));
}

// The C side of the wrapper's tall_path rule for a bf16 call: 1 when
// these shapes and tiles take the tall path.
extern "C" int sparce_mlp_tall_ok(int M, int K, int F, int N, int bm,
                                  int bf) {
  return tall_mlp::ok(M, K, F, N, bm, bf) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, weights and y share it).
// relu2: 0 relu, 1 relu squared. bits: int32 (ceil(M/bm), ceil(F/bf)).
// partial: f32 scratch of ceil(F/bf) x M x N floats. Returns
// cudaGetLastError() after the launches (0 = success;
// cudaErrorInvalidValue when the tile needs more shared memory than a
// block has).
extern "C" int sparce_mlp(const void* x, const void* w_in, const void* w_out,
                          void* y, void* bits, void* partial, int M, int K,
                          int F, int N, int bm, int bf, int relu2, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || F <= 0 || N <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, w_in, w_out, y, bits, partial, M, K, F, N, bm,
                         bf, relu2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_in, w_out, y, bits, partial, M, K, F,
                                 N, bm, bf, relu2, s);
  return (int)cudaErrorInvalidValue;
}

// The launch's grid for these shapes (cluster_mlp.cuh: grid_of).
extern "C" int sparce_mlp_grid(int M, int K, int F, int N, int bm, int bf,
                               int dtype, int* out) {
  return grid_of(M, K, F, N, bm, bf, dtype, out);
}
