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
#include "cluster_mlp.cuh"

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
