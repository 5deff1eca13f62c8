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
// prefill. The design is cluster_mlp.cuh's, with the gate as the first
// product: per live stripe and chunk of rows each CTA computes its
// columns of h and a, then pushes its slice of a into every CTA.
#include "cluster_mlp.cuh"

namespace {

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

// One CTA of the cluster of (row group blockIdx.y, stripe blockIdx.x / C).
template <typename T, int NT8>
__global__ void __launch_bounds__(THREADS) glu_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ w_gate,
    const T* __restrict__ w_in, const T* __restrict__ w_out,
    int32_t* __restrict__ bits, float* __restrict__ partial, const Geo geo,
    int act, float tau, int vec_x, int vec_f, int vec_n) {
  constexpr int RB = 8 * NT8;
  cg::cluster_group cluster = cg::this_cluster();
  const Cta<T> c = enter<T, NT8>(geo, (int)cluster.block_rank());

  // -- 1. the gate first, over the full K: the predictor runs before the
  // work it may cancel. act(g) of this CTA's columns is kept; a row tile
  // with an element above tau is flagged live.
  const Job<T> gate{w_gate, geo.F, 0, geo.K, c.c0, geo.CW, c.c_end, c.nch,
                    x, geo.K, c.row0, c.grows, nullptr, 0, vec_f, vec_x};
  stream<T, NT8>(gate, geo, c.ring, c.red_s,
                 [&](const Blk& k, int r, int col, float v) {
    if (col - c.c0 >= geo.CW) return;  // another CTA's column
    const int gr = k.ch * RB + r;
    float ga = 0.f;
    if (r < k.rlim && col < c.f_lim) {
      ga = round_t<T>(gate_act(round_t<T>(v), act));
      if (!(fabsf(ga) <= tau)) c.live_s[gr / geo.bm] = 1;
    }
    c.ga_s[gr * geo.CW + col - c.c0] = from_f<T>(ga);
  });

  // -- 2. SpRF bits at the gate's writeback; a dead stripe exits: no w_in
  // or w_out address is ever formed.
  if (!or_flags(cluster, geo, c, bits)) return;

  // -- 3. per chunk of rows: h and a = round(act(g) * round(h)) for this
  // CTA's columns (zero in dead row tiles), a pushed into every CTA, then
  // a @ w_out[stripe, this CTA's columns of N] into partial[f].
  constexpr int EV = 16 / sizeof(T);
  const int vpr = geo.CW / EV;  // 16-byte vectors of a row of the slice
  const NSlice ns = n_slice(geo, c);
  for (int ch = 0; ch < c.nch; ++ch) {
    const int r0 = c.row0 + ch * RB, rlim = min(RB, c.grows - ch * RB);
    const Job<T> up{w_in, geo.F, 0, geo.K, c.c0, geo.CW, c.c_end, 1, x,
                    geo.K, r0, rlim, nullptr, 0, vec_f, vec_x};
    stream<T, NT8>(up, geo, c.ring, c.red_s,
                   [&](const Blk&, int r, int col, float v) {
      if (col - c.c0 >= geo.CW) return;  // another CTA's column
      const int gr = ch * RB + r;
      float a = 0.f;
      if (r < rlim && col < c.f_lim && c.live_s[gr / geo.bm])
        a = round_t<T>(to_f(c.ga_s[gr * geo.CW + col - c.c0]) *
                       round_t<T>(v));
      c.a_s[r * geo.AS_LD + col - c.f0] = from_f<T>(a);
    });
    for (int e = threadIdx.x; e < (geo.C - 1) * RB * vpr; e += THREADS) {
      const int q = e / (RB * vpr), rem = e - q * RB * vpr;
      const int r = rem / vpr, vv = rem - r * vpr;
      const size_t off = (size_t)r * geo.AS_LD + c.rank * geo.CW + vv * EV;
      *reinterpret_cast<uint4*>(
          cluster.map_shared_rank(c.a_s, q < c.rank ? q : q + 1) + off) =
          *reinterpret_cast<const uint4*>(c.a_s + off);
    }
    down_chunk<T, NT8>(cluster, geo, c, ns, w_out, partial, ch, vec_n);
  }
}

template <typename T, int NT8>
int launch_nt8(const Geo& g, const T* x, const T* wg, const T* wi,
               const T* wo, T* y, int32_t* bits, float* partial, int act,
               float tau, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const int vec_x = vec_rows<T>(x, g.K);
  const int vec_f = vec_rows<T>(wg, g.F) && vec_rows<T>(wi, g.F) &&
                    g.bf % Cfg<T>::V == 0;
  const int vec_n = vec_rows<T>(wo, g.N);
  return launch_clusters(glu_cluster_kernel<T, NT8>, g, allowed, y, bits,
                         partial, stream, x, wg, wi, wo, bits, partial, g,
                         act, tau, vec_x, vec_f, vec_n);
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

// The launch's grid for these shapes (cluster_mlp.cuh: grid_of).
extern "C" int sparce_glu_mlp_grid(int M, int K, int F, int N, int bm,
                                   int bf, int dtype, int* out) {
  return grid_of(M, K, F, N, bm, bf, dtype, out);
}
