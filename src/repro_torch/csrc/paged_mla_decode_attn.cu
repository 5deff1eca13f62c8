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
// with f32 accumulation, positions at or past the length masked to
// -1e30, an f32 online softmax whose p is rounded to the pool dtype
// before the context product while the normaliser sums the unrounded
// p, a 1e-30 floor on the normaliser, zeros for a length-0 slot. The
// masked tail rows of the last live block are multiplied by p = 0, as
// in the TPU kernel.
//
// Skip contract (the paper's skip-before-fetch): a thread block loops
// over j < ceil(min(len, max_blocks * bs) / bs) only. That loop bound
// takes the place of the TPU kernel's index-map clamp: a table entry at
// or past the live prefix is never read, so neither is the block it
// names; a length-0 slot reads no table entry and no block.
//
// What bounds it on this card: bytes. Per cached row the kernel does
// 2 * H * (2R + ROPE) flops against (R + ROPE) * itemsize bytes of
// latent row -- ~242 flop/byte at H 128, R 512, ROPE 64 in bf16, just
// under the H100's ~295 flop/byte balance point -- so the floor is the
// bytes of the queries, the live rows and the output over HBM
// bandwidth. This first version is the simple correct one: grid
// (slot, group of 8 heads), one warp per head holding its query row
// and its R f32 accumulators in registers (R/32 per lane); the
// block's 8 warps share each staged pool block (bs x (R + ROPE) rows,
// converted to f32 in shared memory). Each head group re-reads the
// slot's live blocks (from L2); tensor cores (wgmma), TMA staging and
// split-K over long sequences are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;  // heads per thread block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kRopePerLane = 4;  // rope widths up to 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same (commutative) sum.
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RPL: latent values per lane (R <= 32 * RPL).
template <typename T, int RPL>
__global__ void __launch_bounds__(kThreads) paged_mla_decode_kernel(
    const T* __restrict__ q_lat, const T* __restrict__ q_rope,
    const T* __restrict__ ckv_pool, const T* __restrict__ kr_pool,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ lengths,
    T* __restrict__ out, int H, int R, int ROPE, int BS, int max_blocks,
    float scale) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head = blockIdx.y * kWarps + warp;
  const bool has_head = head < H;  // warp-uniform
  extern __shared__ float smem[];
  float* ckv_s = smem;              // BS*R    staged latent rows
  float* kr_s = ckv_s + BS * R;     // BS*ROPE staged rope keys
  float* s_w = kr_s + BS * ROPE + warp * BS;  // this warp's BS scores

  const size_t row = (size_t)b * H + (has_head ? head : 0);
  float q[RPL], acc[RPL], qr[kRopePerLane];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int c = lane + 32 * i;
    q[i] = (has_head && c < R) ? to_f(q_lat[row * R + c]) : 0.f;
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRopePerLane; ++i) {
    const int c = lane + 32 * i;
    qr[i] = (has_head && c < ROPE) ? to_f(q_rope[row * ROPE + c]) : 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int len = lengths[b];
  // Live blocks; 0 for a dead slot. Capped at the table width so a
  // length past the table's reach never reads beyond the slot's row.
  const int nblk = len > 0 ? min((len + BS - 1) / BS, max_blocks) : 0;
  for (int j = 0; j < nblk; ++j) {
    const int blk = tables[(size_t)b * max_blocks + j];  // a live entry
    const T* cs = ckv_pool + (size_t)blk * BS * R;
    const T* ks = kr_pool + (size_t)blk * BS * ROPE;
    __syncthreads();  // every warp is done with the previous block
    for (int i = threadIdx.x; i < BS * R; i += kThreads) ckv_s[i] = to_f(cs[i]);
    for (int i = threadIdx.x; i < BS * ROPE; i += kThreads)
      kr_s[i] = to_f(ks[i]);
    __syncthreads();
    if (!has_head) continue;

    const int start = j * BS;
    float mx = kNegInf;
    for (int r = 0; r < BS; ++r) {
      const float* crow = ckv_s + r * R;
      const float* krow = kr_s + r * ROPE;
      float lat = 0.f, rp = 0.f;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int c = lane + 32 * i;
        if (c < R) lat = fmaf(q[i], crow[c], lat);
      }
#pragma unroll
      for (int i = 0; i < kRopePerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < ROPE) rp = fmaf(qr[i], krow[c], rp);
      }
      lat = warp_sum(lat);
      rp = warp_sum(rp);
      // The two dots sum before the scale, as in the TPU kernel.
      const float s = (start + r < len) ? (lat + rp) * scale : kNegInf;
      if (lane == 0) s_w[r] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f, ctx[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) ctx[i] = 0.f;
    for (int r = 0; r < BS; ++r) {
      const float p = expf(s_w[r] - m_new);
      sum += p;  // the normaliser takes p unrounded
      const float pr = round_t<T>(p);  // p in the pool dtype
      const float* crow = ckv_s + r * R;
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int c = lane + 32 * i;
        if (c < R) ctx[i] = fmaf(pr, crow[c], ctx[i]);
      }
    }
    l = l * corr + sum;
#pragma unroll
    for (int i = 0; i < RPL; ++i) acc[i] = acc[i] * corr + ctx[i];
    m = m_new;
  }

  if (!has_head) return;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int c = lane + 32 * i;
    if (c < R) out[row * R + c] = from_f<T>(acc[i] / fmaxf(l, 1e-30f));
  }
}

template <typename T, int RPL>
int launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
           const void* kr_pool, const void* tables, const void* lengths,
           void* out, int B, int H, int R, int ROPE, int BS, int max_blocks,
           float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BS * R + BS * ROPE + kWarps * BS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_mla_decode_kernel<T, RPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, (H + kWarps - 1) / kWarps);
  paged_mla_decode_kernel<T, RPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv_pool), static_cast<const T*>(kr_pool),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), H, R, ROPE,
      BS, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q_lat, const void* q_rope, const void* ckv_pool,
             const void* kr_pool, const void* tables, const void* lengths,
             void* out, int B, int H, int R, int ROPE, int BS,
             int max_blocks, float scale, cudaStream_t s) {
#define MLA_LAUNCH(RPL)                                                     \
  return launch<T, RPL>(q_lat, q_rope, ckv_pool, kr_pool, tables, lengths, \
                        out, B, H, R, ROPE, BS, max_blocks, scale, s)
  if (R <= 32) MLA_LAUNCH(1);
  if (R <= 64) MLA_LAUNCH(2);
  if (R <= 128) MLA_LAUNCH(4);
  if (R <= 256) MLA_LAUNCH(8);
  if (R <= 512) MLA_LAUNCH(16);
#undef MLA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output share it).
// R <= 512, ROPE <= 128. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int paged_mla_decode_attn(const void* q_lat, const void* q_rope,
                                     const void* ckv_pool,
                                     const void* kr_pool, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int H, int R, int ROPE, int BS,
                                     int max_blocks, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (ROPE > 32 * kRopePerLane) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q_lat, q_rope, ckv_pool, kr_pool, tables, lengths,
                           out, B, H, R, ROPE, BS, max_blocks, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q_lat, q_rope, ckv_pool, kr_pool, tables,
                                   lengths, out, B, H, R, ROPE, BS,
                                   max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}
