// Paged grouped-query decode attention straight out of the KV pool, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_decode_attn.py:
// paged_gqa_decode_attn (Pallas). Same contract: q (B, KV, g, D),
// pools (nb, bs, KV, D), int32 block tables (B, max_blocks), int32
// per-slot lengths (B,), output (B, KV, g, D) in q's dtype; online
// softmax in f32 with the scale applied after the dot, positions at or
// past the length masked, p rounded to the value dtype before the PV
// product, a 1e-30 floor on the normaliser, zeros for a length-0 slot.
//
// Skip contract (the paper's PSRU, skip-before-fetch): one thread
// block per (slot, KV head) loops over j < ceil(len / bs) only. The
// loop bound takes the place of the TPU kernel's index-map clamp: a
// table entry at or past the live prefix is never read, so neither is
// the block it names; a length-0 slot reads no table entry and no
// block at all and writes zeros.
//
// What bounds it on this card: bytes. Decode attention does ~4*g*D
// flops per cached row against 2*D*itemsize bytes of K/V per KV head,
// far below the H100's ~295 flop/byte balance point, so the floor is
// the live K/V blocks over HBM bandwidth. This first version is the
// simple correct one: each block stages one pool block of K and V in
// shared memory, converted to f32, and the g query rows of the head
// share every staged row (the GQA reuse). Multi-block pipelining
// (cp.async/TMA), split-K over long sequences and more slots per SM
// are later work; the grid has only B * KV blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_gqa_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int KV, int G,
    int D, int BS, int max_blocks, float scale) {
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  extern __shared__ float smem[];
  float* q_s = smem;             // G*D  query rows of this KV head
  float* acc_s = q_s + G * D;    // G*D  running PV accumulator
  float* k_s = acc_s + G * D;    // BS*D staged keys of one pool block
  float* v_s = k_s + BS * D;     // BS*D staged values
  float* p_s = v_s + BS * D;     // G*BS scores, then probabilities
  float* m_s = p_s + G * BS;     // G    running max
  float* l_s = m_s + G;          // G    running normaliser
  float* c_s = l_s + G;          // G    rescale factor of this block

  const int tid = threadIdx.x;
  const int len = lengths[b];
  const T* qb = q + (size_t)(b * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // Live blocks; 0 for a dead slot. Capped at the table width so a
  // length past the table's reach never reads beyond the slot's row.
  const int nblk = len > 0 ? min((len + BS - 1) / BS, max_blocks) : 0;
  const size_t row_stride = (size_t)KV * D;
  const int warp = tid >> 5, lane = tid & 31, nwarps = kThreads >> 5;
  for (int j = 0; j < nblk; ++j) {
    const int blk = tables[b * max_blocks + j];  // j < nblk: live entry
    const size_t base = (size_t)blk * BS * row_stride + (size_t)h * D;
    for (int i = tid; i < BS * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const size_t off = base + (size_t)r * row_stride + d;
      k_s[i] = to_f(k_pool[off]);
      v_s[i] = to_f(v_pool[off]);
    }
    __syncthreads();

    const int start = j * BS;
    for (int i = tid; i < G * BS; i += kThreads) {
      const int gi = i / BS, r = i - gi * BS;
      const float* qr = q_s + gi * D;
      const float* kr = k_s + r * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      p_s[i] = (start + r < len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // Online-softmax update, one warp per query row. Each lane reads and
    // rewrites only its own entries of p_s, so no extra barrier is needed
    // between the max pass and the exp pass.
    for (int gi = warp; gi < G; gi += nwarps) {
      float* row = p_s + gi * BS;
      float mx = kNegInf;
      for (int r = lane; r < BS; r += 32) mx = fmaxf(mx, row[r]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < BS; r += 32) {
        const float p = expf(row[r] - m_new);
        sum += p;
        row[r] = round_t<T>(p);  // p in the value dtype for the PV product
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        c_s[gi] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int gi = i / D, d = i - gi * D;
      const float* pr = p_s + gi * BS;
      float pv = 0.f;
      for (int r = 0; r < BS; ++r) pv = fmaf(pr[r], v_s[r * D + d], pv);
      acc_s[i] = acc_s[i] * c_s[gi] + pv;
    }
    __syncthreads();
  }

  T* ob = out + (size_t)(b * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gi = i / D;
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int B, int KV,
           int G, int D, int BS, int max_blocks, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * G * D + 2 * BS * D + G * BS + 3 * G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_gqa_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), KV, G, D,
      BS, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output share it).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int paged_gqa_decode_attn(const void* q, const void* k_pool,
                                     const void* v_pool, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int KV, int G, int D, int BS,
                                     int max_blocks, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, KV, G,
                         D, BS, max_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                 KV, G, D, BS, max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}
