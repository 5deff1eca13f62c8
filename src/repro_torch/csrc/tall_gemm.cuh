// The tall path of the port's gated GEMM and fused relu MLP, for Hopper
// (sm_90a): the primitives both build on (TMA, mbarriers, wgmma and its
// shared-memory descriptors, the host's tensor maps) and the gated GEMM's
// tall kernel. sparce_gemm.cu launches tall_gemm_kernel; sparce_mlp.cu
// builds its own tall kernel (mlp_tall_kernel) from the same pieces.
// Beside skip_gemm.cuh's core, tall_gemm_kernel is the port of the TPU
// kernels repro/kernels/sparce_gemm.py:sparce_gemm_gated and
// sparce_gemm_compacted (lhs gate, bf16) at training row counts.
//
// Why a second design: skip_gemm.cuh's core was built for the decode tick
// (1 to 64 rows as the 8-wide N of a transposed mma.sync, 64 columns a
// block, K split into chunk_tiles(K, bk) chunks whose f32 partials go
// through scratch in HBM and back). At training row counts (512 rows and
// up) that design pays the scratch's round trip (126 MB at a training
// step's BP) and runs mma.sync from registers filled by cp.async. The
// tall path instead:
//
//   * A CTA computes a 128-row by BN-column tile (BN 192 where it divides
//     N, else 128: the wrapper's tall_plan): two consumer warpgroups of
//     64 rows each run
//     wgmma.m64nBNk16 (bf16 in, f32 accumulate, A = x K-major, B = w
//     MN-major through the transpose bit, so w is read as it lies) with
//     the accumulators in registers across the whole k walk, a stage's
//     products still running while the next stage's are issued; one
//     producer warp keeps a ring of STAGES stages of TMA loads in flight
//     (128-byte swizzle; completion on mbarriers; a consumer warp frees
//     its slot by an arrive on the slot's empty barrier).
//   * The skip contract is skip_gemm.cuh's: per 32 k tiles a ballot over
//     the bits gives the tiles on which one of the CTA's two row tiles (its
//     warpgroups' 64 rows; one tile when bm >= 128) has its bit at 0; only
//     those are walked, in ascending order. The A box of a warpgroup whose
//     row tile is gated at that k tile is never requested, and that
//     warpgroup skips the stage's wgmma; B of a k tile dead in both row
//     tiles is never requested. Bits are read before the load they gate.
//     Ragged M, K and N rely on TMA's zero fill past the tensor's edge,
//     and TMA's stores write nothing past it.
//   * One chunk but for a long K: then y is written once, rounded to
//     bf16 into shared memory and stored by TMA (storing 4-byte pairs
//     straight from the registers cost a CTA ~4 us on the card, as much
//     as the products of a short K). A K of 2048 or more (a WG's
//     reduction over a step's tokens, whose 1536 x 576 output leaves most
//     of the card idle) splits into K / 1024 chunks; each CTA writes its
//     f32 partial, and skip_gemm.cuh's chunk_reduce_kernel adds them in
//     ascending chunk order: no atomics, so a second call is bit-equal to
//     the first. The plan reads K, N and block_k, never M, so a row's
//     sum runs in one order whatever the call's row count (a pipeline
//     micro-batch's rows equal the whole batch's bit for bit).
//
// What bounds it: operations at the training shapes (a few hundred flops
// per byte of the operands); TMA keeps the operands' bytes off the
// registers and the issue slots.
#pragma once

#include <cuda.h>

#include "dtype.cuh"
#include "skip_gemm.cuh"

namespace tall {

constexpr int BM = 128;       // rows of a GEMM CTA: two 64-row warpgroups
constexpr int KS = 64;        // depth of a stage: 128 bytes of bf16
constexpr int STAGES = 4;     // slots of the GEMM's TMA ring
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX = 64 * 128;  // bytes of a 64 x 64 bf16 box
constexpr int MIN_ROWS = 512;  // the tall path's rows at least

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on `bar`. Past the tensor's edge TMA writes zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory box to global at (c0 innermost, c1) (bulk group);
// TMA writes nothing past the tensor's edge.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
// Wait until the bulk stores issued by this thread have read their
// shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Generic-proxy writes to shared memory become visible to the async
// proxy (wgmma, TMA) after this and a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's products are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Two f32 values rounded to bf16 (as y's writeback: 0 + v, so -0 is +0),
// packed low first.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(0.f + a, 0.f + b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Byte offset of the 4 bytes at (row r, bf16 column 2 t + 8 u) of a
// 64-row x 64-column box in the 128-byte swizzle TMA and wgmma use:
// row r's 16-byte unit u sits at unit u ^ (r % 8).
__device__ __forceinline__ int swz128(int r, int u, int t) {
  return r * 128 + ((u ^ (r & 7)) << 4) + 4 * t;
}

// Keep the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout (1: 128-byte swizzle, 3: 32-byte swizzle). The tiles
// start on 1024-byte boundaries, so the base offset is 0.
constexpr uint64_t SW128 = 1, SW32 = 3;
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A: 64 rows x 64 deep, K-major, 128-byte swizzle (rows 128 bytes apart,
// 8-row groups 1024 apart); the k16 step kk starts 32 bytes further.
__device__ __forceinline__ uint64_t desc_a(uint32_t box, int kk) {
  return desc(box + 32 * kk, 16, 1024, SW128);
}
// B: 64 deep x 64 columns a box, MN-major, 128-byte swizzle (k rows 128
// bytes apart, 8-row groups 1024 apart, the next 64 columns a box
// further); the k16 step kk starts 16 rows further.
__device__ __forceinline__ uint64_t desc_b128(uint32_t box, int kk) {
  return desc(box + 2048 * kk, BOX, 1024, SW128);
}

// wgmma.m64nNk16, f32 += bf16 x bf16, A K-major and B MN-major (the
// transpose bit), both from shared memory. d: the warpgroup's N/2
// accumulators a thread: for 8-column group j, d[4j], d[4j+1] at row
// lane/4 (of its warp's 16), columns 2 (lane%4), +1; d[4j+2], d[4j+3]
// 8 rows below.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n144(float (&d)[72], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 64)
    wgmma_n64(d, da, db);
  else if constexpr (N == 128)
    wgmma_n128(d, da, db);
  else if constexpr (N == 144)
    wgmma_n144(d, da, db);
  else
    wgmma_n192(d, da, db);
}

// -------------------------------------------------- tensor maps (host)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point lookup (the library links no libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 (outer x inner) tensor in boxes of
// (box_outer x box_inner) elements. Returns a cudaError_t.
inline int bf16_map(CUtensorMap* map, const void* base, int inner, int outer,
                    int box_inner, int box_outer, CUtensorMapSwizzle sw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 16-byte aligned base, rows whole 16-byte units: what TMA needs.
inline bool tma_ok(const void* p, int cols) {
  return (uintptr_t)p % 16 == 0 && cols % 8 == 0;
}

// ------------------------------------------------------- the gated GEMM
// The rule of the tall path (kernels/sparce_gemm.py: tall_path, which
// adds the dtype (bf16) and the gate (lhs)): rows enough for many 64-row
// slabs, row tiles whole warpgroups, k tiles whole stages, rows of x and
// w whole 16-byte units.
inline bool gemm_ok(int M, int K, int N, int bm, int bk) {
  return M >= MIN_ROWS && K > 0 && N > 0 && bm % 64 == 0 && bk % KS == 0 &&
         K % 8 == 0 && N % 8 == 0;
}

// The live stages of a CTA's chunk, the same sequence in every warp that
// walks it (producer and consumers): ascending k tiles of [t_lo, t_hi) on
// which row tile r0 or r1 (the warpgroups', -1 past the bit grid) has its
// bit at 0, each cut into KS-deep stages that start before K. Every lane
// of the warp calls next().
struct Walk {
  const int32_t* bits;
  int gk, bk, K, r0, r1, t_hi;
  int base, kt, k0, kend;
  unsigned m0, m1, mask;
  bool live0, live1;

  __device__ void start(const int32_t* b, int gk_, int bk_, int K_, int r0_,
                        int r1_, int t_lo, int t_hi_) {
    bits = b, gk = gk_, bk = bk_, K = K_, r0 = r0_, r1 = r1_, t_hi = t_hi_;
    base = t_lo - 32, kt = -1, k0 = 0, kend = 0;
    m0 = m1 = mask = 0u;
    live0 = live1 = false;
  }

  __device__ bool next() {
    if (kt >= 0 && k0 + KS < kend) {
      k0 += KS;
      return true;
    }
    while (mask == 0u) {
      base += 32;
      if (base >= t_hi) return false;
      const int t = base + (threadIdx.x & 31);
      bool a = false, b = false;
      if (t < t_hi) {
        a = r0 >= 0 && bits[(size_t)r0 * gk + t] == 0;
        b = r1 >= 0 && bits[(size_t)r1 * gk + t] == 0;
      }
      m0 = __ballot_sync(0xffffffffu, a);
      m1 = __ballot_sync(0xffffffffu, b);
      mask = m0 | m1;
    }
    const int i = __ffs(mask) - 1;
    mask &= mask - 1;
    kt = base + i;
    live0 = (m0 >> i) & 1u;
    live1 = (m1 >> i) & 1u;
    k0 = kt * bk;
    kend = min(K, k0 + bk);
    return true;
  }
};

// One CTA: rows [128 y, +128) x columns [BN x, +BN) over the k tiles of
// chunk z = blockIdx.z, [z S, (z + 1) S). Warps 0-3 and 4-7 are the
// consumer warpgroups of rows +0 and +64; warp 8 the producer.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tall_gemm_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap,
    const int32_t* __restrict__ bits, float* __restrict__ partial, int M,
    int K, int N, int bm, int bk, int S, int nchunks) {
  constexpr int SLOT = 2 * BOX + BN * 128;  // A of each warpgroup, then B
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * SLOT, empty = full + 8 * STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int gk = (K + bk - 1) / bk;
  const int t_lo = blockIdx.z * S;
  Walk walk;
  walk.start(bits, gk, bk, K, row0 < M ? row0 / bm : -1,
             row0 + 64 < M ? (row0 + 64) / bm : -1, t_lo, min(gk, t_lo + S));

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
    }
    int slot = 0;
    uint32_t phase = 0;
    while (walk.next()) {
      if (lane == 0) {
        const uint32_t s = base + slot * SLOT, fb = full + 8 * slot;
        mbar_wait(empty + 8 * slot, phase ^ 1u);
        mbar_expect_tx(fb, BN * 128 + (walk.live0 + walk.live1) * BOX);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load(s + 2 * BOX + b * BOX, &wmap, fb, col0 + 64 * b, walk.k0);
        if (walk.live0) tma_load(s, &xmap, fb, walk.k0, row0);
        if (walk.live1) tma_load(s + BOX, &xmap, fb, walk.k0, row0 + 64);
      }
      __syncwarp();
      if (++slot == STAGES) slot = 0, phase ^= 1u;
    }
    return;
  }

  // A consumer warpgroup: 64 rows x BN columns in registers. A stage's
  // products run while the next stage's are issued: its slot is freed
  // one stage later. A warpgroup gated at a stage frees that slot at
  // once, after its data landed (so no warp runs ahead of a slot's
  // earlier use), and first its pending one: held across gated stages,
  // it would be the slot the producer waits for.
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int slot = 0, prev = -1;
  uint32_t phase = 0;
  while (walk.next()) {
    const uint32_t s = base + slot * SLOT;
    mbar_wait(full + 8 * slot, phase);
    if (wg == 0 ? walk.live0 : walk.live1) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        wgmma<BN>(acc, desc_a(s + wg * BOX, kk), desc_b128(s + 2 * BOX, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = slot;
    } else {
      if (prev >= 0) {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        prev = -1;
      }
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }
    __syncwarp();
    if (++slot == STAGES) slot = 0, phase ^= 1u;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);

  const int rw = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
  if (nchunks == 1) {
    // y: the warpgroup's 64 x BN tile, rounded to bf16, into its own A
    // boxes of slots 0.. (every load of the walk has landed and been
    // multiplied, so they are quiet), one 64-column box a slot, then TMA
    // stores (nothing past M or N is written).
    const uint32_t raw = smem_u32(smem_raw);
    uint8_t* gen = smem_raw + (base - raw);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint8_t* box = gen + (j / 8) * SLOT + wg * BOX;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(box + swz128(rw + 8 * h, j % 8, t)) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_store(&ymap, base + b * SLOT + wg * BOX, col0 + 64 * b,
                  row0 + 64 * wg);
      tma_store_drain();
    }
    return;
  }
  // The chunk's f32 partial: pairs of columns, rows and columns past M
  // and N masked.
  const int r = row0 + 64 * wg + rw;
  const int c = col0 + 2 * t;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M || col >= N) continue;
      *reinterpret_cast<float2*>(partial + (size_t)blockIdx.z * M * N +
                                 (size_t)row * N + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
constexpr size_t gemm_smem() {
  return (size_t)STAGES * (2 * BOX + BN * 128) + 1024 + 16 * STAGES;
}

// Launch at column tile BN with S k tiles a chunk, then the chunk
// reduction when there are several chunks. Returns a cudaError_t.
template <int BN>
int launch_gemm(const void* x, const void* w, const void* bits, void* y,
                void* partial, int M, int K, int N, int bm, int bk, int S,
                cudaStream_t stream) {
  CUtensorMap xmap, wmap, ymap;
  int err = bf16_map(&xmap, x, K, M, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = bf16_map(&wmap, w, N, K, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = bf16_map(&ymap, y, N, M, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int gk = (K + bk - 1) / bk, nchunks = (gk + S - 1) / S;
  if (nchunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned rows = (unsigned)((M + BM - 1) / BM);
  if (rows > 65535u || nchunks > 65535) return (int)cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  constexpr size_t smem = gemm_smem<BN>();
  cudaError_t e = sparce::allow_smem(tall_gemm_kernel<BN>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, rows, nchunks);
  tall_gemm_kernel<BN><<<grid, THREADS, smem, stream>>>(
      xmap, wmap, ymap, static_cast<const int32_t*>(bits),
      static_cast<float*>(partial), M, K, N, bm, bk, S, nchunks);
  e = cudaGetLastError();
  if (e != cudaSuccess || nchunks == 1) return (int)e;
  return (int)skip::launch_chunk_reduce<__nv_bfloat16>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y),
      (size_t)M * N, nchunks, stream);
}

}  // namespace tall
