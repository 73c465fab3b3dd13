// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// named barriers, TMA tensor loads, tensor maps, wgmma and its shared-memory
// descriptors, register reallocation.
//
// Shared-memory tiles. Every bf16 tile is loaded by TMA with 128-byte
// swizzling, one box of 64 columns (128 bytes) by R rows at a time, so a
// tile of D = 128 columns is two such boxes stored one after the other:
// column block c of row r starts at byte c * R * 128 + r * 128, with its
// eight 16-byte chunks permuted by (r % 8). Each tile starts on a 1024-byte
// boundary, which is what the swizzle pattern (and the descriptors' zero
// base offset) assume.
//
// wgmma reads such a tile in two ways:
//  - K-major ("the reduction dimension is contiguous"): A = Q [rows, D] or
//    B = K [keys, D] in S = Q K^T. The descriptor for the 16-deep slice kk
//    starts at column block kk / 4, byte (kk % 4) * 32 of the first row;
//    8-row groups are SBO = 1024 bytes apart; LBO is unused (1).
//  - MN-major (transposed B, wgmma's imm-trans-b = 1): B = V [keys, D] in
//    O = P V, where the keys are the reduction dimension and D the output
//    columns. The slice kk starts 16 rows = 2048 bytes further down; 8-row
//    groups are SBO = 1024 bytes apart; LBO = R * 128 bytes is the step
//    from one 64-column block to the next.
//
// Accumulator layout (PTX ISA, wgmma .m64nNk16 D fragment): thread t of the
// warpgroup, warp w = t / 32, lane l = t % 32, holds N / 2 floats d[i] at
//   row = 16 w + l / 4 + 8 ((i / 2) % 2),  col = 8 (i / 4) + 2 (l % 4) + i % 2.
// So a thread owns two rows, and the four lanes of a quad share them. The
// A fragment from registers (bf16, m64k16) has the same shape per 16
// columns, so a bf16 copy of d[8 kk .. 8 kk + 7], packed in pairs, is the A
// operand of the 16-deep slice kk of the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ mbarrier --- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is
// in phase 0, so waiting on parity 1 returns at once (the producer's first
// pass over the empty barriers). A wait that never ends (a pipeline fault)
// traps after 2^26 polls (far longer than any tile takes), so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// ----------------------------------------------------------------- TMA --- //
// One box of a 4-d tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-d tensor map into shared memory (coordinates innermost
// first).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ------------------------------------------------------ named barriers --- //
// Barrier `id` (1-15; 0 is __syncthreads) over `n` threads, whole warps.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at barrier `id` without waiting (a producer's half of a handoff
// whose consumers bar.sync on it).
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma reading a tile the threads wrote); a barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------ register reallocation --- //
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --------------------------------------------------------------- wgmma --- //
__device__ __forceinline__ uint64_t desc_encode(uint64_t x) {
  return (x & 0x3FFFF) >> 4;
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return desc_encode(smem_u32(p)) | (desc_encode(lbo) << 16) |
         (desc_encode(sbo) << 32) | (1ull << 62);
}

// K-major tile of R rows: the 16-deep slice kk.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk,
                                                int rows) {
  const char* p = static_cast<const char*>(tile) + (kk / 4) * rows * 128 +
                  (kk % 4) * 32;
  return make_desc(p, 16, 1024);
}

// MN-major tile of R rows (the reduction runs down the rows): slice kk.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk,
                                                 int rows) {
  const char* p = static_cast<const char*>(tile) + kk * 16 * 128;
  return make_desc(p, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (the registers are in flight until wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HOPPER_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64, 64] (+)= A[64, 16] B[16, 64], A and B from shared memory, B K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 128] (+)= A[64, 16] B[16, 128], A and B from shared memory, B
// K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 64] += A[64, 16] B[16, 64], A from registers (four bf16 pairs), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 128] += A[64, 16] B[16, 128], A from registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define HOPPER_R8(i)                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D[64, 128] (+)= A[64, 32] B[32, 128] in int8 with s32 sums, A and B from
// shared memory, both K-major (8-bit wgmma takes no other layout).
__device__ __forceinline__ void wgmma_ss_n128_s8(int (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef HOPPER_R8
#undef HOPPER_D8

// S (+)= A B^T over a K-major A tile (64 rows from `a`) and a K-major B tile
// of N rows, reduction depth DK: DK / 16 wgmmas.
template <int N, int DK>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], const void* a,
                                        int a_rows, const void* b) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint64_t da = desc_kmajor(a, kk, a_rows);
    const uint64_t db = desc_kmajor(b, kk, N);
    if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, kk > 0);
    else
      wgmma_ss_n128(d, da, db, kk > 0);
  }
}

// D += A B with A in registers (KR / 16 slices of four bf16 pairs) and B an
// MN-major tile of KR rows and N columns.
template <int N, int KR>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[KR / 16][4],
                                        const void* b) {
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk) {
    const uint64_t db = desc_mnmajor(b, kk, KR);
    if constexpr (N == 64)
      wgmma_rs_n64_t(d, a[kk], db);
    else
      wgmma_rs_n128_t(d, a[kk], db);
  }
}

// The 16-byte chunk c (bf16 columns 8c .. 8c + 7) of row r of a tile of
// `rows` rows stored as above.
__device__ __forceinline__ uint4 tile_chunk(const void* tile, int r, int c,
                                            int rows) {
  return *reinterpret_cast<const uint4*>(
      static_cast<const char*>(tile) + (c / 8) * rows * 128 + r * 128 +
      (((c % 8) ^ (r % 8)) * 16));
}

// sum of the eight products of two chunks of bf16 values, in f32 (each
// product is exact in f32)
__device__ __forceinline__ float dot_chunk(uint4 a, uint4 b, float acc) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------- host side --- //
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Make the runtime's current device's context current in this thread for
// the driver calls below (tensor-map encoding): a thread whose first CUDA
// call this is (autograd's backward thread) has none yet, and the encoder
// then fails. Returns a cudaError_t.
inline int bind_context() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  return static_cast<int>(e);
}

// Tensor map over a strided bf16 [n3, n1, n2, n0] tensor read as [B, L, H,
// D] (element strides s_b, s_l, s_h; the last dimension dense): boxes of
// min(64, D) columns by `rows` rows of one (b, h), 128-byte swizzle, zeros
// past the ends. Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
                    int D, long long s_b, long long s_l, long long s_h,
                    int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // a size-1 dimension's stride is never followed; give it a dense one
  const long long e = 2;
  long long st_l = L > 1 ? s_l * e : D * e;
  long long st_h = H > 1 ? s_h * e : st_l * L;
  long long st_b = B > 1 ? s_b * e : st_h * H;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st_l, (cuuint64_t)st_h,
                           (cuuint64_t)st_b};
  cuuint32_t box[4] = {(cuuint32_t)(D < 64 ? D : 64), (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map over a dense 2-d matrix of `rows` rows of `cols` elements of
// `type` (`row_bytes` apart, a multiple of 16): boxes of box_cols x
// box_rows, zeros past the ends. Returns a cudaError_t.
inline int make_map_2d(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, long long cols,
                       long long rows, long long row_bytes, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
