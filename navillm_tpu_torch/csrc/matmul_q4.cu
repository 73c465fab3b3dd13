// int4 dequant-matmul for Hopper (sm_90a): y = x @ dequant(q4p, s).
//
// Replaces navillm_tpu/ops/matmul_q4.py::_mm4_kernel, the Pallas TPU kernel
// behind every layer matmul (wq wk wv wo w_gate w_up w_down) of the int4
// eval path. It computes the same function, not a block-by-block copy:
//
//   y[r, c] = sum_g float(x[r, gG:(g+1)G] . q[gG:(g+1)G, c]) * s[g, c]
//
// with q the int4 values of q4p (uint8 [h, o/2], byte b holds output
// channels 2b (low nibble) and 2b+1 (high nibble), two's complement), s the
// group scales [h/G, o] (bf16 or f32, widened in registers) and the sum over
// groups taken in order g = 0, 1, ... in f32. Two modes:
//   - w4:   x bf16; each group's product runs on bf16 tensor cores
//           (mma.sync m16n8k16) into an f32 partial;
//   - w4a8: x int8; each group's product runs on int8 tensor cores
//           (mma.sync m16n8k32) into an s32 partial, exact, so the result
//           equals the plain version's bit for bit.
// The partial is scaled per column and added without FMA contraction
// (__fmul_rn, __fadd_rn), as the plain version's two separate f32 ops do.
//
// Layout. The TPU kernel wrote an even/odd [m, 2, o/2] output that the
// caller transposed back, to dodge a lane shuffle. Here each block unpacks
// its packed tile into shared memory in natural channel order, as
// B^T [channel][k] (the "col" operand of mma.sync), and writes y [m, o]
// directly: no transpose pass.
//
// Blocking. One block of 8 warps per (128-row tile of x, 128-channel tile
// of o); warps are 4 x 2, each owning 32 rows x 64 channels (2 x 8 mma
// tiles). The block loops over the h/G groups. Per group: the x tile
// [128, G] arrives by cp.async into one of two shared stages while the
// previous group computes; the packed tile [G, 64 bytes] is prefetched into
// registers one group ahead and unpacked into shared memory (bf16 via
// 0x4300|nibble minus 136, int8 by sign-extending four nibbles per word).
// Operands reach the tensor cores through ldmatrix; rows are padded by 16
// bytes so both ldmatrix and the unpack's stores are free of bank conflicts.
//
// What bounds it on the H100. The eval slice runs m ~ 3.5-4 K rows against
// 4096 x 11008 weights, ~100-400 FLOP per weight byte: compute bound. int4
// saves bytes and no FLOPs, so this kernel can at best match a dense bf16
// GEMM and is simple first: mma.sync rather than wgmma, register prefetch
// and a two-stage cp.async ring rather than TMA, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // rows of x per block
constexpr int BN = 128;  // output channels per block
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 channels per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int KSTEP = 32;         // bytes of k per mma: 16 bf16 or 32 int8
constexpr int PAD = 16;           // shared row padding, bytes
constexpr int MAX_G = 128;        // largest group the unpack covers in one pass

struct Params {
  const void* x;       // [m, h], rows dense: bf16 or int8
  const uint8_t* q4p;  // [h, o/2]
  const void* s;       // [h/G, o]: bf16 or f32
  void* y;             // [m, o]: bf16 or f32
  int m, h, o, g;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 load_scales(const __nv_bfloat16* s) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
}

__device__ __forceinline__ float2 load_scales(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* y, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

// The packed bytes one thread unpacks per group, loaded a group ahead.
// bf16 mode: rows k, k+1 (k = 2 * kp), 16 bytes each = 32 channels.
// int8 mode: rows k..k+3 (k = 4 * kp), 8 bytes each = 16 channels.
template <bool INT8>
struct PackedItem {
  static constexpr int ROWS = INT8 ? 4 : 2;
  static constexpr int BYTES = INT8 ? 8 : 16;  // per row
  static constexpr int CHUNKS = (BN / 2) / BYTES;
};

// Load the item (kp, chunk) of group gi into raw[8]; bytes past o/2 read 0.
template <bool INT8>
__device__ __forceinline__ void load_packed(const Params& p, int gi, int n0,
                                            int tid, uint32_t (&raw)[8]) {
  using I = PackedItem<INT8>;
  const int per_chunk = p.g / I::ROWS;
  const int o2 = p.o / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) raw[i] = 0u;
  if (tid >= per_chunk * I::CHUNKS) return;
  const int kp = tid % per_chunk, chunk = tid / per_chunk;
  const int col = n0 / 2 + chunk * I::BYTES;
  const bool vec = (o2 % I::BYTES == 0) && (col + I::BYTES <= o2);
#pragma unroll
  for (int r = 0; r < I::ROWS; ++r) {
    const long long k = (long long)gi * p.g + (long long)kp * I::ROWS + r;
    const uint8_t* src = p.q4p + k * o2 + col;
    uint32_t* dst = raw + r * (I::BYTES / 4);
    if (vec) {
      if constexpr (INT8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        dst[0] = v.x;
        dst[1] = v.y;
      } else {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
#pragma unroll
      for (int b = 0; b < I::BYTES; ++b)  // unrolled: raw stays in registers
        if (col + b < o2)
          dst[b / 4] |= uint32_t(__ldg(src + b)) << (8 * (b % 4));
    }
  }
}

// Unpack raw into sB [channel][k] (row pitch `pitch` bytes).
template <bool INT8>
__device__ __forceinline__ void unpack(const Params& p, int tid,
                                       const uint32_t (&raw)[8],
                                       unsigned char* sB, int pitch) {
  using I = PackedItem<INT8>;
  const int per_chunk = p.g / I::ROWS;
  if (tid >= per_chunk * I::CHUNKS) return;
  const int kp = tid % per_chunk, chunk = tid / per_chunk;
  // each thread writes one 32-bit word per channel: its ROWS consecutive k
  unsigned char* base = sB + kp * 4;
  if constexpr (INT8) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t v = ((raw[w] >> (4 * i)) & 0xFu) |
                     (((raw[2 + w] >> (4 * i)) & 0xFu) << 8) |
                     (((raw[4 + w] >> (4 * i)) & 0xFu) << 16) |
                     (((raw[6 + w] >> (4 * i)) & 0xFu) << 24);
        v |= (v & 0x08080808u) * 0x1Eu;  // sign-extend each nibble to a byte
        const int n = chunk * 16 + w * 8 + i;
        *reinterpret_cast<uint32_t*>(base + n * pitch) = v;
      }
    }
  } else {
    // bf16(128 + t) has the bits 0x4300 | t for t < 128; with t = u ^ 8,
    // (128 + t) - 136 is the nibble u read as two's complement, exactly
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t a0 = raw[w] ^ 0x88888888u;
      const uint32_t a1 = raw[4 + w] ^ 0x88888888u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t v = ((a0 >> (4 * i)) & 0xFu) |
                     (((a1 >> (4 * i)) & 0xFu) << 16) | 0x43004300u;
        __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   bias);
        const int n = chunk * 32 + w * 8 + i;
        *reinterpret_cast<__nv_bfloat162*>(base + n * pitch) = h;
      }
    }
  }
}

template <bool INT8, typename ST, typename OT>
__global__ void __launch_bounds__(THREADS, 1) matmul_q4_kernel(const Params p) {
  using PT = typename std::conditional<INT8, int, float>::type;
  constexpr int XB = INT8 ? 1 : 2;  // bytes per x (and unpacked w) element
  extern __shared__ __align__(128) unsigned char smem[];
  const int rowbytes = p.g * XB;
  const int pitch = rowbytes + PAD;
  unsigned char* sX = smem;                     // 2 stages of [BM][pitch]
  unsigned char* sB = smem + 2 * BM * pitch;    // [BN][pitch]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ng = p.h / p.g;
  const int grp = lane / 4, tig = lane % 4;

  const unsigned char* xg = static_cast<const unsigned char*>(p.x);
  const long long xrow = (long long)p.h * XB;
  const int chunks = rowbytes / 16;

  auto load_x = [&](int gi, int stage) {
    unsigned char* dst = sX + stage * BM * pitch;
    for (int idx = tid; idx < BM * chunks; idx += THREADS) {
      const int r = idx / chunks, c = idx % chunks;
      const int row = m0 + r;
      const unsigned char* src =
          xg + (long long)min(row, p.m - 1) * xrow + (long long)gi * rowbytes +
          c * 16;
      cp_async16(smem_u32(dst + r * pitch + c * 16), src, row < p.m ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint32_t raw[8];
  load_x(0, 0);
  cp_async_commit();
  load_packed<INT8>(p, 0, n0, tid, raw);

  const ST* sg = static_cast<const ST*>(p.s);
  for (int gi = 0; gi < ng; ++gi) {
    const int stage = gi & 1;
    // sB is free here: the last group ended with a barrier
    unpack<INT8>(p, tid, raw, sB, pitch);
    const bool more = gi + 1 < ng;
    if (more) {
      load_x(gi + 1, stage ^ 1);
      cp_async_commit();
      load_packed<INT8>(p, gi + 1, n0, tid, raw);
    }
    float sc[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WN + j * 8 + tig * 2;
      float2 v = make_float2(0.f, 0.f);
      if (col < p.o) v = load_scales(sg + (long long)gi * p.o + col);
      sc[j][0] = v.x;
      sc[j][1] = v.y;
    }
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    PT part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = PT(0);

    const unsigned char* xs = sX + stage * BM * pitch;
    for (int kb = 0; kb < rowbytes; kb += KSTEP) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], smem_u32(xs + (wm * WM + i * 16 + (lane & 15)) *
                                            pitch +
                                   kb + (lane >> 4) * 16));
      uint32_t b[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        const int mi = lane >> 3;
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(sB + (wn * WN + jj * 16 + (mi >> 1) * 8 +
                                      (lane & 7)) * pitch +
                                kb + (mi & 1) * 16));
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(part[i][j], a[i], b[j]);
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(
              acc[i][j][e], __fmul_rn(static_cast<float>(part[i][j][e]),
                                      sc[j][e & 1]));
    __syncthreads();  // every warp is done with sB and this x stage
  }

  OT* y = static_cast<OT*>(p.y);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + i * 16 + grp + half * 8;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + tig * 2;
        if (col < p.o)
          store_pair(y + (long long)row * p.o + col, acc[i][j][2 * half],
                     acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <bool INT8, typename ST, typename OT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int XB = INT8 ? 1 : 2;
  const int bytes = 3 * BM * (p.g * XB + PAD);
  auto kernel = matmul_q4_kernel<INT8, ST, OT>;
  static int max_bytes = 0;  // the attribute only grows
  if (bytes > max_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_bytes = bytes;
  }
  const dim3 grid((p.o + BN - 1) / BN, (p.m + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8, typename ST>
int launch_out(const Params& p, int out_f32, cudaStream_t stream) {
  return out_f32 ? launch<INT8, ST, float>(p, stream)
                 : launch<INT8, ST, __nv_bfloat16>(p, stream);
}

template <bool INT8>
int launch_scales(const Params& p, int s_f32, int out_f32,
                  cudaStream_t stream) {
  return s_f32 ? launch_out<INT8, float>(p, out_f32, stream)
               : launch_out<INT8, __nv_bfloat16>(p, out_f32, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/matmul_q4.py).
// x [m, h] bf16 (x_int8 = 0) or int8 (x_int8 = 1); q4p uint8 [h, o/2];
// s [h/g, o] bf16 (s_f32 = 0) or f32; y [m, o] bf16 (y_f32 = 0) or f32. All
// dense and 16-byte aligned (s: 8). g must be a multiple of 16 (bf16) or 32
// (int8) and at most 128, h a multiple of g, o even. Returns the
// cudaError_t of the launch.
extern "C" int navillm_matmul_q4(const void* x, const void* q4p, const void* s,
                                 void* y, int m, int h, int o, int g,
                                 int x_int8, int s_f32, int y_f32,
                                 void* stream) {
  const int align = x_int8 ? KSTEP : KSTEP / 2;
  if (m <= 0 || g <= 0 || g > MAX_G || g % align || h % g || o <= 0 || o % 2 ||
      (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.q4p = static_cast<const uint8_t*>(q4p);
  p.s = s;
  p.y = y;
  p.m = m;
  p.h = h;
  p.o = o;
  p.g = g;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_int8 ? launch_scales<true>(p, s_f32, y_f32, st)
                : launch_scales<false>(p, s_f32, y_f32, st);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
