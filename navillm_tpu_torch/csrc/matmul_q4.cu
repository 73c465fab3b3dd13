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
// group scales [h/G, o] (bf16 or f32, widened to f32) and the sum over
// groups taken in order g = 0, 1, ... in f32. Three modes:
//   - w4:   x bf16; each group's product runs on bf16 tensor cores into a
//           fresh f32 partial;
//   - w4a8: x int8; each group's product runs on int8 tensor cores into a
//           fresh s32 partial, exact, so the result equals the plain
//           version's bit for bit;
//   - f32 x (the Pallas kernel takes it and accumulates in f32): a first
//           pass splits x into bf16 hi = bf16(x) and lo = bf16(x - hi),
//           which keep x to 2^-17 of itself (TF32 alone would keep 2^-11,
//           too little for a sum over 11008 terms); each group's partial
//           is then hi . q + lo . q on the bf16 path (the int4 values are
//           exact in bf16, so both products are exact and only the f32
//           sums round).
// The partial is scaled per column and added without FMA contraction
// (__fmul_rn, __fadd_rn), as the plain version's two separate f32 ops do;
// the scale is never folded into the dequantized weight (that would round
// it to bf16).
//
// What bounds it on the H100. The eval slice runs m ~ 3.5-4 K rows against
// 4096 x 11008 weights, ~100-400 FLOP per weight byte: the tensor cores
// bound it (int4 saves bytes, not FLOPs, so at best it matches a dense
// GEMM), and the dequantization (integer work on the CUDA cores) and the
// per-group rescale must hide behind them. They do so only in part: each
// group needs a fresh partial beside the accumulator, and two partials in
// flight do not fit the 168 registers a thread of a 384-thread block gets,
// so the rescale waits for the group's products
// (scripts/kernel_ablations.py times the parts).
//
// Design. One block per (128 rows of x, 128 output channels), three
// warpgroups:
//  - a producer warp keeps a ring of k tiles in flight (3 stages for bf16
//    x, 4 for int8): per 128-deep k tile, the x tile [128, 128] by TMA
//    (128-byte swizzle; rows past m read as zeros) and the packed weight
//    tile [128 k, 64 bytes] by TMA (by plain loads when o/2 is not a
//    multiple of 16 bytes), and the tile's group scales [G rows, 128] as
//    f32 beside them (full/empty barriers);
//  - two consumer warpgroups, 64 rows each, reading one dequantized
//    tile: per group a fresh partial of G / 16 wgmma m64n128k16 bf16 steps
//    (w4) or G / 32 m64n128k32 s8 steps into s32 (w4a8), a wait, then the
//    f32 accumulator (64 registers a thread) takes partial x scale. y is
//    written in [m, o] as bf16 or f32, masked at the edges.
//  While tile t's products are in flight, the 256 consumer threads unpack
//  tile t + 1's packed weights into the other of two dequantized tiles
//  B^T [channel][k], K-major in the wgmma layout of csrc/hopper.cuh (8-bit
//  wgmma takes K-major operands only): bf16 0x4300|t - 136 for w4,
//  sign-extended bytes for w4a8, then fence.proxy.async and a named
//  barrier of the 256 threads at the end of the tile. A thread builds
//  16-byte chunks of channels from eight (bf16) or sixteen (int8) packed
//  rows; lanes take the rows and the channels in an order that keeps the
//  shared loads and stores free of bank conflicts.

#include <type_traits>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;          // rows of x per block, 64 per consumer
constexpr int BN = 128;          // output channels per block
constexpr int KT = 128;          // k per ring stage (G divides it)
constexpr int THREADS = 384;     // two consumer warpgroups + producer
constexpr int CONSUMERS = 256;
constexpr int SLICE = 32;        // bytes of k per wgmma: 16 bf16, 32 int8

struct Params {
  CUtensorMap tx;        // x [m, h] (f32 x: its bf16 hi part)
  CUtensorMap tx2;       // f32 x: the bf16 lo part [m, h]
  CUtensorMap tw;        // q4p [h, o/2] (when w_tma)
  const uint8_t* q4p;    // [h, o/2]
  const void* s;         // [h/G, o]: bf16 or f32
  void* y;               // [m, o]: bf16 or f32
  int m, h, o, g, ng, n_tiles, w_tma;
};

template <bool INT8, bool SPLIT>
struct Smem {
  static constexpr int XB = INT8 ? 1 : 2;          // bytes per x element
  static constexpr int STAGES = INT8 ? 4 : SPLIT ? 2 : 3;
  static constexpr int xpart = BM * KT * XB;       // one x tile
  static constexpr int x_bytes = (SPLIT ? 2 : 1) * xpart;  // hi and lo
  static constexpr int b_bytes = BN * KT * XB;     // dequantized tile
  static constexpr int w_bytes = KT * BN / 2;      // packed tile
  static constexpr int sc_bytes = (KT / 16) * BN * 4;  // <= KT/16 groups
  static constexpr int x = 0;
  static constexpr int bt = x + STAGES * x_bytes;  // two buffers
  static constexpr int w = bt + 2 * b_bytes;
  static constexpr int sc = w + STAGES * w_bytes;
  static constexpr int bars = sc + STAGES * sc_bytes;
  static constexpr int bytes = bars + 2 * STAGES * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store_pair(__nv_bfloat16* y, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

// The work unit u (0 .. 255) of unpacking the packed tile `sw` ([KT k][BN
// / 2 bytes]) into the K-major tile `sb` ([BN channels][KT k], 128-byte rows
// per 64 bf16 or 128 int8 k, rows swizzled by channel % 8). Item (wc, kc):
// packed word column wc (channels 8 wc .. 8 wc + 7) and 16-byte chunk kc
// of k (KPC values); an int8 item is split over two units by channel.
template <bool INT8>
__device__ __forceinline__ void unpack_unit(const unsigned char* sw,
                                            unsigned char* sb, int u) {
  constexpr int KPC = INT8 ? 16 : 8;         // k values per chunk
  constexpr int KC = KT / KPC;               // chunks per channel row
  constexpr int ITEMS = 16 * KC;             // 256 (bf16) or 128 (int8)
  constexpr int PARTS = 256 / ITEMS;         // units per item
  const int item = u % ITEMS, part = u / ITEMS;
  const int wc = item % 16, kc = item / 16;
  // the two half-warps read rows of opposite parity (64-byte rows put
  // rows 2 apart on the same banks)
  const int flip = kc & 1;
  uint32_t w[KPC];
#pragma unroll
  for (int r = 0; r < KPC; ++r)
    w[r] = *reinterpret_cast<const uint32_t*>(
        sw + (kc * KPC + (r ^ flip)) * (BN / 2) + 4 * wc);
#pragma unroll
  for (int r = 0; r < KPC; r += 2) {
    const uint32_t a = w[r], b = w[r + 1];
    w[r] = flip ? b : a;
    w[r + 1] = flip ? a : b;
  }
  if constexpr (!INT8) {
    // bf16(128 + t) has the bits 0x4300 | t for t < 128; with t = u ^ 8,
    // (128 + t) - 136 is the nibble u read as two's complement, exactly
#pragma unroll
    for (int r = 0; r < KPC; ++r) w[r] ^= 0x88888888u;
  }
  const int block = kc / 8, pos = kc % 8;
#pragma unroll
  for (int t = part; t < 8; t += PARTS) {
    // lanes of a quarter warp write different chunk positions
    const int j = (t + wc) & 7;
    const int n = 8 * wc + j;
    const int sh = 4 * j;
    uint32_t v[4];
    if constexpr (INT8) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = ((w[4 * q] >> sh) & 0xFu) |
                     (((w[4 * q + 1] >> sh) & 0xFu) << 8) |
                     (((w[4 * q + 2] >> sh) & 0xFu) << 16) |
                     (((w[4 * q + 3] >> sh) & 0xFu) << 24);
        v[q] = x | ((x & 0x08080808u) * 0x1Eu);  // sign-extend each nibble
      }
    } else {
      const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = ((w[2 * q] >> sh) & 0xFu) |
                     (((w[2 * q + 1] >> sh) & 0xFu) << 16) | 0x43004300u;
        __nv_bfloat162 hv =
            __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x), bias);
        v[q] = *reinterpret_cast<uint32_t*>(&hv);
      }
    }
    *reinterpret_cast<uint4*>(sb + block * BN * 128 + n * 128 +
                              ((pos ^ (n % 8)) * 16)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// f32 x [n] -> bf16 hi = bf16(x), lo = bf16(x - hi), four values a thread
// (n is a multiple of 4; x, hi and lo 16-byte aligned).
__global__ void split_bf16_kernel(const float4* x, uint2* hi, uint2* lo,
                                  long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[2] = {0u, 0u}, l[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 he = __float2bfloat16_rn(f[e]);
      const __nv_bfloat16 le = __float2bfloat16_rn(f[e] -
                                                   __bfloat162float(he));
      h[e / 2] |= (uint32_t)__bfloat16_as_ushort(he) << (16 * (e % 2));
      l[e / 2] |= (uint32_t)__bfloat16_as_ushort(le) << (16 * (e % 2));
    }
    hi[i] = make_uint2(h[0], h[1]);
    lo[i] = make_uint2(l[0], l[1]);
  }
}

template <bool INT8, bool SPLIT, typename ST, typename OT>
__global__ void __launch_bounds__(THREADS, 1)
matmul_q4_kernel(const __grid_constant__ Params p) {
  using L = Smem<INT8, SPLIT>;
  using PT = typename std::conditional<INT8, int, float>::type;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024-byte boundaries (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int gpt = KT / p.g;  // groups per k tile

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // this thread's share of unpacking tile t into dequantized tile t % 2
  // (every consumer is past the products that read it before)
  auto unpack = [&](int t) {
    mbar_wait(&full[t % S], (t / S) & 1);
    unpack_unit<INT8>(smem + L::w + (t % S) * L::w_bytes,
                      smem + L::bt + (t % 2) * L::b_bytes, threadIdx.x);
    fence_proxy_async();  // the wgmmas read it after the named barrier
  };

  if (wg == 2) {
    // ------------------------------------------------------- producer --- //
    if (tid >= 32) return;
    const int lane = tid;
    const ST* sg = static_cast<const ST*>(p.s);
    const int o2 = p.o / 2;
    for (int t = 0; t < p.n_tiles; ++t) {
      const int stage = t % S;
      mbar_wait(&empty[stage], ((t / S) & 1) ^ 1);
      const int k0 = t * KT;
      // the tile's group scales in f32; 0 past o and past the last group.
      // Four loads in flight per lane before any store, so the tile pays
      // one memory latency, not four.
      float* sc = reinterpret_cast<float*>(smem + L::sc + stage * L::sc_bytes);
      for (int i0 = 0; i0 < gpt * BN; i0 += 128) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u + lane;
          const int gi = t * gpt + i / BN, col = n0 + i % BN;
          v[u] = gi < p.ng && col < p.o
                     ? to_f32(__ldg(sg + (long long)gi * p.o + col)) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[i0 + 32 * u + lane] = v[u];
      }
      unsigned char* sw = smem + L::w + stage * L::w_bytes;
      if (!p.w_tma) {
        for (int i = lane; i < KT * (BN / 2); i += 32) {
          const int k = k0 + i / (BN / 2), col = n0 / 2 + i % (BN / 2);
          sw[i] = k < p.h && col < o2 ? p.q4p[(long long)k * o2 + col] : 0;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage],
                              L::x_bytes + (p.w_tma ? L::w_bytes : 0));
        unsigned char* sx = smem + L::x + stage * L::x_bytes;
#pragma unroll
        for (int cb = 0; cb < L::XB; ++cb) {  // 128-byte column boxes
          tma_load_2d(sx + cb * BM * 128, &p.tx, &full[stage],
                      k0 + cb * (128 / L::XB), m0);
          if constexpr (SPLIT)
            tma_load_2d(sx + L::xpart + cb * BM * 128, &p.tx2, &full[stage],
                        k0 + cb * (128 / L::XB), m0);
        }
        if (p.w_tma) tma_load_2d(sw, &p.tw, &full[stage], n0 / 2, k0);
      } else {
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers --- //
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int spg = p.g * L::XB / SLICE;  // wgmma slices per group

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  PT part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part[i] = PT(0);

  unpack(0);
  named_bar_sync(1, CONSUMERS);
  for (int t = 0; t < p.n_tiles; ++t) {
    const int stage = t % S, buf = t % 2;
    const unsigned char* sxw = smem + L::x + stage * L::x_bytes + wg * 64 * 128;
    const unsigned char* sb = smem + L::bt + buf * L::b_bytes;
    const float* sc = reinterpret_cast<const float*>(smem + L::sc +
                                                     stage * L::sc_bytes);
    const int groups = min(gpt, p.ng - t * gpt);
    for (int gi = 0; gi < groups; ++gi) {
      fence_regs(part);
      wgmma_fence();
      for (int kk = gi * spg; kk < (gi + 1) * spg; ++kk) {
        const uint64_t da = desc_kmajor(sxw, kk, BM);
        const uint64_t db = desc_kmajor(sb, kk, BN);
        if constexpr (INT8)
          wgmma_ss_n128_s8(part, da, db, kk > gi * spg);
        else
          wgmma_ss_n128(part, da, db, kk > gi * spg);
      }
      if constexpr (SPLIT) {
        // the lo part into the same partial
        for (int kk = gi * spg; kk < (gi + 1) * spg; ++kk)
          wgmma_ss_n128(part, desc_kmajor(sxw + L::xpart, kk, BM),
                        desc_kmajor(sb, kk, BN), true);
      }
      wgmma_commit();
      if (gi == 0 && t + 1 < p.n_tiles) unpack(t + 1);
      wgmma_wait<0>();
      fence_regs(part);
      // accumulator column of part[i]: 8 (i / 4) + 2 quad + i % 2
      const float* sg = sc + gi * BN + 2 * quad;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sg + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(static_cast<float>(part[i]),
                                               (e & 1) ? s2.y : s2.x));
        }
      }
    }
    mbar_arrive(&empty[stage]);
    // tile t + 1 is unpacked everywhere, and every product that read tile
    // t's dequantized buffer is done before it is written again
    named_bar_sync(1, CONSUMERS);
  }

  OT* y = static_cast<OT*>(p.y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * quad;
      if (col < p.o)
        store_pair(y + (long long)row * p.o + col, acc[4 * j + 2 * r],
                   acc[4 * j + 2 * r + 1]);
    }
  }
}

template <bool INT8, bool SPLIT, typename ST, typename OT>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = Smem<INT8, SPLIT>::alloc;
  auto kernel = matmul_q4_kernel<INT8, SPLIT, ST, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.o + BN - 1) / BN, (p.m + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8, bool SPLIT, typename ST>
int launch_out(const Params& p, int out_f32, cudaStream_t stream) {
  return out_f32 ? launch<INT8, SPLIT, ST, float>(p, stream)
                 : launch<INT8, SPLIT, ST, __nv_bfloat16>(p, stream);
}

template <bool INT8, bool SPLIT>
int launch_scales(const Params& p, int s_f32, int out_f32,
                  cudaStream_t stream) {
  return s_f32 ? launch_out<INT8, SPLIT, float>(p, out_f32, stream)
               : launch_out<INT8, SPLIT, __nv_bfloat16>(p, out_f32, stream);
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/matmul_q4.py).
// x [m, h]: bf16 (x_kind = 0), int8 (1) or f32 (2; split into scratch, bf16
// [2, m, h], before the product); q4p uint8 [h, o/2]; s [h/g, o] bf16
// (s_f32 = 0) or f32; y [m, o] bf16 (y_f32 = 0) or f32. All dense and
// 16-byte aligned (s: 8). g must divide 128 and be a multiple of 16 (bf16,
// f32) or 32 (int8), h a multiple of g, o even. Returns a cudaError_t: of
// building the tensor maps, or of a launch.
extern "C" int navillm_matmul_q4(const void* x, const void* q4p, const void* s,
                                 void* y, void* scratch, int m, int h, int o,
                                 int g, int x_kind, int s_f32, int y_f32,
                                 void* stream) {
  const int x_int8 = x_kind == 1, split = x_kind == 2;
  const int step = x_int8 ? SLICE : SLICE / 2;
  if (m <= 0 || g <= 0 || KT % g || g % step || h % g || o <= 0 || o % 2 ||
      (m + BM - 1) / BM > 65535 || x_kind < 0 || x_kind > 2 ||
      (split && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  const int xb = x_int8 ? 1 : 2;
  const void* xt = split ? scratch : x;
  int err = bind_context();
  if (!err && split) {
    const long long n4 = (long long)m * h / 4;
    const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256
                                                         : 132 * 16);
    split_bf16_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const float4*>(x), static_cast<uint2*>(scratch),
        static_cast<uint2*>(scratch) + n4, n4);
    err = static_cast<int>(cudaGetLastError());
  }
  if (!err)
    err = make_map_2d(&p.tx, xt,
                        x_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        h, m, (long long)h * xb, 128 / xb, BM,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err && split)
    err = make_map_2d(&p.tx2,
                      static_cast<const __nv_bfloat16*>(scratch) +
                          (long long)m * h,
                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, m,
                      (long long)h * 2, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  p.w_tma = (o / 2) % 16 == 0;
  if (!err && p.w_tma)
    err = make_map_2d(&p.tw, q4p, CU_TENSOR_MAP_DATA_TYPE_UINT8, o / 2, h,
                      o / 2, BN / 2, KT, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  p.q4p = static_cast<const uint8_t*>(q4p);
  p.s = s;
  p.y = y;
  p.m = m;
  p.h = h;
  p.o = o;
  p.g = g;
  p.ng = h / g;
  p.n_tiles = (h + KT - 1) / KT;
  if (x_int8) return launch_scales<true, false>(p, s_f32, y_f32, st);
  return split ? launch_scales<false, true>(p, s_f32, y_f32, st)
               : launch_scales<false, false>(p, s_f32, y_f32, st);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
