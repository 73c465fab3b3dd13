// Flash-attention forward for Hopper (sm_90a): bf16 Q/K/V in, bf16 O and
// f32 log-sum-exp rows out.
//
// Replaces navillm_tpu/ops/attention.py::_flash_kernel, the Pallas TPU
// kernel that serves every layer of llama.forward_hidden. It computes the
// same function, not a block-by-block copy: masked multi-head attention,
// optionally causal, with an online softmax in f32 so the [T, S] score
// matrix never reaches device memory.
//
// Layout. Q is read as [B, T, NH, D] and K/V as [B, S, NKV, D] through
// their strides (the last dimension must be dense), so neither the
// model's head split nor the GQA broadcast is ever materialised: query
// head h reads kv head h / (NH / NKV). One block handles one 64-row query
// tile of one (batch, head); its four warps own 16 rows each and loop over
// 64-key tiles.
//
// Masking. A key hidden by kv_mask (or above the diagonal under causal)
// scores NEG_INF = -1e30, a finite value, exactly as in the JAX code. Keys
// at index >= S (tile padding) are excluded outright. Prompts are left
// padded, so under causal attention the first rows of a padded prompt see
// no valid key: with finite NEG_INF their softmax is a uniform average of
// the V rows they visited, which keeps them finite. Those rows are
// don't-care for the model, but their V rows feed later layers at masked
// keys with p = 0, and 0 * NaN would poison the real tokens.
//
// What bounds it on the H100. Per (query tile, key tile) the block does
// two 64x64xD products (QK^T and PV) on bf16 WMMA fragments, so at the
// slice's shapes (T <= 1024, D = 128) the work is compute bound. This
// first version is plain: 16x16x16 WMMA (mma.sync) rather than wgmma, one
// synchronous tile load per step rather than a TMA ring, and the output
// accumulator kept in shared memory in f32 so each tile's rescale by
// exp(m_old - m_new) is a plain per-row loop. It needs ~110 KB of shared
// memory at D = 128, so the launcher raises the dynamic shared-memory cap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;             // query rows per block, 16 per warp
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;             // bf16 per 16-byte load
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;  // [B, S] key validity (bool)
  __nv_bfloat16* o;     // [B, T, NH, D]
  float* lse;           // [B, NH, T]
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long m_sb;
  long long o_sb, o_st, o_sh;
  int T, S, NH, group;  // group = NH / NKV
  float scale;
  int causal;
};

// Shared-memory carve-up. Row pitches are padded (+8 bf16, +4 f32) to
// spread the WMMA row accesses over the banks; every region size is a
// multiple of 128 bytes, so every WMMA pointer stays 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // Q/K/V tiles, bf16
  static constexpr int LDS = BK + 4;  // scores, f32
  static constexpr int LDP = BK + 8;  // probabilities, bf16
  static constexpr int LDO = D + 4;   // output accumulator, f32
  static constexpr size_t q = size_t(BQ) * LDH * 2;
  static constexpr size_t k = size_t(BK) * LDH * 2;
  static constexpr size_t v = size_t(BK) * LDH * 2;
  static constexpr size_t s = size_t(BQ) * LDS * 4;
  static constexpr size_t p = size_t(BQ) * LDP * 2;
  static constexpr size_t o = size_t(BQ) * LDO * 4;
  static constexpr size_t key = size_t(BK) * 4;
  static constexpr size_t bytes = q + k + v + s + p + o + key;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params prm) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::q + L::k);
  float* sS = reinterpret_cast<float*>(smem + L::q + L::k + L::v);
  __nv_bfloat16* sP =
      reinterpret_cast<__nv_bfloat16*>(smem + L::q + L::k + L::v + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::q + L::k + L::v + L::s + L::p);
  int* sKey = reinterpret_cast<int*>(smem + L::q + L::k + L::v + L::s + L::p +
                                     L::o);

  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / prm.NH;
  const int h = blockIdx.y % prm.NH;
  const int kvh = h / prm.group;
  const int q0 = blockIdx.x * BQ;

  const __nv_bfloat16* qg = prm.q + b * prm.q_sb + h * prm.q_sh;
  const __nv_bfloat16* kg = prm.k + b * prm.k_sb + kvh * prm.k_sh;
  const __nv_bfloat16* vg = prm.v + b * prm.v_sb + kvh * prm.v_sh;
  const uint8_t* mg = prm.mask + b * prm.m_sb;

  // Q tile (rows past T are zero) and a zeroed output accumulator.
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < prm.T)
      val = *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * prm.q_st + c);
    *reinterpret_cast<uint4*>(sQ + r * L::LDH + c) = val;
  }
  for (int i = tid; i < BQ * L::LDO; i += THREADS) sO[i] = 0.f;
  __syncthreads();

  // This warp's 16 query rows stay in registers for the whole loop.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);

  // Softmax bookkeeping: two lanes per row, each owning half the columns.
  const int row = warp * 16 + lane / 2;  // row within the block's tile
  const int half = lane % 2;
  const int qi = q0 + row;               // absolute query index
  float m_run = -INFINITY;
  float l_run = 0.f;

  int n_tiles = (prm.S + BK - 1) / BK;
  if (prm.causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V/key flags are consumed
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < prm.S) {
        kv = *reinterpret_cast<const uint4*>(kg + (long long)(k0 + r) * prm.k_st + c);
        vv = *reinterpret_cast<const uint4*>(vg + (long long)(k0 + r) * prm.v_st + c);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LDH + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * L::LDH + c) = vv;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      // -1: tile padding (excluded), 0: masked (NEG_INF), 1: valid
      sKey[tid] = key >= prm.S ? -1 : (mg[key] ? 1 : 0);
    }
    __syncthreads();

    // S = Q K^T for this warp's rows (K^T read column-major from sK).
    {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(kb, sK + n * 16 * L::LDH + kk * 16, L::LDH);
          wmma::mma_sync(acc, qa[kk], kb, acc);
        }
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc, L::LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // Online softmax over this tile, then rescale the row's accumulator.
    {
      const float* srow = sS + row * L::LDS;
      float sl[BK / 2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int col = half * (BK / 2) + j;
        const int flag = sKey[col];
        float s = srow[col] * prm.scale;
        if (flag == 0 || (prm.causal && k0 + col > qi)) s = NEG_INF;
        if (flag < 0) s = -INFINITY;
        sl[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      // finite: column 0 of every tile is a key < S
      const float m_new = fmaxf(m_run, mx);
      const float alpha = m_run == -INFINITY ? 0.f : __expf(m_run - m_new);
      float sum = 0.f;
      __nv_bfloat16* prow = sP + row * L::LDP + half * (BK / 2);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float e = sl[j] == -INFINITY ? 0.f : __expf(sl[j] - m_new);
        sum += e;
        prow[j] = __float2bfloat16(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      float* orow = sO + row * L::LDO + half * (D / 2);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's rows.
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + warp * 16 * L::LDP + kk * 16, L::LDP);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* optr = sO + warp * 16 * L::LDO + n * 16;
        wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(vb, sV + kk * 16 * L::LDH + n * 16, L::LDH);
          wmma::mma_sync(acc, pa[kk], vb, acc);
        }
        wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
      }
    }
  }
  __syncwarp();

  if (qi < prm.T) {
    const float l_safe = l_run > 0.f ? l_run : 1.f;
    const float* orow = sO + row * L::LDO + half * (D / 2);
    __nv_bfloat16* og = prm.o + b * prm.o_sb + (long long)qi * prm.o_st +
                        h * prm.o_sh + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += VEC) {
      union {
        uint4 u;
        __nv_bfloat162 h2[VEC / 2];
      } packed;
#pragma unroll
      for (int e = 0; e < VEC / 2; ++e)
        packed.h2[e] = __floats2bfloat162_rn(orow[j + 2 * e] / l_safe,
                                             orow[j + 2 * e + 1] / l_safe);
      *reinterpret_cast<uint4*>(og + j) = packed.u;
    }
    if (half == 0)
      prm.lse[((long long)b * prm.NH + h) * prm.T + qi] =
          l_run > 0.f ? m_run + logf(l_safe) : NEG_INF;
  }
}

template <int D>
int launch(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = static_cast<int>(Smem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.T + BQ - 1) / BQ, batch * prm.NH);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py).
// Strides are in elements. Returns the cudaError_t of the launch.
extern "C" int navillm_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int T, int S, int NH, int NKV, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long m_sb,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, void* stream) {
  Params prm;
  prm.q = static_cast<const __nv_bfloat16*>(q);
  prm.k = static_cast<const __nv_bfloat16*>(k);
  prm.v = static_cast<const __nv_bfloat16*>(v);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.lse = static_cast<float*>(lse);
  prm.q_sb = q_sb; prm.q_st = q_st; prm.q_sh = q_sh;
  prm.k_sb = k_sb; prm.k_st = k_st; prm.k_sh = k_sh;
  prm.v_sb = v_sb; prm.v_st = v_st; prm.v_sh = v_sh;
  prm.m_sb = m_sb;
  prm.o_sb = o_sb; prm.o_st = o_st; prm.o_sh = o_sh;
  prm.T = T; prm.S = S; prm.NH = NH; prm.group = NH / NKV;
  prm.scale = scale;
  prm.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(prm, B, s);
  if (D == 128) return launch<128>(prm, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
