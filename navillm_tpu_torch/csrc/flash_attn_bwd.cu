// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in and
// out, f32 accumulation.
//
// Replaces navillm_tpu/ops/attention.py::_flash_bwd_dkv_kernel, the Pallas
// TPU kernel of the JAX package's fused backward (_flash_backward) that
// computes dK and dV; its twin for dQ is csrc/flash_attn_bwd_dq.cu. It
// recomputes the attention probabilities tile by tile from the forward
// kernel's log-sum-exp rows, P = exp(Q K^T * scale - lse), so the [T, S]
// matrix never reaches device memory, and takes delta = rowsum(O * dO),
// computed beside it in f32, as the JAX code does:
//   dV = P^T dO;  dS = P * (dO V^T - delta) * scale;  dK = dS^T Q.
//
// Masking follows the JAX kernel's rule. P is exactly zero where the key is
// hidden by kv_mask, above the diagonal under causal, past S (tile padding),
// past T (query padding), or where the query row's lse <= NEG_INF / 2: a row
// that saw no valid key in the forward (left padding under causal) has
// lse ~ NEG_INF there, so it adds nothing to dK/dV.
//
// Layout. Q/dO are read as [B, T, NH, D] and K/V/dK/dV as [B, S, NKV, D]
// through their strides (dense last dimension), lse and delta as dense f32
// [B, NH, T]. Under grouped-query attention the block of kv head g loops
// over its NH / NKV query heads and sums them itself.
//
// Blocks: one per 64-key tile of one (batch, kv head); its four warps own
// 16 keys each and loop over 64-row query tiles, starting at the first tile
// that can see the key tile under causal. Every product is a 16x16x16 bf16
// WMMA (mma.sync) with f32 accumulation; scores, dP and the dK/dV
// accumulators live in shared memory, where the element-wise step (masks,
// exp, dS) is a per-row loop.
//
// What bounds it on the H100: per (query tile, key tile) it does four
// 64x64xD products, so at the training shapes (T ~ 1024, D = 128) it is
// compute bound on the tensor cores. This first version is plain: mma.sync
// rather than wgmma, synchronous tile loads rather than a TMA ring, and
// shared-memory accumulators (~185 KB at D = 128, one block per SM), so the
// launcher raises the dynamic shared-memory cap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;             // bf16 per 16-byte load
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;  // [B, S] key validity (bool)
  const bf16* dout;     // [B, T, NH, D]
  const float* lse;     // [B, NH, T]
  const float* delta;   // [B, NH, T]
  bf16* dk;             // [B, S, NKV, D]
  bf16* dv;             // [B, S, NKV, D]
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long m_sb;
  long long do_sb, do_st, do_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int T, S, NH, NKV, group;  // group = NH / NKV
  float scale;
  int causal;
};

// Row pitches are padded (+8 bf16, +4 f32) to spread WMMA row accesses over
// the banks; every region is a multiple of 128 bytes, so every WMMA pointer
// stays 32-byte aligned.
template <int D>
struct Pitch {
  static constexpr int H = D + 8;   // [64, D] bf16 tiles
  static constexpr int S = 64 + 4;  // [64, 64] f32 scores / dP
  static constexpr int P = 64 + 8;  // [64, 64] bf16 P / dS
  static constexpr int O = D + 4;   // [64, D] f32 accumulators
  static constexpr size_t tile_h = size_t(64) * H * 2;
  static constexpr size_t tile_s = size_t(64) * S * 4;
  static constexpr size_t tile_p = size_t(64) * P * 2;
  static constexpr size_t tile_o = size_t(64) * O * 4;
  static constexpr size_t row_f = size_t(64) * 4;  // 64 floats or ints
};

// dK/dV kernel: K, V, Q, dO tiles; S^T, dP^T; P^T, dS^T; dK, dV; lse,
// delta, query flags, key flags.
template <int D>
struct DkvSmem {
  using P = Pitch<D>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + P::tile_h;
  static constexpr size_t q = v + P::tile_h;
  static constexpr size_t dout = q + P::tile_h;
  static constexpr size_t s = dout + P::tile_h;
  static constexpr size_t dp = s + P::tile_s;
  static constexpr size_t p = dp + P::tile_s;
  static constexpr size_t ds = p + P::tile_p;
  static constexpr size_t dk = ds + P::tile_p;
  static constexpr size_t dv = dk + P::tile_o;
  static constexpr size_t lse = dv + P::tile_o;
  static constexpr size_t delta = lse + P::row_f;
  static constexpr size_t qf = delta + P::row_f;
  static constexpr size_t kf = qf + P::row_f;
  static constexpr size_t bytes = kf + P::row_f;
};

// Copy rows [r0, r0 + 64) of a strided [rows, D] bf16 matrix into a padded
// shared tile; rows at or past n_rows are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0,
                                          int n_rows) {
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Pitch<D>::H + c) = val;
  }
}

// Store this thread's half of one accumulator row (f32, shared) as bf16.
template <int D>
__device__ __forceinline__ void store_row_half(bf16* dst, const float* row) {
#pragma unroll
  for (int j = 0; j < D / 2; j += VEC) {
    union {
      uint4 u;
      __nv_bfloat162 h2[VEC / 2];
    } packed;
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e)
      packed.h2[e] = __floats2bfloat162_rn(row[j + 2 * e], row[j + 2 * e + 1]);
    *reinterpret_cast<uint4*>(dst + j) = packed.u;
  }
}

// acc[16, 64] (shared, f32, pitch Pitch::S) = A[16, D] . B^T where A is
// held in fragments and B is 64 rows of a padded bf16 tile (read as a
// column-major [D, 64] matrix).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(
    float* out,
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> (&a)[D / 16],
    const bf16* tile) {
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(bt, tile + n * 16 * Pitch<D>::H + kk * 16, Pitch<D>::H);
      wmma::mma_sync(acc, a[kk], bt, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, Pitch<D>::S, wmma::mem_row_major);
  }
}

// acc[16, D] (shared, f32, pitch Pitch::O) += A[16, 64] . B[64, D] where A
// is 16 rows of a bf16 [.., 64] shared matrix (pitch Pitch::P) and B a
// padded bf16 tile read row-major.
template <int D>
__device__ __forceinline__ void accumulate_rows_times_tile(
    float* acc_rows, const bf16* a_rows, const bf16* tile) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[64 / 16];
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wmma::load_matrix_sync(a[kk], a_rows + kk * 16, Pitch<D>::P);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float* ptr = acc_rows + n * 16;
    wmma::load_matrix_sync(acc, ptr, Pitch<D>::O, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      wmma::load_matrix_sync(b, tile + kk * 16 * Pitch<D>::H + n * 16, Pitch<D>::H);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(ptr, acc, Pitch<D>::O, wmma::mem_row_major);
  }
}

// Per-query-row statistics of one 64-row tile: lse, delta, and whether the
// row takes part (inside T and saw a valid key in the forward).
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_delta,
                                               int* s_qf, const float* lse,
                                               const float* delta, int q0,
                                               int T) {
  if (threadIdx.x < 64) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < T;
    const float l = in ? lse[qi] : 0.f;
    s_lse[threadIdx.x] = l;
    s_delta[threadIdx.x] = in ? delta[qi] : 0.f;
    s_qf[threadIdx.x] = in && l > NEG_INF / 2;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Params prm) {
  using L = DkvSmem<D>;
  using PT = Pitch<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);
  int* sQf = reinterpret_cast<int*>(smem + L::qf);
  int* sKf = reinterpret_cast<int*>(smem + L::kf);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / prm.NKV;
  const int kvh = blockIdx.y % prm.NKV;
  const int k0 = blockIdx.x * BK;

  load_tile<D>(sK, prm.k + b * prm.k_sb + kvh * prm.k_sh, prm.k_st, k0, prm.S);
  load_tile<D>(sV, prm.v + b * prm.v_sb + kvh * prm.v_sh, prm.v_st, k0, prm.S);
  if (tid < BK) {
    const int key = k0 + tid;
    sKf[tid] = key < prm.S && prm.mask[b * prm.m_sb + key] != 0;
  }
  for (int i = tid; i < 64 * PT::O; i += THREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  __syncthreads();

  // This warp's 16 keys (K and V rows) stay in registers.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ka[D / 16], va[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], sK + warp * 16 * PT::H + kk * 16, PT::H);
    wmma::load_matrix_sync(va[kk], sV + warp * 16 * PT::H + kk * 16, PT::H);
  }

  // Element-wise step: two lanes per key row, each owning half the columns.
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int key = k0 + row;
  const bool key_ok = sKf[row] != 0;
  const int first = prm.causal ? k0 / BQ : 0;
  const int n_q_tiles = (prm.T + BQ - 1) / BQ;

  for (int g = 0; g < prm.group; ++g) {
    const int h = kvh * prm.group + g;
    const bf16* qg = prm.q + b * prm.q_sb + h * prm.q_sh;
    const bf16* dog = prm.dout + b * prm.do_sb + h * prm.do_sh;
    const float* lse = prm.lse + ((long long)b * prm.NH + h) * prm.T;
    const float* delta = prm.delta + ((long long)b * prm.NH + h) * prm.T;
    for (int qt = first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q/dO/row stats are consumed
      load_tile<D>(sQ, qg, prm.q_st, q0, prm.T);
      load_tile<D>(sDO, dog, prm.do_st, q0, prm.T);
      load_row_stats(sLse, sDelta, sQf, lse, delta, q0, prm.T);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's keys.
      rows_times_tile_t<D>(sS + warp * 16 * PT::S, ka, sQ);
      rows_times_tile_t<D>(sDP + warp * 16 * PT::S, va, sDO);
      __syncwarp();

      {
        const float* srow = sS + row * PT::S;
        const float* dprow = sDP + row * PT::S;
        bf16* prow = sP + row * PT::P;
        bf16* dsrow = sDS + row * PT::P;
#pragma unroll 8
        for (int j = 0; j < BQ / 2; ++j) {
          const int c = half * (BQ / 2) + j;
          float p = 0.f;
          if (key_ok && sQf[c] && (!prm.causal || key <= q0 + c))
            p = __expf(srow[c] * prm.scale - sLse[c]);
          prow[c] = __float2bfloat16(p);
          dsrow[c] = __float2bfloat16(p * (dprow[c] - sDelta[c]) * prm.scale);
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q for this warp's keys.
      accumulate_rows_times_tile<D>(sDV + warp * 16 * PT::O, sP + warp * 16 * PT::P, sDO);
      accumulate_rows_times_tile<D>(sDK + warp * 16 * PT::O, sDS + warp * 16 * PT::P, sQ);
    }
  }
  __syncwarp();

  if (key < prm.S) {
    store_row_half<D>(prm.dk + b * prm.dk_sb + (long long)key * prm.dk_st +
                          kvh * prm.dk_sh + half * (D / 2),
                      sDK + row * PT::O + half * (D / 2));
    store_row_half<D>(prm.dv + b * prm.dv_sb + (long long)key * prm.dv_st +
                          kvh * prm.dv_sh + half * (D / 2),
                      sDV + row * PT::O + half * (D / 2));
  }
}

template <int D>
int launch_dkv(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = static_cast<int>(DkvSmem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.S + BK - 1) / BK, batch * prm.NKV);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* mask, const void* dout, const void* lse,
                   const void* delta, int T, int S, int NH, int NKV,
                   const long long* st, float scale, int causal) {
  Params prm;
  prm.q = static_cast<const bf16*>(q);
  prm.k = static_cast<const bf16*>(k);
  prm.v = static_cast<const bf16*>(v);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.dout = static_cast<const bf16*>(dout);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.dk = nullptr;
  prm.dv = nullptr;
  prm.q_sb = st[0]; prm.q_st = st[1]; prm.q_sh = st[2];
  prm.k_sb = st[3]; prm.k_st = st[4]; prm.k_sh = st[5];
  prm.v_sb = st[6]; prm.v_st = st[7]; prm.v_sh = st[8];
  prm.m_sb = st[9];
  prm.do_sb = st[10]; prm.do_st = st[11]; prm.do_sh = st[12];
  prm.dk_sb = prm.dk_st = prm.dk_sh = 0;
  prm.dv_sb = prm.dv_st = prm.dv_sh = 0;
  prm.T = T; prm.S = S; prm.NH = NH; prm.NKV = NKV; prm.group = NH / NKV;
  prm.scale = scale;
  prm.causal = causal;
  return prm;
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py).
// `in_strides` holds 13 element strides: q (b, t, h), k (b, s, h),
// v (b, s, h), mask (b), dout (b, t, h). Launches one kernel on `stream` and
// returns the cudaError_t of the launch.
extern "C" int navillm_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int T, int S, int NH, int NKV, int D, const long long* in_strides,
    long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh,
    float scale, int causal, void* stream) {
  Params prm = make_params(q, k, v, mask, dout, lse, delta, T, S, NH, NKV,
                           in_strides, scale, causal);
  prm.dk = static_cast<bf16*>(dk);
  prm.dv = static_cast<bf16*>(dv);
  prm.dk_sb = dk_sb; prm.dk_st = dk_st; prm.dk_sh = dk_sh;
  prm.dv_sb = dv_sb; prm.dv_st = dv_st; prm.dv_sh = dv_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkv<64>(prm, B, s);
  if (D == 128) return launch_dkv<128>(prm, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
