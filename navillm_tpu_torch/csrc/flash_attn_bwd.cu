// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in and
// out, f32 accumulation.
//
// Replaces navillm_tpu/ops/attention.py::_flash_bwd_dkv_kernel, the Pallas
// TPU kernel of the JAX package's fused backward (_flash_backward) that
// computes dK and dV; its twin for dQ is csrc/flash_attn_bwd_dq.cu, which
// runs first on the same stream and writes delta = rowsum(O * dO) (f32)
// that this kernel reads. It recomputes the attention probabilities tile by
// tile from the forward kernel's log-sum-exp rows, P = exp(Q K^T * scale -
// lse), so the [T, S] matrix never reaches device memory:
//   dV = P^T dO;  dS = P * (dO V^T - delta) * scale;  dK = dS^T Q.
//
// Masking follows the JAX kernel's rule. P is exactly zero where the key is
// hidden by kv_mask, above the diagonal under causal, past S (tile padding),
// past T (query padding), or where the query row's lse <= NEG_INF / 2: a row
// that saw no valid key in the forward (left padding under causal) has
// lse ~ NEG_INF there, so it adds exactly nothing to dK/dV.
//
// Layout. Q/dO are read as [B, T, NH, D] and K/V/dK/dV as [B, S, NKV, D]
// through their strides (dense last dimension; Q, dO, K and V by TMA tensor
// maps), lse and delta as dense f32 [B, NH, T]. D is 64 or 128.
//
// Design: key-stationary, on the pipeline of the forward and dQ kernels
// (csrc/hopper.cuh). One block per (64-key tile, batch x kv head). A
// producer warpgroup (setmaxnreg 40) loads the K and V tiles once by TMA
// and keeps a 3-stage ring of 64-row Q and dO tiles in flight, writing
// beside each stage its rows' lse (log2 domain; +inf for a row that takes
// no part: past T or lse <= NEG_INF / 2) and delta. Under grouped-query
// attention the ring walks the group's query heads one after the other, so
// one block sums them all; under causal it starts at the diagonal tile.
// The two consumer warpgroups split the products, not the keys: at D = 128
// one thread cannot hold both dK and dV (64 f32 each) beside S^T and dP^T
// in the 168 registers that ptxas allots a thread of a 384-thread block.
// Per query tile, with the queries as the accumulator's columns (each
// thread reads lse and delta for its 16 columns from the stage):
//   warpgroup 0: S^T = K Q^T (wgmma m64n64k16 from shared memory, both
//   operands K-major); P^T in registers (key flags per row, query rows per
//   column, causal kj <= qi), stored in f32 to a shared buffer (named
//   barrier) and packed to bf16 as the register A operand of dV += P^T dO
//   (dO MN-major: imm-trans-b);
//   warpgroup 1: dP^T = V dO^T, then, once P^T is in the buffer,
//   dS^T = P^T (dP^T - delta) scale in registers, packed to bf16 for
//   dK += dS^T Q.
// Both accumulators have the same register layout, so thread t of one
// warpgroup writes exactly the P^T elements thread t of the other reads.
// The buffer of a ring stage is rewritten only after warpgroup 1 has
// released that stage, so the ring's barriers also order its reuse. dK and
// dV stay in f32 registers until their one bf16 store; a key tile's sums
// are complete within its block, so there are no atomics.
//
// What bounds it on the H100: four products of 2 T S D FLOP each per
// (batch, head) (halved under causal) against reading Q, K, V, dO, lse and
// delta once and writing dK and dV: at the training shapes (T ~ 1024,
// D = 128) the tensor cores bound it.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BK = 64;             // keys per block
constexpr int BQ = 64;             // query rows per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;       // two consumer warpgroups + producer
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tdo, tk, tv;
  const uint8_t* mask;  // [B, S] key validity (bool)
  const float* lse;     // [B, NH, T]
  const float* delta;   // [B, NH, T]
  bf16* dk;             // [B, S, NKV, D]
  bf16* dv;             // [B, S, NKV, D]
  long long m_sb;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int T, S, NH, NKV, group;  // group = NH / NKV
  float scale;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int k = 0;
  static constexpr int v = k + BK * D * 2;
  static constexpr int q = v + BK * D * 2;
  static constexpr int dout = q + STAGES * BQ * D * 2;
  static constexpr int lse = dout + STAGES * BQ * D * 2;  // f32 [STAGES][BQ]
  static constexpr int delta = lse + STAGES * BQ * 4;
  static constexpr int p = delta + STAGES * BQ * 4;  // f32 P^T per stage
  static constexpr int kflags = p + STAGES * BK * BQ * 4;
  static constexpr int bars = kflags + BK;
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Params prm) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024-byte boundaries (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);
  float* sP = reinterpret_cast<float*>(smem + L::p);
  int8_t* sKf = reinterpret_cast<int8_t*>(smem + L::kflags);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / prm.NKV;
  const int kvh = blockIdx.y % prm.NKV;
  const int first = prm.causal ? k0 / BQ : 0;  // the diagonal query tile
  const int n_q_tiles = (prm.T + BQ - 1) / BQ;
  const int per_head = max(n_q_tiles - first, 0);
  const int n_iters = prm.group * per_head;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x < BK) {
    const int key = k0 + threadIdx.x;
    sKf[threadIdx.x] = key < prm.S && prm.mask[b * prm.m_sb + key];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer --- //
    regs_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * BK * D * 2);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_4d(smem + L::k + cb * BK * 128, &prm.tk, kv_bar, cb * 64, k0,
                    kvh, b);
        tma_load_4d(smem + L::v + cb * BK * 128, &prm.tv, kv_bar, cb * 64, k0,
                    kvh, b);
      }
    }
    for (int it = 0; it < n_iters; ++it) {
      const int stage = it % STAGES;
      const int h = kvh * prm.group + it / per_head;
      const int q0 = (first + it % per_head) * BQ;
      mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
      const long long stat = ((long long)b * prm.NH + h) * prm.T;
#pragma unroll
      for (int e = 0; e < BQ / 32; ++e) {
        const int r = lane + 32 * e;
        const int qi = q0 + r;
        float l2 = INFINITY, dl = 0.f;
        if (qi < prm.T) {
          const float l = prm.lse[stat + qi];
          if (l > NEG_INF / 2) l2 = l * LOG2E;
          dl = prm.delta[stat + qi];
        }
        sLse[stage * BQ + r] = l2;
        sDelta[stage * BQ + r] = dl;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * BQ * D * 2);
        unsigned char* sq = smem + L::q + stage * BQ * D * 2;
        unsigned char* sdo = smem + L::dout + stage * BQ * D * 2;
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_4d(sq + cb * BQ * 128, &prm.tq, &full[stage], cb * 64, q0,
                      h, b);
          tma_load_4d(sdo + cb * BQ * 128, &prm.tdo, &full[stage], cb * 64,
                      q0, h, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers --- //
  regs_inc<232>();
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  // this thread's two rows (keys) and whether each is valid
  const int kr0 = warp * 16 + lane / 4;
  const int kj0 = k0 + kr0, kj1 = kj0 + 8;
  const bool kok0 = sKf[kr0] != 0, kok1 = sKf[kr0 + 8] != 0;
  const float c = prm.scale * LOG2E;
  const bool dv_side = wg == 0;  // warpgroup 0: P^T and dV; 1: dS^T and dK

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int stage = it % STAGES;
    const int q0 = (first + it % per_head) * BQ;
    mbar_wait(&full[stage], (it / STAGES) & 1);
    const unsigned char* sq = smem + L::q + stage * BQ * D * 2;
    const unsigned char* sdo = smem + L::dout + stage * BQ * D * 2;
    float* sPs = sP + stage * BK * BQ + tid;  // this thread's P^T elements

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float s[BQ / 2];
    fence_regs(s);
    wgmma_fence();
    gemm_ss<BQ, D>(s, smem + (dv_side ? L::k : L::v), BK, dv_side ? sq : sdo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // accumulator column = query row q0 + 8 j + 2 quad + e
    const float* lse2 = sLse + stage * BQ;
    const float* dlt = sDelta + stage * BQ;
    const bool diag = prm.causal && q0 < k0 + BK;
    uint32_t a[BQ / 16][4];  // P^T or dS^T, bf16, as the A operand
    if (dv_side) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            const bool keep = (r ? kok1 : kok0) &&
                              !(diag && (r ? kj1 : kj0) > q0 + col + e);
            s[i] = keep ? fast_exp2(s[i] * c - (e ? l2.y : l2.x)) : 0.f;
            sPs[i * 128] = s[i];
          }
        }
      }
      __threadfence_block();
      named_bar_arrive(2 + stage, 256);
    } else {
      named_bar_sync(2 + stage, 256);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * quad);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * j + k;
          s[i] = sPs[i * 128] * (s[i] - ((k & 1) ? dl.y : dl.x)) * prm.scale;
        }
      }
    }
    // n8 block j is half of the 16-deep slice j / 2: registers
    // (row 0, row 1) for its first (j even) or second 8 columns
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      a[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
      a[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }

    // dV += P^T dO or dK += dS^T Q
    fence_regs(acc);
    wgmma_fence();
    gemm_rs<D, BQ>(acc, a, dv_side ? sdo : sq);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[stage]);
  }

  bf16* out = dv_side ? prm.dv : prm.dk;
  const long long o_sb = dv_side ? prm.dv_sb : prm.dk_sb;
  const long long o_st = dv_side ? prm.dv_st : prm.dk_st;
  const long long o_sh = dv_side ? prm.dv_sh : prm.dk_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = r ? kj1 : kj0;
    if (kj >= prm.S) continue;
    bf16* g = out + b * o_sb + (long long)kj * o_st + kvh * o_sh + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(g + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
int launch(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.S + BK - 1) / BK, batch * prm.NKV);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py).
// `in_strides` holds 13 element strides: q (b, t, h), k (b, s, h),
// v (b, s, h), mask (b), dout (b, t, h). delta is the dQ kernel's. Launches
// one kernel on `stream` and returns a cudaError_t: of building the tensor
// maps, or of the launch.
extern "C" int navillm_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int T, int S, int NH, int NKV, int D, const long long* st,
    long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh,
    float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || NKV == 0) return 0;
  Params prm;
  int err = bind_context();
  if (!err) err = make_map(&prm.tq, q, B, T, NH, D, st[0], st[1], st[2], BQ);
  if (!err) err = make_map(&prm.tk, k, B, S, NKV, D, st[3], st[4], st[5], BK);
  if (!err) err = make_map(&prm.tv, v, B, S, NKV, D, st[6], st[7], st[8], BK);
  if (!err)
    err = make_map(&prm.tdo, dout, B, T, NH, D, st[10], st[11], st[12], BQ);
  if (err) return err;
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.dk = static_cast<bf16*>(dk);
  prm.dv = static_cast<bf16*>(dv);
  prm.m_sb = st[9];
  prm.dk_sb = dk_sb; prm.dk_st = dk_st; prm.dk_sh = dk_sh;
  prm.dv_sb = dv_sb; prm.dv_st = dv_st; prm.dv_sh = dv_sh;
  prm.T = T; prm.S = S; prm.NH = NH; prm.NKV = NKV; prm.group = NH / NKV;
  prm.scale = scale;
  prm.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(prm, B, s) : launch<128>(prm, B, s);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
