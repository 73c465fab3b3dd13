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
// their strides (the last dimension must be dense), by TMA tensor maps, so
// neither the model's head split nor the GQA broadcast is ever
// materialised: query head h reads kv head h / (NH / NKV). D is 64 or 128.
//
// Masking. A key hidden by kv_mask (or above the diagonal under causal)
// scores NEG_INF = -1e30, a finite value, exactly as in the JAX code. Keys
// at index >= S (tile padding, zero-filled by TMA) are excluded outright.
// Prompts are left padded, so under causal attention the first rows of a
// padded prompt see no valid key: with finite NEG_INF their softmax is a
// uniform average of the V rows they visited, which keeps them finite.
// Those rows are don't-care for the model, but their V rows feed later
// layers at masked keys with p = 0, and 0 * NaN would poison the real
// tokens. lse is written as NEG_INF where the row sum is 0.
//
// Design (FlashAttention-3's forward, without the ping-pong between the two
// consumer warpgroups). One block per (128-row query tile, batch x head),
// heaviest causal tiles first. Three warpgroups:
//  - a producer warpgroup, whose first warp keeps a 2-stage ring of
//    128-key K and V tiles in flight by TMA (128-byte swizzle; a full/empty
//    mbarrier pair per stage) and writes each tile's key-validity flags from
//    kv_mask and S; it gives up its registers (setmaxnreg 40);
//  - two consumer warpgroups (setmaxnreg 232), 64 query rows each. Per key
//    tile: S = Q K^T by wgmma m64n128k16 from shared memory into registers;
//    masks and the online softmax in registers (each thread owns two rows,
//    reduced over the quad with shfl_xor); P packed to bf16 in registers is
//    the A operand of O += P V (wgmma, V transposed from shared memory); O
//    stays in registers in f32 and is rescaled there. The causal mask is
//    applied on the diagonal tile only.
// Epilogue: O / l to bf16, stored to the strided O; lse to its row.
//
// What bounds it on the H100: 4 T S D FLOP per (batch, head) (halved under
// causal) against reading Q, K, V once and writing O; at the slice's
// shapes (T <= 1024, D = 128) the tensor cores bound it. The scores never
// leave registers.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BQ = 128;            // query rows per block, 64 per consumer
constexpr int BK = 128;            // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;       // two consumer warpgroups + producer
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tq, tk, tv;  // [B, T, NH, D] / [B, S, NKV, D], boxes of BQ/BK rows
  const uint8_t* mask;     // [B, S] key validity (bool)
  __nv_bfloat16* o;        // [B, T, NH, D]
  float* lse;              // [B, NH, T]
  long long m_sb;
  long long o_sb, o_st, o_sh;
  int T, S, NH, group;  // group = NH / NKV
  float scale;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + BQ * D * 2;
  static constexpr int v = k + STAGES * BK * D * 2;
  static constexpr int flags = v + STAGES * BK * D * 2;
  static constexpr int bars = flags + STAGES * BK;
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Params prm) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024-byte boundaries (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* sFlags = reinterpret_cast<int8_t*>(smem + L::flags);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int n_q_tiles = (prm.T + BQ - 1) / BQ;
  const int q0 = (n_q_tiles - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / prm.NH;
  const int h = blockIdx.y % prm.NH;
  const int kvh = h / prm.group;
  int n_tiles = (prm.S + BK - 1) / BK;
  if (prm.causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer --- //
    regs_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, BQ * D * 2);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_4d(smem + L::q + cb * BQ * 128, &prm.tq, q_bar, cb * 64, q0,
                    h, b);
    }
    const uint8_t* mg = prm.mask + b * prm.m_sb;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
      const int k0 = t * BK;
      // -1: tile padding (excluded), 0: masked (NEG_INF), 1: valid
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int key = k0 + lane * (BK / 32) + e;
        sFlags[stage * BK + lane * (BK / 32) + e] =
            key >= prm.S ? -1 : (mg[key] ? 1 : 0);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * BK * D * 2);
        unsigned char* sk = smem + L::k + stage * BK * D * 2;
        unsigned char* sv = smem + L::v + stage * BK * D * 2;
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_4d(sk + cb * BK * 128, &prm.tk, &full[stage], cb * 64, k0,
                      kvh, b);
          tma_load_4d(sv + cb * BK * 128, &prm.tv, &full[stage], cb * 64, k0,
                      kvh, b);
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
  // this thread's two rows, absolute query indices
  const int qi0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int qi1 = qi0 + 8;
  const float c = prm.scale * LOG2E;  // scores in the log2 domain
  constexpr float NEG_INF2 = NEG_INF * LOG2E;
  // this warpgroup's 64 rows of the Q tile (128-byte rows per column block)
  const unsigned char* sQw = smem + L::q + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sum

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int k0 = t * BK;
    mbar_wait(&full[stage], (t / STAGES) & 1);
    const unsigned char* sk = smem + L::k + stage * BK * D * 2;
    const unsigned char* sv = smem + L::v + stage * BK * D * 2;

    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
    gemm_ss<BK, D>(s, sQw, BQ, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // masks; running max over this tile
    const int8_t* fl = sFlags + stage * BK;
    const bool diag = prm.causal && k0 + BK > q0 + wg * 64;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const char2 f = *reinterpret_cast<const char2*>(fl + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int flag = e ? f.y : f.x;
        const int col = k0 + 8 * j + 2 * quad + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float x = s[i] * c;
          if (flag == 0 || (diag && col > (r ? qi1 : qi0))) x = NEG_INF2;
          if (flag < 0) x = -INFINITY;
          s[i] = x;
          if (r)
            mx1 = fmaxf(mx1, x);
          else
            mx0 = fmaxf(mx0, x);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // finite: key k0 < S of every visited tile scores at least NEG_INF
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = fast_exp2(m0 - n0), a1 = fast_exp2(m1 - n1);  // 0 at first
    m0 = n0;
    m1 = n1;

    // P = exp2(x - m), packed to bf16 as the A operand of P V
    uint32_t pk[BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        // g = 0, 2: row 0; g = 1, 3: row 1 (i = 8 kk + 2 g + {0, 1})
        const int i = 8 * kk + 2 * g;
        const float mr = (g & 1) ? n1 : n0;
        const float p0 = fast_exp2(s[i] - mr), p1 = fast_exp2(s[i + 1] - mr);
        if (g & 1)
          sum1 += p0 + p1;
        else
          sum0 += p0 + p1;
        pk[kk][g] = pack_bf16(p0, p1);
      }
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= ((i / 2) % 2) ? a1 : a0;

    fence_regs(o);
    wgmma_fence();
    gemm_rs<D, BK>(o, pk, sv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[stage]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? qi1 : qi0;
    if (qi >= prm.T) continue;
    const float inv = r ? inv1 : inv0;
    bf16* og = prm.o + b * prm.o_sb + (long long)qi * prm.o_st + h * prm.o_sh +
               2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(og + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (quad == 0) {
      const float l = r ? l1 : l0;
      const float m = r ? m1 : m0;
      prm.lse[((long long)b * prm.NH + h) * prm.T + qi] =
          l > 0.f ? (m + __log2f(l)) * LN2 : NEG_INF;
    }
  }
}

template <int D>
int launch(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.T + BQ - 1) / BQ, batch * prm.NH);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py).
// Strides are in elements. Returns a cudaError_t: of building the tensor
// maps, or of the launch.
extern "C" int navillm_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int T, int S, int NH, int NKV, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long m_sb,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || NH == 0) return 0;
  Params prm;
  int err = bind_context();
  if (!err) err = make_map(&prm.tq, q, B, T, NH, D, q_sb, q_st, q_sh, BQ);
  if (!err) err = make_map(&prm.tk, k, B, S, NKV, D, k_sb, k_st, k_sh, BK);
  if (!err) err = make_map(&prm.tv, v, B, S, NKV, D, v_sb, v_st, v_sh, BK);
  if (err) return err;
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.lse = static_cast<float*>(lse);
  prm.m_sb = m_sb;
  prm.o_sb = o_sb; prm.o_st = o_st; prm.o_sh = o_sh;
  prm.T = T; prm.S = S; prm.NH = NH; prm.group = NH / NKV;
  prm.scale = scale;
  prm.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(prm, B, s) : launch<128>(prm, B, s);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
