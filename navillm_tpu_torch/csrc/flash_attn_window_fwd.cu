// Window attention of the prefix-cached step for Hopper (sm_90a): bf16 Q,
// K, V in, bf16 O out, forward only.
//
// Replaces no TPU kernel: the JAX package runs this attention through XLA
// (llama.chunk_forward_cached, impl="xla"), and the port ran it eagerly
// (the two K/V sources concatenated, the GQA broadcast materialised, an f32
// [B, NH, S, P+S] score tensor masked and soft-maxed in device memory: 16
// launches a layer). It computes the same function as that eager path: an
// S-token window attends to every valid key of its row's cached prefix and
// to the valid window keys up to itself.
//
// Layout. Q is [B, S, NH, D]; the prefix K/V [B, P, NKV, D] (a layer's view
// of the [L, B, P, NKV, D] cache) and the window K/V [B, S, NKV, D] are two
// key sources, each read through its own TMA tensor maps and strides (the
// last dimension dense), so nothing is concatenated and the GQA broadcast
// is never materialised: query head h reads kv head h / (NH / NKV). D is 64
// or 128.
//
// Masking. The key sequence is the prefix's keys, then the window's. A
// prefix key is valid where prefix_mask [B, P] says so and is seen by every
// query; a window key j is valid where win_mask [B, S] says so and is seen
// by window query i iff j <= i (the causal diagonal aligned to the bottom
// right of the [S, P + S] score matrix). A hidden key scores NEG_INF =
// -1e30, finite, as in the eager path; keys past a source's end (tile
// padding, zero-filled by TMA) are excluded outright. Prefix tiles wholly
// past the row's last valid prefix key are never loaded (the block finds
// that key from prefix_mask before it splits). A row that sees no valid
// key comes out as a finite average of the V rows it visited.
//
// Design: K1's (csrc/flash_attn_fwd.cu), FlashAttention-3's forward without
// the ping-pong. One block per (128-row query tile, batch x head). A
// producer warp keeps a 2-stage ring of 128-key K and V tiles in flight by
// TMA (128-byte swizzle, a full/empty mbarrier pair per stage) over the
// prefix tiles and then the window tiles, and writes each tile's key
// flags; two consumer warpgroups, 64 query rows each, run S = Q K^T and
// O += P V by wgmma with the online softmax in f32 in registers (bf16 P
// into the PV product, f32 accumulation), the causal mask applied on the
// window's diagonal tiles only. Epilogue: O / l to bf16, stored strided.
// K1's arithmetic, kept apart from K1 so that K1's compiled kernel is
// untouched by this path.
//
// What bounds it on the H100: at the cached step's shapes (S <= 99 window
// tokens, P = 192 cache slots, 8 KV heads of 128) it reads the K/V of both
// sources and Q, and writes O: bytes, not operations.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BQ = 128;            // query rows per block, 64 per consumer
constexpr int BK = 128;            // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;       // two consumer warpgroups + producer
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap tq;        // [B, S, NH, D], boxes of BQ rows
  CUtensorMap tkp, tvp;  // prefix [B, P, NKV, D], boxes of BK rows
  CUtensorMap tkw, tvw;  // window [B, S, NKV, D], boxes of BK rows
  const uint8_t* pmask;  // [B, P] prefix key validity (bool)
  const uint8_t* wmask;  // [B, S] window key validity (bool)
  __nv_bfloat16* o;      // [B, S, NH, D]
  long long pm_sb, wm_sb;
  long long o_sb, o_st, o_sh;
  int S, P, NH, group;  // group = NH / NKV
  float scale;
};

template <int D>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + BQ * D * 2;
  static constexpr int v = k + STAGES * BK * D * 2;
  static constexpr int flags = v + STAGES * BK * D * 2;
  static constexpr int bars = flags + STAGES * BK;
  static constexpr int last = bars + (2 * STAGES + 1) * 8;
  static constexpr int bytes = last + 4;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
window_fwd_kernel(const __grid_constant__ Params prm) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  // tiles start on 1024-byte boundaries (the 128-byte swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* sFlags = reinterpret_cast<int8_t*>(smem + L::flags);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  int* sLast = reinterpret_cast<int*>(smem + L::last);

  const int n_q_tiles = (prm.S + BQ - 1) / BQ;
  const int q0 = (n_q_tiles - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int b = blockIdx.y / prm.NH;
  const int h = blockIdx.y % prm.NH;
  const int kvh = h / prm.group;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);    // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(q_bar, 1);
    *sLast = -1;
    mbar_init_fence();
  }
  __syncthreads();
  // the row's last valid prefix key: the prefix tiles past it are skipped
  {
    const uint8_t* pm = prm.pmask + b * prm.pm_sb;
    int last = -1;
    for (int key = threadIdx.x; key < prm.P; key += THREADS)
      if (pm[key]) last = key;
    if (last >= 0) atomicMax(sLast, last);
  }
  __syncthreads();
  const int n_pre = (*sLast + BK) / BK;
  // window tiles up to the query tile's last row (causal)
  const int n_win = min((prm.S + BK - 1) / BK, (q0 + BQ + BK - 1) / BK);
  const int n_tiles = n_pre + n_win;

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
    const uint8_t* pm = prm.pmask + b * prm.pm_sb;
    const uint8_t* wm = prm.wmask + b * prm.wm_sb;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
      const bool pre = t < n_pre;
      const int k0 = (pre ? t : t - n_pre) * BK;
      const int len = pre ? prm.P : prm.S;
      const uint8_t* mg = pre ? pm : wm;
      // -1: tile padding (excluded), 0: masked (NEG_INF), 1: valid
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int key = k0 + lane * (BK / 32) + e;
        sFlags[stage * BK + lane * (BK / 32) + e] =
            key >= len ? -1 : (mg[key] ? 1 : 0);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * BK * D * 2);
        unsigned char* sk = smem + L::k + stage * BK * D * 2;
        unsigned char* sv = smem + L::v + stage * BK * D * 2;
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          if (pre) {
            tma_load_4d(sk + cb * BK * 128, &prm.tkp, &full[stage], cb * 64,
                        k0, kvh, b);
            tma_load_4d(sv + cb * BK * 128, &prm.tvp, &full[stage], cb * 64,
                        k0, kvh, b);
          } else {
            tma_load_4d(sk + cb * BK * 128, &prm.tkw, &full[stage], cb * 64,
                        k0, kvh, b);
            tma_load_4d(sv + cb * BK * 128, &prm.tvw, &full[stage], cb * 64,
                        k0, kvh, b);
          }
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
  // this thread's two rows, window query indices
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
    const bool pre = t < n_pre;
    const int k0 = (pre ? t : t - n_pre) * BK;
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

    // masks; running max over this tile. The diagonal: a window tile with
    // a key past this warpgroup's first row.
    const int8_t* fl = sFlags + stage * BK;
    const bool diag = !pre && k0 + BK > q0 + wg * 64;
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
    // finite: key k0 of every visited tile lies inside its source, so it
    // scores at least NEG_INF
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
    if (qi >= prm.S) continue;
    const float inv = r ? inv1 : inv0;
    bf16* og = prm.o + b * prm.o_sb + (long long)qi * prm.o_st + h * prm.o_sh +
               2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(og + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
int launch(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      window_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.S + BQ - 1) / BQ, batch * prm.NH);
  window_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py:
// window_attention). Strides are in elements. Returns a cudaError_t: of
// building the tensor maps, or of the launch.
extern "C" int navillm_flash_attn_window_fwd(
    const void* q, const void* kp, const void* vp, const void* pmask,
    const void* kw, const void* vw, const void* wmask, void* o, int B, int S,
    int P, int NH, int NKV, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long kp_sb, long long kp_st, long long kp_sh,
    long long vp_sb, long long vp_st, long long vp_sh, long long pm_sb,
    long long kw_sb, long long kw_st, long long kw_sh,
    long long vw_sb, long long vw_st, long long vw_sh, long long wm_sb,
    long long o_sb, long long o_st, long long o_sh, float scale,
    void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || NH == 0) return 0;
  Params prm = {};
  int err = bind_context();
  if (!err) err = make_map(&prm.tq, q, B, S, NH, D, q_sb, q_st, q_sh, BQ);
  if (!err && P > 0)
    err = make_map(&prm.tkp, kp, B, P, NKV, D, kp_sb, kp_st, kp_sh, BK);
  if (!err && P > 0)
    err = make_map(&prm.tvp, vp, B, P, NKV, D, vp_sb, vp_st, vp_sh, BK);
  if (!err) err = make_map(&prm.tkw, kw, B, S, NKV, D, kw_sb, kw_st, kw_sh, BK);
  if (!err) err = make_map(&prm.tvw, vw, B, S, NKV, D, vw_sb, vw_st, vw_sh, BK);
  if (err) return err;
  prm.pmask = static_cast<const uint8_t*>(pmask);
  prm.wmask = static_cast<const uint8_t*>(wmask);
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.pm_sb = pm_sb;
  prm.wm_sb = wm_sb;
  prm.o_sb = o_sb; prm.o_st = o_st; prm.o_sh = o_sh;
  prm.S = S; prm.P = P; prm.NH = NH; prm.group = NH / NKV;
  prm.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(prm, B, s) : launch<128>(prm, B, s);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
