// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 in and out, f32
// accumulation.
//
// Replaces navillm_tpu/ops/attention.py::_flash_bwd_dq_kernel, the Pallas
// TPU kernel of the JAX package's fused backward (_flash_backward) that
// computes dQ; its twin for dK/dV is csrc/flash_attn_bwd.cu, which runs
// after it on the same stream. It recomputes the probabilities tile by tile
// from the forward kernel's log-sum-exp rows, P = exp(Q K^T * scale - lse),
// so the [T, S] matrix never reaches device memory:
//   delta = rowsum(O * dO);  dS = P * (dO V^T - delta) * scale;  dQ = dS K.
// delta (f32, as in the JAX code) is computed here, in the prologue, from
// the O and dO tiles the block holds anyway, and written to a dense
// [B, NH, T] buffer for the dK/dV kernel, which would read O S / 128 times
// over if it computed delta itself.
//
// Masking follows the JAX kernel's rule. P is exactly zero where the key is
// hidden by kv_mask, above the diagonal under causal, past S (tile padding),
// past T (query padding), or where the query row's lse <= NEG_INF / 2: a row
// that saw no valid key in the forward (left padding under causal) has
// lse ~ NEG_INF there, so it gets dQ = 0 exactly.
//
// Layout. Q, O, dO and dQ are [B, T, NH, D] and K, V [B, S, NKV, D], read
// and written through their strides (dense last dimension; Q, O, dO, K and
// V by TMA tensor maps); lse and delta dense f32 [B, NH, T]. D is 64 or 128.
//
// Design: the forward kernel's pipeline (csrc/flash_attn_fwd.cu). One block
// per (128-row query tile, batch x head). A producer warpgroup (setmaxnreg
// 40) loads the Q, O and dO tiles once and keeps a 2-stage TMA ring of
// 64-key K and V tiles in flight, with each tile's key-validity flags. Two
// consumer warpgroups (setmaxnreg 232) of 64 rows each first reduce their
// rows of O * dO over the quad that holds them (shfl_xor) into delta, then,
// per key tile:
// S = Q K^T and dP = dO V^T as two wgmma m64n64k16 chains from shared
// memory into registers; P and dS in registers from the thread's rows' lse
// and delta; dQ += dS K with dS packed to bf16 as the register A operand
// and K transposed from shared memory. dQ stays in registers in f32 until
// its one store: no atomics and no second pass, since a query tile's dQ is
// complete within its block.
//
// What bounds it on the H100: three products of 2 T S D FLOP each per
// (batch, head) (halved under causal) against reading Q, K, V, dO, O and
// lse once and writing dQ and delta: at the training shapes (T ~ 1024,
// D = 128) the two bounds are within ~15% of each other, the bytes ahead
// since the kernel reads O for delta.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BQ = 128;            // query rows per block, 64 per consumer
constexpr int BK = 64;             // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;       // two consumer warpgroups + producer
constexpr float NEG_INF = -1e30f;  // navillm_tpu/ops/masking.py:NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tdo, to, tk, tv;
  const uint8_t* mask;  // [B, S] key validity (bool)
  const float* lse;     // [B, NH, T]
  float* delta;         // [B, NH, T], written here
  bf16* dq;             // [B, T, NH, D]
  long long m_sb;
  long long dq_sb, dq_st, dq_sh;
  int T, S, NH, group;  // group = NH / NKV
  float scale;
  int causal;
};

template <int D>
struct Smem {
  static constexpr int q = 0;
  static constexpr int dout = q + BQ * D * 2;
  static constexpr int o = dout + BQ * D * 2;
  static constexpr int k = o + BQ * D * 2;
  static constexpr int v = k + STAGES * BK * D * 2;
  static constexpr int flags = v + STAGES * BK * D * 2;
  static constexpr int bars = flags + STAGES * BK;
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Params prm) {
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
      mbar_arrive_expect_tx(q_bar, 3 * BQ * D * 2);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_4d(smem + L::q + cb * BQ * 128, &prm.tq, q_bar, cb * 64, q0,
                    h, b);
        tma_load_4d(smem + L::dout + cb * BQ * 128, &prm.tdo, q_bar, cb * 64,
                    q0, h, b);
        tma_load_4d(smem + L::o + cb * BQ * 128, &prm.to, q_bar, cb * 64, q0,
                    h, b);
      }
    }
    const uint8_t* mg = prm.mask + b * prm.m_sb;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(&empty[stage], ((t / STAGES) & 1) ^ 1);
      const int k0 = t * BK;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int key = k0 + lane * (BK / 32) + e;
        sFlags[stage * BK + lane * (BK / 32) + e] = key < prm.S && mg[key];
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
  const int qi0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int qi1 = qi0 + 8;
  // per row: lse in the log2 domain and whether the row takes part (inside
  // T and saw a valid key in the forward)
  const long long stat = ((long long)b * prm.NH + h) * prm.T;
  float lse2[2], dlt[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? qi1 : qi0;
    const float l = qi < prm.T ? prm.lse[stat + qi] : NEG_INF;
    ok[r] = qi < prm.T && l > NEG_INF / 2;
    lse2[r] = l * LOG2E;
  }
  const float c = prm.scale * LOG2E;
  const unsigned char* sQw = smem + L::q + wg * 64 * 128;
  const unsigned char* sDOw = smem + L::dout + wg * 64 * 128;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_bar, 0);
  // delta = rowsum(O * dO): the quad's four lanes take every fourth
  // 16-byte chunk of the thread's two rows (rows past T are zero-filled)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + lane / 4 + 8 * r;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      sum = dot_chunk(tile_chunk(smem + L::o, row, quad + 4 * i, BQ),
                      tile_chunk(smem + L::dout, row, quad + 4 * i, BQ), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[r] = sum;
    const int qi = r ? qi1 : qi0;
    if (quad == 0 && qi < prm.T) prm.delta[stat + qi] = sum;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int k0 = t * BK;
    mbar_wait(&full[stage], (t / STAGES) & 1);
    const unsigned char* sk = smem + L::k + stage * BK * D * 2;
    const unsigned char* sv = smem + L::v + stage * BK * D * 2;

    float s[BK / 2], dp[BK / 2];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    gemm_ss<BK, D>(s, sQw, BQ, sk);
    gemm_ss<BK, D>(dp, sDOw, BQ, sv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P and dS in registers; dS packed to bf16 as the A operand of dS K
    const int8_t* fl = sFlags + stage * BK;
    const bool diag = prm.causal && k0 + BK > q0 + wg * 64;
    uint32_t dsk[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const char2 f = *reinterpret_cast<const char2*>(fl + 8 * j + 2 * quad);
      float ds[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const int col = k0 + 8 * j + 2 * quad + e;
          const bool keep = ok[r] && (e ? f.y : f.x) &&
                            !(diag && col > (r ? qi1 : qi0));
          const float p = keep ? fast_exp2(s[i] * c - lse2[r]) : 0.f;
          ds[2 * r + e] = p * (dp[i] - dlt[r]) * prm.scale;
        }
      }
      // n8 block j is half of the 16-deep slice j / 2: registers
      // (row 0, row 1) for its first (j even) or second 8 columns
      dsk[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      dsk[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }

    fence_regs(dq);
    wgmma_fence();
    gemm_rs<D, BK>(dq, dsk, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? qi1 : qi0;
    if (qi >= prm.T) continue;
    bf16* g = prm.dq + b * prm.dq_sb + (long long)qi * prm.dq_st +
              h * prm.dq_sh + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(g + 8 * j) =
          pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

template <int D>
int launch(const Params& prm, int batch, cudaStream_t stream) {
  const int bytes = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.T + BQ - 1) / BQ, batch * prm.NH);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (navillm_tpu_torch/ops/attention.py).
// `st` holds 16 element strides: q (b, t, h), k (b, s, h), v (b, s, h),
// mask (b), dout (b, t, h), o (b, t, h). Writes dq and delta. Launches one
// kernel on `stream` and returns a cudaError_t: of building the tensor
// maps, or of the launch.
extern "C" int navillm_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* o, void* delta, void* dq,
    int B, int T, int S, int NH, int NKV, int D, const long long* st,
    long long dq_sb, long long dq_st, long long dq_sh,
    float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0 || NH == 0) return 0;
  Params prm;
  int err = bind_context();
  if (!err) err = make_map(&prm.tq, q, B, T, NH, D, st[0], st[1], st[2], BQ);
  if (!err) err = make_map(&prm.tk, k, B, S, NKV, D, st[3], st[4], st[5], BK);
  if (!err) err = make_map(&prm.tv, v, B, S, NKV, D, st[6], st[7], st[8], BK);
  if (!err)
    err = make_map(&prm.tdo, dout, B, T, NH, D, st[10], st[11], st[12], BQ);
  if (!err)
    err = make_map(&prm.to, o, B, T, NH, D, st[13], st[14], st[15], BQ);
  if (err) return err;
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<float*>(delta);
  prm.dq = static_cast<bf16*>(dq);
  prm.m_sb = st[9];
  prm.dq_sb = dq_sb; prm.dq_st = dq_st; prm.dq_sh = dq_sh;
  prm.T = T; prm.S = S; prm.NH = NH; prm.group = NH / NKV;
  prm.scale = scale;
  prm.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(prm, B, s) : launch<128>(prm, B, s);
}

extern "C" const char* navillm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
