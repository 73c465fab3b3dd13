#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (navillm_tpu_torch) once on one H100.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits nonzero:
  0. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
     name and power limit;
  1. build: compiles every kernel (csrc/flash_attn_fwd.cu,
     flash_attn_bwd.cu, flash_attn_bwd_dq.cu, matmul_q4.cu) with nvcc for
     sm_90a, all at once, and prints ptxas's registers and spills for each;
  2. kernel vs plain: the flash-attention forward kernel (K1) against its
     plain PyTorch version (32 heads of 128, bf16, left-padded masks with
     fully-masked rows): causal at B=4 with T in {65, 128, 640, 1000,
     1024}, B=16 at T=1024 (the training shape), one GQA case, one D=64
     case, one non-causal case with S != T and one with flat rows (q / 8);
     O is held per element to a bound scaled by the element and its row's
     RMS (testing.attn_excess), which the plain version with one key, or
     one 64-key tile, hidden must fail on the rows that see 256 keys or
     more; then K1, its plain version and one library call
     (F.scaled_dot_product_attention with the same boolean mask, a
     yardstick the port never calls; its own max |d| from the plain
     version printed beside it) timed with CUDA events at the eval and
     training shapes, on full masks and on PR 1-3's left-padded masks;
  3. the eval slice: greedy R2R streaming evaluation (validate_streaming)
     of the navigation model at Vicuna-7B width (bf16, random weights from
     a seed) on a synthetic 8x8 grid world; every LLM layer of every step
     must go through the kernel;
  4. model-level A/B: one forward_navigation step through the kernel and
     through the eager attention path on the same inputs;
  5. backward kernels vs plain: the dQ kernel (K3), which also writes
     delta = rowsum(O * dO), and then the dK/dV kernel (K2) on that delta,
     against their plain versions (on the same delta; delta itself against
     attention_delta to DELTA_RTOL of each row's sum of |O * dO|) on
     BWD_CASES: a GQA case, a D=64 case and a non-causal case with S != T
     at B=4, then the training slice's shapes (B = rows per grad call, 32
     heads of 128, bf16, causal, T in {640, 1024}, and T=1024 with flat
     rows), all on left-padded masks with fully-masked rows, whose dQ must
     be exactly 0 (and hidden keys' dK and dV), under phase 2's
     per-element bound, which a hidden key or key tile (dQ) and a skipped
     query row or 64-row query tile (dK/dV) must fail; the differentiable
     FlashAttention against autograd through the eager path; then both
     kernels (on full masks and on PR 2's left-padded ones, each with
     nvidia-smi's SM clock and power read while they run), their plain
     versions and the backward of the masked F.scaled_dot_product_attention
     call (the library yardstick for K2 + K3, its max |d| from the plain
     versions beside it) timed with CUDA events;
  6. the training slice: R2R teacher-forcing training of the same 7B-width
     model through train_one_epoch (stage pretrain, fused teacher, dropout
     on, AdamW, gradient accumulation 2): a warm-up epoch, then 4 batches
     of 8 episodes (2 optimizer steps); every LLM layer of every grad call
     must go through the three kernels;
  7. gradient A/B: one grad call through the kernels and through the eager
     attention path, on the same inputs and weights with dropout off;
  8. int4 matmul vs plain: the int4 dequant-matmul kernel (K4) against its
     plain version at the 7B layer shapes (h, o) in {(4096, 4096), (4096,
     11008), (11008, 4096)}, m in {4096, 3584, 7}, w4 (bf16 x) and w4a8
     (int8 x), timed with CUDA events beside a dense bf16 torch.matmul and,
     for w4, torch._weight_int4pack_mm on the same weight repacked (the
     library yardstick, its max |d| from the plain version beside it);
  9. the w4 slice: the trained model's LLM quantized to int4 on the card
     (quantize_nav_params, bits=4), then phase 3's evaluation again; every
     layer matmul of every step must go through the int4 kernel;
 10. the w4a8 slice: phase 9 with act_int8 (int8 activations);
 11. int4 model-level A/B: one forward_navigation step on the int4 tree
     through the kernel and through its plain version, w4 and w4a8.
Phase 2 also checks K1 on the prefill's right-padded masks (B=8, T in
{192, 1024}, the last row all false, whose O must be finite) and times it
at B=8, T=192. The subword slices run between phases 4 and 5 (bf16) and
after phase 10 (int4):
 12. the BPE check: the port's NavTokenizer.bpe (plain Python) gives the
     golden ids of tests/fixtures/bpe_nav_golden.json (made by the JAX
     package's tokenizer; a CPU test keeps it equal), decode(encode(x)) ==
     x, and the mean prompt width of phase 3's prompts, byte against BPE;
 13. phase 3 on BPE prompts (NavTokenizer.bpe(max_length=1024,
     pad_to_multiple=64), RolloutDims(48, 44, 12, 16, max_prefix=192)),
     uncached: 32 K1 launches per step;
 14. the same run with args.prefix_cache: it must take the cached step
     only (prefills and eval_step_cached, no whole-prompt step); K1
     launches once per layer of every prefill call and never in a cached
     step (the window's attention is the eager path); printed beside
     phase 13: tokens and wall ms per step, episodes/s, the window widths,
     cache bytes, peak memory and the trajectories both share;
 15. cached-step A/B: one snapshotted step with history through
     eval_step_cached and through eval_step on the same state and prompts,
     candidate logits gated per element (CACHED_LOGIT_*); the step with
     the last cached token hidden must fail the gate;
 16. phase 14 on the int4 tree (w4): K4 launches 7 times per layer of
     every prefill call and cached step;
 17. phase 16 with act_int8 (w4a8): every K4 launch in int8 mode.
The kernels line lists K1-K4 with each one's time, its plain version's,
the library call's (or why there is none) with its agreement, the worst
gate excess of the checks (K3: and of its delta) and its bound: the
larger of
the bytes it must move over 3.35 TB/s and its FLOPs over 989 TFLOP/s (the
H100 SXM's bf16 dense peak). Then nvidia-smi's name and power limit, and
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.mp3d_agent import TrainArgs
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.loaders import Dataloader, MetaLoader
from navillm_tpu_torch.models.llama import LlamaConfig, _act_q
from navillm_tpu_torch.models.nav_model import (NavModel, NavModelConfig,
                                                forward_navigation)
from navillm_tpu_torch.models.pano_encoder import PanoConfig
from navillm_tpu_torch.models.quant import _quant_one4, quantize_nav_params
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.ops import _build
from navillm_tpu_torch.ops.attention import (
    FlashAttention, attention_delta, attention_eager, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference)
from navillm_tpu_torch.ops.masking import NEG_INF
from navillm_tpu_torch.ops.matmul_q4 import (matmul_q4, matmul_q4_reference,
                                             unpack_q4)
from navillm_tpu_torch.training.optim import make_optimizer
from navillm_tpu_torch.training.train_loop import (make_opt_step,
                                                   train_one_epoch)

KERNELS = {
    "fwd": {"name": "flash_attn_fwd", "route": "cuda",
            "source": "navillm_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "navillm_tpu/ops/attention.py:61"},
    "dkv": {"name": "flash_attn_bwd_dkv", "route": "cuda",
            "source": "navillm_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "navillm_tpu/ops/attention.py:183"},
    "dq": {"name": "flash_attn_bwd_dq", "route": "cuda",
           "source": "navillm_tpu_torch/csrc/flash_attn_bwd_dq.cu",
           "replaces": "navillm_tpu/ops/attention.py:234"},
    "q4": {"name": "matmul_q4", "route": "cuda",
           "source": "navillm_tpu_torch/csrc/matmul_q4.cu",
           "replaces": "navillm_tpu/ops/matmul_q4.py:60"},
}
COUNTERS = {"fwd": flash_attention_fwd, "dkv": flash_attention_bwd_dkv,
            "dq": flash_attention_bwd_dq}
SOURCES = ["flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_dq",
           "matmul_q4"]
# the H100 SXM's published peaks (bf16 dense tensor cores; HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# K1's cases: (b, t, s, nh, nkv, d, causal, q scale); random q and k make
# peaked rows, q / 8 flat ones, where a skipped key moves O the least
FLAT_Q = 0.125
FWD_CASES = [(4, t, t, 32, 32, 128, True, 1.0)
             for t in (65, 128, 640, 1000, 1024)]
FWD_CASES += [(16, 1024, 1024, 32, 32, 128, True, 1.0),  # the training shape
              (4, 1024, 1024, 32, 8, 128, True, 1.0),    # grouped-query
              (4, 640, 640, 32, 32, 64, True, 1.0),      # D = 64
              (4, 640, 1000, 32, 32, 128, False, 1.0),   # cross-attention
              (4, 1024, 1024, 32, 32, 128, True, FLAT_Q)]
# the prefill's layout: right-padded prefixes at the prefill's batch (<= 8
# rows) and the BPE prefix bucket, and at T=1024; the last row's mask is
# all false (a padding entry of prefill_rows)
FWD_RIGHT_CASES = [(8, 192, 192, 32, 32, 128, True, 1.0),
                   (8, 1024, 1024, 32, 32, 128, True, 1.0)]
# K2/K3's cases: (b, t, s, nh, nkv, d, causal, q scale): grouped-query,
# D = 64 and non-causal S != T at B = 4, then the training slice's shapes
# (B = rows per grad call; the last is the FlashAttention check's)
BWD_CASES = [(4, 1024, 1024, 32, 8, 128, True, 1.0),
             (4, 640, 640, 32, 32, 64, True, 1.0),
             (4, 640, 1000, 32, 32, 128, False, 1.0),
             (16, 640, 640, 32, 32, 128, True, 1.0),
             (16, 1024, 1024, 32, 32, 128, True, FLAT_Q),
             (16, 1024, 1024, 32, 32, 128, True, 1.0)]
# K3's delta against attention_delta: each product of two bf16 values is
# exact in f32, so the two differ only in the order of the D-term f32 sum,
# by at most ~D * 2**-24 of the row's sum of |O * dO| on each side (2**-17
# at D = 128); the limit leaves 4x of that
DELTA_RTOL = 2 ** -15
# K1 is timed at the eval slice's shapes (B = 4 slots) and the training
# slice's (B = 16 rows per grad call); K2/K3 at the training shapes
FWD_TIMED = ((4, 128), (4, 640), (4, 1024), (16, 1024))
# O, dK, dV and dQ against their plain versions: T.attn_excess, per element
# (rel T.ATTN_REL, row RMS T.ATTN_ROW, floor T.ATTN_FLOOR), on the rows that
# see a valid key. Its power is shown on every case whose rows see 256 keys
# or more: the plain version with one key (and one 64-key tile) hidden must
# fail it there.
LONG_ROW = 256
# lse is f32 on both sides and differs in summation order only (~1e-6);
# hiding a 64-key tile from a flat row of 1024 keys moves it by ~0.06
LSE_ATOL = 1e-4
# FlashAttention's three gradients against autograd through the eager path,
# which rounds P to bf16 after normalizing and runs its backward products on
# bf16 operands: a few bf16 ulps of gradients up to ~8
EAGER_GRAD_ATOL = 0.125
# the 7B gradient through the kernels vs through eager attention
MIN_GRAD_COSINE = 0.999
N_EPISODES = 32
N_SLOTS = 4
MAX_ACTION_LEN = 10
MAX_PREFIX = 192
# the cached step's candidate logits against the uncached step's on the
# same state and prompts (phase 15), per element: tol = CACHED_LOGIT_REL *
# |ref| + CACHED_LOGIT_ROW * rms(ref's valid logits of the row). The two
# paths run the same bf16 ops in other groupings (the window's eager
# attention against K1, the prefix K/V from a prefill at another width, so
# other GEMM tilings), and once an input differs by an ulp every later
# rounding may too: each layer rounds its residual stream's inputs about
# six times (q/k/v and attention out, wo, the adds, the norms, the MLP), so
# independent errors of <= 2**-8 relative over 2 sides x 32 layers x 6
# reach ~sqrt(384) * 2**-8 ~ 2**-3.7 of the hidden's scale, and the logit,
# a dot of the hidden with one out_head column, moves by that share of the
# row's logit scale; the limit leaves ~1.6x. The logit is rounded to bf16
# once on each side (2**-7 of itself). Hiding one cached token moves the
# logits by several times this.
CACHED_LOGIT_REL = 2 ** -7
CACHED_LOGIT_ROW = 2 ** -3
# phase 15 snapshots the 3rd step with every slot appending history, from
# a run whose stop logit is lowered by 30 (far below the others, so no
# episode stops early)
AB_SNAPSHOT = 3
AB_STOP_SHIFT = 30.0
BPE_GOLDEN = "tests/fixtures/bpe_nav_golden.json"
# training slice: 4 batches of 8 episodes, accumulation 2 -> 2 steps
TRAIN_EPISODES = 32
TRAIN_BATCH = 8
ROWS_PER_CALL = 16
# a batch's loss is its summed CE over steps / episodes: ~ln(#candidates)
# per step at random init, far below this
MAX_LOSS = 1e3
# int4 matmul, bf16 x: the f32 sums of kernel and plain version differ in
# order only, so their bf16 outputs differ by at most one bf16 ulp (2**-7 of
# the element), plus Q4_FLOOR of the largest element for values near zero;
# int8 x: every group product is exact, so the same f32 ops give the same
# result (Q4_A8_RTOL)
Q4_FLOOR = 1e-4
Q4_A8_RTOL = 1e-6
# the 7B layer matmuls (h, o): wq/wk/wv/wo, w_gate/w_up, w_down
Q4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
Q4_LAYER_MATMULS = 7


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_clocked(fn, iters: int):
    """cuda_ms, with nvidia-smi's SM clock and power draw read while the
    timed launches run (``iters`` should keep the card busy ~0.5 s)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    end.synchronize()
    return start.elapsed_time(end) / iters, smi


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port "
                           "on an NVIDIA H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (Hopper), "
                           f"found {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[0] device {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    # f32 products in the plain versions run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nbytes`` and do ``flops`` at ``peak_flops``."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attn_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs a full key mask leaves, per (batch, head)."""
    return t * (t + 1) // 2 if causal else t * s


def fwd_bound(b, t, s, nh, nkv, d, causal):
    """K1: 2 products of 2 D FLOP per pair; Q, K, V and the mask read once,
    O and lse written once."""
    nbytes = 2 * d * (2 * b * t * nh + 2 * b * s * nkv) + 4 * b * nh * t + b * s
    return bound(4 * d * b * nh * attn_pairs(t, s, causal), nbytes)


def bwd_bounds(b, t, nh, d):
    """(K2, K3), causal with T == S and NKV == NH. K2 does 4 products per
    pair, reads Q, K, V, dO, lse, delta and the mask and writes dK and dV;
    K3 does 3 products per pair and the 2 D FLOP per row of delta, reads
    Q, K, V, dO, O, lse and the mask and writes dQ and delta."""
    pairs = b * nh * attn_pairs(t, t, True)
    tensor = 2 * b * t * nh * d           # one [B, T, NH, D] bf16 tensor
    rows = 4 * b * nh * t                 # one [B, NH, T] f32 tensor
    return (bound(8 * d * pairs, 6 * tensor + 2 * rows + b * t),
            bound(6 * d * pairs + 2 * d * b * nh * t,
                  6 * tensor + 2 * rows + b * t))


def q4_bound(m, h, o, g, int8_x: bool):
    """K4: 2 m h o operations (int8 tensor cores at twice the bf16 rate for
    w4a8); x, the nibbles and the bf16 scales read once, y written once
    (bf16 for w4, f32 for w4a8)."""
    nbytes = (m * h * (1 if int8_x else 2) + h * o // 2 + (h // g) * o * 2
              + m * o * (4 if int8_x else 2))
    return bound(2 * m * h * o, nbytes, 2 * PEAK_FLOPS if int8_x else PEAK_FLOPS)


def left_padded_mask(b: int, s: int, min_keys: int = 1):
    """[B, S] key masks with the first pads[i] keys of row i hidden, pads
    from none to all but ``min_keys`` keys."""
    pads = torch.linspace(0, s - min_keys, b, device="cuda").long()
    return torch.arange(s, device="cuda")[None, :] >= pads[:, None]


def right_padded_mask(b: int, s: int):
    """[B, S] key masks of right-padded prefixes: row i keeps its first
    lens[i] keys, lens from S down to 1, and the last row none."""
    lens = torch.cat([torch.linspace(s, 1, b - 1, device="cuda").long(),
                      torch.zeros(1, dtype=torch.long, device="cuda")])
    return torch.arange(s, device="cuda")[None, :] < lens[:, None]


def hide_keys(mask, start: int, width: int):
    """A copy of the [B, S] key mask with keys start..start+width-1 hidden:
    the plain version on it is what a kernel that skipped them gives."""
    hidden = mask.clone()
    hidden[:, start:start + width] = False
    return hidden


def gate(what: str, got, want, rows, faults=(), long_rows=None) -> float:
    """Holds ``got`` to ``want`` by T.attn_excess on ``rows``; each of
    ``faults`` ((name, output of the plain version with the fault planted))
    must fail the same gate on ``long_rows``. Returns the excess."""
    excess = T.attn_excess(got, want, rows)
    shown = []
    for name, bad in faults:
        r = T.attn_excess(bad, want, long_rows)
        shown.append(f"{name} {r:.1f}")
        if r <= 1:
            raise RuntimeError(f"{what}: the gate passes a planted fault "
                               f"({name}, excess {r:.3f})")
    note = (f"; planted faults fail it: {', '.join(shown)}" if shown else "")
    print(f"{what}: excess {excess:.3f} of the limit{note}")
    if not excess <= 1:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version")
    return excess


def sdpa_call(q, k, v, mask, causal: bool, scale: float):
    """K1's function as one F.scaled_dot_product_attention call on the
    [B, NH, T, D] views with the same boolean mask (the library yardstick;
    the port never calls it)."""
    t, s = q.shape[1], k.shape[1]
    am = mask[:, None, None, :]
    if causal:
        am = am & torch.ones(t, s, dtype=torch.bool,
                             device=mask.device).tril(s - t)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    return lambda: F.scaled_dot_product_attention(*views, attn_mask=am,
                                                  scale=scale)


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def phase_build():
    t0 = time.perf_counter()
    demangle = shutil.which("c++filt")
    for built in _build.load_all(SOURCES):
        print(f"[1] built {built.path.name} in {built.seconds:.2f} s")
        fn = None
        for ln in built.log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
                if demangle:
                    fn = subprocess.run([demangle, fn], capture_output=True,
                                        text=True).stdout.strip()
            elif fn and ("registers" in ln or "spill" in ln):
                print(f"[1]   {fn}: {ln.split(':', 1)[-1].strip()}")
    print(f"[1] all kernels built in {time.perf_counter() - t0:.2f} s")


def padded_timing_mask(b: int, t: int):
    """The left-padded masks PRs 1-3 timed on: at B=4 the first 0, T/8,
    T/2 and T-1 keys of the four rows hidden (phase 2's), else
    left_padded_mask (phase 5's)."""
    if b != 4:
        return left_padded_mask(b, t)
    pads = torch.tensor([0, t // 8, t // 2, t - 1], device="cuda")
    return torch.arange(t, device="cuda")[None, :] >= pads[:, None]


def phase_kernel():
    """K1 against its plain version on FWD_CASES, then timed at FWD_TIMED
    beside its plain version and the library call. Returns (max |dO| and
    the worst gate excess over the cases, {(b, t): timings})."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    top = {"max_abs_err": 0.0, "gate_excess": 0.0}
    cases = [(c, "left") for c in FWD_CASES] \
        + [(c, "right") for c in FWD_RIGHT_CASES]
    with torch.inference_mode():
        for (b, t, s, nh, nkv, d, causal, qs), padding in cases:
            q, k, v = randn(gen, b, t, nh, d) * qs, randn(gen, b, s, nkv, d), \
                randn(gen, b, s, nkv, d)
            mask = (left_padded_mask(b, s) if padding == "left"
                    else right_padded_mask(b, s))
            scale = d ** -0.5
            o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                         scale=scale)
            ro, rlse = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                     scale)
            torch.cuda.synchronize()
            case = (f"B={b} T={t} S={s} NH={nh} NKV={nkv} D={d} "
                    f"{'causal' if causal else 'non-causal'}"
                    f"{'' if qs == 1 else f' q x {qs}'}, {padding}-padded")
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"{case}: kernel output is not finite")
            if padding == "right":
                print(f"[2] {case}: the all-false row's O is finite "
                      f"(max |O| {o[-1].float().abs().max().item():.3f})")
            seen = T.visible_keys(mask, t, causal)
            rows, long_rows = seen > 0, seen >= LONG_ROW
            err_o = (o.float() - ro.float()).abs()[rows].max().item()
            err_lse = (lse - rlse).abs().transpose(1, 2)[rows].max().item()
            print(f"[2] {case}: max|dO|={err_o:.3e} (|O| up to "
                  f"{ro.float()[rows].abs().max().item():.2f}) max|dlse|="
                  f"{err_lse:.3e} (tol {LSE_ATOL})")
            faults = [(name, flash_attention_fwd_reference(
                q, k, v, hide_keys(mask, 128, w), causal, scale)[0])
                for name, w in (("one key hidden", 1),
                                ("one 64-key tile hidden", 64))
                if long_rows.any()]
            excess = gate("[2]   O", o, ro, rows, faults, long_rows)
            if err_lse > LSE_ATOL:
                raise RuntimeError(f"{case}: kernel's lse disagrees with its "
                                   f"plain version")
            top["max_abs_err"] = max(top["max_abs_err"], err_o)
            top["gate_excess"] = max(top["gate_excess"], excess)
            del faults
        timed = {}
        for b, t in FWD_TIMED:
            nh, d = 32, 128
            q, k, v = (randn(gen, b, t, nh, d) for _ in range(3))
            mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
            padded = padded_timing_mask(b, t)
            scale = d ** -0.5
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask,
                                                     causal=True, scale=scale))
            padded_ms = cuda_ms(lambda: flash_attention_fwd(
                q, k, v, padded, causal=True, scale=scale))
            plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
                q, k, v, mask, True, scale), iters=5)
            library = sdpa_call(q, k, v, mask, True, scale)
            library_ms = cuda_ms(library)
            # the yardstick's own agreement with the plain version, reported
            # beside its time and not gated
            ro = flash_attention_fwd_reference(q, k, v, mask, True, scale)[0]
            lo = library().transpose(1, 2)
            lib_err = (lo.float() - ro.float()).abs().max().item()
            lib_excess = T.attn_excess(lo, ro, mask)
            bound_ms, by = fwd_bound(b, t, t, nh, nh, d, True)
            tflops = 4 * d * b * nh * attn_pairs(t, t, True) / ms / 1e9
            print(f"[2] B={b} T={t} causal, full masks: kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s; {padded_ms:.4f} ms on PR 1-3's "
                  f"left-padded masks), plain {plain_ms:.4f} ms, masked SDPA "
                  f"{library_ms:.4f} ms (max|d| {lib_err:.3e} from the plain "
                  f"version, gate excess {lib_excess:.3f}), bound "
                  f"{bound_ms:.4f} ms ({by})")
            timed[(b, t)] = {"ms": ms, "padded_ms": padded_ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "library_max_abs_err": lib_err,
                             "library_gate_excess": lib_excess,
                             "bound_ms": bound_ms, "bound_by": by}
        # the prefill's call: 8 right-padded BPE prefixes of <= 192 tokens
        b, t, nh, d = 8, MAX_PREFIX, 32, 128
        q, k, v = (randn(gen, b, t, nh, d) for _ in range(3))
        mask = right_padded_mask(b, t)
        scale = d ** -0.5
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, causal=True,
                                                 scale=scale))
        plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
            q, k, v, mask, True, scale), iters=5)
        library_ms = cuda_ms(sdpa_call(q, k, v, mask, True, scale))
        bound_ms, by = fwd_bound(b, t, t, nh, nh, d, True)
        print(f"[2] B={b} T={t} causal, right-padded masks (the prefill's "
              f"call): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, masked "
              f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        timed[("prefill", b, t)] = {"ms": ms, "plain_ms": plain_ms,
                                    "library_ms": library_ms,
                                    "bound_ms": bound_ms, "bound_by": by}
    return top, timed


def model_7b():
    tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
    llm = LlamaConfig.vicuna_7b(vocab_size=32128, max_seq_len=1024,
                                dtype=torch.bfloat16)
    cfg = NavModelConfig(llm=llm, pano=PanoConfig(output_size=llm.hidden_size,
                                                  dtype=torch.bfloat16))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = NavModel(cfg, init_nav_params(cfg, gen))  # on the card
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"[3] Vicuna-7B-width nav model: {n / 1e9:.3f} B params (bf16), "
          f"random init on the card in {time.perf_counter() - t0:.1f} s")
    return tok, cfg, model


def run_eval(agent, ds, args):
    with torch.inference_mode():
        return agent.validate_streaming(
            "R2R", args, T.eval_config(MAX_ACTION_LEN),
            Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)


def slice_dims():
    """The eval slices' padded sizes (bench.py's; max_prefix 192 holds the
    BPE prompts' instruction and history prefixes)."""
    return RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=12,
                       max_hist=16, max_prefix=MAX_PREFIX)


def phase_slice(tag, tok, cfg, model, tmp, warm_up: bool = True,
                window=contextlib.nullcontext, prefix_cache: bool = False,
                prompts=None):
    """Greedy streaming eval of N_EPISODES episodes (after a warm-up on its
    own world); gates every trajectory's start, SR/SPL and K1's launches:
    one per layer of every uncached step, or with ``prefix_cache`` one per
    layer of every prefill call, where the run must have taken the cached
    step only (no whole-prompt step). ``window()`` is entered around the
    measured run (scripts/profile_port.py traces it); ``prompts``, a list,
    receives the uncached steps' prompt texts. Returns ({instr_id:
    trajectory}, the run's counts and measures)."""
    runner = NavModelRunner(cfg, model, tok, dims=slice_dims())
    widths = []
    step, cached_step = runner.eval_step, runner.eval_step_cached
    tokenize = runner.tokenize_with_positions

    def eval_step(state, pano_inputs, batch, *a, **kw):
        widths.append(batch["input_ids"].shape[1])
        return step(state, pano_inputs, batch, *a, **kw)

    def eval_step_cached(state, cache, pano_inputs, batch, *a, **kw):
        widths.append((batch["app_ids"].shape[1], batch["suf_ids"].shape[1]))
        return cached_step(state, cache, pano_inputs, batch, *a, **kw)

    def tokenize_with_positions(texts, *a, **kw):
        if prompts is not None:
            prompts.extend(texts)
        return tokenize(texts, *a, **kw)

    runner.eval_step, runner.eval_step_cached = eval_step, eval_step_cached
    runner.tokenize_with_positions = tokenize_with_positions
    feat = cfg.pano.image_feat_size
    if warm_up:   # cuBLAS handles, allocator, on its own small world
        warm = T.make_r2r_world(f"{tmp}/warm", n_episodes=2 * N_SLOTS, seed=1)
        run_eval(*T.r2r_eval(warm, runner, N_SLOTS, feat,
                             prefix_cache=prefix_cache))
    anno = T.make_r2r_world(f"{tmp}/main", n_episodes=N_EPISODES)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat,
                                 prefix_cache=prefix_cache)
    widths.clear()
    if prompts is not None:
        prompts.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    matmul_q4.launches = matmul_q4.int8_launches = 0
    runner.eval_steps = runner.cached_steps = runner.prefill_calls = 0
    runner.llm_token_units = 0.0
    with window():
        t0 = time.perf_counter()
        preds = run_eval(agent, ds, args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches, layers = flash_attention_fwd.launches, cfg.llm.num_layers
    counts = {"eval_steps": runner.eval_steps,
              "cached_steps": runner.cached_steps,
              "prefill_calls": runner.prefill_calls}
    steps = counts["eval_steps"] + counts["cached_steps"]

    if len(preds) != len(ds):
        raise RuntimeError(f"{len(preds)} trajectories for {len(ds)} episodes")
    for p in preds:
        start = ds.gt_trajs[p["instr_id"]][1][0]
        if p["trajectory"][0][0] != start:
            raise RuntimeError(f"{p['instr_id']} does not start at {start}")
    avg, _ = ds.eval_metrics(preds, None, "R2R")
    if not all(math.isfinite(avg[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"SR/SPL not finite: {avg}")
    if prefix_cache:
        # the memory policy must have agreed: no quiet uncached fallback
        if counts["eval_steps"] or not counts["cached_steps"] \
                or not counts["prefill_calls"]:
            raise RuntimeError(f"the cached run did not take the cached "
                               f"path: {counts}")
        want, per = counts["prefill_calls"] * layers, "prefill calls"
    else:
        want, per = counts["eval_steps"] * layers, "eval steps"
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != "
                           f"{want // layers} {per} x {layers} layers")
    stats = {**counts, "steps": steps, "seconds": dt,
             "episodes_per_s": len(preds) / dt, "ms_per_step": 1e3 * dt / steps,
             "token_units": runner.llm_token_units,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    kind = "cached" if prefix_cache else "eval"
    widths_note = (f"[append | suffix] window widths {sorted(set(widths))}"
                   if prefix_cache else f"prompt widths {sorted(set(widths))}")
    print(f"[{tag}] {len(preds)} episodes in {dt:.3f} s = "
          f"{stats['episodes_per_s']:.3f} episodes/s; {steps} {kind} steps "
          f"of {N_SLOTS} slots, {stats['ms_per_step']:.2f} ms wall per step; "
          f"{widths_note}; {stats['token_units'] / steps:.1f} LLM tokens per "
          f"step; peak memory {stats['peak_gib']:.2f} GiB; SR "
          f"{avg['sr']:.2f} SPL {avg['spl']:.2f}; flash kernel launches "
          f"{launches} = {want // layers} {per} x {layers}")
    return {p["instr_id"]: p["trajectory"] for p in preds}, stats


def ab_batch(cfg):
    """Phase 4's inputs: 4 rows of 768 tokens, left-padded."""
    batch = T.synthetic_nav_batch(cfg, b=4, g=48, v=45, c=12, hh=16,
                                  tlen=768, seed=0)
    for row, pad in enumerate((0, 64, 300, 700)):
        batch["attention_mask"][row, :pad] = False
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def compare_logits(tag, what, model, cfg_a, cfg_b):
    """forward_navigation through two configs on phase 4's inputs."""
    dev = ab_batch(cfg_a)
    with torch.inference_mode():
        la = forward_navigation(model, cfg_a, dev)["fuse_logits"]
        lb = forward_navigation(model, cfg_b, dev)["fuse_logits"]
    if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
        raise RuntimeError("logits are not finite")
    valid = lb > NEG_INF / 2
    diff = (la - lb).abs()[valid].max().item()
    agree = (la.argmax(-1) == lb.argmax(-1)).float().mean().item()
    print(f"[{tag}] forward_navigation {what}: max |dlogit| {diff:.4e} over "
          f"{int(valid.sum())} candidate logits (range "
          f"{lb[valid].min().item():.3f}..{lb[valid].max().item():.3f}); "
          f"argmax agreement {agree:.2f}")


def phase_ab(cfg, model):
    eager = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, attn_impl="eager"))
    compare_logits(4, "kernel vs eager attention", model, cfg, eager)


def keys_seen_by(mask, t: int, causal: bool):
    """[B, S]: how many query rows see each valid key (0 for hidden keys)."""
    s = mask.shape[1]
    keys = mask[:, None, :].expand(-1, t, -1)
    if causal:
        keys = keys & mask.new_ones((t, s)).tril(s - t)
    return keys.sum(1)


def phase_backward():
    """K3 (with its delta) and K2 against their plain versions on
    BWD_CASES, FlashAttention against eager autograd, then both kernels
    timed beside their plain versions and the library call. Returns
    ({"dkv", "dq"}: max |err| and worst gate excess, {T: timings})."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"dkv": {"max_abs_err": 0.0, "gate_excess": 0.0},
            "dq": {"max_abs_err": 0.0, "gate_excess": 0.0,
                   "delta_excess": 0.0}}
    for b, t, s, nh, nkv, d, causal, qs in BWD_CASES:
        scale = 1.0 / math.sqrt(d)
        q = randn(gen, b, t, nh, d) * qs
        k, v = randn(gen, b, s, nkv, d), randn(gen, b, s, nkv, d)
        do = randn(gen, b, t, nh, d)
        # left padding: under causal the first pads[i] rows of row i see no
        # valid key. Without causal every row of a batch row sees all of its
        # keys, so each keeps two: where every row sees one key alone, P = 1
        # and dS = P (dP - delta) is zero but for rounding, and dK there is
        # a sum of rounding noise on both sides, not a check of the kernel
        mask = left_padded_mask(b, s, 1 if causal else 2)
        case = (f"B={b} T={t} S={s} NH={nh} NKV={nkv} D={d} "
                f"{'causal' if causal else 'non-causal'}"
                f"{'' if qs == 1 else f' q x {qs}'}")
        with torch.inference_mode():
            o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                         scale=scale)
            dq, kdelta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                                causal=causal, scale=scale)
            dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, kdelta, do,
                                             causal=causal, scale=scale)
            delta = attention_delta(o, do)
            # the plain versions on the delta K3 computed, which is held to
            # attention_delta on its own: where a key is the only one a row
            # sees, dK (and the row's dQ) is a cancellation to rounding
            # noise that moves with delta's last bits
            args = (q, k, v, mask, lse, kdelta, do)
            rk, rv = flash_attention_bwd_dkv_reference(*args, causal, scale)
            rq = flash_attention_bwd_dq_reference(*args, causal, scale)
            torch.cuda.synchronize()
            for name, x in (("dK", dk), ("dV", dv), ("dQ", dq),
                            ("delta", kdelta)):
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"{case}: {name} is not finite")
            # K3's delta against attention_delta, to DELTA_RTOL of each
            # row's sum of |O * dO|
            size = (o.float() * do.float()).abs().sum(-1).transpose(1, 2)
            d_ex = ((kdelta - delta).abs() / (DELTA_RTOL * size)).max().item()
            print(f"[5] {case}: delta max|d| "
                  f"{(kdelta - delta).abs().max().item():.3e}, "
                  f"{d_ex:.3f} of its limit")
            if not d_ex <= 1:
                raise RuntimeError(f"{case}: the dQ kernel's delta disagrees "
                                   f"with attention_delta")
            seen = T.visible_keys(mask, t, causal)
            rows_q, long_q = seen > 0, seen >= LONG_ROW
            long_k = keys_seen_by(mask, t, causal) >= LONG_ROW

            def skipped_rows(w):      # what skipping query rows gives K2
                hidden = lse.clone()
                hidden[:, :, 128:128 + w] = NEG_INF
                return flash_attention_bwd_dkv_reference(
                    q, k, v, mask, hidden, kdelta, do, causal, scale)

            dq_faults = [(name, flash_attention_bwd_dq_reference(
                q, k, v, hide_keys(mask, 128, w), lse, kdelta, do, causal,
                scale)) for name, w in (("one key hidden", 1),
                                        ("one 64-key tile hidden", 64))]
            dkv_faults = [(name, skipped_rows(w))
                          for name, w in (("one query row skipped", 1),
                                          ("one 64-row query tile skipped",
                                           64))]
            print(f"[5] {case}: max|err| dK "
                  f"{(dk.float() - rk.float()).abs().max():.3e}, dV "
                  f"{(dv.float() - rv.float()).abs().max():.3e}, dQ "
                  f"{(dq.float() - rq.float()).abs().max():.3e} (|grad| up "
                  f"to {max(x.float().abs().max() for x in (rk, rv, rq)):.2f})")
            ex = {"dkv": max(
                gate("[5]   dK", dk, rk, mask,
                     [(n, f[0]) for n, f in dkv_faults], long_k),
                gate("[5]   dV", dv, rv, mask,
                     [(n, f[1]) for n, f in dkv_faults], long_k)),
                "dq": gate("[5]   dQ", dq, rq, rows_q, dq_faults, long_q)}
            del dq_faults, dkv_faults
            errs["dq"]["delta_excess"] = max(errs["dq"]["delta_excess"], d_ex)
            for key, got, want, rows in (("dkv", (dk, dv), (rk, rv), mask),
                                         ("dq", (dq,), (rq,), rows_q)):
                e = errs[key]
                e["gate_excess"] = max(e["gate_excess"], ex[key])
                for a, w in zip(got, want):
                    e["max_abs_err"] = max(e["max_abs_err"], (
                        a.float() - w.float()).abs()[rows].max().item())
            # rows that see no valid key: dQ exactly 0; hidden keys: dK and
            # dV exactly 0
            dead = ~rows_q
            if dq[dead].float().abs().sum().item() != 0.0:
                raise RuntimeError(f"{case}: fully-masked rows got a dQ")
            if (dk[~mask].float().abs().sum().item() != 0.0
                    or dv[~mask].float().abs().sum().item() != 0.0):
                raise RuntimeError(f"{case}: hidden keys got a dK or dV")
        print(f"[5]   dQ exactly 0 on the {int(dead.sum())} rows that see no "
              f"valid key; dK and dV exactly 0 on the {int((~mask).sum())} "
              f"hidden keys")
    b, nh, d = ROWS_PER_CALL, 32, 128
    scale = 1.0 / math.sqrt(d)
    # the differentiable FlashAttention against autograd of the eager path
    # (cotangent zero on rows that see no valid key, as in the model)
    do = do * mask[:, :, None, None]
    grads = []
    for fn in (lambda *x: FlashAttention.apply(*x, mask, True, scale),
               lambda *x: attention_eager(*x, mask, True, scale)):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(do)
        grads.append([x.grad.float() for x in xs])
    err = max((a - w).abs().max().item() for a, w in zip(*grads))
    print(f"[5] FlashAttention vs autograd through attention_eager (T={t}): "
          f"max|d(dq,dk,dv)| {err:.3e} (tol {EAGER_GRAD_ATOL})")
    if err > EAGER_GRAD_ATOL:
        raise RuntimeError("FlashAttention's gradient disagrees with the "
                           "eager path's")
    del grads, dk, dv, dq, rk, rv, rq
    timed = {}
    for t in (640, 1024):
        q, k, v, do = (randn(gen, b, t, nh, d) for _ in range(4))
        res = {"dkv": {}, "dq": {}}
        for masks in ("full", "padded"):
            mask = (torch.ones((b, t), dtype=torch.bool, device="cuda")
                    if masks == "full" else left_padded_mask(b, t))
            with torch.inference_mode():
                o, lse = flash_attention_fwd(q, k, v, mask, causal=True,
                                             scale=scale)
                delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                               causal=True, scale=scale)[1]
                # K3 computes dQ and delta; its plain version is the two
                # plain passes
                for key, call, ref in (
                        ("dkv", lambda: flash_attention_bwd_dkv(
                            q, k, v, mask, lse, delta, do, causal=True,
                            scale=scale),
                         lambda: flash_attention_bwd_dkv_reference(
                             q, k, v, mask, lse, delta, do, True, scale)),
                        ("dq", lambda: flash_attention_bwd_dq(
                            q, k, v, mask, lse, o, do, causal=True,
                            scale=scale),
                         lambda: flash_attention_bwd_dq_reference(
                             q, k, v, mask, lse, attention_delta(o, do), do,
                             True, scale))):
                    # ~0.5 s of launches, so nvidia-smi reads a busy card
                    iters = max(20, math.ceil(500 / cuda_ms(call, iters=5)))
                    ms, clock = cuda_ms_clocked(call, iters)
                    if masks == "full":
                        res[key].update(ms=ms, clock=clock,
                                        plain_ms=cuda_ms(ref, iters=5))
                    else:
                        res[key].update(padded_ms=ms, padded_clock=clock)
                if masks == "full":
                    delta_ms = cuda_ms(lambda: attention_delta(o, do))
                    want = flash_attention_bwd_reference(
                        q, k, v, mask, o, lse, do, True, scale)
        # the library yardstick: the backward of the masked SDPA call
        # (dQ, dK, dV and its own delta), on full masks; its agreement
        # with the plain version is reported beside it and not gated
        mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa_call(*xs, mask, True, scale)()
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, xs, dot, retain_graph=True))
        lib = torch.autograd.grad(out, xs, dot)
        lib_err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(lib, want))
        lib_excess = max(T.attn_excess(a, w, mask) for a, w in zip(lib, want))
        del out, xs, lib, want
        for key, (bound_ms, by) in zip(("dkv", "dq"),
                                       bwd_bounds(b, t, nh, d)):
            res[key].update(library_ms=library_ms,
                            library_max_abs_err=lib_err,
                            library_gate_excess=lib_excess,
                            bound_ms=bound_ms, bound_by=by)
        timed[t] = res
        dkv, dq = res["dkv"], res["dq"]
        print(f"[5] T={t}, B={b} causal, full masks: dK/dV kernel "
              f"{dkv['ms']:.4f} ms (plain {dkv['plain_ms']:.4f}, bound "
              f"{dkv['bound_ms']:.4f}); dQ kernel with delta {dq['ms']:.4f} "
              f"ms (plain dQ + attention_delta {dq['plain_ms']:.4f}, bound "
              f"{dq['bound_ms']:.4f}); together {dkv['ms'] + dq['ms']:.4f} "
              f"ms against the masked SDPA backward's {library_ms:.4f} ms "
              f"(max|d| {lib_err:.3e} from the plain version, gate excess "
              f"{lib_excess:.3f}); the plain attention_delta pass, no longer "
              f"on the path, takes {delta_ms:.4f} ms")
        for key, name in (("dkv", "dK/dV"), ("dq", "dQ")):
            r = res[key]
            print(f"[5]   {name} on full masks {r['ms']:.4f} ms (SM clock, "
                  f"power: {r['clock']}); on PR 2's left-padded masks "
                  f"{r['padded_ms']:.4f} ms ({r['padded_clock']})")
    return errs, timed


def phase_train(tok, cfg, model, tmp, window=contextlib.nullcontext):
    """``window()`` is entered around the measured epoch. Returns (kernel
    launches of the measured run, the first grad call's arguments for
    phase 7)."""
    # every unvisited node of the graph map is a candidate (max_cands =
    # max_gmap_nodes - 1): a teacher target left out of the prompt would
    # score NEG_INF and give a loss of ~1e29
    dims = RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=47,
                       max_hist=16)
    args = TrainArgs(stage="pretrain", image_feat_size=cfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL,
                     gradient_accumulation_step=2, seed=0)
    runner = NavModelRunner(cfg, model, tok, dims=dims,
                            feat_dropout=args.feat_dropout, seed=args.seed)
    # fill: valid keys and all keys of the grad calls' [rows, T] masks
    widths, losses, first_call, tokens, fill = [], [], [], [0], [0, 0]
    grad_call = runner.pano_navigation_train

    def recorded_grad_call(pano_inputs, seed, batch, targets, coef):
        widths.append(batch["input_ids"].shape[1])
        # tokens of the rows that carry a target (not the chunk padding)
        tokens[0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        fill[0] += int(batch["attention_mask"].sum())
        fill[1] += math.prod(batch["attention_mask"].shape)
        if not first_call:
            first_call.append((pano_inputs, seed, batch, targets, coef))
        return grad_call(pano_inputs, seed, batch, targets, coef)

    runner.pano_navigation_train = recorded_grad_call
    config = T.train_config(MAX_ACTION_LEN)
    tx = make_optimizer(dict(model.named_parameters()), lr=args.lr,
                        num_warmup_steps=args.num_warmup_steps,
                        grad_clip_norm=args.grad_clip_norm)
    moments = sum(x.numel() * x.element_size()
                  for st in (tx.mu, tx.nu) for x in st.values())

    def epoch(root, n_episodes, seed):
        anno = T.make_r2r_world(root, n_episodes=n_episodes, seed=seed,
                                split="train")
        agent, ds, loader = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        train = agent.train

        def recorded_train(*a, **kw):
            loss = train(*a, **kw)
            losses.append(loss)
            return loss

        agent.train = recorded_train
        return train_one_epoch(
            args, config, runner, tx, make_opt_step(tx),
            MetaLoader({"R2R": (loader, 1.0)}), {"R2R": agent},
            {"R2R": ds}, 0, None, num_batches=len(loader))

    # warm-up epoch (cuBLAS handles, allocator) on its own small world
    epoch(f"{tmp}/warm", 2 * TRAIN_BATCH, seed=1)
    widths.clear()
    losses.clear()
    tokens[0] = fill[0] = fill[1] = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    runner.grad_calls = 0
    with window():
        t0 = time.perf_counter()
        avg_loss, norms = epoch(f"{tmp}/main", TRAIN_EPISODES, seed=0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    calls, layers = runner.grad_calls, cfg.llm.num_layers
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n_batches = TRAIN_EPISODES // TRAIN_BATCH
    if len(losses) != n_batches or not all(
            math.isfinite(float(x)) and 0 < float(x) < MAX_LOSS
            for x in losses):
        raise RuntimeError(f"losses {[float(x) for x in losses]}: not all "
                           f"finite and in (0, {MAX_LOSS})")
    norms = [float(n) for n in norms]
    if len(norms) != n_batches // args.gradient_accumulation_step or not all(
            math.isfinite(n) and n > 0 for n in norms):
        raise RuntimeError(f"global gradient norms {norms}")
    if launches["dkv"] != calls * layers or launches["dq"] != calls * layers:
        raise RuntimeError(f"backward launches {launches} != {calls} grad "
                           f"calls x {layers} layers")
    # remat: each grad call runs every layer's forward once, and once more
    # when the backward recomputes the layer, so K1 launches twice per
    # layer; the pano encoder's attention is eager and launches none
    if launches["fwd"] != 2 * calls * layers:
        raise RuntimeError(f"forward launches {launches['fwd']} != 2 x "
                           f"{calls} grad calls x {layers} layers")
    tokens = tokens[0]
    print(f"[6] trained {TRAIN_EPISODES} episodes in {dt:.3f} s = "
          f"{TRAIN_EPISODES / dt:.3f} episodes/s; {len(norms)} optimizer "
          f"steps, {1e3 * dt / len(norms):.1f} ms wall per step; {calls} "
          f"grad calls of {ROWS_PER_CALL} rows, prompt widths "
          f"{sorted(set(widths))}, key masks {100 * fill[0] / fill[1]:.1f}%"
          f" valid; {tokens} trained tokens = "
          f"{tokens / dt:.0f} tokens/s; peak memory {peak:.2f} GiB "
          f"(AdamW moments {moments / 2 ** 30:.2f} GiB); losses "
          f"{[round(float(x), 4) for x in losses]} (mean {avg_loss:.4f}); "
          f"grad norms {[round(n, 4) for n in norms]}; launches {launches}")
    del tx
    return launches, first_call[0]


def phase_grad_ab(tok, cfg, model, call):
    """One grad call through the kernels and through eager attention."""
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.wq[{last}]": lambda m: m.llm.layers.wq.grad[last],
             "out_head.w": lambda m: m.out_head.w.grad,
             "pano.mapper.w": lambda m: m.pano.mapper.w.grad}
    res = {}
    for impl in ("auto", "eager"):
        cfg_i = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, attn_impl=impl),
            pano=dataclasses.replace(cfg.pano, hidden_dropout_prob=0.0))
        runner = NavModelRunner(cfg_i, model, tok, feat_dropout=0.0)
        runner.zero_grads()
        loss = float(runner.pano_navigation_train(*call))
        res[impl] = (loss, {k: f(model).float().clone()
                            for k, f in watch.items()})
    (lk, gk), (le, ge) = res["auto"], res["eager"]
    print(f"[7] one grad call of {ROWS_PER_CALL} rows: loss kernel {lk:.6f} "
          f"eager {le:.6f} (diff {abs(lk - le):.3e})")
    for name in watch:
        a, w = gk[name].flatten(), ge[name].flatten()
        rel = ((a - w).norm() / w.norm()).item()
        cos = torch.nn.functional.cosine_similarity(a, w, dim=0).item()
        print(f"[7] {name}: rel L2 err {rel:.3e}, cosine {cos:.6f} "
              f"(|g| {w.norm().item():.4e})")
        if not cos >= MIN_GRAD_COSINE:
            raise RuntimeError(f"{name}: gradient cosine {cos} < "
                               f"{MIN_GRAD_COSINE}")


def int4pack(q4p, s):
    """The port's int4 weight (nibbles [h, o/2], scales [h/G, o]) in the
    layout of torch's own int4 matmul, torch._weight_int4pack_mm: packed
    [o, h] nibbles shifted by +8 and [h/G, o, 2] scales with zero points 0
    (that op dequantizes (q - 8) * scale + zero)."""
    w = (unpack_q4(q4p).to(torch.int32) + 8).t().contiguous()
    packed = torch._convert_weight_to_int4pack(
        (w[:, ::2] << 4 | w[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([s, torch.zeros_like(s)], -1).to(torch.bfloat16)
    return packed, sz.contiguous()


def phase_q4_kernel():
    """Returns {(m, h, o, mode): row}, row holding max_abs_err, ms,
    plain_ms, library_ms (w4: with the call's max |d| from the plain version
    and how far beyond K4's tolerance; w4a8: None, with the reason in
    ``library``), bound_ms and bound_by."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    has_lib = all(hasattr(torch, f) for f in ("_weight_int4pack_mm",
                                             "_convert_weight_to_int4pack"))
    out = {}
    for h, o in Q4_SHAPES:
        w = torch.randn((h, o), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * h ** -0.5
        q4p, s = _quant_one4(w)
        g = h // s.shape[0]
        packed = int4pack(q4p, s) if has_lib else None
        for m in (4096, 3584, 7):
            x = torch.randn((m, h), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            dense_ms = cuda_ms(lambda: x @ w)
            for mode, a in (("w4", x), ("w4a8", _act_q(x)[0])):
                y = matmul_q4(a, q4p, s)
                ref = matmul_q4_reference(a, q4p, s)
                torch.cuda.synchronize()
                if not torch.isfinite(y).all():
                    raise RuntimeError(f"{mode} m={m} h={h} o={o}: kernel "
                                       f"output is not finite")
                top = ref.float().abs()
                tol = (2 ** -7 * top + Q4_FLOOR * top.max() if mode == "w4"
                       else Q4_A8_RTOL * top)
                d = (y.float() - ref.float()).abs()
                rel = (d / top.clamp(min=Q4_FLOOR * top.max().item())).max()
                ms = cuda_ms(lambda: matmul_q4(a, q4p, s))
                plain_ms = cuda_ms(lambda: matmul_q4_reference(a, q4p, s),
                                   iters=5)
                bound_ms, by = q4_bound(m, h, o, g, mode == "w4a8")
                err = d.max().item()
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, "bound_ms": bound_ms,
                       "bound_by": by}
                lib_note = ""
                if mode == "w4a8":
                    row["library"] = ("none: no PyTorch call multiplies int8 "
                                      "activations by int4 weights")
                elif not has_lib:
                    row["library"] = ("none: this torch has no "
                                      "_weight_int4pack_mm")
                else:
                    # the yardstick's agreement with the plain version is
                    # reported beside its time and not gated (it rounds the
                    # dequantized weight to bf16)
                    lib = lambda: torch._weight_int4pack_mm(x, packed[0], g,
                                                            packed[1])
                    lib_ms = cuda_ms(lib)
                    ld = (lib().float() - ref.float()).abs()
                    over = (ld - tol).max().item()
                    row.update(library_ms=lib_ms,
                               library_max_abs_err=ld.max().item(),
                               library_beyond_tol=max(over, 0.0),
                               library="torch._weight_int4pack_mm on the "
                                       "repacked weight")
                    lib_note = (f", torch._weight_int4pack_mm {lib_ms:.4f} "
                                f"ms (max|d| {ld.max().item():.3e} from the "
                                f"plain version; beyond K4's tolerance by "
                                f"{max(over, 0.0):.3e})")
                print(f"[8] {mode} m={m} h={h} o={o}: max|d|={err:.3e} "
                      f"(max |d|/|ref| {rel.item():.3e}, |ref| up to "
                      f"{top.max().item():.2f}); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, dense bf16 matmul {dense_ms:.4f} "
                      f"ms{lib_note}; bound {bound_ms:.4f} ms ({by}); "
                      f"{2 * m * h * o / ms / 1e9:.1f} TFLOP/s")
                if (d - tol).max().item() > 0:
                    raise RuntimeError(f"{mode} m={m} h={h} o={o}: kernel "
                                       f"disagrees with its plain version")
                out[(m, h, o, mode)] = row
    return out


def quantize_model(cfg, model):
    """The model with its LLM in int4 (bits=4), quantized on the card;
    the bf16 LLM's storage is freed by the caller dropping ``model``."""
    for p in model.parameters():       # phase 6's gradients
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = NavModel(cfg, quantize_nav_params(model, bits=4))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())
    print(f"[9] LLM quantized to int4 on the card in {dt:.2f} s: "
          f"{nbytes(model.llm) / 1e9:.3f} GB -> {nbytes(qmodel.llm) / 1e9:.3f}"
          f" GB (layer matmuls int4, embed and lm_head int8)")
    return qmodel


def phase_q4_slice(tag, tok, cfg, qmodel, tmp, dense_trajs, warm_up,
                   window=contextlib.nullcontext, prefix_cache: bool = False,
                   dense_tag: int = 3):
    """K4 launches once per layer matmul of every LLM pass: each uncached
    step, or each prefill call and cached step. Returns (the int4 kernel's
    launches in the measured run, the trajectories, phase_slice's
    stats)."""
    trajs, stats = phase_slice(tag, tok, cfg, qmodel, tmp, warm_up=warm_up,
                               window=window, prefix_cache=prefix_cache)
    launches, int8 = matmul_q4.launches, matmul_q4.int8_launches
    passes = stats["steps"] + stats["prefill_calls"]
    want = passes * cfg.llm.num_layers * Q4_LAYER_MATMULS
    if launches != want:
        raise RuntimeError(f"int4 kernel launches {launches} != {passes} "
                           f"LLM passes x {cfg.llm.num_layers} layers x "
                           f"{Q4_LAYER_MATMULS}")
    if int8 != (launches if cfg.llm.act_int8 else 0):
        raise RuntimeError(f"{int8} of {launches} int4 launches had int8 "
                           f"activations (act_int8={cfg.llm.act_int8})")
    same = sum(trajs[k] == dense_trajs[k] for k in trajs)
    what = (f"({stats['prefill_calls']} prefill calls + {stats['steps']} "
            f"cached steps)" if prefix_cache else f"{passes} steps")
    print(f"[{tag}] int4 kernel launches {launches} = {what} x "
          f"{cfg.llm.num_layers} x {Q4_LAYER_MATMULS} (int8 activations: "
          f"{int8}); trajectories equal to phase {dense_tag}'s (bf16, before "
          f"training moved the weights): {same} of {len(trajs)}")
    return launches, trajs, stats


def phase_bpe_check(byte_tok, bpe, prompts):
    """The port's BPE (plain Python; the card's machine has no
    `tokenizers`) against the ids the JAX package's tokenizer gave on the
    CPU (tests/fixtures/bpe_nav_golden.json, which a CPU test holds equal
    to JAX's output); decode(encode(x)) == x; the prompt width, byte
    against BPE, on phase 3's prompts."""
    golden = json.loads((Path(__file__).resolve().parent
                         / BPE_GOLDEN).read_text())
    bad = [t for t, ids in zip(golden["texts"], golden["ids"])
           if bpe.encode(t) != ids]
    if bad or not golden["texts"]:
        raise RuntimeError(f"BPE ids differ from the golden ids on "
                           f"{len(bad)} of {len(golden['texts'])} texts: "
                           f"{bad[:2]!r}")
    texts = sorted(set(prompts)) + golden["texts"]
    be = bpe.backend
    lost = [t for t in texts if be.decode(be.encode(t), False) != t]
    if lost or not prompts:
        raise RuntimeError(f"decode(encode(x)) != x on {len(lost)} texts: "
                           f"{lost[:2]!r}")
    nb = sum(len(byte_tok.encode(p)) for p in prompts) / len(prompts)
    nt = sum(len(bpe.encode(p)) for p in prompts) / len(prompts)
    print(f"[12] BPE ids equal the golden ids on all {len(golden['texts'])} "
          f"texts; decode(encode(x)) == x on {len(texts)} texts; phase 3's "
          f"{len(prompts)} prompts: {nb:.1f} byte tokens against {nt:.1f} "
          f"BPE tokens on average ({nb / nt:.2f}x)")


WINDOW_KEYS = ("app_ids", "app_mask", "app_hist_pos", "suf_ids", "suf_mask",
               "cand_positions", "cls_pos")


def logit_excess(got, want) -> float:
    """The worst |got - want| / tol over want's valid logits (the
    CACHED_LOGIT_* bound); both must mask the same logits."""
    valid = want > NEG_INF / 2
    if not torch.equal(got > NEG_INF / 2, valid):
        return math.inf
    w = torch.where(valid, want, torch.zeros((), device=want.device))
    rms = (w.square().sum(-1, keepdim=True)
           / valid.sum(-1, keepdim=True).clamp(min=1)).sqrt()
    tol = CACHED_LOGIT_REL * want.abs() + CACHED_LOGIT_ROW * rms
    return ((got - want).abs() / tol)[valid].max().item()


def phase_cached_ab(bpe, cfg, model, tmp):
    """One slot group's cached step against the uncached step on the same
    state and prompts. A cached run on its own small world, its stop logit
    lowered by AB_STOP_SHIFT so that the episodes run on, snapshots its
    AB_SNAPSHOT-th step on which every slot is active and appends history
    (the cache built by a prefill and several appends); with the stop
    logit restored, that step is replayed through eval_step_cached and
    through eval_step on the same prompts. The candidate logits are gated
    per element (CACHED_LOGIT_*); the same cached step with the last cached
    token hidden from the prefix (plen - 1) must fail the gate."""
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
    feat = cfg.pano.image_feat_size
    anno = T.make_r2r_world(f"{tmp}/ab", n_episodes=2 * N_SLOTS, seed=2)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat,
                                 prefix_cache=True)
    snap, seen, found = {}, [], [0]
    step, windows = runner.eval_step_cached, agent._cached_prompt_windows

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    def eval_step_cached(state, cache, pano, batch, reset, cur, cand, active,
                         *a, **kw):
        if active.all() and batch["app_mask"].any(1).all():
            found[0] += 1
        if not snap and found[0] == AB_SNAPSHOT:
            snap.update(state=clone(state), cache=clone(cache), pano=pano,
                        batch=batch, args=(reset.copy(), cur.copy(),
                                           cand.copy(), active.copy()),
                        prompts=list(seen[-1]))
        return step(state, cache, pano, batch, reset, cur, cand, active,
                    *a, **kw)

    def cached_prompt_windows(slots, prompts, *a):
        seen.append(list(prompts))
        return windows(slots, prompts, *a)

    runner.eval_step_cached = eval_step_cached
    agent._cached_prompt_windows = cached_prompt_windows
    stop_b = model.out_head.b
    with torch.no_grad():
        stop_b0 = stop_b[0].clone()
        stop_b[0] -= AB_STOP_SHIFT
        try:
            run_eval(agent, ds, args)
        finally:
            stop_b[0] = stop_b0
    if not snap:
        raise RuntimeError("no cached step with history to compare")

    with torch.inference_mode():
        def cached(hide: int):
            cache = clone(snap["cache"])
            cache["plen"] -= hide
            return step(clone(snap["state"]), cache, snap["pano"],
                        snap["batch"], *snap["args"])[3]

        got, fault = cached(0), cached(1)
        toks, cand_pos, hist_pos, cls_pos = runner.tokenize_with_positions(
            snap["prompts"])
        batch = {k: v for k, v in snap["batch"].items()
                 if k not in WINDOW_KEYS}
        batch.update(input_ids=toks.input_ids,
                     attention_mask=toks.attention_mask,
                     cand_positions=cand_pos, hist_positions=hist_pos,
                     cls_pos=cls_pos)
        want = runner.eval_step(clone(snap["state"]), snap["pano"], batch,
                                *snap["args"])[2]
        torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("cached-step A/B: logits are not finite")
    valid = want > NEG_INF / 2
    excess, f_excess = logit_excess(got, want), logit_excess(fault, want)
    n_hist = int(snap["batch"]["app_mask"].sum(1).min())
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[15] cached step vs uncached step ({N_SLOTS} slots, each "
          f"appending >= {n_hist} history tokens, at the slots' step "
          f"{AB_SNAPSHOT} or later; prompts of {toks.input_ids.shape[1]} "
          f"tokens, "
          f"windows {snap['batch']['app_ids'].shape[1]} | "
          f"{snap['batch']['suf_ids'].shape[1]}): max |dlogit| "
          f"{(got - want).abs()[valid].max().item():.4e} over "
          f"{int(valid.sum())} candidate logits (range "
          f"{want[valid].min().item():.3f}..{want[valid].max().item():.3f}), "
          f"excess {excess:.3f} of the limit; argmax agreement {agree:.2f}; "
          f"planted fault (last cached token hidden) fails it: excess "
          f"{f_excess:.1f}")
    if f_excess <= 1:
        raise RuntimeError(f"cached-step A/B: the gate passes a planted "
                           f"fault (excess {f_excess:.3f})")
    if not excess <= 1:
        raise RuntimeError("cached-step A/B: the cached step disagrees with "
                           "the uncached step")
    return excess


def report_cached(tag, cfg, trajs, stats, ref_trajs, ref_stats, ref_tag):
    """The cached run beside the uncached one on the same tokenizer."""
    c = cfg.llm
    cache_bytes = (2 * c.num_layers * N_SLOTS * MAX_PREFIX * c.num_kv_heads
                   * c.head_dim * c.dtype.itemsize)
    same = sum(trajs[k] == ref_trajs[k] for k in trajs)
    tok_c = stats["token_units"] / stats["steps"]
    tok_u = ref_stats["token_units"] / ref_stats["steps"]
    print(f"[{tag}] against phase {ref_tag} (uncached): {tok_c:.1f} against "
          f"{tok_u:.1f} LLM tokens per step ({tok_u / tok_c:.2f}x fewer, "
          f"prefills included); {stats['ms_per_step']:.2f} against "
          f"{ref_stats['ms_per_step']:.2f} ms wall per step; "
          f"{stats['episodes_per_s']:.3f} against "
          f"{ref_stats['episodes_per_s']:.3f} episodes/s; peak memory "
          f"{stats['peak_gib']:.2f} against {ref_stats['peak_gib']:.2f} GiB; "
          f"cache {cache_bytes} bytes ({cache_bytes / 2 ** 30:.3f} GiB) per "
          f"stream of {N_SLOTS} slots x {MAX_PREFIX} tokens; trajectories "
          f"equal to phase {ref_tag}'s: {same} of {len(trajs)}")


def main():
    smi = phase_device()
    phase_build()
    fwd_err, fwd_timed = phase_kernel()
    tok, cfg, model = model_7b()
    prompts = []
    with tempfile.TemporaryDirectory() as tmp:
        dense_trajs, _ = phase_slice(3, tok, cfg, model, tmp, prompts=prompts)
    phase_ab(cfg, model)
    # the BPE slices at 7B width, bf16, before training moves the weights
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    phase_bpe_check(tok, bpe, prompts)
    with tempfile.TemporaryDirectory() as tmp:
        bpe_trajs, bpe_stats = phase_slice(13, bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cached_trajs, cached_stats = phase_slice(14, bpe, cfg, model, tmp,
                                                 prefix_cache=True)
    report_cached(14, cfg, cached_trajs, cached_stats, bpe_trajs, bpe_stats,
                  13)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cached_ab(bpe, cfg, model, tmp)
    bwd_err, bwd_timed = phase_backward()
    with tempfile.TemporaryDirectory() as tmp:
        launches, call = phase_train(tok, cfg, model, tmp)
    phase_grad_ab(tok, cfg, model, call)
    del call
    q4 = phase_q4_kernel()
    qmodel = quantize_model(cfg, model)
    # free the bf16 LLM: the phases' runners hold it in reference cycles
    # (their wrapped methods), so it goes with a collection
    del model
    gc.collect()
    torch.cuda.empty_cache()
    a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                          act_int8=True))
    with tempfile.TemporaryDirectory() as tmp:
        launches["q4"], w4, w4_stats = phase_q4_slice(
            9, tok, cfg, qmodel, tmp, dense_trajs, warm_up=True)
    with tempfile.TemporaryDirectory() as tmp:
        _, w4a8, w4a8_stats = phase_q4_slice(10, tok, a8, qmodel, tmp,
                                             dense_trajs, warm_up=False)
    print(f"[10] w4a8 trajectories equal to w4's (same int4 tree): "
          f"{sum(w4a8[k] == w4[k] for k in w4)} of {len(w4)}")
    # the cached BPE slices on the int4 tree: prefills and cached steps
    # through K4
    for tag, c, warm, ref, ref_tag in ((16, cfg, True, w4_stats, 9),
                                       (17, a8, False, w4a8_stats, 10)):
        with tempfile.TemporaryDirectory() as tmp:
            _, _, st = phase_q4_slice(tag, bpe, c, qmodel, tmp, bpe_trajs,
                                      warm_up=warm, prefix_cache=True,
                                      dense_tag=13)
        print(f"[{tag}] {st['ms_per_step']:.2f} ms wall per cached BPE step "
              f"and peak memory {st['peak_gib']:.2f} GiB, beside phase "
              f"{ref_tag}'s byte-prompt uncached {ref['ms_per_step']:.2f} ms "
              f"and {ref['peak_gib']:.2f} GiB")
    for c in (cfg, a8):
        plain = dataclasses.replace(c, llm=dataclasses.replace(
            c.llm, q4_impl="plain"))
        mode = "w4a8" if c.llm.act_int8 else "w4"
        compare_logits(11, f"on the int4 tree ({mode}): kernel vs plain "
                       f"version", qmodel, c, plain)
    # K1 at the eval slice's widest prompts (B=4, T=1024), K2/K3 at the
    # training slice's (B=16, T=1024), K4 at the w_gate shape with 4 slots
    # of 1024 tokens (w4); launches from the measured runs of phases 6
    # (K1-K3) and 9 (K4)
    sdpa = ("F.scaled_dot_product_attention on the [B, NH, T, D] views with "
            "the same boolean mask (causal AND key mask)")
    rows = [{**KERNELS["fwd"], "launches": launches["fwd"],
             **fwd_err, **fwd_timed[(4, 1024)],
             "shape": "B=4 T=S=1024 NH=32 D=128 causal", "library": sdpa}]
    for key in ("dkv", "dq"):
        rows.append({**KERNELS[key], "launches": launches[key],
                     **bwd_err[key], **bwd_timed[1024][key],
                     "shape": "B=16 T=S=1024 NH=32 D=128 causal",
                     "library": "the backward of " + sdpa + " (dQ, dK, dV "
                                "and delta in one call)"})
    rows.append({**KERNELS["q4"], "launches": launches["q4"],
                 **q4[(4096, 4096, 11008, "w4")],
                 "max_abs_err": max(r["max_abs_err"] for r in q4.values()),
                 "shape": "m=4096 h=4096 o=11008 w4"})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
