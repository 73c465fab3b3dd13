#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (navillm_tpu_torch) once on one H100.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits nonzero:
  0. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
     name and power limit;
  1. build: compiles csrc/flash_attn_fwd.cu and csrc/flash_attn_bwd.cu
     with nvcc for sm_90a, both at once;
  2. kernel vs plain: the flash-attention forward kernel against its plain
     PyTorch version at the eval slice's shapes (B=4, 32 heads of 128,
     bf16, causal, left-padded masks with fully-masked rows), both timed
     with CUDA events;
  3. the eval slice: greedy R2R streaming evaluation (validate_streaming)
     of the navigation model at Vicuna-7B width (bf16, random weights from
     a seed) on a synthetic 8x8 grid world; every LLM layer of every step
     must go through the kernel;
  4. model-level A/B: one forward_navigation step through the kernel and
     through the eager attention path on the same inputs;
  5. backward kernels vs plain: the dK/dV and dQ kernels against their
     plain versions at the training slice's shapes (B = rows per grad
     call, 32 heads of 128, bf16, causal, T in {640, 1024}, left-padded
     masks with fully-masked rows), timed with CUDA events; and the
     differentiable FlashAttention against autograd through the eager
     path;
  6. the training slice: R2R teacher-forcing training of the same 7B-width
     model through train_one_epoch (stage pretrain, fused teacher, dropout
     on, AdamW, gradient accumulation 2): a warm-up epoch, then 4 batches
     of 8 episodes (2 optimizer steps); every LLM layer of every grad call
     must go through the three kernels;
  7. gradient A/B: one grad call through the kernels and through the eager
     attention path, on the same inputs and weights with dropout off;
  8. int4 matmul vs plain: the int4 dequant-matmul kernel against its plain
     version at the 7B layer shapes (h, o) in {(4096, 4096), (4096, 11008),
     (11008, 4096)}, m in {4096, 3584, 7}, w4 (bf16 x) and w4a8 (int8 x),
     timed with CUDA events beside a dense bf16 torch.matmul;
  9. the w4 slice: the trained model's LLM quantized to int4 on the card
     (quantize_nav_params, bits=4), then phase 3's evaluation again; every
     layer matmul of every step must go through the int4 kernel;
 10. the w4a8 slice: phase 9 with act_int8 (int8 activations);
 11. int4 model-level A/B: one forward_navigation step on the int4 tree
     through the kernel and through its plain version, w4 and w4a8.
The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import tempfile
import time

import numpy as np
import torch

from navillm_tpu.data.loaders import Dataloader, MetaLoader
from navillm_tpu.models.tokenization import NavTokenizer
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.mp3d_agent import TrainArgs
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.models.llama import LlamaConfig, _act_q
from navillm_tpu_torch.models.nav_model import (NavModel, NavModelConfig,
                                                forward_navigation)
from navillm_tpu_torch.models.pano_encoder import PanoConfig
from navillm_tpu_torch.models.quant import _quant_one4, quantize_nav_params
from navillm_tpu_torch.ops import _build
from navillm_tpu_torch.ops.attention import (
    FlashAttention, attention_delta, attention_eager, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
from navillm_tpu_torch.ops.masking import NEG_INF
from navillm_tpu_torch.ops.matmul_q4 import matmul_q4, matmul_q4_reference
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
           "source": "navillm_tpu_torch/csrc/flash_attn_bwd.cu",
           "replaces": "navillm_tpu/ops/attention.py:234"},
    "q4": {"name": "matmul_q4", "route": "cuda",
           "source": "navillm_tpu_torch/csrc/matmul_q4.cu",
           "replaces": "navillm_tpu/ops/matmul_q4.py:60"},
}
COUNTERS = {"fwd": flash_attention_fwd, "dkv": flash_attention_bwd_dkv,
            "dq": flash_attention_bwd_dq}
# bf16 output of values of magnitude <= ~1: a few bf16 ulps
O_ATOL = 3e-2
# lse is f32 on both sides; scores differ only in summation order
LSE_ATOL = 2e-3
# bf16 gradients of magnitude up to ~8 (f32 sums on both sides, P and dS
# rounded to bf16 in the same places): two bf16 ulps at the top of range
GRAD_ATOL = 0.125
# the 7B gradient through the kernels vs through eager attention
MIN_GRAD_COSINE = 0.99
N_EPISODES = 32
N_SLOTS = 4
MAX_ACTION_LEN = 10
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


def phase_build():
    t0 = time.perf_counter()
    for built in _build.load_all(["flash_attn_fwd", "flash_attn_bwd",
                                  "matmul_q4"]):
        regs = [ln.strip() for ln in built.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[1] built {built.path.name} in {built.seconds:.2f} s; "
              f"ptxas: {regs}")
    print(f"[1] all kernels built in {time.perf_counter() - t0:.2f} s")


def phase_kernel():
    """Returns {T: (max_abs_err_o, ms, plain_ms)}."""
    b, nh, d = 4, 32, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for t in (128, 640, 1024):
        q, k, v = (torch.randn((b, t, nh, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        pads = torch.tensor([0, t // 8, t // 2, t - 1], device="cuda")
        mask = torch.arange(t, device="cuda")[None, :] >= pads[:, None]
        scale = 1.0 / math.sqrt(d)
        with torch.inference_mode():
            o, lse = flash_attention_fwd(q, k, v, mask, causal=True,
                                         scale=scale)
            ro, rlse = flash_attention_fwd_reference(q, k, v, mask, True,
                                                     scale)
            torch.cuda.synchronize()
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"T={t}: kernel output is not finite")
            # causal + left padding: row i is valid iff key i is
            err_o = (o.float() - ro.float()).abs()[mask].max().item()
            err_lse = (lse - rlse).abs().transpose(1, 2)[mask].max().item()
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask,
                                                     causal=True, scale=scale))
            plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
                q, k, v, mask, True, scale))
        print(f"[2] T={t}: max|dO|={err_o:.3e} (tol {O_ATOL}) "
              f"max|dlse|={err_lse:.3e} (tol {LSE_ATOL}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if err_o > O_ATOL or err_lse > LSE_ATOL:
            raise RuntimeError(f"T={t}: kernel disagrees with its plain "
                               f"version")
        out[t] = (err_o, ms, plain_ms)
    return out


def model_7b():
    tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
    llm = LlamaConfig.vicuna_7b(vocab_size=32128, max_seq_len=1024,
                                dtype=torch.bfloat16)
    cfg = NavModelConfig(llm=llm, pano=PanoConfig(output_size=llm.hidden_size,
                                                  dtype=torch.bfloat16))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = NavModel(cfg, init_nav_params(cfg, gen, torch.device("cuda")))
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


def phase_slice(tag, tok, cfg, model, tmp, warm_up: bool = True):
    """Greedy streaming eval of N_EPISODES episodes (after a warm-up on its
    own world); gates every trajectory's start, SR/SPL and K1's launches.
    Returns ({instr_id: trajectory}, eval steps)."""
    runner = NavModelRunner(cfg, model, tok, dims=RolloutDims(
        max_gmap_nodes=48, max_views=44, max_cands=12, max_hist=16))
    widths = []
    step = runner.eval_step

    def eval_step(state, pano_inputs, batch, *a, **kw):
        widths.append(batch["input_ids"].shape[1])
        return step(state, pano_inputs, batch, *a, **kw)

    runner.eval_step = eval_step
    feat = cfg.pano.image_feat_size
    if warm_up:   # cuBLAS handles, allocator, on its own small world
        warm = T.make_r2r_world(f"{tmp}/warm", n_episodes=2 * N_SLOTS, seed=1)
        run_eval(*T.r2r_eval(warm, runner, N_SLOTS, feat))
    anno = T.make_r2r_world(f"{tmp}/main", n_episodes=N_EPISODES)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat)
    widths.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    matmul_q4.launches = matmul_q4.int8_launches = 0
    runner.eval_steps = 0
    t0 = time.perf_counter()
    preds = run_eval(agent, ds, args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, steps = flash_attention_fwd.launches, runner.eval_steps

    if len(preds) != len(ds):
        raise RuntimeError(f"{len(preds)} trajectories for {len(ds)} episodes")
    for p in preds:
        start = ds.gt_trajs[p["instr_id"]][1][0]
        if p["trajectory"][0][0] != start:
            raise RuntimeError(f"{p['instr_id']} does not start at {start}")
    avg, _ = ds.eval_metrics(preds, None, "R2R")
    if not all(math.isfinite(avg[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"SR/SPL not finite: {avg}")
    if launches != steps * cfg.llm.num_layers:
        raise RuntimeError(f"kernel launches {launches} != {steps} eval "
                           f"steps x {cfg.llm.num_layers} layers")
    print(f"[{tag}] {len(preds)} episodes in {dt:.3f} s = "
          f"{len(preds) / dt:.3f} episodes/s; {steps} eval steps of "
          f"{N_SLOTS} slots, {1e3 * dt / steps:.2f} ms wall per step; prompt "
          f"widths {sorted(set(widths))}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"SR {avg['sr']:.2f} SPL {avg['spl']:.2f}; flash kernel launches "
          f"{launches} = {steps} x {cfg.llm.num_layers}")
    return {p["instr_id"]: p["trajectory"] for p in preds}, steps


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


def phase_backward():
    """Returns {T: {"dkv": (err, ms, plain_ms), "dq": (...)}}."""
    b, nh, d = ROWS_PER_CALL, 32, 128
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for t in (640, 1024):
        q, k, v, do = (torch.randn((b, t, nh, d), generator=gen,
                                   device="cuda", dtype=torch.bfloat16)
                       for _ in range(4))
        # left padding from none to all but one key: under causal the
        # first pads[i] rows of row i see no valid key
        pads = torch.linspace(0, t - 1, b, device="cuda").long()
        mask = torch.arange(t, device="cuda")[None, :] >= pads[:, None]
        with torch.inference_mode():
            o, lse = flash_attention_fwd(q, k, v, mask, causal=True,
                                         scale=scale)
            delta = attention_delta(o, do)
            args = (q, k, v, mask, lse, delta, do)
            got = {"dkv": flash_attention_bwd_dkv(*args, causal=True,
                                                  scale=scale),
                   "dq": (flash_attention_bwd_dq(*args, causal=True,
                                                 scale=scale),)}
            want = {"dkv": flash_attention_bwd_dkv_reference(*args, True,
                                                             scale),
                    "dq": (flash_attention_bwd_dq_reference(*args, True,
                                                            scale),)}
            torch.cuda.synchronize()
            res, top = {}, 0.0
            for key, fn, ref in (
                    ("dkv", flash_attention_bwd_dkv,
                     flash_attention_bwd_dkv_reference),
                    ("dq", flash_attention_bwd_dq,
                     flash_attention_bwd_dq_reference)):
                err = 0.0
                for a, w in zip(got[key], want[key]):
                    if not torch.isfinite(a).all():
                        raise RuntimeError(f"T={t}: {key} kernel output is "
                                           f"not finite")
                    # causal + left padding: row i is valid iff key i is
                    err = max(err, (a.float() - w.float()).abs()[mask]
                              .max().item())
                    top = max(top, w.float().abs()[mask].max().item())
                ms = cuda_ms(lambda: fn(*args, causal=True, scale=scale))
                plain_ms = cuda_ms(lambda: ref(*args, True, scale), iters=5)
                res[key] = (err, ms, plain_ms)
            rows = ~mask          # rows that see no valid key: dQ must be 0
            if got["dq"][0][rows].float().abs().max().item() != 0.0:
                raise RuntimeError(f"T={t}: fully-masked rows got a dQ")
        print(f"[5] T={t}, B={b}: dK/dV max|err| {res['dkv'][0]:.3e}, dQ "
              f"max|err| {res['dq'][0]:.3e} (tol {GRAD_ATOL}, |grad| up to "
              f"{top:.2f}); dK/dV kernel {res['dkv'][1]:.4f} ms vs plain "
              f"{res['dkv'][2]:.4f} ms; dQ kernel {res['dq'][1]:.4f} ms vs "
              f"plain {res['dq'][2]:.4f} ms")
        if max(res["dkv"][0], res["dq"][0]) > GRAD_ATOL:
            raise RuntimeError(f"T={t}: a backward kernel disagrees with "
                               f"its plain version")
        out[t] = res
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
          f"max|d(dq,dk,dv)| {err:.3e} (tol {GRAD_ATOL})")
    if err > GRAD_ATOL:
        raise RuntimeError("FlashAttention's gradient disagrees with the "
                           "eager path's")
    return out


def phase_train(tok, cfg, model, tmp):
    """Returns (kernel launches of the measured run, prompt widths, the
    first grad call's arguments for phase 7)."""
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
    widths, losses, first_call, tokens = [], [], [], [0]
    grad_call = runner.pano_navigation_train

    def recorded_grad_call(pano_inputs, seed, batch, targets, coef):
        widths.append(batch["input_ids"].shape[1])
        # tokens of the rows that carry a target (not the chunk padding)
        tokens[0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
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
    tokens[0] = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    runner.grad_calls = 0
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
          f"{sorted(set(widths))}; {tokens} trained tokens = "
          f"{tokens / dt:.0f} tokens/s; peak memory {peak:.2f} GiB "
          f"(AdamW moments {moments / 2 ** 30:.2f} GiB); losses "
          f"{[round(float(x), 4) for x in losses]} (mean {avg_loss:.4f}); "
          f"grad norms {[round(n, 4) for n in norms]}; launches {launches}")
    del tx
    return launches, widths, first_call[0]


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


def phase_q4_kernel():
    """Returns {(m, h, o, mode): (max_abs_err, ms, plain_ms)}."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for h, o in Q4_SHAPES:
        w = torch.randn((h, o), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * h ** -0.5
        q4p, s = _quant_one4(w)
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
                d = (y.float() - ref.float()).abs()
                top = ref.float().abs()
                if mode == "w4":
                    excess = (d - (2 ** -7 * top + Q4_FLOOR * top.max())).max()
                else:
                    excess = (d - Q4_A8_RTOL * top).max()
                rel = (d / top.clamp(min=Q4_FLOOR * top.max().item())).max()
                ms = cuda_ms(lambda: matmul_q4(a, q4p, s))
                plain_ms = cuda_ms(lambda: matmul_q4_reference(a, q4p, s),
                                   iters=5)
                err = d.max().item()
                print(f"[8] {mode} m={m} h={h} o={o}: max|d|={err:.3e} "
                      f"(max |d|/|ref| {rel.item():.3e}, |ref| up to "
                      f"{top.max().item():.2f}); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, dense bf16 matmul {dense_ms:.4f} "
                      f"ms; {2 * m * h * o / ms / 1e9:.1f} TFLOP/s")
                if excess.item() > 0:
                    raise RuntimeError(f"{mode} m={m} h={h} o={o}: kernel "
                                       f"disagrees with its plain version")
                out[(m, h, o, mode)] = (err, ms, plain_ms)
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


def phase_q4_slice(tag, tok, cfg, qmodel, tmp, dense_trajs, warm_up):
    """Returns (the int4 kernel's launches in the measured run, the
    trajectories)."""
    trajs, steps = phase_slice(tag, tok, cfg, qmodel, tmp, warm_up=warm_up)
    launches, int8 = matmul_q4.launches, matmul_q4.int8_launches
    want = steps * cfg.llm.num_layers * Q4_LAYER_MATMULS
    if launches != want:
        raise RuntimeError(f"int4 kernel launches {launches} != {steps} "
                           f"steps x {cfg.llm.num_layers} layers x "
                           f"{Q4_LAYER_MATMULS}")
    if int8 != (launches if cfg.llm.act_int8 else 0):
        raise RuntimeError(f"{int8} of {launches} int4 launches had int8 "
                           f"activations (act_int8={cfg.llm.act_int8})")
    same = sum(trajs[k] == dense_trajs[k] for k in trajs)
    print(f"[{tag}] int4 kernel launches {launches} = {steps} x "
          f"{cfg.llm.num_layers} x {Q4_LAYER_MATMULS} (int8 activations: "
          f"{int8}); trajectories equal to phase 3's (bf16, before training "
          f"moved the weights): {same} of {len(trajs)}")
    return launches, trajs


def main():
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    tok, cfg, model = model_7b()
    with tempfile.TemporaryDirectory() as tmp:
        dense_trajs, _ = phase_slice(3, tok, cfg, model, tmp)
    phase_ab(cfg, model)
    bwd = phase_backward()
    with tempfile.TemporaryDirectory() as tmp:
        launches, widths, call = phase_train(tok, cfg, model, tmp)
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
        launches["q4"], w4 = phase_q4_slice(9, tok, cfg, qmodel, tmp,
                                            dense_trajs, warm_up=True)
    with tempfile.TemporaryDirectory() as tmp:
        _, w4a8 = phase_q4_slice(10, tok, a8, qmodel, tmp, dense_trajs,
                                 warm_up=False)
    print(f"[10] w4a8 trajectories equal to w4's (same int4 tree): "
          f"{sum(w4a8[k] == w4[k] for k in w4)} of {len(w4)}")
    for c in (cfg, a8):
        plain = dataclasses.replace(c, llm=dataclasses.replace(
            c.llm, q4_impl="plain"))
        mode = "w4a8" if c.llm.act_int8 else "w4"
        compare_logits(11, f"on the int4 tree ({mode}): kernel vs plain "
                       f"version", qmodel, c, plain)
    # report each kernel's time at the width nearest the training slice's
    # median prompt width (phase 2 for the forward, phase 5 for the rest)
    med = float(np.median(widths))
    t1 = min(kernel, key=lambda w: abs(w - med))
    t2 = min(bwd, key=lambda w: abs(w - med))
    rows = [{**KERNELS["fwd"], "launches": launches["fwd"],
             "max_abs_err": max(e for e, _, _ in kernel.values()),
             "ms": kernel[t1][1], "plain_ms": kernel[t1][2]}]
    for key in ("dkv", "dq"):
        rows.append({**KERNELS[key], "launches": launches[key],
                     "max_abs_err": max(r[key][0] for r in bwd.values()),
                     "ms": bwd[t2][key][1], "plain_ms": bwd[t2][key][2]})
    # K4 at the w_gate shape with 4 slots of 1024 tokens, w4
    _, ms, plain_ms = q4[(4096, 4096, 11008, "w4")]
    rows.append({**KERNELS["q4"], "launches": launches["q4"],
                 "max_abs_err": max(e for e, _, _ in q4.values()),
                 "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
