#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (navillm_tpu_torch) once on one H100.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits nonzero:
  0. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
     name and power limit;
  1. build: compiles csrc/flash_attn_fwd.cu with nvcc for sm_90a;
  2. kernel vs plain: the flash-attention kernel against its plain
     PyTorch version at the slice's shapes (B=4, 32 heads of 128, bf16,
     causal, left-padded masks with fully-masked rows), both timed with
     CUDA events;
  3. the slice: greedy R2R streaming evaluation (validate_streaming) of
     the navigation model at Vicuna-7B width (bf16, random weights from a
     seed) on a synthetic 8x8 grid world; every LLM layer of every step
     must go through the kernel;
  4. model-level A/B: one forward_navigation step through the kernel and
     through the eager attention path on the same inputs.
The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import tempfile
import time

import numpy as np
import torch

from navillm_tpu.data.loaders import Dataloader
from navillm_tpu.models.tokenization import NavTokenizer
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.models.llama import LlamaConfig
from navillm_tpu_torch.models.nav_model import (NavModel, NavModelConfig,
                                                forward_navigation)
from navillm_tpu_torch.models.pano_encoder import PanoConfig
from navillm_tpu_torch.ops import _build
from navillm_tpu_torch.ops.attention import (flash_attention_fwd,
                                             flash_attention_fwd_reference)
from navillm_tpu_torch.ops.masking import NEG_INF

KERNEL = {"name": "flash_attn_fwd", "route": "cuda",
          "source": "navillm_tpu_torch/csrc/flash_attn_fwd.cu",
          "replaces": "navillm_tpu/ops/attention.py:61"}
# bf16 output of values of magnitude <= ~1: a few bf16 ulps
O_ATOL = 3e-2
# lse is f32 on both sides; scores differ only in summation order
LSE_ATOL = 2e-3
N_EPISODES = 32
N_SLOTS = 4
MAX_ACTION_LEN = 10


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
    built = _build.load("flash_attn_fwd")
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    print(f"[1] built {built.path.name} in {built.seconds:.2f} s; "
          f"ptxas: {regs}")


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


def phase_slice(tok, cfg, model, tmp):
    """Returns (kernel launches in the measured run, prompt widths)."""
    runner = NavModelRunner(cfg, model, tok, dims=RolloutDims(
        max_gmap_nodes=48, max_views=44, max_cands=12, max_hist=16))
    widths = []
    step = runner.eval_step

    def eval_step(state, pano_inputs, batch, *a, **kw):
        widths.append(batch["input_ids"].shape[1])
        return step(state, pano_inputs, batch, *a, **kw)

    runner.eval_step = eval_step
    feat = cfg.pano.image_feat_size
    # warm-up pass (cuBLAS handles, allocator) on its own small world
    warm = T.make_r2r_world(f"{tmp}/warm", n_episodes=2 * N_SLOTS, seed=1)
    run_eval(*T.r2r_eval(warm, runner, N_SLOTS, feat))
    anno = T.make_r2r_world(f"{tmp}/main", n_episodes=N_EPISODES)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat)
    widths.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
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
    print(f"[3] {len(preds)} episodes in {dt:.3f} s = {len(preds) / dt:.3f} "
          f"episodes/s; {steps} eval steps of {N_SLOTS} slots, "
          f"{1e3 * dt / steps:.2f} ms wall per step; prompt widths "
          f"{sorted(set(widths))}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"SR {avg['sr']:.2f} SPL {avg['spl']:.2f}; kernel launches "
          f"{launches} = {steps} x {cfg.llm.num_layers}")
    return launches, widths


def phase_ab(cfg, model):
    batch = T.synthetic_nav_batch(cfg, b=4, g=48, v=45, c=12, hh=16,
                                  tlen=768, seed=0)
    for row, pad in enumerate((0, 64, 300, 700)):      # left padding
        batch["attention_mask"][row, :pad] = False
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    eager = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, attn_impl="eager"))
    with torch.inference_mode():
        lk = forward_navigation(model, cfg, dev)["fuse_logits"]
        le = forward_navigation(model, eager, dev)["fuse_logits"]
    if not (torch.isfinite(lk).all() and torch.isfinite(le).all()):
        raise RuntimeError("logits are not finite")
    valid = le > NEG_INF / 2
    diff = (lk - le).abs()[valid].max().item()
    agree = (lk.argmax(-1) == le.argmax(-1)).float().mean().item()
    print(f"[4] forward_navigation kernel vs eager attention: max |dlogit| "
          f"{diff:.4e} over {int(valid.sum())} candidate logits (range "
          f"{le[valid].min().item():.3f}..{le[valid].max().item():.3f}); "
          f"argmax agreement {agree:.2f}")


def main():
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    tok, cfg, model = model_7b()
    with tempfile.TemporaryDirectory() as tmp:
        launches, widths = phase_slice(tok, cfg, model, tmp)
    phase_ab(cfg, model)
    # report the kernel's time at the phase-2 width nearest the slice's
    # median prompt width
    t = min(kernel, key=lambda w: abs(w - float(np.median(widths))))
    err = max(e for e, _, _ in kernel.values())
    print(json.dumps({"kernels": [{**KERNEL, "launches": launches,
                                   "max_abs_err": err, "ms": kernel[t][1],
                                   "plain_ms": kernel[t][2]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
