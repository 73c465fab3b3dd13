#!/usr/bin/env python3
"""Where the card's time goes in the PyTorch/CUDA port's 7B-width cells.

    python3 scripts/profile_port.py [--tokenizer byte|bpe] [--cells all|multi]
        # on an H100, from the repository root

Runs chip_smoke.py's eval slice (bf16), training slice and int4 eval
slices (w4, then w4a8) with the same model, seeds and worlds, each after
its warm-up, on the byte tokenizer (NavTokenizer(max_length=1024,
pad_to_multiple=128), the default) or the BPE one
(NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)); then the
prefix-cached BPE eval cells (bf16 after the eval slice, w4 and w4a8 after
theirs), as chip_smoke.py's phases 14, 16 and 17 run them; and the
stage-multi training cell (teacher and fused DAgger batches on BPE
prompts, chip_smoke.py's phase 18) after the training slice. ``--cells
multi`` traces that cell alone. Each measured
run is traced with torch.profiler. For each cell it prints the wall time
of the run, the summed device time of its kernels and copies, the card's
busy share (the union of their spans over the wall time), the device time
and launches by kernel group, largest first, and the SM clock and power
draw nvidia-smi read every 200 ms during the run. The cached step's window
attention (the eager path: einsums, mask and softmax) is a group of its
own: its kernels are the ones launched inside the program's
``nav.window_attn`` ranges (``llama.chunk_forward_cached``). The card's
idle gaps are named by the innermost of the program's ``nav.*`` ranges
(``utils/profiling.py``: the loop's stages, ``assemble``, ``retire``, the
runner's ``upload``, ``launch``, ``wait``) the host was in at each gap's
middle, ``outside`` where it was in none. The profiler adds host work per
launch, so the wall times here are a little above chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu_torch.utils.profiling import SPAN_PREFIX  # noqa: E402

WINDOW = SPAN_PREFIX + "window_attn"

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("K1 flash forward", ("flash_fwd_kernel",)),
    ("K2 flash dK/dV", ("flash_bwd_dkv_kernel",)),
    ("K3 flash dQ", ("flash_bwd_dq_kernel",)),
    ("K4 int4 matmul", ("matmul_q4_kernel",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy",
                                "Memcpy", "Memset", "cat", "index",
                                "scatter", "gather", "fill")),
)


def launched_under(event):
    """(name, device us) of every kernel launched inside a CPU event."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += launched_under(child)
    return out


def idle_gaps(spans, host):
    """Idle seconds between the device spans (sorted (start, end, name),
    us), by the innermost host range of ``host`` (sorted (start, end,
    name)) that holds each gap's middle, "outside" where none does."""
    gaps, reach = {}, None
    starts = [h[0] for h in host]
    longest = max((h1 - h0 for h0, h1, _ in host), default=0)
    for start, end, _ in spans:
        if reach is not None and start > reach:
            mid = 0.5 * (reach + start)
            name, k = "outside", bisect.bisect_right(starts, mid) - 1
            # the latest-starting range that holds mid is the innermost
            while k >= 0 and host[k][0] >= mid - longest:
                if host[k][1] >= mid:
                    name = host[k][2][len(SPAN_PREFIX):]
                    break
                k -= 1
            gaps[name] = gaps.get(name, 0.0) + (start - reach) / 1e6
        reach = end if reach is None else max(reach, end)
    return gaps


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


@contextlib.contextmanager
def clocks_read(cell: str):
    """nvidia-smi's SM clock (MHz) and power draw (W), read every 200 ms
    while the body runs."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "--loop-ms=200"],
        stdout=subprocess.PIPE, text=True)
    try:
        yield
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    reads = [[float(x) for x in ln.split(",")]
             for ln in out.splitlines() if ln.count(",") == 1]
    if not reads:
        raise RuntimeError(f"{cell}: nvidia-smi read no clock")
    clock, power = zip(*reads)
    print(f"[profile] {cell}: SM clock {statistics.mean(clock):.0f} MHz "
          f"(min {min(clock):.0f}, max {max(clock):.0f}), power "
          f"{statistics.mean(power):.1f} W (max {max(power):.1f}) over "
          f"{len(reads)} reads")


@contextlib.contextmanager
def traced(cell: str):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with clocks_read(cell), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device-side events only (kernels, copies, memsets); the CPU ops
    # above them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == cuda
                   and not e.name.startswith(SPAN_PREFIX)
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        raise RuntimeError(f"{cell}: the trace holds no device time")
    by_group, count, total, busy, reach = {}, {}, 0.0, 0.0, spans[0][0]
    for start, end, name in spans:
        group = group_of(name)
        by_group[group] = by_group.get(group, 0.0) + end - start
        count[group] = count.get(group, 0) + 1
        total += end - start
        busy += max(0, end - max(start, reach))   # union of the spans
        reach = max(reach, end)
    # the window attention's kernels move from their groups to their own
    ranges = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    for name, us in (k for e in ranges for k in launched_under(e)):
        group = group_of(name)
        by_group[group] -= us
        count[group] -= 1
        by_group[WINDOW] = by_group.get(WINDOW, 0.0) + us
        count[WINDOW] = count.get(WINDOW, 0) + 1
    if ranges and WINDOW not in by_group:
        print(f"[profile] {cell}: {len(ranges)} {WINDOW} ranges, but the "
              f"trace links no kernel to them: their time is not measured")
    print(f"[profile] {cell}: wall {wall:.3f} s, device {total / 1e6:.3f} s "
          f"in {len(spans)} device events, busy {100 * busy / 1e6 / wall:.1f}%"
          f" of the wall time")
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type != cuda
                  and e.name.startswith(SPAN_PREFIX))
    gaps = idle_gaps(spans, host)
    print(f"[profile]   idle {sum(gaps.values()):.3f} s: " + ", ".join(
        f"in {k} {v:.3f}" for k, v in sorted(gaps.items(),
                                              key=lambda kv: -kv[1])))
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        if not count[group]:
            continue
        print(f"[profile]   {group}: {us / 1e6:.3f} s "
              f"({100 * us / total:.1f}%) in {count[group]} events, "
              f"{us / 1e3 / count[group]:.4f} ms each")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokenizer", choices=("byte", "bpe"), default="byte")
    ap.add_argument("--cells", choices=("all", "multi"), default="all")
    opts = ap.parse_args()
    smi = C.phase_device()
    C.phase_build()
    tok, cfg, model = C.model_7b()
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    if opts.tokenizer == "bpe":
        tok = bpe
    sfx = "_bpe" if opts.tokenizer == "bpe" else ""

    def cell(name, what):
        return lambda: traced(f"r2r_{name}{sfx} ({what}, {opts.tokenizer} "
                              f"prompts)")

    def cached_cell(name, what):
        return lambda: traced(f"r2r_{name}_bpe_cached ({what}, BPE prompts, "
                              f"prefix cache)")

    def multi():
        return traced("r2r_train_7b_multi (stage multi: teacher and fused "
                      "DAgger batches, BPE prompts)")

    if opts.cells == "multi":
        with tempfile.TemporaryDirectory() as tmp:
            C.phase_dagger(bpe, cfg, model, tmp, window=multi)
        print(smi)
        return
    with tempfile.TemporaryDirectory() as tmp:
        C.phase_slice(3, tok, cfg, model, tmp,
                      window=cell("stream_7b", "bf16 eval"))
    with tempfile.TemporaryDirectory() as tmp:
        C.phase_slice(14, bpe, cfg, model, tmp, prefix_cache=True,
                      window=cached_cell("stream_7b", "bf16 eval"))
    with tempfile.TemporaryDirectory() as tmp:
        C.phase_train(tok, cfg, model, tmp,
                      window=cell("train_7b", "training"))
    with tempfile.TemporaryDirectory() as tmp:
        C.phase_dagger(bpe, cfg, model, tmp, window=multi)
    qmodel = C.quantize_model(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                          act_int8=True))
    for tag, c, warm, name, what in (
            (9, cfg, True, "stream_7b_w4", "int4 eval"),
            (10, a8, False, "stream_7b_w4a8",
             "int4 eval, int8 activations")):
        with tempfile.TemporaryDirectory() as tmp:
            C.phase_slice(tag, tok, c, qmodel, tmp, warm_up=warm,
                          window=cell(name, what))
        with tempfile.TemporaryDirectory() as tmp:
            C.phase_slice(tag + 7, bpe, c, qmodel, tmp, warm_up=warm,
                          prefix_cache=True, window=cached_cell(name, what))
    print(smi)


if __name__ == "__main__":
    main()
