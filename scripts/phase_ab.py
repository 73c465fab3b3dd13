#!/usr/bin/env python3
"""Time chip_smoke.py's fused training and streaming evaluation phases in
two checkouts of the repository on one H100: one process per run, in the
order base, change, change, base, so drift in the card's clock shows.

    python3 scripts/phase_ab.py --base DIR [--phases 6 13 18]

DIR is another checkout (the parent commit unpacked with ``git archive``,
say); the checkout this script sits in is the change. Each run imports
its checkout's chip_smoke.py in a fresh process started in that
checkout's root, builds the kernels and the Vicuna-7B-width model (bf16,
random weights from seed 0) and runs the phases named, each with its own
warm-up: 6 (the fused teacher at stage pretrain, 4 batches of 8), 13
(greedy streaming evaluation on BPE prompts, 32 episodes) and 18 (stage
multi: 2 fused teacher and 2 fused DAgger batches of 8). It prints each
run's lines of those phases, then one JSON line per phase: per run, ms
per batch (6: the measured epoch over its batches; 18: the teacher and
the DAgger batches) or ms per step (13).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN_PHASES = """
import sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as C
from navillm_tpu_torch.models.tokenization import NavTokenizer
phases = sys.argv[1:]
C.phase_device()
C.phase_build()
tok, cfg, model = C.model_7b()
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
for tag in phases:
    with tempfile.TemporaryDirectory() as tmp:
        if tag == "6":
            C.phase_train(tok, cfg, model, tmp)
        elif tag == "13":
            C.phase_slice(13, bpe, cfg, model, tmp)
        elif tag == "18":
            C.phase_dagger(bpe, cfg, model, tmp)
"""

NUMS = r"\[([\d., ]*)\]"


def parse(tag: str, line: str) -> dict:
    if tag == "6":
        m = re.search(r"trained (\d+) episodes in ([\d.]+) s", line)
        batches = int(m.group(1)) // 8
        return {"ms_per_batch": 1e3 * float(m.group(2)) / batches}
    if tag == "13":
        return {"ms_per_step": float(re.search(
            r"([\d.]+) ms wall per step", line).group(1))}
    m = re.search(rf"teacher batch {NUMS} ms; DAgger batch {NUMS} ms", line)
    return {"teacher_ms": [float(x) for x in m.group(1).split(",")],
            "dagger_ms": [float(x) for x in m.group(2).split(",")]}


def run(tree: Path, phases) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN_PHASES, *phases],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"run in {tree} failed ({proc.returncode})")
    lines = proc.stdout.splitlines()
    out = {"smi": lines[0]}
    for tag in phases:
        line = next(x for x in lines if x.startswith(f"[{tag}] ")
                    and ("trained" in x or "wall per step" in x
                         or "DAgger batch" in x))
        print(f"{tree.name}: {line}", flush=True)
        out[tag] = parse(tag, line)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--phases", nargs="+", default=["6", "13", "18"])
    a = ap.parse_args()
    trees = {"base": a.base.resolve(), "change": ROOT}
    results = []
    for name in ("base", "change", "change", "base"):
        res = run(trees[name], a.phases)
        print(res["smi"], flush=True)
        results.append((name, res))
    for tag in a.phases:
        print(json.dumps({"phase": tag, "smi": results[0][1]["smi"],
                          "runs": [{"tree": n, **r[tag]}
                                   for n, r in results]}))


if __name__ == "__main__":
    main()
