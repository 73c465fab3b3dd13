"""A tiny cell for the CPU tests: the evaluation cells' code at small
widths in f32, written with its own configuration and traffic files into
a copy of the benchmark under a temporary root."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345


def make_root(tmp: Path, traffic: str = "r2r_eval", **over) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "navbench", root / "navbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "navbench/configs/mistral-7b-v0.3.json")
                     .read_text())
    cfg.update(name="tiny", hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=1024,
               torch_dtype="float32")
    cfg["panorama"].update(image_feat_size=32, hidden_size=32,
                           num_attention_heads=4, intermediate_size=64,
                           num_pano_layers=1)
    (root / "navbench/configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / f"navbench/traffic/{traffic}.json").read_text())
    tr.update(scans=3, scan_sizes={"3": 1, "4": 1, "5": 1}, paths=40,
              warm_paths=2, slots_per_group=3, max_action_len=5,
              ramp_steps=4, check_slots=3, check_episodes=4,
              trace_seconds=1)
    tr["dims"].update(max_gmap_nodes=16, max_cands=8, max_hist=8)
    tr.update(over)
    (root / "navbench/traffic/tiny_t.json").write_text(json.dumps(tr))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "navbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.t", "config": "tiny",
                               "traffic": "tiny_t", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mistral-7b-v0.3.r2r_eval" in m.get("workloads", []):
            m["workloads"].append("tiny.t")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, trace: bool = False, seconds: int = 2, control=False,
        cell: str = "tiny.t"):
    """One run of a tiny cell on the CPU, past the harness's look for a
    card."""
    import torch
    from navbench import harness as H
    cell = H.Cell(root, cell)
    work = root / "work"
    work.mkdir(exist_ok=True)
    return H.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), work,
                      time.perf_counter(), control=control)
