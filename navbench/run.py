#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 navbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
The last line of standard output is the result (JSON: correct, attempted,
failed, metrics, device, with --trace 1 breakdown); the numbers compared
for ``correct`` are printed beside their limits as the last lines of
standard error and under the result's last key. Without the cards the
cell asks for, it exits 2 and prints no result; so it does when a module
of JAX, flax or the JAX package is loaded once the window has closed.
Kernel build caches stay in fixed directories under ``build/`` in the
checkout; the run's data (world, episodes, HDF5 features) goes to a
temporary directory under TMPDIR, removed at exit.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
CACHE = ROOT / "build" / "navbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int = 2):
    print(f"navbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)

    from navbench import harness as H
    t_start = H.process_start()
    cell = H.Cell(ROOT, opts.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on NVIDIA cards only")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, "
             f"{torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    work = Path(tempfile.mkdtemp(prefix="navbench_"))
    try:
        result = H.run_cell(cell, opts.seed, opts.seconds, bool(opts.trace),
                            device, work, t_start)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    H.check_line(result, bool(opts.trace))
    loaded = H.forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    for name, item in result["compared"].items():
        print(f"{name} {item['value']!r} limit {item['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
