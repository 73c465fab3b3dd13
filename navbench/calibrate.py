#!/usr/bin/env python3
"""Readings for a cell's correctness limits: many seeds in one process.

    python3 navbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 8 [--control N]

from the root of a checkout on an NVIDIA card. For each seed it runs the
cell as ``run.py`` does (a shorter window), then prints one JSON line with
``correct`` and the compared numbers of the program against the plain
reference. With ``--control N``, on the first N seeds the cell's control
takes the program's place in the same comparison and limits (for the
evaluation cells the reference computed in fp8, ``reference/nav_ref.py``,
against itself in f32 on the same steps), so ``correct`` has to come out
false there; the program's own readings of those seeds are kept beside it
(``program_*``). The benchmark's own runs never run the control. PERF.md gives the readings and
the limits set from them (``navbench/limits/<cell>.json``).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=8)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control on the first N seeds")
    opts = ap.parse_args(argv)
    import torch
    from navbench import harness as H
    if not torch.cuda.is_available():
        print("navbench: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = H.Cell(ROOT, opts.workload)
    for k, seed in enumerate(int(s) for s in opts.seeds.split(",")):
        work = Path(tempfile.mkdtemp(prefix="navbench_cal_"))
        t0 = time.perf_counter()
        try:
            res = H.run_cell(cell, seed, opts.seconds, False,
                             torch.device("cuda", 0), work, t0,
                             control=k < opts.control)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": opts.workload, "seed": seed,
                          "control": k < opts.control,
                          "correct": res["correct"],
                          "compared": res["compared"],
                          "numbers": res["numbers"], "run": res["run"],
                          "metrics": res["metrics"]}), flush=True)


if __name__ == "__main__":
    main()
