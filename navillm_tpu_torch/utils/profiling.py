"""Profiling: per-stage host timers and torch.profiler traces.

Twin of navillm_tpu/utils/profiling.py. StageTimer sums wall-clock time per
named stage across rollout steps (the same keys, rounding and report as
JAX's). It never synchronises the card: a stage that launches device work
times the launch, and the wait shows in the stage that reads the result
(``*_dispatch`` against ``*_sync``), so the overlap that the pipelined
loops build stays intact. ``trace()`` wraps a block in a torch.profiler
trace (CPU and, on the card, CUDA activities) written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k] /
                                     max(self.counts[k], 1), 3)}
                for k in sorted(self.totals)}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self, logger=None):
        s = self.summary()
        lines = ["per-stage timings:"]
        for k, v in s.items():
            lines.append("  %-24s %8.1f ms/call x %5d = %7.2f s"
                         % (k, v["mean_ms"], v["count"], v["total_s"]))
        msg = "\n".join(lines)
        if logger is not None:
            logger.info(msg)
        return msg


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace of the block, written to log_dir/trace.json
    (chrome://tracing, Perfetto); the profiler is yielded. With None it does
    nothing."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
