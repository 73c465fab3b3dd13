"""Profiling: per-stage host timers, the program's spans and counters, and
torch.profiler traces.

Twin of navillm_tpu/utils/profiling.py. StageTimer sums wall-clock time per
named stage across rollout steps (the same keys, rounding and report as
JAX's). It never synchronises the card: a stage that launches device work
times the launch, and the wait shows in the stage that reads the result
(``*_dispatch`` against ``*_sync``), so the overlap that the pipelined
loops build stays intact. ``trace()`` wraps a block in a torch.profiler
trace (CPU and, on the card, CUDA activities) written as a Chrome trace.

Spans and counters are recorded only while a torch profiler records
(``trace()``, or any ``torch.profiler.profile`` started by ``with`` or by
``.start()``). Otherwise ``span`` and ``count`` cost one read of torch's
profiler flag: no ``record_function``, no clock, no counter. While it
records, a span enters ``record_function("nav.<name>")``, so the range
sits in the trace on the clock of the kernels it launches, with the
slot-group step it serves as its argument; it times itself on
``time.perf_counter``, and the process-wide registry ``TRACE`` keeps, per
span name, its layer, count, seconds, the seconds nested spans of another
layer covered (the rest is the layer's self time) and its parents, and
the counters (``steps``: slot-group steps dispatched; ``uploads``,
``h2d_bytes``: host arrays sent to the device). A span given a tensor
(``timed=``) also records a pair of CUDA events on that tensor's stream,
read when ``TRACE`` is read: the stream's interval from the range's start
to its end. A span that began while recording is recorded whole: counted,
its range closed; where the profiler stopped inside it, its seconds end
at the last moment a span saw the profiler recording, so the profiler's
own stop is not timed as the program's work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "nav."


@dataclasses.dataclass
class SpanTotals:
    """One span name's totals in ``TRACE``."""
    layer: str
    count: int = 0
    seconds: float = 0.0
    # of ``seconds``, the part that nested spans of another layer covered
    covered_s: float = 0.0
    # spans given ``timed=``: the device stream's seconds (on a CPU tensor
    # the host's)
    device_s: float = 0.0
    parents: Counter = dataclasses.field(default_factory=Counter)

    @property
    def self_s(self) -> float:
        return self.seconds - self.covered_s


class Trace:
    """The registry of spans and counters recorded while a profiler
    records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        # perf_counter of the last span entry or exit that saw the
        # profiler recording
        self.last_on = 0.0
        self.reset()

    def reset(self):
        with self._lock:
            self.spans: Dict[str, SpanTotals] = {}
            self.counters: Dict[str, int] = defaultdict(int)
            self._timed: List[tuple] = []

    @property
    def steps(self) -> int:
        """Slot-group steps dispatched while recording."""
        return self.counters.get("steps", 0)

    def totals(self, name: str) -> Optional[SpanTotals]:
        """A span name's totals, its device seconds read, or None."""
        with self._lock:
            timed, self._timed = self._timed, []
        for tot, start, end in timed:
            end.synchronize()
            tot.device_s += start.elapsed_time(end) / 1e3
            self._pool.append((start, end))
        return self.spans.get(name)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _events(self):
        if self._pool:
            return self._pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _close(self, sp: "_Span", seconds: float):
        stack = self._stack()
        stack.pop()
        with self._lock:
            tot = self.spans.get(sp.name)
            if tot is None:
                tot = self.spans[sp.name] = SpanTotals(sp.layer)
            tot.count += 1
            tot.seconds += seconds
            tot.parents[stack[-1].name if stack else None] += 1
            if sp.events is not None:
                self._timed.append((tot, *sp.events))
            elif sp.timed is not None:
                tot.device_s += seconds
            # the nearest run of ancestors that share one layer other than
            # the span's is covered by it
            other = None
            for anc in reversed(stack):
                if other is None:
                    if anc.layer == sp.layer:
                        break
                    other = anc.layer
                elif anc.layer != other:
                    break
                self.spans.setdefault(
                    anc.name, SpanTotals(anc.layer)).covered_s += seconds


TRACE = Trace()


class _Span:
    __slots__ = ("name", "layer", "step", "timed", "rf", "events", "stream",
                 "t0", "outer_step")

    def __init__(self, name, layer, step, timed):
        self.name, self.layer, self.step, self.timed = name, layer, step, \
            timed
        self.events = None

    def __enter__(self):
        loc = TRACE._local
        self.outer_step = getattr(loc, "step", None)
        if self.step is not None:
            loc.step = self.step
        step = getattr(loc, "step", None)
        self.rf = torch.profiler.record_function(
            SPAN_PREFIX + self.name,
            None if step is None else "group %d step %d" % step)
        self.rf.__enter__()
        TRACE._stack().append(self)
        if self.timed is not None and self.timed.is_cuda:
            self.stream = torch.cuda.current_stream(self.timed.device)
            self.events = TRACE._events()
            self.events[0].record(self.stream)
        self.t0 = TRACE.last_on = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if _autograd_profiler._is_profiler_enabled:
            TRACE.last_on = t1
        else:
            t1 = max(self.t0, TRACE.last_on)
        seconds = t1 - self.t0
        if self.events is not None:
            self.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        TRACE._local.step = self.outer_step
        TRACE._close(self, seconds)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, layer: str, step: Optional[Tuple[int, int]] = None,
         timed: Optional[torch.Tensor] = None):
    """A span of ``layer`` named ``name``; ``step``: the (slot group, step
    number) it and its nested spans serve; ``timed``: a tensor on whose
    stream the span is timed as well."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, layer, step, timed)


def count(**counters: int):
    """Add each value to ``TRACE``'s counter of its name while
    recording."""
    if _autograd_profiler._is_profiler_enabled:
        with TRACE._lock:
            for name, n in counters.items():
                TRACE.counters[name] += n


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name, "loop"):
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
    (chrome://tracing, Perfetto) with the program's ``nav.*`` ranges;
    ``TRACE`` is reset on entry and holds the block's spans and counters.
    The profiler is yielded. With None it does nothing."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    TRACE.reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
