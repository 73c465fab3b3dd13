"""The program's own spans and counters, as the per-layer readers read
them: ``navillm_tpu_torch.utils.profiling.TRACE``.

The program records them only while a torch profiler records, so in a
traced run ``TRACE`` holds the kind's profiled sub-window and nothing
else. Every reading is per slot-group step, over the steps ``TRACE``
itself counted (the runner's ``steps`` counter). A program without
``TRACE``, or a window in which it counted no step, reads None.
"""
from __future__ import annotations

from typing import Optional


def registry():
    """The program's TRACE, or None where there is none or it counted no
    step."""
    try:
        from navillm_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    return TRACE if TRACE.steps else None


def ms_per_step(name: str, part: str = "seconds") -> Optional[float]:
    """A span's ``part`` of its totals (``seconds``, ``self_s`` or
    ``device_s``) in ms per slot-group step, or None where the span never
    ran."""
    tr = registry()
    tot = tr.totals(name) if tr is not None else None
    if tot is None:
        return None
    return 1e3 * getattr(tot, part) / tr.steps


def per_step(counter: str) -> Optional[float]:
    """A counter per slot-group step."""
    tr = registry()
    if tr is None:
        return None
    return tr.counters.get(counter, 0) / tr.steps
