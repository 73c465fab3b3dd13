"""The device trace of a window: busy time, kernel groups, idle gaps.

The method is a frozen copy of ``scripts/profile_port.py``'s (commit
20b2d57): torch.profiler with CPU and CUDA activities, the device events
(kernels, copies, memsets) only, the card's busy time as the union of
their spans, and kernel groups by name substrings, first match wins.
Beyond it: the idle gaps between device spans are named by the benchmark's
own host span the process was in at the gap's middle (``HOST_SPANS``,
recorded with ``record_function`` around the calls into the program's
runner), or ``host_loop`` outside all of them.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import torch

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
K1_GROUP = "K1 flash forward"
SPAN_PREFIX = "navbench."


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def digest(prof) -> Dict:
    """From a stopped profiler: the device spans' union (busy seconds),
    seconds by kernel group, and the idle gaps' seconds by the host span
    they fell in. Times are the profiler's (microseconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(SPAN_PREFIX))
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type != cuda
                  and e.name.startswith(SPAN_PREFIX))
    by_group: Dict[str, float] = {}
    busy, gaps, reach = 0.0, [], None
    for start, end, name in spans:
        group = group_of(name)
        by_group[group] = by_group.get(group, 0.0) + (end - start) / 1e6
        if reach is not None and start > reach:
            gaps.append((reach, start))
        busy += max(0, end - max(start, reach if reach is not None
                                 else start))
        reach = end if reach is None else max(reach, end)
    gap_by: Dict[str, float] = {}
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "host_loop"
        k = bisect.bisect_right(starts, mid) - 1
        while k >= 0:
            h0, h1, hname = host[k]
            if h0 <= mid <= h1:
                name = hname[len(SPAN_PREFIX):]
                break
            if h1 < mid - 1e6:        # spans before are long over
                break
            k -= 1
        gap_by[name] = gap_by.get(name, 0.0) + (g1 - g0) / 1e6
    return {"busy_s": busy / 1e6, "groups": by_group, "gaps": gap_by,
            "device_events": len(spans)}


def top(d: Dict[str, float], n: int = 10) -> List[Tuple[str, float]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
