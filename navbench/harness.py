"""The benchmark's harness: one cell, one run, one result line.

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
checkout's root: the cell's entry names its configuration (whose entry
names its file, ``navbench/configs/<config>.json``) and its traffic
(``navbench/traffic/<traffic>.json``, whose ``kind`` names the driver
``navbench/kinds/<kind>.py``); the limits of its correctness numbers are
``navbench/limits/<cell>.json``; each per-layer metric is read by
``navbench/metrics/<metric>.py`` (``read(traced) -> float | None``),
all under the root the harness is given. A later change adds a cell, a
configuration, a traffic mix, a kind of traffic or a metric by adding
files and entries.

A kind is a module with:

- ``run(ctx) -> out``: set up, warm up and measure. ``ctx`` holds the
  configuration and traffic dicts, the seed, the window's seconds, whether
  to trace, the device, a work directory and ``peak_bytes()`` /
  ``reset_peak()``. ``out`` holds at least ``window`` (the window's start
  and end on ``time.perf_counter``'s clock) and ``peak_process`` (the
  process's peak device bytes).
- ``end_to_end(out, seconds) -> (metrics, info)``: the end-to-end metrics
  by name (``setup_s`` is the harness's), and counts for the line's
  ``run`` key.
- ``traced(out, config) -> dict``: what the per-layer readers read, with
  ``busy_s``, ``window_s``, ``groups`` and ``gaps`` (device seconds by
  kernel group, idle seconds by host span).
- ``take(out) -> held``: what the check reads, as plain data; the program's
  state is freed once it returns.
- ``COMPARED``: the names of the numbers that decide ``correct``.
- ``check(held, config, traffic, seed, device, control) -> dict``:
  ``compared`` (each name of ``COMPARED`` with its value), ``numbers``
  (further readings), ``attempted`` and ``failed``. With ``control`` the
  lower-precision control is put in the program's place, and its numbers
  are compared with the same limits.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "navillm_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(home: Path, kind: str):
    """``home/kinds/<kind>.py``, loaded as a module of this package, so
    that its relative imports resolve here."""
    name = f"{__package__}.kinds.{kind}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, home / "kinds" / f"{kind}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


class Cell:
    """A cell of BENCHMARK.json with its files and metrics."""

    def __init__(self, root: Path, name: str, bench: Optional[Dict] = None):
        self.root = Path(root)
        bench = bench if bench is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.home = self.root / HERE.name
        self.traffic = json.loads((self.home / "traffic"
                                   / f"{self.entry['traffic']}.json")
                                  .read_text())
        lim = self.home / "limits" / f"{name}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._reports(m, bench)]
        self.per_layer = [m for m in bench["per_layer"]
                          if self._reports(m, bench)]

    def _reports(self, metric: Dict, bench: Dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:       # a per-layer metric without a list
            moved = {m["name"]: m for m in bench["end_to_end"]}[
                metric["moves"]]
            return "workloads" not in moved or self.name in moved["workloads"]
        return True

    def reader(self, metric: str):
        path = self.home / "metrics" / f"{metric}.py"
        return load_module(path, f"navbench_metric_{metric}").read


def process_start() -> float:
    """The process's start on time.perf_counter's clock (from
    /proc/self/stat), or this module's import where that is not read."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_info(torch, device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips}


def run_cell(cell: Cell, seed: int, seconds: int, trace: bool, device,
             workdir: Path, t_start: float, control: bool = False) -> Dict:
    """Run one cell; returns the result line's dict, the compared numbers
    under its last key ("compared": name -> value and limit). With
    ``control`` the cell's kind puts its lower-precision control in the
    program's place, and ``correct`` is decided on the control's numbers."""
    import torch
    kind = kind_module(cell.home, cell.traffic["kind"])

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)

    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          seed=seed, seconds=seconds, trace=trace,
                          device=device, workdir=workdir,
                          peak_bytes=peak_bytes, reset_peak=reset_peak)
    out = kind.run(ctx)
    e2e, extra = kind.end_to_end(out, seconds)
    e2e["setup_s"] = out["window"][0] - t_start
    extra["marks_s"] = out.get("marks", {})
    metrics: Dict[str, Dict] = {}
    dev = device_info(torch, device, cell.entry["chips"])
    dev["memory_peak_bytes"] = int(out["peak_process"])
    breakdown = None
    if trace:
        t = kind.traced(out, cell.config)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        from .trace import top
        breakdown = {"device_ops": top(t.get("groups", {})),
                     "idle_gaps": top(t.get("gaps", {}))}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    # the program's state goes before the reference runs
    held = kind.take(out)
    del out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    verdict = kind.check(held, cell.config, cell.traffic, seed, device,
                         control=control)
    extra["reference_s"] = time.perf_counter() - t_ref
    compared = {k: (verdict["compared"][k], cell.limits.get(k, 0))
                for k in kind.COMPARED if k in verdict["compared"]}
    correct = len(compared) == len(kind.COMPARED) and all(
        v <= lim for v, lim in compared.values())
    result = {"correct": correct, "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["run"] = extra
    result["numbers"] = verdict.get("numbers", {})
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result


def check_line(result: Dict, trace: bool) -> None:
    """Raise where a result line breaks the benchmark's contract: the keys
    correct, attempted, failed, metrics and device; each metric a finite
    number with its unit; the device's platform, kind, count and peak
    bytes, and with trace its busy and window seconds; a breakdown of at
    most 10 entries per list; the compared numbers under the last key."""
    import math
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        if key not in result:
            raise ValueError(f"result line without {key!r}")
    if not isinstance(result["correct"], bool):
        raise ValueError("correct is not a bool")
    for key in ("attempted", "failed"):
        if not isinstance(result[key], int) or result[key] < 0:
            raise ValueError(f"{key} is not a count")
    for name, m in result["metrics"].items():
        if set(m) != {"value", "unit"} or not isinstance(
                m["value"], (int, float)) or not math.isfinite(m["value"]):
            raise ValueError(f"metric {name}: {m}")
    dev = result["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        if key not in dev:
            raise ValueError(f"device without {key!r}")
    if trace:
        if not (dev.get("window_s", 0) > 0 and "busy_s" in dev):
            raise ValueError("a traced line needs busy_s and window_s")
        for lst in result.get("breakdown", {}).values():
            if len(lst) > 10:
                raise ValueError("a breakdown list holds more than 10")
    if list(result)[-1] != "compared":
        raise ValueError("the compared numbers are not the last key")
