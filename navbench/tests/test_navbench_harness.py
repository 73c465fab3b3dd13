"""The harness on the CPU at tiny widths: the result line's schema, the
reference against the port's forward, cells and metrics found from files
alone, and the imports of the run and of the reference."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from navbench import harness as H
from navbench.tests import tiny

pytest.importorskip("torch")
NAVBENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("nb"))


@pytest.mark.parametrize("trace", [False, True])
def test_line_schema_and_reference_agree(root, trace):
    res = tiny.run(root, trace=trace)
    H.check_line(res, trace)
    json.dumps(res)
    got = res["compared"]
    # f32 program and f32 reference: the same sums in other orders
    assert got["logit_err"]["value"] < 1e-5
    assert got["action_gap"]["value"] < 1e-5
    for k in ("masks_differ", "views_wrong", "prompts_wrong", "paths_wrong"):
        assert got[k]["value"] == 0
    assert res["numbers"]["checked_steps"] > 0
    want = {"host_ms_per_step.eval", "mfu.eval", "idle_share.eval"} if trace \
        else {"actions_per_s", "peak_mem_gib", "setup_s"}
    assert want <= set(res["metrics"])


def test_cached_path_against_reference(tmp_path):
    res = tiny.run(tiny.make_root(tmp_path, "r2r_eval_cached"))
    assert res["compared"]["logit_err"]["value"] < 1e-5
    assert res["compared"]["prompts_wrong"]["value"] == 0


def test_line_schema_refuses(root):
    good = {"correct": True, "attempted": 1, "failed": 0,
            "metrics": {"x": {"value": 1.0, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "k", "count": 1,
                       "memory_peak_bytes": 1}, "compared": {}}
    H.check_line(good, False)
    for bad in ({**good, "metrics": {"x": {"value": float("nan"),
                                           "unit": "s"}}},
                {k: v for k, v in good.items() if k != "failed"},
                {**good, "compared": {}, "device": good["device"]}
                | {"extra": 1}):
        with pytest.raises(ValueError):
            H.check_line(bad, False)
    with pytest.raises(ValueError):
        H.check_line(good, True)


def test_new_cell_config_and_metric_from_files(tmp_path):
    """A configuration, a cell and a per-layer metric that exist only as
    added files and BENCHMARK.json entries are found and reported."""
    root = tiny.make_root(tmp_path)
    (root / "navbench/metrics/steps_seen.eval.py").write_text(
        "def read(t):\n    return float(t['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_seen.eval", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "host loop",
                               "moves": "actions_per_s",
                               "workloads": ["tiny.t"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = H.Cell(root, "tiny.t")
    assert cell.config["name"] == "tiny"
    assert "steps_seen.eval" in [m["name"] for m in cell.per_layer]
    res = tiny.run(root, trace=True)
    assert res["metrics"]["steps_seen.eval"]["value"] > 0


TOY_KIND = '''"""A throwaway kind: row sums of a matrix drawn from the seed."""
import time

import numpy as np
import torch

COMPARED = ("sum_err",)


def draw(traffic, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(traffic["rows"], traffic["width"], generator=g)


def run(ctx):
    x = draw(ctx.traffic, ctx.seed).to(ctx.device)
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() < t0 + 0.2:
        s = x.sum(1)
        done += 1
    return {"window": (t0, time.perf_counter()), "s": s, "done": done,
            "peak_process": ctx.peak_bytes()}


def end_to_end(out, seconds):
    w = out["window"][1] - out["window"][0]
    return {"sums_per_s": out["done"] / w, "peak_mem_gib": 1.0}, \\
        {"sums": out["done"]}


def traced(out, cfg):
    w = out["window"][1] - out["window"][0]
    return {"busy_s": w, "window_s": w, "groups": {"sum": w}, "gaps": {},
            "sums": out["done"]}


def take(out):
    return {"s": out["s"].cpu().double().numpy()}


def check(held, cfg, traffic, seed, device, control=False):
    want = draw(traffic, seed).double().numpy()
    got = want.astype(np.float16).sum(1) if control else held["s"]
    return {"compared": {"sum_err": float(np.abs(got - want.sum(1)).max())},
            "numbers": {}, "attempted": 1, "failed": 0}
'''


def test_new_kind_from_files(tmp_path):
    """A kind of traffic with its own compared number, its own end-to-end
    and per-layer metrics, found under the root from added files and
    entries alone; its control comes out not correct."""
    root = tiny.make_root(tmp_path)
    nb = root / "navbench"
    (nb / "kinds/row_sums.py").write_text(TOY_KIND)
    (nb / "traffic/sums.json").write_text(json.dumps(
        {"kind": "row_sums", "rows": 256, "width": 512}))
    (nb / "limits/tiny.sums.json").write_text(json.dumps({"sum_err": 1e-3}))
    (nb / "metrics/sums_seen.sums.py").write_text(
        "def read(t):\n    return float(t['sums'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.sums", "config": "tiny",
                               "traffic": "sums", "chips": 1,
                               "why": "CPU tests"})
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.sums"]})
    bench["per_layer"].append({"name": "sums_seen.sums", "unit": "sums",
                               "better": "higher", "source": "host_clock",
                               "layer": "host loop", "moves": "sums_per_s",
                               "workloads": ["tiny.sums"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert not (NAVBENCH / "kinds/row_sums.py").exists()
    res = tiny.run(root, cell="tiny.sums")
    H.check_line(res, False)
    assert res["correct"] and res["compared"]["sum_err"]["limit"] == 1e-3
    assert set(res["metrics"]) == {"sums_per_s", "peak_mem_gib", "setup_s"}
    res = tiny.run(root, cell="tiny.sums", trace=True)
    H.check_line(res, True)
    assert set(res["metrics"]) == {"sums_seen.sums"}
    res = tiny.run(root, cell="tiny.sums", control=True)
    assert res["correct"] is False
    assert res["compared"]["sum_err"]["value"] > 1e-3


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (NAVBENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "navillm_tpu", "navillm_tpu_torch"), \
                f"{path.name} imports {name}"
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import navbench.reference.check, navbench.reference.compare\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'navillm_tpu', 'navillm_tpu_torch')]\n"
            "print(bad); sys.exit(1 if bad else 0)" % str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process loads the port (navillm_tpu_torch)
    and nothing whose top-level name is jax, jaxlib, flax or
    navillm_tpu."""
    root = tiny.make_root(tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from navbench.tests import tiny\n"
            "from navbench import harness as H\n"
            "tiny.run(Path(%r))\n"
            "assert 'navillm_tpu_torch' in sys.modules\n"
            "bad = H.forbidden_modules(); print(bad)\n"
            "sys.exit(1 if bad else 0)" % (str(tiny.REPO), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin",
                                         "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert H.FORBIDDEN == ("jax", "jaxlib", "flax", "navillm_tpu")
