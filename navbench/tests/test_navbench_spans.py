"""The per-layer metrics that read the program's own spans and counters
(navbench/spans.py, navillm_tpu_torch.utils.profiling.TRACE) on the CPU
at tiny widths: a traced run reports each of them finite, six in the
uncached cell and seven in the cached one; an untraced run reports
none."""
import json
import math

import pytest

from navbench.tests import tiny

pytest.importorskip("torch")

SPAN_METRICS = ("assemble_ms_per_step.eval", "retire_ms_per_step.eval",
                "upload_ms_per_step.eval", "launch_ms_per_step.eval",
                "uploads_per_step.eval", "h2d_mb_per_step.eval")
WINDOW = "window_attn_ms_per_step.eval"


def _root(tmp_path, traffic):
    """A tiny checkout whose seven span metrics all list the tiny cell."""
    root = tiny.make_root(tmp_path, traffic)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS + (WINDOW,) \
                and "tiny.t" not in m["workloads"]:
            m["workloads"].append("tiny.t")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traffic,want", [
    ("r2r_eval", SPAN_METRICS),
    ("r2r_eval_cached", SPAN_METRICS + (WINDOW,))])
def test_traced_run_reports_span_metrics(tmp_path, traffic, want):
    from navillm_tpu_torch.utils.profiling import TRACE
    root = _root(tmp_path, traffic)
    TRACE.reset()
    res = tiny.run(root, trace=True)
    got = {k: v["value"] for k, v in res["metrics"].items()
           if k in SPAN_METRICS + (WINDOW,)}
    assert set(got) == set(want), got
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["uploads_per_step.eval"] > 0 and got["h2d_mb_per_step.eval"] > 0
    assert TRACE.steps > 0
    res_off = tiny.run(root, trace=False)
    assert not set(res_off["metrics"]) & set(SPAN_METRICS + (WINDOW,))
