"""The port's per-stage timer and profiler trace
(navillm_tpu_torch/utils/profiling.py) against the JAX package's
(navillm_tpu/utils/profiling.py): the same stage sequence on a fake clock
gives the same summary (keys, counts, rounding) and the same report, a
stage that raises is counted; trace(None) does nothing, trace(dir) writes
a Chrome trace of the block on the CPU."""
import json

import pytest

torch = pytest.importorskip("torch")

from navillm_tpu.utils import profiling as JP  # noqa: E402
from navillm_tpu_torch.utils import profiling as P  # noqa: E402


class _Clock:
    """perf_counter stand-in: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def perf_counter(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


def _drive(mod, monkeypatch):
    # a second of 1/3 s steps and odd sizes exercise the rounding
    steps = [0.0, 1 / 3, 0.0, 0.0123456, 0.0, 2.5e-5, 0.0, 1.0, 0.0, 0.25]
    monkeypatch.setattr(mod, "time", _Clock(steps))
    timer = mod.StageTimer()
    with timer.stage("pano_assemble"):
        pass
    with timer.stage("nav_dispatch"):
        pass
    with timer.stage("pano_assemble"):
        pass
    with pytest.raises(ValueError):
        with timer.stage("nav_sync"):
            raise ValueError("a failing stage is still timed")
    with timer.stage("env_step"):
        pass
    return timer


def test_stage_timer_matches_jax(monkeypatch):
    got, want = _drive(P, monkeypatch), _drive(JP, monkeypatch)
    assert got.summary() == want.summary()
    assert list(got.summary()) == sorted(got.summary())
    assert got.summary()["nav_sync"]["count"] == 1
    assert got.summary()["pano_assemble"] == {
        "total_s": round(1 / 3 + 2.5e-5, 4), "count": 2,
        "mean_ms": round(1e3 * (1 / 3 + 2.5e-5) / 2, 3)}
    assert got.report() == want.report()
    assert got.report().splitlines()[0] == "per-stage timings:"

    class _Logger:
        def __init__(self):
            self.lines = []

        def info(self, msg):
            self.lines.append(msg)

    log = _Logger()
    assert got.report(log) == log.lines[0]
    got.reset()
    assert got.summary() == {} and got.report() == "per-stage timings:"


def test_trace_none_does_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("trace(None) must not start a profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with P.trace(None) as prof:
        assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with P.trace(str(d)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert prof is not None
    events = json.loads((d / P.TRACE_FILE).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
