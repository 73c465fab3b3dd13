"""The port's spans and counters (navillm_tpu_torch/utils/profiling.py:
span, count, TRACE) on a tiny streaming evaluation on the CPU.

With no profiler running, an uncached and a prefix-cached
``validate_streaming`` enter no ``record_function``, read no clock beyond
the stage timer's and leave ``TRACE`` empty. Under ``trace(dir)`` each
``nav.*`` span counts the work it wraps (``assemble``, ``retire`` per
slot-group step, ``launch`` per step and prefill, ``window_attn`` per
layer of each cached step), children nest inside their parents in
``TRACE`` and in ``trace.json``, ``uploads`` / ``h2d_bytes`` equal what a
wrapped ``runner.upload`` saw, and every step's logits and action equal
those of the run with tracing off."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import runner as R  # noqa: E402
from navillm_tpu_torch.convert import init_nav_params  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models.nav_model import (NavModel,  # noqa: E402
                                                NavModelConfig)
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu_torch.utils import profiling as P  # noqa: E402

SLOTS = 2
ACTION_LEN = 4


class _CountingClock:
    """time stand-in for profiling.py that counts perf_counter reads."""

    def __init__(self):
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        return float(self.reads)


@pytest.fixture(scope="module")
def model_and_world(tmp_path_factory):
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    cfg = NavModelConfig.tiny(vocab_size=bpe.vocab_size, use_obj=False)
    model = NavModel(cfg, init_nav_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    anno = T.make_r2r_world(tmp_path_factory.mktemp("world"), n_episodes=5,
                            rows=3, cols=3)
    return bpe, cfg, model, anno


def _evaluate(model_and_world, cached, tmp=None):
    """One streaming evaluation; with ``tmp`` under ``trace(tmp)``. Returns
    the runner, the agent, the trajectories, each step's (logits, actions)
    and what a wrapped runner.upload saw (count, bytes)."""
    bpe, cfg, model, anno = model_and_world
    runner = R.NavModelRunner(cfg, model, bpe, dims=R.RolloutDims.tiny())
    agent, ds, args = T.r2r_eval(anno, runner, SLOTS,
                                 cfg.pano.image_feat_size,
                                 prefix_cache=cached)
    steps, seen = [], {"n": 0, "bytes": 0}
    upload = runner.upload

    def wrapped_upload(x, dtype=None):
        out = upload(x, dtype)
        seen["n"] += 1
        seen["bytes"] += out.nbytes
        return out

    runner.upload = wrapped_upload
    name = "eval_step_cached" if cached else "eval_step"
    step = getattr(runner, name)

    def kept_step(*a, **kw):
        out = step(*a, **kw)
        steps.append((out[-1].clone(), out[-2].clone()))
        return out

    setattr(runner, name, kept_step)
    with P.trace(None if tmp is None else str(tmp)):
        preds = agent.validate_streaming("R2R", args,
                                         T.eval_config(ACTION_LEN),
                                         Dataloader(ds, SLOTS, False),
                                         dataset=ds)
    trajs = {p["instr_id"]: p["trajectory"] for p in preds}
    return runner, agent, trajs, steps, seen


@pytest.fixture(scope="module")
def runs(model_and_world, tmp_path_factory):
    """Per path (uncached, cached): the run with tracing off, then the
    traced run with TRACE's state copied."""
    out = {}
    for cached in (False, True):
        P.TRACE.reset()
        off = _evaluate(model_and_world, cached)
        tmp = tmp_path_factory.mktemp("trace")
        on = _evaluate(model_and_world, cached, tmp=tmp)
        spans = {k: (v.layer, v.count, v.seconds, v.covered_s,
                     dict(v.parents)) for k, v in P.TRACE.spans.items()}
        window = P.TRACE.totals("window_attn")
        out[cached] = {"off": off, "on": on, "spans": spans,
                       "counters": dict(P.TRACE.counters),
                       "steps": P.TRACE.steps, "dir": tmp,
                       "window_device_s": None if window is None
                       else window.device_s}
    return out


@pytest.mark.parametrize("cached", [False, True])
def test_no_profiler_records_nothing(model_and_world, monkeypatch, cached):
    def refuse(*a, **kw):
        raise AssertionError("a span entered record_function with no "
                             "profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    clock = _CountingClock()
    monkeypatch.setattr(P, "time", clock)
    P.TRACE.reset()
    _, agent, trajs, steps, _ = _evaluate(model_and_world, cached)
    assert steps and trajs
    assert P.TRACE.spans == {} and dict(P.TRACE.counters) == {}
    assert P.TRACE.steps == 0
    # the stage timer's two reads per stage and nothing more
    assert clock.reads == 2 * sum(agent.timer.counts.values()) > 0


@pytest.mark.parametrize("cached", [False, True])
def test_span_counts_match_the_work(runs, model_and_world, cached):
    r = runs[cached]
    runner = r["on"][0]
    spans = r["spans"]
    n_steps = runner.cached_steps if cached else runner.eval_steps
    assert n_steps > 0 and r["steps"] == n_steps
    prefills = runner.prefill_calls
    assert (prefills > 0) == cached
    count = {k: v[1] for k, v in spans.items()}
    assert count["assemble"] == count["retire"] == n_steps
    assert count["launch"] == n_steps + prefills
    # one panorama assembly per step, one gathered upload per runner call
    assert count["upload"] == 2 * n_steps + prefills
    layers = model_and_world[1].llm.num_layers
    if cached:
        assert count["window_attn"] == layers * runner.cached_steps
    else:
        assert "window_attn" not in spans
    # on CPU tensors a HostCopy has no event to wait on
    assert "wait" not in spans
    assert spans["upload"][0] == spans["launch"][0] == "runner"
    assert spans["assemble"][0] == spans["retire"][0] == "loop"
    # the stages keep their JAX names as ranges of the loop
    for stage in ("pano_assemble", "nav_assemble", "nav_dispatch",
                  "nav_sync"):
        assert spans[stage][0] == "loop" and spans[stage][1] == n_steps


@pytest.mark.parametrize("cached", [False, True])
def test_children_nest_inside_parents(runs, cached):
    r = runs[cached]
    spans = r["spans"]
    parents = {k: set(v[4]) for k, v in spans.items()}
    assert parents["assemble"] == parents["retire"] == {None}
    assert parents["upload"] <= {"pano_assemble", "nav_dispatch",
                                 "prefill_dispatch"}
    assert parents["launch"] <= {"nav_dispatch", "prefill_dispatch"}
    if cached:
        assert parents["window_attn"] == {"launch"}
        assert "prefill_dispatch" in parents["upload"]
    for stage in ("pano_assemble", "nav_assemble", "nav_dispatch"):
        assert parents[stage] == {"assemble"}
    for stage in ("nav_sync", "env_step", "get_obs"):
        assert parents[stage] == {"retire"}
    # assemble's cover is its runner spans (upload, launch), no more
    ups = sum(v[2] for k, v in spans.items() if k in ("upload", "launch"))
    assert spans["assemble"][3] == pytest.approx(ups, rel=1e-9)
    assert 0 < spans["assemble"][2] - spans["assemble"][3]
    assert spans["retire"][3] == 0.0
    if cached:
        # the window attention is the model's, covered inside launch
        assert spans["launch"][3] == pytest.approx(
            spans["window_attn"][2], rel=1e-9)
        assert r["window_device_s"] == pytest.approx(spans["window_attn"][2])


@pytest.mark.parametrize("cached", [False, True])
def test_trace_json_holds_nested_nav_ranges(runs, cached):
    r = runs[cached]
    events = json.loads((r["dir"] / P.TRACE_FILE).read_text())["traceEvents"]
    nav = [e for e in events
           if str(e.get("name", "")).startswith(P.SPAN_PREFIX)
           and e.get("ph") == "X"]
    names = {e["name"][len(P.SPAN_PREFIX):] for e in nav}
    assert names == set(r["spans"])
    by = {}
    for e in nav:
        by.setdefault(e["name"][len(P.SPAN_PREFIX):], []).append(
            (e["ts"], e["ts"] + e["dur"]))

    def inside(child, parents):
        outer = [iv for p in parents for iv in by[p]]
        for c0, c1 in by[child]:
            assert any(p0 <= c0 and c1 <= p1 for p0, p1 in outer), child

    inside("upload", ["assemble"])
    inside("launch", ["assemble"])
    inside("nav_sync", ["retire"])
    if cached:
        inside("window_attn", ["launch"])
    assert len(by["assemble"]) == r["spans"]["assemble"][1]


@pytest.mark.parametrize("cached", [False, True])
def test_upload_counters_match_wrapped_upload(runs, cached):
    r = runs[cached]
    seen = r["on"][4]
    assert seen["n"] > 0
    assert r["counters"]["uploads"] == seen["n"]
    assert r["counters"]["h2d_bytes"] == seen["bytes"]


@pytest.mark.parametrize("cached", [False, True])
def test_step_outputs_equal_with_tracing_off(runs, cached):
    r = runs[cached]
    _, _, trajs_off, steps_off, _ = r["off"]
    _, _, trajs_on, steps_on, _ = r["on"]
    assert trajs_on == trajs_off
    assert len(steps_on) == len(steps_off) > 0
    for (lo, ao), (ln, an) in zip(steps_off, steps_on):
        assert torch.equal(lo, ln)
        assert np.array_equal(np.asarray(ao), np.asarray(an))


def test_span_records_whole_and_covers_by_layer(monkeypatch):
    """A span begun while recording is recorded after the profiler stops,
    timed up to the last moment a span saw it recording; its nested spans'
    step id reaches record_function; the nearest ancestors of one other
    layer are covered, not those beyond."""
    clock = _CountingClock()
    monkeypatch.setattr(P, "time", clock)
    args = []
    real = torch.profiler.record_function

    def kept(name, a=None):
        args.append((name, a))
        return real(name, a)

    monkeypatch.setattr(torch.profiler, "record_function", kept)
    P.TRACE.reset()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        outer = P.span("assemble", "loop", (1, 7))
        outer.__enter__()
        with P.span("nav_dispatch", "loop"):
            with P.span("launch", "runner"):
                with P.span("window_attn", "model", timed=torch.zeros(1)):
                    pass
        P.count(uploads=3)
    finally:
        prof.stop()
    outer.__exit__(None, None, None)
    with P.span("after", "loop"):
        P.count(uploads=1)
    tot = {k: v for k, v in P.TRACE.spans.items()}
    assert set(tot) == {"assemble", "nav_dispatch", "launch", "window_attn"}
    # fake clock: a read per enter and exit, one unit apart
    assert tot["window_attn"].seconds == 1.0
    assert tot["launch"].seconds == 3.0
    # read 8 at its exit, after the stop: cut at nav_dispatch's exit, 7
    assert tot["assemble"].seconds == 6.0 and tot["assemble"].count == 1
    assert tot["launch"].covered_s == 1.0
    assert tot["nav_dispatch"].covered_s == 3.0
    assert tot["assemble"].covered_s == 3.0
    assert tot["assemble"].self_s == 3.0
    assert tot["window_attn"].device_s == 1.0
    assert tot["launch"].parents == {"nav_dispatch": 1}
    assert dict(P.TRACE.counters) == {"uploads": 3}
    assert [a for _, a in args] == ["group 1 step 7"] * 4


def test_wait_span_around_the_event(monkeypatch):
    class _Event:
        synced = 0

        def synchronize(self):
            _Event.synced += 1

    copy = R.HostCopy(torch.arange(4))
    copy.event = _Event()
    P.TRACE.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.span("nav_sync", "loop"):
            got = copy.result()
    assert list(got) == [0, 1, 2, 3] and _Event.synced == 1
    wait = P.TRACE.spans["wait"]
    assert wait.count == 1 and wait.layer == "runner"
    assert wait.parents == {"nav_sync": 1}
    assert P.TRACE.spans["nav_sync"].covered_s == wait.seconds
