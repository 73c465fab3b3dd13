"""The comparison that decides ``correct`` sees the faults a cell can have,
planted in the timed path underneath the harness (the port's device step),
and the lower-precision control, at tiny widths on the CPU. The tiny cell's
limits sit far above its sound readings (~1e-7 in f32 on both sides) and
far below what each fault moves."""
import json

import pytest

from navbench.tests import tiny

torch = pytest.importorskip("torch")
DM = pytest.importorskip("navillm_tpu_torch.agents.device_memory")
LIMITS = {"logit_err": 1e-4, "action_gap": 1e-4}


def root_with_limits(tmp_path, traffic="r2r_eval"):
    root = tiny.make_root(tmp_path, traffic)
    (root / "navbench/limits/tiny.t.json").write_text(json.dumps(LIMITS))
    return root


def state_unchanged(orig):
    def step(params, cfg, state, *a, **kw):
        out = orig(params, cfg, state, *a, **kw)
        return (state,) + tuple(out[1:])
    return step


def half_left_out(orig):
    """The second half of the rows is not computed: it gets the first
    half's logits and actions."""
    def step(*a, **kw):
        state, a_t, logits = orig(*a, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h: 2 * h] = logits[:h]
        a_t = a_t.clone()
        a_t[h: 2 * h] = logits[h: 2 * h].argmax(-1).int()
        return state, a_t, logits
    return step


def action_altered(orig):
    """The served action of row 0 is the worst valid candidate, not the
    best."""
    def select(logits, *a, **kw):
        a_t = orig(logits, *a, **kw).clone()
        valid = logits[0] > -1e29
        worst = torch.where(valid, logits[0], torch.full_like(logits[0],
                                                             1e30))
        a_t[0] = worst.argmin().int()
        return a_t
    return select


def test_sound_run_is_correct(tmp_path):
    assert tiny.run(root_with_limits(tmp_path))["correct"]


@pytest.mark.parametrize("name,target,fault,number", [
    ("state_unchanged", "eval_step", state_unchanged, "logit_err"),
    ("half_left_out", "eval_step", half_left_out, "logit_err"),
    ("action_altered", "select_actions", action_altered, "action_gap"),
])
def test_fault_is_not_correct(tmp_path, monkeypatch, name, target, fault,
                              number):
    monkeypatch.setattr(DM, target, fault(getattr(DM, target)))
    res = tiny.run(root_with_limits(tmp_path))
    assert not res["correct"], name
    assert res["compared"][number]["value"] > LIMITS[number]


def test_cached_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(DM, "eval_step_cached",
                        state_unchanged(DM.eval_step_cached))
    res = tiny.run(root_with_limits(tmp_path, "r2r_eval_cached"))
    assert not res["correct"]


def test_control_is_not_correct(tmp_path):
    """The reference in fp8, put in the program's place, comes out not
    correct through the same comparison and limits, and reads far above
    the program's sound reading."""
    res = tiny.run(root_with_limits(tmp_path), control=True)
    assert res["correct"] is False
    ctl = res["compared"]["logit_err"]["value"]
    sound = res["numbers"]["program_logit_err"]
    assert ctl > LIMITS["logit_err"] > sound and ctl > 100 * sound
