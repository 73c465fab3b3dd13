"""The port's batched evaluation (``validate``) against the JAX package's:
R2R, and EQA with its trie-constrained answers and the oracle pass; the
streaming evaluator with one slot against it (the twin of
tests/test_streaming_eval.py:92); and --no-streaming_eval's routing.

The harness is tests/test_torch_perstep.py's: the same world, features,
converted f32 weights, BPE prompts and RandomState on both sides, with a
stop bias so that episodes end at mixed steps. Predictions must be
identical, and so the per-stage structure.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_perstep import (models, side, structure,  # noqa: E402,F401
                                worlds)

from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402

STOP_BIAS = 2.0
KEYS = ("trajectory", "pred_answer", "oracle_pred_answer", "gt_answer")


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


def _validate(port, models, root, task, streaming=False, slots=2,
              identity=False, **kw):
    s = side(port, models, root, task, training=False, stop_bias=STOP_BIAS,
             val_batch_size=slots, **kw)
    if identity:
        s.agent.np_rng = _IdentityRng()
    loader = (Dataloader if port else JLoader)(s.ds, slots, False)
    run = s.agent.validate_streaming if streaming else s.agent.validate
    preds = run(task, s.args, s.cfg, loader, dataset=s.ds)
    scores, _ = s.ds.eval_metrics(preds, None, task)
    return {p["instr_id"]: p for p in preds}, scores, s


@pytest.mark.parametrize("task", ["R2R", "EQA"])
def test_validate_matches_jax(models, worlds, task):
    """Batched argmax evaluation of the val split in batches of 2; on EQA the
    answers come from the trie over the answer vocabulary and the oracle
    pass reruns each batch under the expert: trajectories, answers,
    oracle answers, scores and stage counts are JAX's."""
    got, scores, s = _validate(True, models, worlds, task)
    want, jscores, js = _validate(False, models, worlds, task)
    assert got.keys() == want.keys() and len(got) == len(s.ds)
    for k, p in want.items():
        for key in KEYS:
            assert got[k].get(key) == p.get(key), (k, key)
    assert len({len(p["trajectory"]) for p in got.values()}) > 1
    for k in jscores:
        assert scores[k] == pytest.approx(jscores[k], rel=1e-9), k
    assert structure(s.agent.timer) == structure(js.agent.timer)
    if task == "EQA":
        vocab = s.ds.answer_vocab
        assert all(p["pred_answer"] in vocab
                   and p["oracle_pred_answer"] in vocab
                   for p in got.values())
        # two generate calls per batch: the policy's pass and the oracle's
        assert s.runner.generate_calls == 2 * len(s.ds) // 2
    assert s.runner.forward_calls == s.agent.timer.summary()[
        "nav_device"]["count"]


def test_streaming_one_slot_matches_validate(models, worlds):
    """With one slot and batches of one, streaming evaluation steps
    through the same math as the batched one: identical trajectories. The
    candidate order is the identity on both: the batched rollout draws a
    permutation on its final step after the episode ended (as JAX's
    does), which the streaming one does not."""
    want, _, _ = _validate(True, models, worlds, "R2R", slots=1,
                           identity=True)
    got, _, _ = _validate(True, models, worlds, "R2R", streaming=True,
                          slots=1, identity=True)
    assert {k: p["trajectory"] for k, p in got.items()} == \
        {k: p["trajectory"] for k, p in want.items()}


def test_no_streaming_eval_routes_to_validate(models, worlds):
    """val_one_epoch runs the agent's validate under --no-streaming_eval
    and validate_streaming otherwise, as the JAX train loop does."""
    s = side(True, models, worlds, "R2R", training=False,
             stop_bias=STOP_BIAS)
    calls = []
    for name in ("validate", "validate_streaming"):
        def fn(*a, _name=name, **kw):
            calls.append(_name)
            return []
        setattr(s.agent, name, fn)
    s.ds.eval_metrics = lambda preds, logger, name: ({"sr": 0.0}, {})
    for streaming in (False, True):
        s.args.streaming_eval = streaming
        TTL.val_one_epoch(s.args, s.cfg, s.runner,
                          {"R2R": (Dataloader(s.ds, 2, False), 1.0)},
                          {"R2R": s.agent}, {"R2R": s.ds}, 0, None)
    assert calls == ["validate", "validate_streaming"]
