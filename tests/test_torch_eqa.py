"""Port EQA (dataset, streaming evaluation with the oracle pass) and
test-mode summarization against the JAX package.

Both sides get the same world, synthetic features, converted weights (f32,
a stop bias so that episodes end at mixed steps) and BPE prompts; the
streamed trajectories, pred_answer and oracle_pred_answer must be
identical, uncached and prefix-cached, and so the scores.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load  # noqa: E402
from navillm_tpu.data.feature_db import \
    SyntheticImageFeaturesDB as JFeatures  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.feature_db import \
    SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runners():
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jcfg = JNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(2.0)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    return (JRunner(jcfg, pj, tok, dims=JDims.tiny()),
            NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny()))


def _config(root, split, source, max_action_len, feat):
    sec = {"DIR": source, "SPLIT": {"val_unseen": f"annotations/{split}"}}
    if source == "EQA":
        sec["ANSWER_VOCAB"] = "annotations/answer_vocab.json"
    return {"Feature": {"image_feat_size": feat, "angle_feat_size": 4},
            source: sec,
            "Optim": {"val_max_action_len": {source: max_action_len}}}


def _stream(runner, port, root, split, source, max_action_len, **flags):
    """validate_streaming on one package: {instr_id: prediction}, the
    dataset's scores, and the dataset."""
    feat = runner.cfg.pano.image_feat_size
    cfg = _config(root, split, source, max_action_len, feat)
    kw = dict(data_dir=str(root), val_batch_size=2, seed=0,
              image_feat_size=feat, **flags)
    if port:
        args = TCFG.TrainArgs(device="cpu", **kw)
        world, cfg = WorldModel(str(root / "connectivity")), \
            TCFG.ConfigDict(cfg)
        load, feats, loader, agent_of = load_dataset, \
            SyntheticImageFeaturesDB, Dataloader, load_agent
    else:
        args = TrainArgs(**kw)
        world, cfg = JWorld(str(root / "connectivity")), ConfigDict(cfg)
        load, feats, loader, agent_of = j_load, JFeatures, JLoader, \
            j_load_agent
    name = source.lower()
    ds = load(name, args, cfg, training=False, source=source, world=world)
    ds.init_feat_db(feats(feat))
    preds = agent_of(name, args, world, runner).validate_streaming(
        source, args, cfg, loader(ds, 2, False), dataset=ds)
    scores, _ = ds.eval_metrics(preds, None, source)
    return {p["instr_id"]: p for p in preds}, scores, ds


def test_eqa_dataset_and_metrics_match_jax(data_dir, task_config, tmp_path):
    """The fixture's EQA annotations and make_r2r_world's: the same
    samples, observations (question as the instruction, the answer beside
    it) and answer vocabulary; eval_metrics' exact-match scores on a set
    of predictions."""
    T.make_r2r_world(tmp_path, n_episodes=5, rows=4, cols=4, seed=1)
    for root, cfg in ((data_dir, task_config),
                      (tmp_path, _config(tmp_path, "val.json", "EQA", 5,
                                         32))):
        args = TCFG.TrainArgs(data_dir=str(root), device="cpu")
        jargs = TrainArgs(data_dir=str(root))
        ds = load_dataset("eqa", args, TCFG.ConfigDict(cfg), source="EQA",
                          world=WorldModel(str(root / "connectivity")))
        jds = j_load("eqa", jargs, ConfigDict(cfg), source="EQA",
                     world=JWorld(str(root / "connectivity")))
        assert ds.alldata == jds.alldata and ds.gt_trajs == jds.gt_trajs
        assert ds.answer_vocab == jds.answer_vocab
        ds.init_feat_db(SyntheticImageFeaturesDB(32))
        jds.init_feat_db(JFeatures(32))
        ob, job = ds[0]["observations"], jds[0]["observations"]
        assert ob["instruction"] == job["instruction"]
        assert ob["answer"] == job["answer"] and ob["instr_id"] == \
            job["instr_id"]
    assert len(ds.answer_vocab) >= 16
    preds = [{"instr_id": x["instr_id"], "trajectory": [[p] for p in
                                                        x["path"][:k + 1]],
              "gt_answer": x["question"]["answer_text"],
              "pred_answer": ds.answer_vocab[k],
              "oracle_pred_answer": x["question"]["answer_text"]}
             for k, x in enumerate(ds.alldata)]
    got, want = ds.eval_metrics(preds, None, "EQA")[0], \
        jds.eval_metrics(preds, None, "EQA")[0]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    assert got["oracle_exact_match"] == 100.0


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["uncached", "cached"])
def test_streaming_eqa_with_oracle_matches_jax(runners, tmp_path,
                                               prefix_cache):
    """Trie-constrained answers per finishing slot and the oracle second
    pass in the same slot: trajectories, pred_answer and
    oracle_pred_answer identical to JAX's, every answer in the
    vocabulary."""
    jrunner, trunner = runners
    T.make_r2r_world(tmp_path, n_episodes=6, rows=4, cols=4, seed=3)
    calls = trunner.generate_calls
    got, scores, ds = _stream(trunner, True, tmp_path, "val.json", "EQA", 5,
                              prefix_cache=prefix_cache)
    want, jscores, _ = _stream(jrunner, False, tmp_path, "val.json", "EQA",
                               5, prefix_cache=prefix_cache)
    assert got.keys() == want.keys() and len(got) == 6
    for k, p in want.items():
        for key in ("trajectory", "pred_answer", "oracle_pred_answer",
                    "gt_answer"):
            assert got[k][key] == p[key], (k, key)
        assert p["pred_answer"] in ds.answer_vocab
        assert p["oracle_pred_answer"] in ds.answer_vocab
    assert len({len(p["trajectory"]) for p in want.values()}) > 1
    for k in jscores:
        assert scores[k] == pytest.approx(jscores[k], rel=1e-9), k
    # one generate call per flush of 2 slots, both passes: 6 of each
    assert trunner.generate_calls - calls == 6


def test_generation_queue_drains_under_a_flood(runners, tmp_path):
    """max_action_len 1 with two slot groups: every slot finishes on every
    iteration, so the queue grows by up to twice the flush width at once;
    the forced flush at the end must drain it (twin of
    tests/test_streaming_eval.py's flood test), as JAX does."""
    jrunner, trunner = runners
    T.make_r2r_world(tmp_path, n_episodes=12, rows=4, cols=4, seed=5)
    got, _, ds = _stream(trunner, True, tmp_path, "val.json", "EQA", 1,
                         prefix_cache=True)
    want, _, _ = _stream(jrunner, False, tmp_path, "val.json", "EQA", 1,
                         prefix_cache=True)
    assert len(got) == 12 and got == want
    assert all(p["pred_answer"] in ds.answer_vocab
               and p["oracle_pred_answer"] in ds.answer_vocab
               for p in got.values())


def test_test_mode_summarization_matches_jax(runners, tmp_path):
    """enable_summarize in test mode: every finished R2R slot gets a summary
    from the generation queue (50 greedy tokens, no trie), equal to
    JAX's, with the instruction as its ground truth."""
    jrunner, trunner = runners
    T.make_r2r_world(tmp_path, n_episodes=4, rows=4, cols=4, seed=7)
    flags = dict(enable_summarize=True, mode="test")
    got, _, _ = _stream(trunner, True, tmp_path, "val.json", "R2R", 4,
                        **flags)
    want, _, ds = _stream(jrunner, False, tmp_path, "val.json", "R2R", 4,
                          **flags)
    assert got == want and len(got) == 4
    items = {x["instr_id"]: x["instruction"] for x in ds.alldata}
    for k, p in got.items():
        assert isinstance(p["pred_answer"], str) and p["pred_answer"]
        assert p["gt_answer"] == items[k]


def test_unported_eval_paths_still_raise(runners, tmp_path):
    """The paths that once named an item of the roadmap run: the int8
    prefix cache (A9) answers every EQA episode from the vocabulary through
    cached steps; sampled evaluation with the OG flag (A7), EQA sampled at
    T = 0.01 with enable_og, answers every episode and grounds nothing (the
    OG head is REVERIE's and SOON's)."""
    _, trunner = runners
    T.make_r2r_world(tmp_path, n_episodes=2, rows=4, cols=4, seed=9)
    steps = trunner.cached_steps
    got, _, ds = _stream(trunner, True, tmp_path, "val.json", "EQA", 2,
                         prefix_cache=True, kv_int8=True)
    assert len(got) == 2 and trunner.cached_steps > steps
    assert all(p["pred_answer"] in ds.answer_vocab for p in got.values())
    calls = trunner.og_calls
    got, _, ds = _stream(trunner, True, tmp_path, "val.json", "EQA", 2,
                         do_sample=True, temperature=0.01, enable_og=True)
    assert len(got) == 2 and trunner.og_calls == calls
    assert all(p["pred_answer"] in ds.answer_vocab
               and "pred_objid" not in p for p in got.values())
    assert json.loads((tmp_path / "EQA" / "annotations" /
                       "answer_vocab.json").read_text()) == T.EQA_ANSWERS
