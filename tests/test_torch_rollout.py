"""The slice end to end: the port's greedy R2R streaming evaluation vs the
JAX package's, on the same world, features and converted weights.

Both run validate_streaming with device memory, no prefix cache, argmax
actions and two slot groups, so refills and the pipeline's order are
exercised. They must give identical trajectories and identical SR/SPL.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from navillm_tpu.agents import load_agent  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset  # noqa: E402
from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu.data.loaders import Dataloader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models import quant as JQ  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu.sim import WorldModel  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import EvalArgs, R2RAgent  # noqa
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims  # noqa
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402

torch.set_num_threads(1)
STOP_BIAS = -0.8


def _make_runners(bits=16, act_int8=False, stop_bias=STOP_BIAS):
    tok = NavTokenizer(max_length=2048, pad_to_multiple=128)
    jcfg = JNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    # a stop bias, so that the random policy walks a few steps (episodes
    # end at mixed lengths, and slots refill at different times)
    pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(stop_bias)
    if bits != 16:
        pj = dict(pj, llm=JQ._quantize_llama_impl(pj["llm"], bits))
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
            jcfg.llm, act_int8=act_int8))
        tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(
            tcfg.llm, act_int8=act_int8))
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                                   device="cpu"))
    return (JRunner(jcfg, pj, tok, dims=JDims.tiny()),
            NavModelRunner(tcfg, model, tok, dims=RolloutDims.tiny()))


@pytest.fixture(scope="module")
def runners():
    return _make_runners()


def _both(runners, data_root, split_file, max_action_len, n_slots):
    """(JAX, port) -> ({instr_id: trajectory}, metrics) each."""
    jrunner, trunner = runners
    feat = jrunner.cfg.pano.image_feat_size
    tcfg = ConfigDict({
        "Feature": {"image_feat_size": feat, "angle_feat_size": 4},
        "R2R": {"DIR": "R2R", "SPLIT": {"val_unseen": split_file}}})
    optim = {"Optim": {"val_max_action_len": {"R2R": max_action_len}}}
    args = TrainArgs(data_dir=str(data_root), val_batch_size=n_slots, seed=0)
    args.image_feat_size = feat
    jworld = WorldModel(str(data_root / "connectivity"))
    jds = load_dataset("r2r", args, tcfg, training=False, source="R2R",
                       world=jworld)
    jds.init_feat_db(SyntheticImageFeaturesDB(feat))
    jpreds = load_agent("r2r", args, jworld, jrunner).validate_streaming(
        "R2R", args, ConfigDict(optim), Dataloader(jds, n_slots, False),
        dataset=jds)

    tworld = WorldModel(str(data_root / "connectivity"))
    tds = R2RDataset(data_root / "R2R" / split_file, tworld)
    tds.init_feat_db(SyntheticImageFeaturesDB(feat))
    targs = EvalArgs(seed=0, val_batch_size=n_slots, image_feat_size=feat)
    tpreds = R2RAgent(targs, tworld, trunner).validate_streaming(
        "R2R", targs, T.eval_config(max_action_len),
        Dataloader(tds, n_slots, False), dataset=tds)

    return [({p["instr_id"]: p["trajectory"] for p in preds},
             ds.eval_metrics(preds, None, "R2R")[0])
            for preds, ds in ((jpreds, jds), (tpreds, tds))]


def test_slice_matches_jax_on_fixture_world(runners, data_dir):
    (jt, jm), (tt, tm) = _both(runners, data_dir,
                               "annotations/R2R_val_unseen_enc.json", 5, 2)
    assert len(tt) == 4
    assert tt == jt
    assert tm == jm


def test_slice_matches_jax_with_refills(runners, tmp_path):
    """More episodes than slots in a grid world written by the port's
    make_r2r_world: every slot is refilled mid-run."""
    T.make_r2r_world(tmp_path, n_episodes=10, rows=4, cols=4, seed=3)
    (jt, jm), (tt, tm) = _both(runners, tmp_path, "annotations/val.json",
                               6, 2)
    assert len(tt) == 10
    assert len({len(t) for t in tt.values()}) > 1     # mixed lengths
    assert tt == jt
    assert tm == jm
    assert all(np.isfinite(tm[k]) for k in ("sr", "spl"))


@pytest.mark.parametrize("act_int8", [False, True], ids=["w4", "w4a8"])
def test_int4_slice_matches_jax(act_int8, tmp_path):
    """The int4 slice: the JAX int4 tree (bits=4) in both packages, w4 and
    w4a8, with refills. Both run the same function on the same bytes, so
    trajectories and SR/SPL are identical (the JAX package's own int4
    test only asks for 60% agreement with the dense policy)."""
    T.make_r2r_world(tmp_path, n_episodes=6, rows=4, cols=4, seed=5)
    # no stop bias: the int4 policy then stops at mixed steps
    (jt, jm), (tt, tm) = _both(_make_runners(4, act_int8, stop_bias=0.0),
                               tmp_path, "annotations/val.json", 5, 2)
    assert len(tt) == 6
    assert len({len(t) for t in tt.values()}) > 1     # mixed lengths
    assert tt == jt
    assert tm == jm
    assert all(np.isfinite(tm[k]) for k in ("sr", "spl"))
