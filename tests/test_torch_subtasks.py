"""The fused trainer's sub-task heads (summarization, FGR2R) and FGR2R
parsing, against the JAX package.

Both sides get the same world, features and converted weights (f32), with
dropout off and the identity candidate permutation, as
tests/test_torch_train.py: one teacher batch with enable_summarize and one
with enable_fgr2r must give the same trajectories, loss (rtol 1e-4) and
every accumulated gradient leaf (testing.assert_grads_close, rtol 2e-3).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents.fused_teacher import \
    rollout_teacher_fused as j_rollout  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load  # noqa: E402
from navillm_tpu.data.feature_db import \
    SyntheticImageFeaturesDB as JFeatures  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.fused_teacher import \
    rollout_teacher_fused, rollout_dagger_fused  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import R2RAgent  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data.feature_db import \
    SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
MAX_ACTION_LEN = 5
ROWS_PER_CALL = 4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
# a coefficient off 1, so that the heads' scaling is checked
GEN_COEF = 0.7


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


@pytest.fixture(scope="module")
def models():
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pj, tcfg, tok, ttok


@pytest.fixture(scope="module")
def world_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    T.make_r2r_world(root, n_episodes=4, rows=4, cols=4, seed=2,
                     split="train")
    return root


def _cfg(root):
    return {"Feature": {"image_feat_size": 32, "angle_feat_size": 4},
            "R2R": {"DIR": "R2R", "SPLIT": {
                "train": "annotations/train.json"}}}


def test_fgr2r_parsing_matches_jax(world_root, tmp_path):
    """new_instructions / chunk_view become fg_instruction / fg_view as in
    JAX (ast.literal_eval for its eval), on make_r2r_world's items and on
    tests/test_subtasks.py's two-chunk item, and get_obs carries both."""
    items = [{"distance": 6.0, "scan": "scan0", "path_id": 99,
              "path": ["vp_0_0", "vp_0_1", "vp_0_2", "vp_1_2"],
              "heading": 0.0,
              "instructions": ["walk east twice then go south", "go"],
              "new_instructions": "[[['walk', 'east'], ['then', 'south']]]",
              "chunk_view": [[[1, 3], [3, 4]]]}]
    T.make_grid_connectivity(tmp_path / "connectivity", scan="scan0")
    (tmp_path / "R2R" / "annotations").mkdir(parents=True)
    (tmp_path / "R2R" / "annotations" / "train.json").write_text(
        json.dumps(items))
    for root in (world_root, tmp_path):
        ds = R2RDataset(root / "R2R" / "annotations" / "train.json",
                        WorldModel(str(root / "connectivity")), training=True)
        jds = j_load("r2r", TrainArgs(data_dir=str(root)),
                     ConfigDict(_cfg(root)), training=True, source="R2R",
                     world=JWorld(str(root / "connectivity")))
        assert ds.alldata == jds.alldata
        assert "fg_instruction" in ds.alldata[0]
        ds.init_feat_db(SyntheticImageFeaturesDB(32))
        jds.init_feat_db(JFeatures(32))
        for k in range(len(ds)):
            ob, job = ds[k]["observations"], jds[k]["observations"]
            assert ob.get("fg_instruction") == job.get("fg_instruction")
            assert ob.get("fg_view") == job.get("fg_view")
    # the first instruction has its chunks, the second (none listed) keeps
    # the raw fields, as in JAX
    assert ds.alldata[0]["fg_instruction"] == ["walk east", "then south"]
    assert ds.alldata[0]["fg_view"] == [0, 0, 1]
    assert "fg_instruction" not in ds.alldata[1]
    assert "new_instructions" in ds.alldata[1]


def _jax_batch(models, root, **flags):
    jcfg, pj, _, tok, _ = models
    runner = JRunner(jcfg, jax.tree.map(jax.numpy.copy, pj), tok,
                     dims=JDims.tiny(), feat_dropout=0.0)
    args = TrainArgs(data_dir=str(root), seed=0, image_feat_size=32,
                     fused_rows_per_call=ROWS_PER_CALL,
                     gen_loss_coef=GEN_COEF, **flags)
    world = JWorld(str(root / "connectivity"))
    ds = j_load("r2r", args, ConfigDict(_cfg(root)), training=True,
                source="R2R", world=world)
    ds.init_feat_db(JFeatures(32))
    agent = j_load_agent("r2r", args, world, runner)
    agent.np_rng = _IdentityRng()
    runner.zero_grads()
    loss, traj = j_rollout(
        agent, args, "R2R", ConfigDict({"train_max_action_len": {
            "R2R": MAX_ACTION_LEN}}), next(iter(JLoader(ds, 2, False))),
        dataset=ds, train_ml=1.0)
    return float(loss), [t["path"] for t in traj], flatten_tree(
        jax.tree.map(np.asarray, runner.take_grads()))


def _port_batch(models, root, dagger=False, **flags):
    _, pj, tcfg, _, ttok = models
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    runner = NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny(),
                            feat_dropout=0.0)
    args = TCFG.TrainArgs(seed=0, image_feat_size=32, device="cpu",
                          fused_rows_per_call=ROWS_PER_CALL,
                          gen_loss_coef=GEN_COEF, **flags)
    world = WorldModel(str(root / "connectivity"))
    ds = R2RDataset(root / "R2R" / "annotations" / "train.json", world,
                    training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(32))
    agent = R2RAgent(args, world, runner)
    agent.np_rng = _IdentityRng()
    runner.zero_grads()
    rollout = rollout_dagger_fused if dagger else rollout_teacher_fused
    loss, traj = rollout(agent, args, "R2R",
                         T.train_config(MAX_ACTION_LEN).Optim,
                         next(iter(Dataloader(ds, 2, False))), dataset=ds,
                         train_ml=1.0)
    return (float(loss), [t["path"] for t in traj], grads_to_numpy(model),
            runner)


@pytest.mark.parametrize("flag", ["enable_summarize", "enable_fgr2r"])
def test_fused_teacher_head_matches_jax(models, world_root, flag):
    jloss, jtraj, jgrads = _jax_batch(models, world_root, **{flag: True})
    loss, traj, grads, runner = _port_batch(models, world_root,
                                            **{flag: True})
    base, _, base_grads, base_runner = _port_batch(models, world_root)
    assert traj == jtraj and max(len(t) for t in traj) > 2
    # summarization: one call at the final step; FGR2R: one per step
    # before the last on which the first episode walks
    heads = runner.gen_grad_calls
    assert heads == 1 if flag == "enable_summarize" else heads > 1
    assert runner.grad_calls == base_runner.grad_calls + heads
    assert loss > base                       # the head's loss came in
    np.testing.assert_allclose(loss, jloss, rtol=1e-4, atol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    T.assert_grads_close(grads, jgrads, GRAD_RTOL, GRAD_ATOL)
    # the head trains the LM head and the generation-only path (vp_pos,
    # token type 0), which navigation alone does not move the same way
    assert np.abs(grads["llm.lm_head"]).max() > 0
    assert not np.allclose(grads["llm.lm_head"], base_grads["llm.lm_head"])


def test_dagger_half_accepts_the_head_flags_and_runs_no_head(models,
                                                             world_root):
    """The sampled half runs neither generation head (JAX
    fused_teacher.py:1171-1175) but takes the flags; on R2R batches the OG
    flag runs no head either (it is REVERIE's and SOON's), under either
    feedback, and leaves the loss as it was."""
    loss, _, _, runner = _port_batch(models, world_root, dagger=True,
                                     enable_summarize=True,
                                     enable_fgr2r=True)
    assert np.isfinite(loss) and runner.gen_grad_calls == 0
    for dagger in (False, True):
        og, _, _, og_runner = _port_batch(models, world_root, dagger=dagger,
                                          enable_og=True)
        base, _, _, _ = _port_batch(models, world_root, dagger=dagger)
        assert og_runner.og_grad_calls == 0 and og == base
