"""The port's CVDN paths against the JAX package: greedy streaming
evaluation (val_max_action_len 30, uncached and prefix-cached; the
trajectories, every step's logits and the scores), and the fused
trainer's teacher batch (loss and every gradient leaf), where neither the
object-grounding nor the summarization head runs on CVDN.

Both sides read testing.make_r2r_world's dialogs (60-150 words, cut to 128
by the dataset) on a 6x6 grid with synthetic features, under dims that
hold 30 steps and every node of the grid (max_cands = max_gmap_nodes - 1),
with converted f32 weights, dropout off and the identity candidate
permutation. Trajectories are identical; step logits agree to rtol 1e-4,
atol 1e-4 (the prefix cache's test), losses to rtol 1e-4 and gradients
under testing.assert_grads_close at rtol 2e-3 (tests/test_torch_train.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
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
from navillm_tpu_torch.agents import fused_teacher as FT  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.feature_db import \
    SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
FEAT = 32
ROWS, COLS = 6, 6
VAL_LEN, TRAIN_LEN = 30, 15
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
# every node of the 6x6 grid and the stop node fit; 31 history slots hold
# the 30 steps of a CVDN evaluation
DIMS = dict(max_gmap_nodes=48, max_views=40, max_cands=47, max_hist=31,
            max_objects=8, max_prefix=512)


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvdn")
    T.make_r2r_world(root, n_episodes=4, rows=ROWS, cols=COLS, seed=5,
                     split="train")
    T.make_r2r_world(root, n_episodes=6, rows=ROWS, cols=COLS, seed=6,
                     split="val")
    return root


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


def _decisive(models):
    """The weights with decisive navigation logits (a wide out_head) and a
    stop logit that lets evaluation episodes run from one step to the
    30-step cap."""
    jcfg, pj, tcfg, tok, ttok = models
    head = {"w": pj["out_head"]["w"] * 30.0,
            "b": pj["out_head"]["b"].at[0].set(50.0)}
    return jcfg, {**pj, "out_head": head}, tcfg, tok, ttok


def _runners(models):
    jcfg, pj, tcfg, tok, ttok = models
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok, dims=JDims(**DIMS),
                 feat_dropout=0.0)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    tr = NavModelRunner(tcfg, model, ttok, dims=RolloutDims(**DIMS),
                        feat_dropout=0.0)
    return jr, tr


def _config():
    return {"Feature": {"image_feat_size": FEAT, "angle_feat_size": 4},
            "CVDN": {"DIR": "CVDN", "SPLIT": {
                "train": "annotations/train.json",
                "val_unseen": "annotations/val.json"}},
            "Multi": {"SOURCE": ["CVDN"], "Ratio": [1], "LOSS_COEF": {}},
            "Optim": {"val_max_action_len": {"CVDN": VAL_LEN},
                      "train_max_action_len": {"CVDN": TRAIN_LEN}}}


def _side(port, root, training, **flags):
    kw = dict(data_dir=str(root), val_batch_size=2, seed=0,
              image_feat_size=FEAT, **{"fused_rows_per_call": 8, **flags})
    if port:
        args, cfg = TCFG.TrainArgs(device="cpu", **kw), \
            TCFG.ConfigDict(_config())
        world = WorldModel(str(root / "connectivity"))
        ds = load_dataset("cvdn", args, cfg, training=training,
                          source="CVDN", world=world)
        ds.init_feat_db(SyntheticImageFeaturesDB(FEAT))
    else:
        args, cfg = TrainArgs(**kw), ConfigDict(_config())
        world = JWorld(str(root / "connectivity"))
        ds = j_load("cvdn", args, cfg, training=training, source="CVDN",
                    world=world)
        ds.init_feat_db(JFeatures(FEAT))
    return args, cfg, world, ds


def _stream(port, runner, root, prefix_cache):
    """validate_streaming on one package, each step's logits recorded:
    ({instr_id: prediction}, scores, dataset, [step logits of the active
    rows])."""
    args, cfg, world, ds = _side(port, root, False,
                                 prefix_cache=prefix_cache)
    logits = []
    name = "eval_step_cached" if prefix_cache else "eval_step"
    step = getattr(runner, name)

    def recording(*a, **kw):
        out = step(*a, **kw)
        active = np.asarray(a[7 if prefix_cache else 6])
        logits.append(np.asarray(out[-1], np.float32)[active])
        return out
    setattr(runner, name, recording)
    agent = (load_agent if port else j_load_agent)("cvdn", args, world,
                                                   runner)
    preds = agent.validate_streaming(
        "CVDN", args, cfg, (Dataloader if port else JLoader)(ds, 2, False),
        dataset=ds)
    scores, _ = ds.eval_metrics(preds, None, "CVDN")
    return {p["instr_id"]: p for p in preds}, scores, ds, logits


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["uncached", "cached"])
def test_streaming_cvdn_matches_jax(models, world, prefix_cache):
    """Six dialogs in two slot groups of 2, up to 30 steps: the
    trajectories (starting at each start panorama), every step's logits
    and the scores are JAX's; episodes end at mixed steps, one at the cap
    or with no node left."""
    jr, tr = _runners(_decisive(models))
    got, scores, ds, logits = _stream(True, tr, world, prefix_cache)
    want, jscores, _, jlogits = _stream(False, jr, world, prefix_cache)
    assert got.keys() == want.keys() and len(got) == len(ds) == 6
    for k, p in want.items():
        assert got[k]["trajectory"] == p["trajectory"], k
        start = ds.gt_trajs[k]["start_pano"]["pano"]
        assert got[k]["trajectory"][0][0] == start
    steps = sorted(len(p["trajectory"]) for p in got.values())
    assert len(set(steps)) > 1 and steps[-1] > TRAIN_LEN, steps
    assert len(logits) == len(jlogits)
    for g, w in zip(logits, jlogits):
        np.testing.assert_allclose(g, w, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for k in jscores:
        assert scores[k] == pytest.approx(jscores[k], rel=1e-9), k
    if prefix_cache:
        assert tr.cached_steps and not tr.eval_steps
    else:
        assert tr.eval_steps and not tr.cached_steps
    # the dialogs are the longest prompts of any task: the cut to 128 words
    # holds them inside the prefix capacity
    assert max(len(x["instruction"].split()) for x in ds.alldata) == 128


def _train(port, models, world, **flags):
    jr, tr = _runners(models)
    runner = tr if port else jr
    args, cfg, w, ds = _side(port, world, True, **flags)
    agent = (load_agent if port else j_load_agent)("cvdn", args, w, runner)
    agent.np_rng = _IdentityRng()
    np.random.seed(11)
    batch = list((Dataloader if port else JLoader)(ds, 4, False))[0]
    fn = (FT if port else JFT).rollout_teacher_fused
    runner.zero_grads()
    loss, traj = fn(agent, args, "CVDN", cfg.Optim, batch, dataset=ds,
                    train_ml=1.0)
    if port:
        grads = grads_to_numpy(tr.model)
    else:
        grads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))
    return float(loss), grads, [t["path"] for t in traj], runner


def test_fused_teacher_cvdn_matches_jax(models, world):
    """A teacher batch of 4 dialogs (train_max_action_len 15) with
    --enable_og --enable_summarize: the trajectories follow the trusted
    paths, and the loss and every gradient leaf are JAX's; neither head
    runs on CVDN, so the loss is the one without the flags."""
    flags = dict(enable_og=True, enable_summarize=True)
    loss, grads, paths, runner = _train(True, models, world, **flags)
    wloss, wgrads, wpaths, _ = _train(False, models, world, **flags)
    assert paths == wpaths
    assert loss == pytest.approx(wloss, rel=LOSS_REL)
    assert sorted(grads) == sorted(wgrads)
    T.assert_grads_close(grads, wgrads, GRAD_RTOL, GRAD_ATOL)
    assert np.abs(grads["llm.layers.wq"]).sum() > 0
    assert runner.gen_grad_calls == runner.og_grad_calls == 0
    assert runner.grad_calls > 0
    base = _train(True, models, world)
    assert base[0] == loss and base[2] == paths
