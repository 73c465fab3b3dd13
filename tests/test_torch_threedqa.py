"""The port's 3D-QA and instruction-tuning paths against the JAX package:
LLaVAAgent.train and ScanQAAgent.train (the answer loss and every
gradient leaf, the panorama encoder's included), ScanQAAgent.validate's
generated answers (greedy, no trie) and the runner's host panorama.

Both sides read the same annotations (testing.make_r2r_world's ScanQA
questions of 40-48 frames and LLaVA conversations) through the same
synthetic frame stores, with converted f32 weights and dropout off.
ScanQA draws its 36 frames from Python's global random, so each side's
loader runs after the same random.seed. Losses agree to rtol 1e-4 and
gradients under testing.assert_grads_close at rtol 2e-3
(tests/test_torch_train.py); generated tokens are
identical, on JAX logits whose top-2 margin exceeds 1e-3 at every compared
pick (tests/test_torch_generation.py).
"""
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load  # noqa: E402
from navillm_tpu.data.feature_db import \
    SyntheticImageFeaturesDB as JFeatures  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.eval.captioning import Meteor  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
FEAT = 32
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
MIN_MARGIN = 1e-3
QA_COEF = 0.6
TASKS = {"ScanQA": ("scanqa", "scan_qa"), "LLaVA": ("llava", "coco")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("threedqa")
    T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=3,
                     split="train")
    T.make_r2r_world(root, n_episodes=5, rows=4, cols=4, seed=4, split="val")
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


def _runners(models):
    jcfg, pj, tcfg, tok, ttok = models
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok, dims=JDims.tiny(),
                 feat_dropout=0.0)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    tr = NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny(),
                        feat_dropout=0.0)
    return jr, tr


def _config(task):
    splits = {"train": "annotations/train.json"}
    if task == "ScanQA":
        splits["val_unseen"] = "annotations/val.json"
    return {"Feature": {"image_feat_size": FEAT, "angle_feat_size": 4},
            task: {"DIR": task, "SPLIT": splits},
            "Multi": {"SOURCE": [task], "Ratio": [1],
                      "LOSS_COEF": {task: QA_COEF}}}


def _side(port, root, task, training, **flags):
    """(args, cfg, dataset with its frame store) of one package."""
    kw = dict(data_dir=str(root), val_batch_size=2, seed=0,
              image_feat_size=FEAT, gradient_accumulation_step=2, **flags)
    name, key = TASKS[task]
    if port:
        args, cfg = TCFG.TrainArgs(device="cpu", **kw), \
            TCFG.ConfigDict(_config(task))
        ds = load_dataset(name, args, cfg, training=training, source=task)
        ds.init_feat_db(T.feature_dbs(FEAT)[key])
    else:
        args, cfg = TrainArgs(**kw), ConfigDict(_config(task))
        ds = j_load(name, args, cfg, training=training, source=task)
        ds.init_feat_db(JFeatures(FEAT, num_views=1))
    return args, cfg, ds


def _batch(port, ds, b, index=0):
    random.seed(7)
    return list((Dataloader if port else JLoader)(ds, b, False))[index]


def _train(port, models, root, task):
    jr, tr = _runners(models)
    runner = tr if port else jr
    args, cfg, ds = _side(port, root, task, True)
    agent = (load_agent if port else j_load_agent)(TASKS[task][0], args,
                                                   None, runner)
    batch = _batch(port, ds, 3)
    runner.zero_grads()
    loss = agent.train(task, batch, args, cfg, dataset=ds)
    if port:
        grads = grads_to_numpy(tr.model)
        assert torch.is_tensor(loss) and runner.gen_grad_calls == 1
    else:
        grads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))
    return float(loss), grads, batch


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_loss_and_grads_match_jax(models, world, task):
    """A batch of 3 (ScanQA: 36 frames each, drawn from the global random
    in JAX's order; LLaVA: one COCO frame): the answer loss, scaled by
    LOSS_COEF, and every gradient leaf, the panorama encoder's included."""
    loss, grads, batch = _train(True, models, world, task)
    wloss, wgrads, wbatch = _train(False, models, world, task)
    for g, w in zip(batch["features"], wbatch["features"]):
        np.testing.assert_array_equal(g, w)
    frames = {f.shape[0] for f in batch["features"]}
    assert frames == ({36} if task == "ScanQA" else {1})
    assert np.isfinite(loss) and loss > 0
    assert loss == pytest.approx(wloss, rel=LOSS_REL)
    assert sorted(grads) == sorted(wgrads)
    T.assert_grads_close(grads, wgrads, GRAD_RTOL, GRAD_ATOL)
    for name in ("pano.img_linear.w", "token_type_emb", "llm.layers.wq"):
        assert np.abs(grads[name]).sum() > 0, name


def _jax_margins(jl, jcfg, ids, mask, inj_pos, inj_emb, out, smask,
                 eos_id, pad_id, bucket=64):
    """The JAX logits behind every pick of ``out`` up to each row's eos,
    from one teacher-forced forward over the bucketed prompt and the picks
    (the special-token mask applied): their top-2 margins."""
    b, t = ids.shape
    extra = -t % bucket
    n = out.shape[1]
    full_ids = np.concatenate([np.pad(ids, ((0, 0), (extra, 0)),
                                      constant_values=pad_id), out], 1)
    full_mask = np.concatenate([np.pad(mask, ((0, 0), (extra, 0))),
                                np.ones((b, n), bool)], 1)
    pos = np.where(inj_pos >= 0, inj_pos + extra, -1)
    x = JL.embed_with_injection(jl, full_ids, pos, inj_emb)
    h, _ = JL.forward_hidden(jl, jcfg, x, full_mask)
    logits = np.asarray(JL.logits_from_hidden(jl, jcfg, h, smask))
    margins = []
    for k in range(n):
        top = np.sort(logits[:, t + extra - 1 + k], -1)[:, -2:]
        for i in range(b):
            if eos_id not in out[i, :k]:
                margins.append(top[i, 1] - top[i, 0])
    return np.asarray(margins)


def test_scanqa_validate_matches_jax(models, world, tmp_path):
    """ScanQAAgent.validate over 5 questions in batches of 2: each
    generate call's inputs (36 frames' fused embeds at the <cand> tokens,
    one zero history embed) and its 20 greedy tokens equal JAX's, the
    answers and the scores too; save_json writes the leaderboard's
    format."""
    jr, tr = _runners(models)
    calls = {"jax": [], "port": []}
    for key, runner in (("jax", jr), ("port", tr)):
        gen = runner.generate

        def recording(*a, _gen=gen, _key=key, **kw):
            out = _gen(*a, **kw)
            calls[_key].append((a, kw, np.asarray(out)))
            return out
        runner.generate = recording
    args, cfg, ds = _side(True, world, "ScanQA", False)
    jargs, jcfg, jds = _side(False, world, "ScanQA", False)
    random.seed(9)
    preds = load_agent("scanqa", args, None, tr).validate(
        "ScanQA", args, cfg, Dataloader(ds, 2, False), dataset=ds)
    random.seed(9)
    want = j_load_agent("scanqa", jargs, None, jr).validate(
        "ScanQA", jargs, jcfg, JLoader(jds, 2, False), dataset=jds)
    assert preds == want and len(preds) == len(ds) == 5
    assert all(isinstance(p["generated_sentences"][0], str) for p in preds)
    assert len(calls["port"]) == len(calls["jax"]) == 3 == tr.generate_calls
    smask = jr._special_mask
    for (a, kw, out), (ja, jkw, jout) in zip(calls["port"], calls["jax"]):
        assert kw == jkw and kw["max_new_tokens"] == 20
        for got, exp in zip(a, ja):
            np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(out, jout)
        margins = _jax_margins(jr.params["llm"], jr.cfg.llm, *ja, jout,
                               smask, jr.tok.eos_id, jr.tok.pad_id)
        assert margins.size and margins.min() > MIN_MARGIN, margins.min()
    scores, per = ds.eval_metrics(preds, None, "ScanQA")
    jscores, jper = jds.eval_metrics(want, None, "ScanQA")
    assert scores == jscores and per == jper
    assert {"bleu-4", "rouge", "cider", "exact_match"} <= set(scores)
    assert ("meteor" in scores) == Meteor().available()
    ds.save_json(preds, tmp_path / "scanqa.json")
    out = json.loads((tmp_path / "scanqa.json").read_text())
    assert out[0]["answer_top10"] and out[0]["pred_bbox"] == []


def test_runner_panorama_matches_jax(models):
    """runner.panorama: the host outputs of the 3D-QA batch (ragged
    view_lens, zero loc_fts, nav_types 1) through PANO_KEYS as given."""
    jr, tr = _runners(models)
    r = np.random.RandomState(1)
    pano_in = {"view_img_fts": r.randn(3, 7, FEAT).astype(np.float32),
               "view_lens": np.array([7, 3, 1], np.int32),
               "loc_fts": np.zeros((3, 7, 7), np.float32),
               "nav_types": np.ones((3, 7), np.int32)}
    got = tr.panorama(pano_in, deterministic=True)
    want = jr.panorama(pano_in, deterministic=True)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["pano_masks"].sum(1), [7, 3, 1])
