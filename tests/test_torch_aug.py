"""The augmented R2R and REVERIE sets and the whole task mix against the JAX
package: the default decoder (bert-base-uncased from an offline Hugging
Face cache, testing.write_bert_cache) against JAX's, and its refusal
without a cache, the fused teacher on R2R_AUG and REVERIE_AUG batches
(summarization runs on both, object grounding on neither; R2R_AUG also
through the default decoder), and run_training at stage multi over
configs/multi.yaml's six sources and at stage pretrain over its seven,
with --enable_og --enable_summarize --enable_fgr2r, the per-batch losses
against JAX's.

Both sides read testing.make_r2r_world's annotations (the augmented sets'
.jsonl token ids through testing.aug_decoder) with synthetic features and
objects, converted f32 weights, dropout off; the fused trainer's candidate
permutation is the identity where a test calls it, and each side's run
starts from the same seed of Python's global random, from which ScanQA
draws its frames. Losses agree to rtol 1e-4 and gradients under
testing.assert_grads_close at rtol 2e-3 (tests/test_torch_train.py).
"""
import json
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
from navillm_tpu.agents import llava_agent as JLA  # noqa: E402
from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents import mp3d_agent as JMA  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data import feature_db as JFDB  # noqa: E402
from navillm_tpu.data.datasets import aug as JA  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.training import train_loop as JTL  # noqa: E402
from navillm_tpu.utils import config as JCFG  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import fused_teacher as FT  # noqa: E402
from navillm_tpu_torch.agents import llava_agent as PLA  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents import mp3d_agent as PMA  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data import aug as PA  # noqa: E402
from navillm_tpu_torch.data import feature_db as FDB  # noqa: E402
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
FEAT, OBJ_FEAT, N_OBJECTS = 32, 16, 4
MAX_ACTION_LEN = 4
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
MULTI = ["R2R", "REVERIE", "CVDN", "SOON", "ScanQA", "LLaVA"]
PRETRAIN = ["R2R_AUG", "REVERIE_AUG", "R2R", "REVERIE", "SOON", "CVDN",
            "ScanQA"]
# the MetaLoader's draws at these seeds (every task at ratio 1): stage
# multi CVDN, ScanQA, SOON, ScanQA, LLaVA, REVERIE (DAgger), R2R, REVERIE
# (DAgger), so no DAgger batch comes before step 5; stage pretrain CVDN,
# REVERIE_AUG, REVERIE, SOON, R2R_AUG, ScanQA
MULTI_SEED, PRETRAIN_SEED = 262, 175
MULTI_STEPS, PRETRAIN_STEPS = 8, 6
# stage multi's DAgger batches draw their actions from each package's own
# sampler, so the weights part after the first optimizer step that takes a
# DAgger gradient (steps 4-5): the losses before it are compared
MULTI_COMPARED = 5


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


@pytest.fixture(autouse=True)
def decoders(monkeypatch):
    """The augmented sets read their .jsonl token ids through
    testing.aug_decoder in both packages."""
    for mod in (JA, PA):
        for cls in (mod.R2RAugDataset, mod.REVERIEAugDataset):
            monkeypatch.setattr(cls, "decoder",
                                staticmethod(T.aug_decoder))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("mix")
    T.make_r2r_world(root, n_episodes=8, rows=4, cols=4, seed=7,
                     split="train")
    T.make_r2r_world(root, n_episodes=2, rows=4, cols=4, seed=8, split="val")
    return root


@pytest.fixture(scope="module")
def models():
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pj, tcfg, tok, ttok


def _runners(models, seed=0):
    jcfg, pj, tcfg, tok, ttok = models
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok, dims=JDims.tiny(),
                 feat_dropout=0.0, seed=seed)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    tr = NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny(),
                        feat_dropout=0.0, seed=seed)
    return jr, tr


def _yaml_config():
    split = {"train": "annotations/train.json",
             "val_unseen": "annotations/val.json"}
    sections = {task: {"DIR": task, "SPLIT": dict(split)}
                for task in ("R2R", "CVDN", "ScanQA")}
    sections["REVERIE"] = {"DIR": "REVERIE", "SPLIT": dict(split),
                           "bbox_file": "annotations/BBoxes.json"}
    sections["SOON"] = {"DIR": "SOON", "SPLIT": {
        k: v.replace(".json", ".jsonl") for k, v in split.items()}}
    sections["LLaVA"] = {"DIR": "LLaVA", "SPLIT": {
        "train": "annotations/train.json"}}
    sections["R2R_AUG"] = {"DIR": "R2R", "SPLIT": {
        "train": "annotations/train_aug.jsonl"}}
    sections["REVERIE_AUG"] = {"DIR": "REVERIE", "SPLIT": {
        "train": "annotations/train_aug.jsonl"},
        "bbox_file": "annotations/BBoxes.json"}
    tasks = sorted(sections)
    return {"Feature": {"image_feat_size": FEAT, "angle_feat_size": 4,
                        "obj_feat_size": OBJ_FEAT, "max_objects": N_OBJECTS},
            "Dataset": sections,
            "Pretrain": {"SOURCE": PRETRAIN, "Ratio": [1] * len(PRETRAIN),
                         "LOSS_COEF": {"R2R_AUG": 1, "REVERIE_AUG": 1}},
            "Multi": {"SOURCE": MULTI, "Ratio": [1] * len(MULTI),
                      "LOSS_COEF": {}},
            "Model": {"num_pano_layers": 2, "enc_full_graph": True,
                      "expert_policy": "spl"},
            "Optim": {"val_max_action_len": {t: MAX_ACTION_LEN
                                             for t in tasks},
                      "train_max_action_len": {t: MAX_ACTION_LEN
                                               for t in tasks}}}


def _feats(port):
    if port:
        return T.feature_dbs(FEAT), {
            s: FDB.synthetic_object_db(s, OBJ_FEAT, N_OBJECTS)
            for s in ("reverie", "soon")}
    return ({"mp3d": JFDB.SyntheticImageFeaturesDB(FEAT),
             "scan_qa": JFDB.SyntheticImageFeaturesDB(FEAT, num_views=1),
             "coco": JFDB.SyntheticImageFeaturesDB(FEAT, num_views=1)},
            {s: JFDB.synthetic_object_db(s, OBJ_FEAT, N_OBJECTS)
             for s in ("reverie", "soon")})


# ------------------------------------------------------------ datasets --- #
# the variables that name the Hugging Face cache, cleared around each test
# that reads one
CACHE_VARS = ("TRANSFORMERS_CACHE", "PYTORCH_TRANSFORMERS_CACHE",
              "PYTORCH_PRETRAINED_BERT_CACHE", "HF_HUB_CACHE",
              "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME")


def _cache_env(monkeypatch, **env):
    for k in CACHE_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def test_default_decoder_raises_naming_the_vocabulary(world, monkeypatch,
                                                      tmp_path):
    """Without an injected decoder and with no bert-base-uncased in the
    Hugging Face cache, a .jsonl augmented file cannot be read: the error
    names the cache directories it looked in and vocab.txt. A .json file
    needs no decoder."""
    _cache_env(monkeypatch, HF_HOME=tmp_path / "empty")
    cfg = TCFG.ConfigDict(_yaml_config())
    args = TCFG.TrainArgs(device="cpu", data_dir=str(world),
                          image_feat_size=FEAT)
    w = WorldModel(str(world / "connectivity"))
    hub = tmp_path / "empty" / "hub"
    for cls, name, source in ((PA.R2RAugDataset, "r2r_aug", "R2R_AUG"),
                              (PA.REVERIEAugDataset, "reverie_aug",
                               "REVERIE_AUG")):
        monkeypatch.setattr(cls, "decoder", None)
        with pytest.raises(FileNotFoundError) as err:
            load_dataset(name, args, cfg, training=True, source=source,
                         world=w)
        msg = str(err.value)
        assert "vocab.txt" in msg and str(hub) in msg and str(
            hub / "models--bert-base-uncased" / "refs" / "main") in msg
        sec = cfg.Dataset[source]
        sec.SPLIT["train"] = "annotations/train_aug.json"
        ds = load_dataset(name, args, cfg, training=True, source=source,
                          world=w)
        assert len(ds) == 8 and ds.name == name
        sec.SPLIT["train"] = "annotations/train_aug.jsonl"


# a vocabulary with what bert-base-uncased's decode treats apart: "##"
# pieces, punctuation, contractions, specials among the words
BERT_WORDS = T.AUG_WORDS + [
    ".", ",", "?", "!", "'", "n't", "'m", "'s", "'ve", "'re", "do", "not",
    "don", "t", "s", "m", "re", "ve", "ok", "gone", "it", "we", "they",
    "caf", "##\u00e9", "##s", "##ing", "##ed", "##'", "##.", "##,",
    "##n't", "[unused0]", "##"]
# (revision, write_bert_cache's keywords): a vocab.txt-only snapshot (it
# cleans up spaces, BertTokenizer's default), one with tokenizer.json (it
# does not), and each with the config saying the other
BERT_SNAPSHOTS = [
    ("vocab", {}),
    ("json", dict(tokenizer_json=True)),
    ("vocab_noclean", dict(config={"do_lower_case": True,
                                   "clean_up_tokenization_spaces": False})),
    ("json_clean", dict(tokenizer_json=True, config={
        "do_lower_case": True, "clean_up_tokenization_spaces": True}))]

JAX_DECODE = """
import json, sys
from pathlib import Path
from navillm_tpu.data.datasets import aug
out = []
for ref, rev, seqs in json.load(sys.stdin):
    Path(ref).write_text(rev)
    aug._default_decoder = None          # the module caches its decoder
    dec = aug._bert_decoder()
    out.append([dec(ids) for ids in seqs])
print(json.dumps(out))
"""


def _bert_sequences(n_vocab: int):
    words = {w: i for i, w in enumerate(T.bert_vocab(BERT_WORDS))}
    text = [
        "[CLS] walk left into the kitchen [SEP]",
        "turn right , don ' t stop . [SEP] [PAD] [PAD]",
        "it ' s the sofa ! we ' re near it ? they ' ve gone",
        "caf ##\u00e9 ##s walk ##ing walk ##ed the ##' s",
        "do not stop ##. go ##, ok ##n't m ' m",
        "##s [MASK] [UNK] stop [unused0] ##"]
    seqs = [[words[t] for t in line.split()] for line in text]
    rng = np.random.RandomState(0)
    seqs += [rng.randint(0, n_vocab + 3, rng.randint(0, 16)).tolist()
             for _ in range(300)]
    return seqs + [T.aug_encode("walk left into the kitchen and stop")]


@pytest.mark.parametrize("variable", ["HF_HOME", "HF_HUB_CACHE"])
def test_default_decoder_matches_jax(tmp_path, monkeypatch, variable):
    """bert-base-uncased's decode(ids, skip_special_tokens=True) read from
    an offline cache named by HF_HOME or by HF_HUB_CACHE: the port's
    default decoder against JAX's _bert_decoder (transformers'
    AutoTokenizer, in a fresh process given the same environment) on each
    snapshot of BERT_SNAPSHOTS in turn (refs/main moved to it)."""
    import os
    import subprocess
    import sys
    home = tmp_path / "hf"
    for rev, kw in BERT_SNAPSHOTS:
        hub = T.write_bert_cache(home, words=BERT_WORDS, revision=rev, **kw)
    ref = hub / "models--bert-base-uncased" / "refs" / "main"
    seqs = _bert_sequences(len(T.bert_vocab(BERT_WORDS)))
    env = {variable: home if variable == "HF_HOME" else hub}
    _cache_env(monkeypatch, **env)
    monkeypatch.setattr(PA.R2RAugDataset, "decoder", None)
    got = []
    for rev, _ in BERT_SNAPSHOTS:
        ref.write_text(rev)
        dec = PA._default_decoder()
        got.append([dec(ids) for ids in seqs])
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", JAX_DECODE],
        input=json.dumps([(str(ref), rev, seqs) for rev, _ in
                          BERT_SNAPSHOTS]),
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    for (rev, _), g, w in zip(BERT_SNAPSHOTS, got, want):
        for ids, a, b in zip(seqs, g, w):
            assert a == b, (rev, ids)
    assert got[0][0] == "walk left into the kitchen"
    assert got[0][1] == "turn right, don't stop."
    assert got[1][1] == "turn right, don ' t stop."
    assert got[0][-1] == T.aug_decoder(seqs[-1])


def test_default_decoder_reads_the_jsonl_sets(world, monkeypatch, tmp_path):
    """Over write_bert_cache's vocabulary (AUG_WORDS at AUG_ID0 + k) the
    default decoder gives the instructions testing.aug_decoder gives."""
    T.write_bert_cache(tmp_path / "hf")
    _cache_env(monkeypatch, HF_HOME=tmp_path / "hf")
    cfg = TCFG.ConfigDict(_yaml_config())
    args = TCFG.TrainArgs(device="cpu", data_dir=str(world),
                          image_feat_size=FEAT)
    w = WorldModel(str(world / "connectivity"))
    for cls, name, source in ((PA.R2RAugDataset, "r2r_aug", "R2R_AUG"),
                              (PA.REVERIEAugDataset, "reverie_aug",
                               "REVERIE_AUG")):
        want = load_dataset(name, args, cfg, training=True, source=source,
                            world=w)
        monkeypatch.setattr(cls, "decoder", None)
        got = load_dataset(name, args, cfg, training=True, source=source,
                           world=w)
        assert [x["instruction"] for x in got.alldata] == \
            [x["instruction"] for x in want.alldata]
        assert len(got.alldata) == 8


# ------------------------------------------------------ fused teacher --- #
def _teacher(port, models, world, task):
    jr, tr = _runners(models)
    runner = tr if port else jr
    kw = dict(data_dir=str(world), seed=0, image_feat_size=FEAT,
              obj_feat_size=OBJ_FEAT, fused_rows_per_call=4, enable_og=True,
              enable_summarize=True)
    name = task.lower()
    feats, objs = _feats(port)
    if port:
        args, cfg = TCFG.TrainArgs(device="cpu", **kw), \
            TCFG.ConfigDict(_yaml_config())
        w = WorldModel(str(world / "connectivity"))
        ds = load_dataset(name, args, cfg, training=True, source=task,
                          world=w)
    else:
        args, cfg = JCFG.TrainArgs(**kw), JCFG.ConfigDict(_yaml_config())
        w = JWorld(str(world / "connectivity"))
        ds = j_load(name, args, cfg, training=True, source=task, world=w)
    ds.init_feat_db(feats["mp3d"],
                    objs["reverie"] if task == "REVERIE_AUG" else None)
    agent = (load_agent if port else j_load_agent)(name, args, w, runner)
    agent.np_rng = _IdentityRng()
    np.random.seed(11)
    batch = list((Dataloader if port else JLoader)(ds, 4, False))[0]
    runner.zero_grads()
    loss, traj = (FT if port else JFT).rollout_teacher_fused(
        agent, args, task, cfg.Optim, batch, dataset=ds, train_ml=1.0)
    if port:
        grads = grads_to_numpy(tr.model)
    else:
        grads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))
    return float(loss), grads, [t["path"] for t in traj], runner


def test_fused_teacher_default_decoder(models, world, monkeypatch,
                                      tmp_path):
    """A teacher batch of 4 R2R_AUG episodes read from .jsonl through the
    default decoder (write_bert_cache's offline cache) equals the batch
    with testing.aug_decoder injected: trajectories, loss and gradients
    bit for bit."""
    want = _teacher(True, models, world, "R2R_AUG")
    T.write_bert_cache(tmp_path / "hf")
    _cache_env(monkeypatch, HF_HOME=tmp_path / "hf")
    monkeypatch.setattr(PA.R2RAugDataset, "decoder", None)
    got = _teacher(True, models, world, "R2R_AUG")
    assert got[2] == want[2] and got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for name, g in want[1].items():
        np.testing.assert_array_equal(got[1][name], g, err_msg=name)


@pytest.mark.parametrize("task", ["R2R_AUG", "REVERIE_AUG"])
def test_fused_teacher_aug_matches_jax(models, world, task):
    """A teacher batch of 4 augmented episodes with --enable_og
    --enable_summarize: the trajectories, loss and every gradient leaf are
    JAX's; the summarization head runs (one call), the OG head does not
    (the augmented REVERIE set has no target object)."""
    loss, grads, paths, runner = _teacher(True, models, world, task)
    wloss, wgrads, wpaths, _ = _teacher(False, models, world, task)
    assert paths == wpaths
    assert loss == pytest.approx(wloss, rel=LOSS_REL)
    assert sorted(grads) == sorted(wgrads)
    T.assert_grads_close(grads, wgrads, GRAD_RTOL, GRAD_ATOL)
    assert runner.gen_grad_calls == 1 and runner.og_grad_calls == 0


# ------------------------------------------------------- run_training --- #
def _record_losses(monkeypatch, classes, out):
    """Wrap each agent class's train to record (task, loss)."""
    for cls in classes:
        orig = cls.train

        def train(self, name, *a, _orig=orig, **kw):
            loss = _orig(self, name, *a, **kw)
            out.append((name, float(loss)))
            return loss
        monkeypatch.setattr(cls, "train", train)


def _run(port, models, world, tmp_path, stage, seed, steps, monkeypatch):
    jr, tr = _runners(models, seed=seed)
    losses = []
    kw = dict(data_dir=str(world), output_dir=str(tmp_path / stage),
              stage=stage, num_epochs=1, num_steps_per_epoch=steps,
              gradient_accumulation_step=2, batch_size=2, val_batch_size=2,
              image_feat_size=FEAT, obj_feat_size=OBJ_FEAT, lr=1e-3,
              feat_dropout=0.0, fused_rows_per_call=4, seed=seed,
              enable_og=True, enable_summarize=True, enable_fgr2r=True,
              max_saved_checkpoints=0, save_ckpt_per_epochs=100,
              test_datasets=["CVDN", "ScanQA"])
    feats, objs = _feats(port)
    # ScanQA draws its frames from Python's global random
    random.seed(seed)
    if port:
        _record_losses(monkeypatch, (PMA.R2RAgent, PLA.LLaVAAgent), losses)
        args = TCFG.TrainArgs(device="cpu", **kw)
        cfg = TCFG.ConfigDict(_yaml_config())
        res = TTL.run_training(args, cfg, world=WorldModel(
            str(world / "connectivity")), feat_dbs=feats, obj_feat_dbs=objs,
            runner=tr)
        runner = tr
    else:
        _record_losses(monkeypatch, (JMA.MP3DAgent, JLA.LLaVAAgent), losses)
        args = JCFG.TrainArgs(**kw)
        cfg = JCFG.ConfigDict(_yaml_config())
        res = JTL.run_training(args, cfg, world=JWorld(
            str(world / "connectivity")), feat_dbs=feats, obj_feat_dbs=objs,
            runner=jr)
        runner = jr
    return losses, res, runner


@pytest.mark.parametrize("stage,seed,steps,compared", [
    ("multi", MULTI_SEED, MULTI_STEPS, MULTI_COMPARED),
    ("pretrain", PRETRAIN_SEED, PRETRAIN_STEPS, PRETRAIN_STEPS)])
def test_run_training_task_mix_matches_jax(models, world, tmp_path, stage,
                                           seed, steps, compared,
                                           monkeypatch):
    """One epoch of run_training over the stage's sources of
    configs/multi.yaml (stage multi: teacher and DAgger batches of the six
    tasks, the 3D-QA ones through LLaVAAgent.train; stage pretrain: the
    augmented sets' .jsonl files too) with the recipe's three heads, then
    validation of CVDN (streaming) and ScanQA (its agent's validate): the
    same tasks in the same order, the losses of the batches before any
    DAgger gradient reaches the weights equal to JAX's, every loss finite,
    every validated task scored."""
    got, res, runner = _run(True, models, world, tmp_path, stage, seed,
                            steps, monkeypatch)
    want, jres, _ = _run(False, models, world, tmp_path, stage, seed, steps,
                         monkeypatch)
    tasks = [n for n, _ in got]
    assert tasks == [n for n, _ in want] and len(tasks) == steps
    assert set(tasks) >= ({"ScanQA", "CVDN"} | (
        {"LLaVA", "R2R", "REVERIE", "SOON"} if stage == "multi"
        else {"R2R_AUG", "REVERIE_AUG"}))
    for (name, loss), (_, wloss) in zip(got[:compared], want[:compared]):
        assert loss == pytest.approx(wloss, rel=LOSS_REL), name
    assert all(np.isfinite(x) and x > 0 for _, x in got)
    assert sorted(res) == sorted(jres) == ["CVDN", "ScanQA"]
    for task in res:
        assert res[task].keys() == jres[task].keys()
        assert all(np.isfinite(v) for v in res[task].values())
    assert runner.og_grad_calls > 0 and runner.gen_grad_calls > 0
