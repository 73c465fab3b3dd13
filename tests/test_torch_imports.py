"""The port stands alone: it imports nothing of navillm_tpu, no jax and
none of the packages the card's machine lacks (tokenizers, protobuf,
sentencepiece and huggingface_hub among them), and its tiny slices (greedy
evaluation on bytes, on BPE uncached and prefix-cached, on int4, one
teacher-forcing optimizer step through
train_one_epoch, then run_training at stage multi from a YAML config),
its generation paths (EQA streaming evaluation, run_training with the
summarization and FGR2R heads validating R2R and EQA), its object-grounding
paths (REVERIE and SOON streaming evaluation with enable_og, sampled and
prefix-cached, and run_training over R2R, REVERIE and SOON with the OG,
summarization and FGR2R heads), the rest of the task mix (CVDN streaming
evaluation, ScanQA evaluation, and run_training over configs/multi.yaml's
sources at stage multi and, with the augmented sets, at stage pretrain),
the per-step paths (the per-step teacher and the interleaved DAgger
through run_training with batched validation, batched EQA validation, the
host-memory runner, the stage timer and the profiler trace), the vision
towers and the extraction entry points, run_training at tp=2 over two
gloo ranks, the HDF5 feature files (streaming evaluation and run_training
over a feature_database the port's writer made, read by its own reader),
and ``python -m navillm_tpu_torch.train --help`` run on the CPU.

The check runs in a subprocess, because tests/conftest.py imports jax into
the pytest process.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "yaml", "ml_dtypes", "tokenizers", "transformers",
          "safetensors", "h5py", "google.protobuf", "sentencepiece",
          "huggingface_hub", "regex")

SLICE = """
import sys, tempfile
import torch
import navillm_tpu_torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.tokenization import NavTokenizer

torch.set_num_threads(1)
tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
cfg = NavModelConfig.tiny(vocab_size=max(tok.vocab_size, bpe.vocab_size),
                          use_obj=False)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
runner = NavModelRunner(cfg, model, tok, dims=RolloutDims.tiny())
with tempfile.TemporaryDirectory() as tmp:
    anno = T.make_r2r_world(tmp, n_episodes=4, rows=3, cols=3)
    agent, ds, args = T.r2r_eval(anno, runner, 2, cfg.pano.image_feat_size)
    preds = agent.validate_streaming("R2R", args, T.eval_config(4),
                                     Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 4, preds
    print("metrics", ds.eval_metrics(preds, None, "R2R")[0])

    # the BPE slice, uncached and prefix-cached
    trajs = []
    for cached in (False, True):
        brunner = NavModelRunner(cfg, model, bpe, dims=RolloutDims.tiny())
        bagent, bds, bargs = T.r2r_eval(anno, brunner, 2,
                                        cfg.pano.image_feat_size,
                                        prefix_cache=cached)
        bpreds = bagent.validate_streaming(
            "R2R", bargs, T.eval_config(4), Dataloader(bds, 2, False),
            dataset=bds)
        trajs.append({p["instr_id"]: p["trajectory"] for p in bpreds})
    assert brunner.eval_steps == 0 and brunner.cached_steps > 0 \
        and brunner.prefill_calls > 0
    assert len(trajs[1]) == 4 and trajs[0] == trajs[1], trajs
    print("bpe cached metrics", bds.eval_metrics(bpreds, None, "R2R")[0])

    from navillm_tpu_torch.models.quant import quantize_nav_params, weight_bits
    from navillm_tpu_torch.ops.matmul_q4 import matmul_q4
    q4 = NavModel(cfg, quantize_nav_params(model, bits=4))
    assert weight_bits(q4) == 4
    agent.runner = NavModelRunner(cfg, q4, tok, dims=RolloutDims.tiny())
    preds = agent.validate_streaming("R2R", args, T.eval_config(4),
                                     Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 4 and matmul_q4.launches == 0, preds
    print("w4 metrics", ds.eval_metrics(preds, None, "R2R")[0])

    from navillm_tpu_torch.data.loaders import MetaLoader
    from navillm_tpu_torch.agents.mp3d_agent import TrainArgs
    from navillm_tpu_torch.training.optim import make_optimizer
    from navillm_tpu_torch.training.train_loop import (make_opt_step,
                                                       train_one_epoch)
    targs = TrainArgs(stage="pretrain", image_feat_size=cfg.pano.image_feat_size,
                      fused_rows_per_call=4, gradient_accumulation_step=1)
    anno = T.make_r2r_world(tmp + "/train", n_episodes=2, rows=3, cols=3,
                            split="train")
    agent, ds, loader = T.r2r_train(anno, runner, targs, batch_size=2)
    tx = make_optimizer(dict(model.named_parameters()), lr=targs.lr)
    loss, norms = train_one_epoch(
        targs, T.train_config(4), runner, tx, make_opt_step(tx),
        MetaLoader({"R2R": (loader, 1.0)}), {"R2R": agent}, {"R2R": ds}, 0,
        None, num_batches=1)
    assert loss > 0 and len(norms) == 1 and float(norms[0]) > 0, (loss, norms)
    print("train loss", loss)

    # run_training: a YAML config without pyyaml, stage multi
    # (teacher, then the fused DAgger) on build_runner's model, validation,
    # checkpoints
    import os
    from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu_torch.training.train_loop import run_training
    from navillm_tpu_torch.utils.config import TrainArgs as Args
    from navillm_tpu_torch.utils.config import load_yaml_text
    run = tmp + "/run"
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="train")
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="val", seed=1)
    cfg = load_yaml_text(RUN_CFG)
    rargs = Args(data_dir=run, output_dir=run + "/out", device="cpu",
                 num_epochs=1, num_steps_per_epoch=2, batch_size=2,
                 fused_rows_per_call=4, save_latest_states=True,
                 max_saved_checkpoints=1)
    rargs.sync_from_config(cfg)
    res = run_training(rargs, cfg, feat_dbs={"mp3d": SyntheticImageFeaturesDB(
        rargs.image_feat_size)})
    assert "sr" in res["R2R"], res
    assert sorted(os.listdir(run + "/out")) == [
        "epoch_0.json", "epoch_0.npz", "latest.json", "latest.npz"]
    print("run_training", res["R2R"])
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)

RUN_CFG = '''
Feature: {image_feat_size: 32, angle_feat_size: 4}
Dataset:
  R2R:
    DIR: R2R
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
Multi:
  SOURCE: ['R2R']
  Ratio: [1]
  LOSS_COEF: {}
Optim:
  train_max_action_len: {"R2R": 4}
  val_max_action_len: {"R2R": 4}
'''
SLICE = "RUN_CFG = %r\n" % RUN_CFG + SLICE

# the entry point's --help, in a fresh process
CLI_HELP = """
import runpy, sys
sys.argv = ["navillm_tpu_torch.train", "--help"]
try:
    runpy.run_module("navillm_tpu_torch.train", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)


# the HDF5 feature files: write_hdf5_features writes the world's views as
# the extractors do; streaming evaluation over create_feature_db's store on
# that file walks as over the synthetic store of the same values, and
# run_training reads the YAML's feature_database itself
HDF5 = """
import os, sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.feature_db import (SyntheticImageFeaturesDB,
                                               create_feature_db)
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.training.train_loop import run_training
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

torch.set_num_threads(1)
tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
cfg = NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
size = cfg.pano.image_feat_size
with tempfile.TemporaryDirectory() as tmp:
    anno = T.make_r2r_world(tmp, n_episodes=4, rows=3, cols=3, split="val")
    T.write_hdf5_features(tmp + "/feats/mp3d.hdf5", tmp + "/connectivity",
                          size)
    db = create_feature_db({"mp3d": "feats/mp3d.hdf5"}, size, tmp)["mp3d"]
    walks = {}
    for name, store in (("hdf5", db), ("synthetic",
                                       SyntheticImageFeaturesDB(size))):
        runner = NavModelRunner(cfg, model, tok, dims=RolloutDims.tiny())
        agent, ds, args = T.r2r_eval(anno, runner, 2, size)
        ds.init_feat_db(store)
        preds = agent.validate_streaming("R2R", args, T.eval_config(4),
                                         Dataloader(ds, 2, False),
                                         dataset=ds)
        walks[name] = {p["instr_id"]: p["trajectory"] for p in preds}
    assert len(walks["hdf5"]) == 4 and walks["hdf5"] == walks["synthetic"]
    assert db._h5 is not None and len(db._h5.keys()) == 9, db._h5
    print("hdf5 streaming eval", sorted(walks["hdf5"]))

    T.make_r2r_world(tmp, n_episodes=2, rows=3, cols=3, split="train")
    ycfg = load_yaml_text(HDF5_CFG)
    rargs = TrainArgs(data_dir=tmp, output_dir=tmp + "/out", device="cpu",
                      num_epochs=1, num_steps_per_epoch=2, batch_size=2,
                      fused_rows_per_call=4, max_saved_checkpoints=0)
    rargs.sync_from_config(ycfg)
    res = run_training(rargs, ycfg)
    assert "sr" in res["R2R"], res
    print("hdf5 run_training", res["R2R"])
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
HDF5_CFG = '''
Feature:
  image_feat_size: 32
  angle_feat_size: 4
  feature_database: {"mp3d": "feats/mp3d.hdf5"}
Dataset:
  R2R:
    DIR: R2R
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
Multi:
  SOURCE: ['R2R']
  Ratio: [1]
  LOSS_COEF: {}
Optim:
  train_max_action_len: {"R2R": 4}
  val_max_action_len: {"R2R": 4}
'''
HDF5 = "HDF5_CFG = %r\n" % HDF5_CFG + HDF5

# the generation paths: EQA streaming evaluation (trie answers, oracle pass)
# uncached and prefix-cached, then run_training at stage multi with the
# summarization and FGR2R heads, validating R2R and EQA
GEN = """
import os, sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.training.train_loop import run_training
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

torch.set_num_threads(1)
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
cfg = NavModelConfig.tiny(vocab_size=bpe.vocab_size, use_obj=False)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
with tempfile.TemporaryDirectory() as tmp:
    T.make_r2r_world(tmp, n_episodes=3, rows=3, cols=3, split="val")
    answers = []
    for cached in (False, True):
        runner = NavModelRunner(cfg, model, bpe, dims=RolloutDims.tiny())
        agent, ds, args = T.eqa_eval(tmp, "val", runner, 2,
                                     cfg.pano.image_feat_size,
                                     prefix_cache=cached)
        preds = agent.validate_streaming("EQA", args,
                                         T.eval_config(3, "EQA"),
                                         Dataloader(ds, 2, False), dataset=ds)
        assert runner.generate_calls == 3, runner.generate_calls
        answers.append({p["instr_id"]: (p["pred_answer"],
                                        p["oracle_pred_answer"])
                        for p in preds})
    assert len(answers[0]) == 3 and answers[0] == answers[1], answers
    assert all(a in ds.answer_vocab for ab in answers[0].values()
               for a in ab), answers
    print("eqa", ds.eval_metrics(preds, None, "EQA")[0])

    T.make_r2r_world(tmp, n_episodes=2, rows=3, cols=3, split="train")
    ycfg = load_yaml_text(GEN_CFG)
    rargs = TrainArgs(data_dir=tmp, output_dir=tmp + "/out", device="cpu",
                      num_epochs=1, num_steps_per_epoch=2, batch_size=2,
                      fused_rows_per_call=4, max_saved_checkpoints=0,
                      enable_summarize=True, enable_fgr2r=True,
                      gen_loss_coef=0.5, test_datasets=["R2R", "EQA"])
    rargs.sync_from_config(ycfg)
    res = run_training(rargs, ycfg, feat_dbs={"mp3d": SyntheticImageFeaturesDB(
        rargs.image_feat_size)})
    assert sorted(res) == ["EQA", "R2R"], res
    assert "exact_match" in res["EQA"] and "sr" in res["R2R"], res
    print("run_training", res)
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
GEN_CFG = '''
Feature: {image_feat_size: 32, angle_feat_size: 4}
Dataset:
  R2R:
    DIR: R2R
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  EQA:
    DIR: EQA
    ANSWER_VOCAB: annotations/answer_vocab.json
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
Multi:
  SOURCE: ['R2R', 'EQA']
  Ratio: [1, 0]
  LOSS_COEF: {}
Optim:
  train_max_action_len: {"R2R": 4, "EQA": 4}
  val_max_action_len: {"R2R": 4, "EQA": 3}
'''
GEN = "GEN_CFG = %r\n" % GEN_CFG + GEN


# the object-grounding paths: REVERIE and SOON streaming evaluation with the
# OG queue, sampled at T = 0.01 and prefix-cached, then run_training at
# stage multi over R2R, REVERIE and SOON with --enable_og --fuse_obj
# --enable_summarize --enable_fgr2r, validating all three
OG = """
import sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.feature_db import (SyntheticImageFeaturesDB,
                                               synthetic_object_db)
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.training.train_loop import (calc_overall_score,
                                                   run_training)
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

torch.set_num_threads(1)
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
cfg = NavModelConfig.tiny(vocab_size=bpe.vocab_size, use_obj=True)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
dbs = {s: synthetic_object_db(s, cfg.pano.obj_feat_size, 4)
       for s in ("reverie", "soon")}
with tempfile.TemporaryDirectory() as tmp:
    T.make_r2r_world(tmp, n_episodes=3, rows=3, cols=3, split="val")
    for task in ("REVERIE", "SOON"):
        runner = NavModelRunner(cfg, model, bpe, dims=RolloutDims.tiny())
        agent, ds, args = T.object_eval(
            task, tmp, "val", runner, 2, cfg.pano.image_feat_size,
            dbs[task.lower()], prefix_cache=True, do_sample=True,
            temperature=0.01)
        preds = agent.validate_streaming(task, args, T.eval_config(3, task),
                                         Dataloader(ds, 2, False), dataset=ds)
        assert len(preds) == 3 and runner.og_calls == 2, runner.og_calls
        assert runner.cached_steps and not runner.eval_steps
        assert all("pred_objid" in p for p in preds), preds
        print(task, ds.eval_metrics(preds, None, task)[0])

    T.make_r2r_world(tmp, n_episodes=2, rows=3, cols=3, split="train")
    ycfg = load_yaml_text(OG_CFG)
    rargs = TrainArgs(data_dir=tmp, output_dir=tmp + "/out", device="cpu",
                      num_epochs=1, num_steps_per_epoch=4, batch_size=2,
                      fused_rows_per_call=4, max_saved_checkpoints=0,
                      enable_og=True, fuse_obj=True, obj_loss_coef=0.5,
                      enable_summarize=True, enable_fgr2r=True, seed=3,
                      test_datasets=["R2R", "REVERIE", "SOON"])
    rargs.sync_from_config(ycfg)
    res = run_training(rargs, ycfg, feat_dbs={"mp3d": SyntheticImageFeaturesDB(
        rargs.image_feat_size)}, obj_feat_dbs=dbs)
    assert sorted(res) == ["R2R", "REVERIE", "SOON"], res
    assert "rgs" in res["REVERIE"] and "det_sr" in res["SOON"], res
    print("run_training", res, calc_overall_score(res, ycfg))
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
OG_CFG = '''
Feature: {image_feat_size: 32, angle_feat_size: 4, obj_feat_size: 16,
          max_objects: 70}
Dataset:
  R2R:
    DIR: R2R
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  REVERIE:
    DIR: REVERIE
    bbox_file: annotations/BBoxes.json
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  SOON:
    DIR: SOON
    SPLIT: {"train": "annotations/train.jsonl",
            "val_unseen": "annotations/val.jsonl"}
Multi:
  SOURCE: ['R2R', 'REVERIE', 'SOON']
  Ratio: [1, 1, 1]
  LOSS_COEF: {}
Optim:
  train_max_action_len: {"R2R": 4, "REVERIE": 4, "SOON": 4}
  val_max_action_len: {"R2R": 3, "REVERIE": 3, "SOON": 3}
'''
OG = "OG_CFG = %r\n" % OG_CFG + OG


# the rest of the paper's task mix: CVDN streaming evaluation (uncached and
# prefix-cached), ScanQA evaluation, then run_training at stage multi over
# the six sources of configs/multi.yaml with --enable_og --enable_summarize
# --enable_fgr2r (validating CVDN, SOON, R2R, REVERIE and ScanQA), and at
# stage pretrain over its seven (the augmented sets' .jsonl files read
# through the default decoder, bert-base-uncased from an offline cache
# written by testing.write_bert_cache)
MIX = """
import os, sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data import aug
from navillm_tpu_torch.data.feature_db import synthetic_object_db
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.training.train_loop import run_training
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

torch.set_num_threads(1)
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
cfg = NavModelConfig.tiny(vocab_size=bpe.vocab_size, use_obj=True)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
dims = RolloutDims(max_gmap_nodes=16, max_views=40, max_cands=15,
                   max_hist=8, max_objects=8, max_prefix=448)
dbs = {s: synthetic_object_db(s, cfg.pano.obj_feat_size, 4)
       for s in ("reverie", "soon")}
for k in ("TRANSFORMERS_CACHE", "PYTORCH_TRANSFORMERS_CACHE",
          "PYTORCH_PRETRAINED_BERT_CACHE", "HF_HUB_CACHE",
          "HUGGINGFACE_HUB_CACHE"):
    os.environ.pop(k, None)
with tempfile.TemporaryDirectory() as tmp:
    os.environ["HF_HOME"] = tmp + "/hf"
    T.write_bert_cache(tmp + "/hf")
    assert aug.R2RAugDataset.decoder is None
    ids = T.aug_encode("walk left into the kitchen")
    assert aug._default_decoder()(ids) == T.aug_decoder(ids)
    T.make_r2r_world(tmp, n_episodes=3, rows=3, cols=3, split="val")
    trajs = []
    for cached in (False, True):
        runner = NavModelRunner(cfg, model, bpe, dims=dims)
        agent, ds, args = T.cvdn_eval(tmp, "val", runner, 2,
                                      cfg.pano.image_feat_size,
                                      prefix_cache=cached)
        preds = agent.validate_streaming("CVDN", args,
                                         T.eval_config(6, "CVDN"),
                                         Dataloader(ds, 2, False), dataset=ds)
        trajs.append({p["instr_id"]: p["trajectory"] for p in preds})
    assert runner.cached_steps and not runner.eval_steps
    assert len(trajs[0]) == 3 and trajs[0] == trajs[1], trajs
    print("cvdn", ds.eval_metrics(preds, None, "CVDN")[0])
    runner = NavModelRunner(cfg, model, bpe, dims=dims)
    agent, ds, args = T.scanqa_eval(tmp, "val", runner, 2,
                                    cfg.pano.image_feat_size)
    preds = agent.validate("ScanQA", args, None, Dataloader(ds, 2, False))
    assert len(preds) == 3 and runner.generate_calls == 2, preds
    print("scanqa", ds.eval_metrics(preds, None, "ScanQA")[0])

    T.make_r2r_world(tmp, n_episodes=4, rows=3, cols=3, split="train")
    ycfg = load_yaml_text(MIX_CFG)
    for stage, steps, seed in (("multi", 8, 262), ("pretrain", 6, 175)):
        runner = NavModelRunner(cfg, model, bpe, dims=dims, seed=seed)
        rargs = TrainArgs(data_dir=tmp, output_dir=tmp + "/out",
                          device="cpu", stage=stage, num_epochs=1,
                          num_steps_per_epoch=steps, batch_size=2,
                          fused_rows_per_call=4, max_saved_checkpoints=0,
                          save_ckpt_per_epochs=100, enable_og=True,
                          enable_summarize=True, enable_fgr2r=True,
                          seed=seed, test_datasets=["CVDN", "SOON", "R2R",
                                                    "REVERIE", "ScanQA"])
        rargs.sync_from_config(ycfg)
        res = run_training(rargs, ycfg, feat_dbs=T.feature_dbs(
            rargs.image_feat_size), obj_feat_dbs=dbs, runner=runner)
        assert sorted(res) == ["CVDN", "R2R", "REVERIE", "SOON", "ScanQA"]
        assert runner.gen_grad_calls and runner.og_grad_calls, stage
        print("run_training", stage, res["CVDN"], res["ScanQA"])
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
MIX_CFG = '''
Feature: {image_feat_size: 32, angle_feat_size: 4, obj_feat_size: 16,
          max_objects: 70}
Dataset:
  R2R: {DIR: R2R, SPLIT: {"train": "annotations/train.json",
                          "val_unseen": "annotations/val.json"}}
  REVERIE: {DIR: REVERIE, bbox_file: annotations/BBoxes.json,
            SPLIT: {"train": "annotations/train.json",
                    "val_unseen": "annotations/val.json"}}
  CVDN: {DIR: CVDN, SPLIT: {"train": "annotations/train.json",
                            "val_unseen": "annotations/val.json"}}
  SOON: {DIR: SOON, SPLIT: {"train": "annotations/train.jsonl",
                            "val_unseen": "annotations/val.jsonl"}}
  ScanQA: {DIR: ScanQA, SPLIT: {"train": "annotations/train.json",
                                "val_unseen": "annotations/val.json"}}
  LLaVA: {DIR: LLaVA, SPLIT: {"train": "annotations/train.json"}}
  R2R_AUG: {DIR: R2R, SPLIT: {"train": "annotations/train_aug.jsonl"}}
  REVERIE_AUG: {DIR: REVERIE, bbox_file: annotations/BBoxes.json,
                SPLIT: {"train": "annotations/train_aug.jsonl"}}
Pretrain:
  SOURCE: ['R2R_AUG', 'REVERIE_AUG', 'R2R', 'REVERIE', 'SOON', 'CVDN',
           'ScanQA']
  Ratio: [1, 1, 1, 1, 1, 1, 1]
  LOSS_COEF: {"R2R_AUG": 1, "REVERIE_AUG": 1}
Multi:
  SOURCE: ['R2R', 'REVERIE', 'CVDN', 'SOON', 'ScanQA', 'LLaVA']
  Ratio: [1, 1, 1, 1, 1, 1]
  LOSS_COEF: {}
Optim:
  train_max_action_len: {"R2R": 4, "REVERIE": 4, "SOON": 4, "CVDN": 4,
                         "R2R_AUG": 4, "REVERIE_AUG": 4}
  val_max_action_len: {"R2R": 3, "REVERIE": 3, "SOON": 3, "CVDN": 6}
'''
MIX = "MIX_CFG = %r\n" % MIX_CFG + MIX


# the pretrained path: an HF-layout directory written by the port's own
# writer (sharded safetensors, config.json) with the bpe_nav tokenizer as its
# tokenizer.json; run_training from it at stage multi with 8-bit Adam
# moments, then eval_r2r.sh's shape (--mode test --resume_from_checkpoint)
# and the int4 evaluation (--quantize_llm --quant_bits 4)
PRETRAINED = """
import json, os, shutil, sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.convert import init_llama_params
from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
from navillm_tpu_torch.models import llama as L
from navillm_tpu_torch.models.convert import save_vicuna
from navillm_tpu_torch.models.quant import weight_bits
from navillm_tpu_torch.training import train_loop as TTL
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

torch.set_num_threads(1)
built = []
build = TTL.build_runner
TTL.build_runner = lambda *a, **kw: built.append(build(*a, **kw)) or built[-1]
with tempfile.TemporaryDirectory() as tmp:
    vic = tmp + "/vicuna"
    cfg = L.LlamaConfig.tiny(vocab_size=1024)
    save_vicuna(vic, init_llama_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu"),
                cfg, vocab_rows=1016, shard_bytes=200_000)
    shutil.copy(os.path.join(os.path.dirname(L.__file__), "bpe_nav.json"),
                vic + "/tokenizer.json")
    with open(vic + "/tokenizer_config.json", "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "pad_token": "<PAD>"}, f)
    run = tmp + "/run"
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="train")
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="val", seed=1)
    ycfg = load_yaml_text(RUN_CFG)
    feats = {"mp3d": SyntheticImageFeaturesDB(32)}
    common = dict(data_dir=run, device="cpu", precision="fp32",
                  pretrained_model_name_or_path=vic, num_epochs=1,
                  num_steps_per_epoch=2, batch_size=2, fused_rows_per_call=4,
                  num_pano_layers=1)
    args = TrainArgs(output_dir=run + "/out", adam_8bit=True,
                     max_saved_checkpoints=1, **common)
    args.sync_from_config(ycfg)
    res = TTL.run_training(args, ycfg, feat_dbs=feats)
    assert "sr" in res["R2R"] and built[-1].cached_steps > 0, res
    for extra in (dict(resume_from_checkpoint=run + "/out/epoch_0"),
                  dict(quantize_llm=True, quant_bits=4)):
        a = TrainArgs(output_dir=run + "/eval", mode="test", **common,
                      **extra)
        a.sync_from_config(ycfg)
        res = TTL.run_training(a, ycfg, feat_dbs=feats)
        assert "sr" in res["R2R"], res
    assert weight_bits(built[-1].model) == 4
    print("pretrained", res["R2R"])
    # the same checkpoint with LLaMA's sentencepiece tokenizer.model alone
    os.remove(vic + "/tokenizer.json")
    for f in ("tokenizer.model", "tokenizer_config.json"):
        shutil.copy("tests/fixtures/spm_llama/" + f, vic + "/" + f)
    a = TrainArgs(output_dir=run + "/spm", mode="test", **common)
    a.sync_from_config(ycfg)
    res = TTL.run_training(a, ycfg, feat_dbs=feats)
    assert "sr" in res["R2R"] and built[-1].tok.true_vocab_size == 1022, res
    print("tokenizer.model", res["R2R"])
    # a LLaMA-3-layout tokenizer.json (its Split regex translated for re)
    os.remove(vic + "/tokenizer.model")
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy("tests/fixtures/llama3_bpe/" + f, vic + "/" + f)
    a = TrainArgs(output_dir=run + "/llama3", mode="test", **common)
    a.sync_from_config(ycfg)
    res = TTL.run_training(a, ycfg, feat_dbs=feats)
    assert "sr" in res["R2R"] and \
        built[-1].tok.bos_token == T.LLAMA3_BOS, res
    print("llama3", res["R2R"])
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
PRETRAINED = "RUN_CFG = %r\n" % RUN_CFG + PRETRAINED


# the per-step paths: the per-step teacher and the interleaved DAgger
# streams through run_training (stage multi, --no-fused_teacher
# --no-fused_dagger --dagger_pipeline, batched validation under
# --no-streaming_eval), batched EQA validation, the host-memory runner
# under streaming evaluation and the fused trainers, the stage timer and
# the profiler trace
PERSTEP = """
import os, sys, tempfile
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents import fused_teacher as FT
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.training import train_loop as TTL
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text
from navillm_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)
with tempfile.TemporaryDirectory() as tmp:
    run = tmp + "/run"
    T.make_r2r_world(run, n_episodes=4, rows=3, cols=3, split="train")
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="val", seed=1)
    cfg = load_yaml_text(RUN_CFG)
    args = TrainArgs(data_dir=run, output_dir=run + "/out", device="cpu",
                     num_epochs=1, num_steps_per_epoch=2, batch_size=4,
                     fused_teacher=False, fused_dagger=False,
                     dagger_pipeline=True, dagger_streams=2,
                     streaming_eval=False)
    args.sync_from_config(cfg)
    built, calls = [], []
    build = TTL.build_runner
    TTL.build_runner = lambda *a, **k: built.append(build(*a, **k)) or built[-1]
    from navillm_tpu_torch.agents.mp3d_agent import R2RAgent
    for name in ("rollout", "rollout_interleaved", "validate"):
        def spy(self, *a, _name=name, _fn=getattr(R2RAgent, name), **k):
            calls.append(_name)
            return _fn(self, *a, **k)
        setattr(R2RAgent, name, spy)
    with trace(None):
        res = TTL.run_training(args, cfg, feat_dbs={
            "mp3d": SyntheticImageFeaturesDB(args.image_feat_size)})
    assert "sr" in res["R2R"], res
    assert calls[:2] == ["rollout", "rollout_interleaved"], calls
    assert "validate" in calls and built[-1].eval_steps == 0, calls
    print("run_training per-step", res["R2R"])

    runner = NavModelRunner(built[-1].cfg, built[-1].model, built[-1].tok,
                            dims=RolloutDims.tiny(), device_memory=False)
    agent, ds, eargs = T.eqa_eval(run, "val", runner, 2,
                                  args.image_feat_size)
    preds = agent.validate("EQA", eargs, T.eval_config(4, "EQA"),
                           Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 2 and all(p["pred_answer"] in ds.answer_vocab
                                   for p in preds), preds
    preds = agent.validate_streaming("EQA", eargs, T.eval_config(4, "EQA"),
                                     Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 2 and runner.eval_steps == 0, preds
    targs = TrainArgs(image_feat_size=args.image_feat_size, device="cpu",
                      fused_rows_per_call=4)
    tagent, tds, loader = T.r2r_train(run + "/R2R/annotations/train.json",
                                      runner, targs, 4, shuffle=False)
    runner.zero_grads()
    for fn in (FT.rollout_teacher_fused, FT.rollout_dagger_fused):
        loss, _ = fn(tagent, targs, "R2R", T.train_config(4).Optim,
                     next(iter(loader)), dataset=tds, train_ml=1.0)
        assert torch.isfinite(loss), loss
    report = tagent.timer.report()
    assert "fuse_device" in report and "dagger_sample" in report, report
    with trace(tmp + "/trace"):
        torch.ones(8).sum()
    assert os.path.exists(tmp + "/trace/trace.json")
    print("host memory", report.splitlines()[0])
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
PERSTEP = "RUN_CFG = %r\n" % RUN_CFG + PERSTEP

# the rest of quantization: W8A8 on an int8 tree drawn quantized, with the
# prefix cache and the int8 K/V; generate on a w4a8 tree with an int8 prompt
# K/V; the fused DAgger sampling from the W8A8 policy
QUANT = """
import dataclasses, sys, tempfile
import numpy as np
import torch
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents import fused_teacher as FT
from navillm_tpu_torch.agents.mp3d_agent import TrainArgs
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.data.loaders import Dataloader
from navillm_tpu_torch.models import decoding as D
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig
from navillm_tpu_torch.models.quant import quantize_nav_params, weight_bits
from navillm_tpu_torch.models.tokenization import NavTokenizer

torch.set_num_threads(1)
bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
cfg = NavModelConfig.tiny(vocab_size=bpe.vocab_size, use_obj=False)
a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                      act_int8=True))
q8 = NavModel(a8, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", quantize_llm=True))
assert weight_bits(q8) == 8
with tempfile.TemporaryDirectory() as tmp:
    anno = T.make_r2r_world(tmp, n_episodes=4, rows=3, cols=3)
    runner = NavModelRunner(a8, q8, bpe, dims=RolloutDims.tiny())
    agent, ds, args = T.r2r_eval(anno, runner, 2, cfg.pano.image_feat_size,
                                 prefix_cache=True)
    args.kv_int8 = True
    preds = agent.validate_streaming("R2R", args, T.eval_config(4),
                                     Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 4 and runner.cached_steps > 0, preds
    print("w8a8 kv8 metrics", ds.eval_metrics(preds, None, "R2R")[0])

    model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0),
                                          device="cpu"))
    w4 = quantize_nav_params(model, bits=4)
    ids = np.random.RandomState(0).randint(3, 200, (2, 40)).astype(np.int32)
    out = D.generate(w4["llm"], a8.llm, ids, np.ones((2, 40), bool),
                     eos_id=bpe.eos_id, pad_id=bpe.pad_id, max_new_tokens=6,
                     kv_int8=True)
    assert out.shape == (2, 6)
    print("w4a8 generate", out.tolist())

    runner = NavModelRunner(cfg, model, bpe, dims=RolloutDims.tiny())
    targs = TrainArgs(image_feat_size=cfg.pano.image_feat_size,
                      fused_rows_per_call=4, dagger_sample_quant=True)
    anno = T.make_r2r_world(tmp + "/train", n_episodes=4, rows=3, cols=3,
                            split="train")
    tagent, tds, loader = T.r2r_train(anno, runner, targs, 4, shuffle=False)
    runner.zero_grads()
    loss, _ = FT.rollout_dagger_fused(tagent, targs, "R2R",
                                      T.train_config(4).Optim,
                                      next(iter(loader)), dataset=tds,
                                      train_ml=1.0)
    assert torch.isfinite(loss) and runner.sampling_quantizations == 1
    print("dagger sample quant", float(loss))
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)


# the vision and parallel slices, in two ranks joined from torchrun's
# environment variables: each rank runs the tiny EVA02 and CLIP towers and
# the extractor's device half, the extraction entry points' --help, then
# run_training at tp=2 (stage multi: the teacher and the sampled DAgger on
# the split LLM, merged validation, the checkpoint gathered on rank 0)
PARALLEL = """
import os, runpy, sys
import numpy as np
import torch
from navillm_tpu_torch.vision import vit as V
from navillm_tpu_torch.vision.extract import FeatureExtractor

torch.set_num_threads(1)
for style in ("eva02", "clip"):
    vcfg = V.ViTConfig.tiny(style=style)
    params = V.init_vit_params(vcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    fe = FeatureExtractor(params, vcfg, batch_size=4, decode_workers=1)
    feats = fe.encode(np.random.RandomState(0).randn(
        6, 28, 28, 3).astype(np.float32))
    assert feats.shape == (6, 64) and np.isfinite(feats).all()
    assert fe.forward_calls == 2
    print("vit", style, feats.shape)
for mod in ("navillm_tpu_torch.vision.extract_features_mp3d",
            "navillm_tpu_torch.vision.extract_features_frames"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code

from navillm_tpu_torch import testing as T
from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
from navillm_tpu_torch.parallel.dist import init_distributed
from navillm_tpu_torch.training.train_loop import run_training
from navillm_tpu_torch.utils.config import TrainArgs, load_yaml_text

assert init_distributed(backend="gloo")
run = os.environ["RUN_DIR"]
rank = int(os.environ["RANK"])
if rank == 0:
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="train")
    T.make_r2r_world(run, n_episodes=2, rows=3, cols=3, split="val", seed=1)
    os.makedirs(run + "/out")
torch.distributed.barrier()
cfg = load_yaml_text(RUN_CFG)
args = TrainArgs(data_dir=run, output_dir=run + "/out", device="cpu",
                 num_epochs=1, num_steps_per_epoch=2, batch_size=2,
                 fused_rows_per_call=4, save_latest_states=True, tp_size=2,
                 max_saved_checkpoints=1)
args.sync_from_config(cfg)
res = run_training(args, cfg, feat_dbs={"mp3d": SyntheticImageFeaturesDB(
    args.image_feat_size)})
assert (args.rank, args.dp_size, args.tp_size) == (rank, 1, 2), args
if rank == 0:
    assert "sr" in res["R2R"], res
    assert sorted(os.listdir(run + "/out")) == [
        "epoch_0.json", "epoch_0.npz", "latest.json", "latest.npz"]
    print("run_training tp=2", res["R2R"])
torch.distributed.destroy_process_group()
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)
PARALLEL = "RUN_CFG = %r\n" % RUN_CFG + PARALLEL


def _fresh(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "loaded []" in proc.stdout, proc.stdout
    return proc.stdout


def test_port_runs_vision_and_parallel_without_jax(tmp_path):
    """Two ranks, each with the environment torchrun gives it."""
    from navillm_tpu_torch.testing import free_port
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RUN_DIR=str(tmp_path / "run"))
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PARALLEL], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert "loaded []" in out and "vit eva02" in out, out
    assert "run_training tp=2" in outs[0][0]
    assert "torch.distributed: backend gloo" in outs[0][0]


def test_port_runs_its_slice_without_jax():
    _fresh(SLICE)


def test_port_runs_the_hdf5_feature_files_without_h5py():
    out = _fresh(HDF5)
    assert "hdf5 streaming eval" in out and "hdf5 run_training" in out


def test_port_runs_its_generation_paths_without_jax():
    _fresh(GEN)


def test_port_runs_its_object_grounding_paths_without_jax():
    out = _fresh(OG)
    assert "REVERIE" in out and "SOON" in out and "run_training" in out


def test_port_runs_the_task_mix_without_jax():
    out = _fresh(MIX)
    assert "cvdn" in out and "scanqa" in out
    assert "run_training multi" in out and "run_training pretrain" in out


def test_port_runs_the_pretrained_path_without_jax():
    out = _fresh(PRETRAINED)
    assert "pretrained" in out and "tokenizer.model" in out \
        and "llama3" in out


def test_port_runs_the_per_step_paths_without_jax():
    out = _fresh(PERSTEP)
    assert "run_training per-step" in out and "host memory" in out


def test_port_runs_the_quantization_paths_without_jax():
    out = _fresh(QUANT)
    assert "w8a8 kv8" in out and "w4a8 generate" in out \
        and "dagger sample quant" in out


def test_train_entry_point_help_without_jax():
    out = _fresh(CLI_HELP)
    assert "--dagger_prefix_cache" in out and "--device" in out
    assert "--enable_fgr2r" in out and "--gen_loss_coef" in out
    for flag in ("--enable_og", "--obj_loss_coef", "--fuse_obj",
                 "--do_sample", "--temperature"):
        assert flag in out, flag


def _port_sources():
    files = [*(ROOT / "navillm_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"navillm_tpu_torch/vision/vit.py",
            "navillm_tpu_torch/vision/extract.py",
            "navillm_tpu_torch/vision/extract_features_mp3d.py",
            "navillm_tpu_torch/vision/extract_features_frames.py",
            "navillm_tpu_torch/parallel/mesh.py",
            "navillm_tpu_torch/parallel/dist.py",
            "navillm_tpu_torch/data/reverie.py",
            "navillm_tpu_torch/data/soon.py",
            "navillm_tpu_torch/data/cvdn.py", "navillm_tpu_torch/data/aug.py",
            "navillm_tpu_torch/data/llava.py",
            "navillm_tpu_torch/data/scanqa.py",
            "navillm_tpu_torch/data/prefetch.py",
            "navillm_tpu_torch/models/sentencepiece.py",
            "navillm_tpu_torch/models/pretokenize.py",
            "navillm_tpu_torch/models/unigram.py",
            "navillm_tpu_torch/utils/hdf5.py",
            "navillm_tpu_torch/eval/captioning.py",
            "navillm_tpu_torch/agents/llava_agent.py"} <= names
    return files


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
    hits = [str(f) for f in _port_sources() if pat.search(f.read_text())]
    assert not hits, hits


def test_port_sources_never_import_hf_packages():
    """The pretrained path reads HF's layouts itself: the card's machine has
    neither transformers, safetensors, tokenizers nor regex."""
    pat = re.compile(r"^\s*(import|from)\s+(transformers|safetensors|"
                     r"tokenizers|google\.protobuf|sentencepiece|"
                     r"huggingface_hub|regex)\b", re.M)
    files = _port_sources()
    assert ROOT / "navillm_tpu_torch/models/convert.py" in files
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
    assert pat.search("from safetensors import safe_open") \
        and pat.search("import tokenizers\n") \
        and pat.search("from google.protobuf import message") \
        and pat.search("import sentencepiece as spm") \
        and pat.search("from huggingface_hub import constants") \
        and pat.search("import regex\n") \
        and not pat.search("from .sentencepiece import load_model") \
        and not pat.search("from . import pretokenize as PT")


def test_port_sources_never_import_h5py():
    """The feature files go through utils/hdf5.py: the card's machine has
    no h5py. The word may stand in prose, never in an import."""
    pat = re.compile(r"^\s*(import|from)\s+h5py\b", re.M)
    files = _port_sources()
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
    assert pat.search("    import h5py\n") \
        and pat.search("from h5py import File") \
        and not pat.search("# read as h5py does")


def test_port_sources_never_import_navillm_tpu():
    """Not even a numpy-only module: the port keeps its own copies."""
    pat = re.compile(r"^\s*(import|from)\s+navillm_tpu(\.|\s|$)", re.M)
    hits = [str(f) for f in _port_sources() if pat.search(f.read_text())]
    assert not hits, hits
    assert pat.search("from navillm_tpu.sim import WorldModel") \
        and pat.search("import navillm_tpu\n") \
        and not pat.search("from navillm_tpu_torch.sim import WorldModel")


def test_prefetcher_imports_nothing_of_the_device_path():
    """data/prefetch.py runs in worker threads on host memory: no torch
    either, and of the port nothing at all."""
    src = (ROOT / "navillm_tpu_torch/data/prefetch.py").read_text()
    imports = re.findall(r"^\s*(?:import|from)\s+(\S+)", src, re.M)
    assert imports and not [m for m in imports if m.split(".")[0] in (
        "torch", "jax", "jaxlib", "navillm_tpu", "navillm_tpu_torch")
        or m.startswith(".")], imports
