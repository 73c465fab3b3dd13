"""The port stands alone: it imports nothing of navillm_tpu, no jax and
none of the packages the card's machine lacks (tokenizers among them), and
its tiny slices (greedy evaluation on bytes, on BPE uncached and
prefix-cached, on int4, then one teacher-forcing optimizer step through
train_one_epoch) run on the CPU.

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
          "h5py")

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
print("loaded", sorted(m for m in sys.modules if m in %r
                       or m == "navillm_tpu" or m.startswith("navillm_tpu.")))
""" % (BANNED,)


def test_port_runs_its_slice_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "loaded []" in proc.stdout, proc.stdout


def _port_sources():
    files = [*(ROOT / "navillm_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
    hits = [str(f) for f in _port_sources() if pat.search(f.read_text())]
    assert not hits, hits


def test_port_sources_never_import_navillm_tpu():
    """Not even a numpy-only module: the port keeps its own copies."""
    pat = re.compile(r"^\s*(import|from)\s+navillm_tpu(\.|\s|$)", re.M)
    hits = [str(f) for f in _port_sources() if pat.search(f.read_text())]
    assert not hits, hits
    assert pat.search("from navillm_tpu.sim import WorldModel") \
        and pat.search("import navillm_tpu\n") \
        and not pat.search("from navillm_tpu_torch.sim import WorldModel")
