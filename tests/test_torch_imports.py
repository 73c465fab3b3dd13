"""The port stands alone: it imports no jax and none of the packages the
card's machine lacks, and its tiny slice runs on the CPU.

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
from navillm_tpu.data.loaders import Dataloader
from navillm_tpu.models.tokenization import NavTokenizer
from navillm_tpu_torch import testing as T
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import init_nav_params
from navillm_tpu_torch.models.nav_model import NavModel, NavModelConfig

torch.set_num_threads(1)
tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
cfg = NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
model = NavModel(cfg, init_nav_params(cfg, torch.Generator().manual_seed(0)))
runner = NavModelRunner(cfg, model, tok, dims=RolloutDims.tiny())
with tempfile.TemporaryDirectory() as tmp:
    anno = T.make_r2r_world(tmp, n_episodes=4, rows=3, cols=3)
    agent, ds, args = T.r2r_eval(anno, runner, 2, cfg.pano.image_feat_size)
    preds = agent.validate_streaming("R2R", args, T.eval_config(4),
                                     Dataloader(ds, 2, False), dataset=ds)
    assert len(preds) == 4, preds
    print("metrics", ds.eval_metrics(preds, None, "R2R")[0])
print("loaded", sorted(m for m in %r if m in sys.modules))
""" % (BANNED,)


def test_port_runs_its_slice_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "loaded []" in proc.stdout, proc.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
    files = [*(ROOT / "navillm_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
