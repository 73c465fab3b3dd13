"""Two-level config: CLI flags + the YAML experiment config.

Torch-side copy of navillm_tpu/utils/config.py (the reference's argparse +
EasyDict YAML merge, tools/parser.py:22-156): ``ConfigDict``, ``TrainArgs``
with every flag, name and default of the JAX package's, ``build_arg_parser``
and ``read_args`` with the auto-resume probe. The YAML goes through the
port's own reader of the subset the configs use (utils/yaml_subset.py),
since the card's machine has no pyyaml.

The one field the JAX package lacks is ``device``: the port's entry points
run on the card ("cuda") unless the caller asks for the CPU
(``--device cpu``). Flags of paths the port does not run yet parse as in
JAX; set to anything but their default, ``check_ported`` refuses them and
names the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional

from . import yaml_subset


class ConfigDict(dict):
    """Recursive attribute-access dict (drop-in for EasyDict)."""

    def __init__(self, d: Optional[Dict] = None, **kwargs):
        super().__init__()
        d = dict(d or {})
        d.update(kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def update(self, other=None, **kwargs):  # keep ConfigDict wrapping
        merged = dict(other or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = self._wrap(v)


def load_yaml_text(text: str) -> ConfigDict:
    return ConfigDict(yaml_subset.safe_load(text))


def load_yaml_config(path) -> ConfigDict:
    with open(path) as f:
        return load_yaml_text(f.read())


@dataclasses.dataclass
class TrainArgs:
    """All run flags, with the JAX package's names and defaults (reference
    tools/parser.py flag for flag), plus ``device``."""

    # paths
    data_dir: str = "data"
    cfg_file: Optional[str] = None
    pretrained_model_name_or_path: Optional[str] = None
    output_dir: str = "output"

    # run mode
    mode: str = "train"              # train | test
    stage: str = "multi"             # pretrain | multi
    debug: bool = False
    seed: int = 0

    # schedule
    num_epochs: int = 30
    num_steps_per_epoch: int = -1
    batch_size: int = 1
    val_batch_size: int = 2
    lr: float = 1e-5
    feat_dropout: float = 0.4
    num_warmup_steps: int = 0
    gradient_accumulation_step: int = 2
    precision: str = "bf16"          # bf16 | fp32
    workers: int = 0
    grad_clip_norm: float = 40.0

    # checkpointing
    resume_from_checkpoint: Optional[str] = None
    from_scratch: bool = False
    max_saved_checkpoints: int = 0
    save_ckpt_per_epochs: int = 10
    save_latest_states: bool = False
    save_pred_results: bool = False
    save_detail_results: bool = False

    # tasks
    ignoreid: int = -100
    enable_og: bool = False
    enable_summarize: bool = False
    enable_fgr2r: bool = False
    gen_loss_coef: float = 1.0
    obj_loss_coef: float = 1.0
    teacher_forcing_coef: float = 1.0
    fuse_obj: bool = False
    multi_endpoints: int = 1
    path_type: str = "trusted_path"
    max_datapoints: Optional[int] = None
    off_batch_task: bool = False

    # evaluation
    test_datasets: Optional[List[str]] = None
    validation_split: str = "val_unseen"
    do_sample: bool = False
    temperature: float = 1.0
    streaming_eval: bool = True
    # prompt-prefix KV cache in streaming eval (opt-in)
    prefix_cache: bool = False
    # streaming-eval slot groups
    eval_streams: int = 2
    # eval-only weight quantization (int8, or int4 with quant_bits=4)
    quantize_llm: bool = False
    quant_bits: int = 8
    # int8 activations on a quantized LLM (W8A8 on int8, w4a8 on int4)
    act_int8: bool = False
    # int8 K/V: the streaming prefix cache and generate's prompt K/V
    # (per token and head, f32 scales: models/llama.py:kv_quantize)
    kv_int8: bool = False
    # 8-bit Adam moments (training/optim.py:AdamQ8): int8/uint8 codes in
    # the parameter's shape with f32 group scales, f32 update math
    adam_8bit: bool = False
    # ZeRO-1 over the data group (parallel/mesh.py): the moments of large
    # leaves keep each rank's slice only
    zero1: bool = True
    # fused whole-trajectory teacher forcing
    fused_teacher: bool = True
    # the per-step DAgger (without fused_dagger) in dagger_streams streams
    # (rollout_interleaved)
    dagger_pipeline: bool = True
    # fused-DAgger sampling slot groups
    dagger_streams: int = 2
    # the fused DAgger samples from an int8 copy of the LLM with int8
    # activations (W8A8), re-quantized after each optimizer step
    dagger_sample_quant: bool = False
    # fused DAgger: no-grad sampling rollout + one fused loss pass
    fused_dagger: bool = True
    # prefix-cached DAgger sampling (budget-gated at batch start)
    dagger_prefix_cache: bool = True
    # rows per fused grad call (0: one call over all rows)
    fused_rows_per_call: int = 48

    # parallelism: one process per card under torchrun; run_training sets
    # these from the plan (training/train_loop.py:build_mesh_plan)
    dp_size: int = -1
    tp_size: int = 1
    rank: int = 0
    world_size: int = 1

    # copied from the YAML Feature/Model sections at load time
    image_feat_size: int = 1024
    obj_feat_size: int = 768
    angle_feat_size: int = 4
    enc_full_graph: bool = True
    expert_policy: str = "spl"
    num_pano_layers: int = 2

    # the port's own: where the model lives ("cuda", the card, or "cpu")
    device: str = "cuda"

    def sync_from_config(self, cfg: ConfigDict) -> "TrainArgs":
        """Copy select YAML fields onto args (reference parser.py:128-135)."""
        feat = cfg.get("Feature", {})
        model = cfg.get("Model", {})
        self.image_feat_size = feat.get("image_feat_size", self.image_feat_size)
        self.obj_feat_size = feat.get("obj_feat_size", self.obj_feat_size)
        self.angle_feat_size = feat.get("angle_feat_size", self.angle_feat_size)
        self.enc_full_graph = model.get("enc_full_graph", self.enc_full_graph)
        self.expert_policy = model.get("expert_policy", self.expert_policy)
        self.num_pano_layers = model.get("num_pano_layers",
                                         self.num_pano_layers)
        return self


# flag -> why it cannot act in the port
UNPORTED = {
    "workers": "the loaders have no worker processes (neither has the JAX "
               "package's)",
}


def check_ported(args: "TrainArgs"):
    """Raise NotImplementedError for a flag of UNPORTED set to anything but
    its default: it would change nothing and say nothing."""
    defaults = TrainArgs()
    for name, why in UNPORTED.items():
        if getattr(args, name) != getattr(defaults, name):
            raise NotImplementedError(
                f"--{name}={getattr(args, name)!r}: {why}; leave it at its "
                f"default {getattr(defaults, name)!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NaviLLM training and evaluation on the PyTorch/CUDA port")
    for f in dataclasses.fields(TrainArgs):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            # --flag / --no-flag (default-True flags like --streaming_eval)
            p.add_argument(name, action=argparse.BooleanOptionalAction,
                           default=f.default)
        elif f.name == "test_datasets":
            p.add_argument(name, type=str, nargs="+", default=None)
        else:
            typ = {int: int, float: float}.get(type(f.default), str)
            p.add_argument(name, type=typ, default=f.default)
    return p


def read_args(argv: Optional[List[str]] = None):
    """Parse flags, load the YAML config, sync fields, probe auto-resume.
    Returns (args: TrainArgs, cfg: ConfigDict)."""
    ns = build_arg_parser().parse_args(argv)
    args = TrainArgs(**{f.name: getattr(ns, f.name)
                        for f in dataclasses.fields(TrainArgs)})
    if args.cfg_file is None:
        raise SystemExit("--cfg_file is required")
    cfg = load_yaml_config(args.cfg_file)
    args.sync_from_config(cfg)
    os.makedirs(args.output_dir, exist_ok=True)
    # auto-resume (reference parser.py:151-154). The JAX probe tests the
    # bare path "latest", which its save_checkpoint never writes (it writes
    # latest.npz/.json); the port probes the header run_training writes
    latest = Path(args.output_dir) / "latest"
    if latest.with_suffix(".json").exists():
        args.resume_from_checkpoint = str(latest)
    return args, cfg
