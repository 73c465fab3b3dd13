"""The port's training driver against the JAX package's: the YAML config
without pyyaml, the run flags, checkpoints (both ways, both backends), the
registries and loaders, and run_training at stage pretrain (against JAX,
with an injected runner) and multi (checkpoint retention and resume).
"""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load_dataset  # noqa
from navillm_tpu.data.feature_db import \
    SyntheticImageFeaturesDB as JFeatures  # noqa: E402
from navillm_tpu.data.loaders import \
    create_dataloaders as j_create_dataloaders  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.training import checkpoints as JC  # noqa: E402
from navillm_tpu.training import train_loop as JTL  # noqa: E402
from navillm_tpu.training.optim import make_optimizer as j_optimizer  # noqa
from navillm_tpu.utils import config as JCFG  # noqa: E402
from navillm_tpu_torch import train as TRAIN  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import flatten_tree, params_from_jax  # noqa
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.feature_db import \
    SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.data.loaders import create_dataloaders  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.quant import quantize_nav_params  # noqa: E402
from navillm_tpu_torch.ops.attention import \
    _check_kernel_inputs  # noqa: E402
from navillm_tpu_torch.parallel.dist import (all_gather_objects,  # noqa
                                             merge_dist_results)
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.training import checkpoints as TC  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.training.optim import make_optimizer  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402
from navillm_tpu_torch.utils.registry import AGENTS  # noqa: E402
from navillm_tpu_torch.utils import yaml_subset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*.yaml"))
LR = 1e-3

# every construct of the subset, and the scalar forms pyyaml resolves
SUBSET = """
# a comment
a: 1   # trailing comment
b: 'it''s # no comment'
c: "tab\\there: # no comment"
d: [1, 2.5, -3, 1e3, 1.0e-3, .5, 0x1f, 017, 0b11, 1_000, true, No, ~, null,
    '', "q", .inf, -.Inf, +7, 08]
e: {x: 1, 'y': [a, b], z: {w: ON},
    }
f:
- 1
- - 2
  - 3
- k: v
  k2: [4]
-
  m: n
g:
  h:
    i: {
      "k": 1,
      "l": 2,
    }
empty_map: {}
empty_list: []
none:
plain: hello world
colon: a:b
"quoted key": yes
"""

# a run_training config: R2R only, both stages
RUN_CFG = """
Feature:
  image_feat_size: 32
  angle_feat_size: 4
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {
      "train": "annotations/R2R_train_enc.json",
      "val_unseen": "annotations/R2R_val_unseen_enc.json",
    }
Pretrain:
  SOURCE: ['R2R']
  Ratio: [1]
  LOSS_COEF: {}
Multi:
  SOURCE: ['R2R']
  Ratio: [1]
  LOSS_COEF: {}
Model:
  num_pano_layers: 2
  enc_full_graph: True
  expert_policy: "spl"
Optim:
  train_max_action_len: {"R2R": 4}
  val_max_action_len: {"R2R": 5}
"""


# ------------------------------------------------------------ config --- #
@pytest.mark.parametrize("path", CONFIGS)
def test_load_yaml_config_matches_pyyaml(path):
    want = yaml.safe_load((ROOT / path).read_text())
    got = TCFG.load_yaml_config(ROOT / path)
    assert isinstance(got, TCFG.ConfigDict) and got == want
    assert got == JCFG.load_yaml_config(ROOT / path)


def test_yaml_subset_matches_pyyaml_and_refuses_the_rest():
    got, want = yaml_subset.safe_load(SUBSET), yaml.safe_load(SUBSET)
    assert repr(got) == repr(want)            # types too (1 vs 1.0, True)
    for text in ("[1, 2]", "", "- a\n- b", "a: -1.5\nb: 1.\nc: 3.e+2"):
        assert repr(yaml_subset.safe_load(text)) == \
            repr(yaml.safe_load(text))
    for text in ("a: |\n  x\n", "a: &x 1\nb: *x\n", "a: !!str 1\n",
                 "a: {b: 1\n"):
        with pytest.raises(ValueError):
            yaml_subset.safe_load(text)


def test_train_args_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JCFG.TrainArgs)}
    tf = {f.name: f.default for f in dataclasses.fields(TCFG.TrainArgs)}
    assert {k: v for k, v in tf.items() if k != "device"} == jf
    assert tf["device"] == "cuda"
    argv = ["--cfg_file", "c.yaml", "--no-streaming_eval", "--lr", "0.5",
            "--test_datasets", "R2R", "CVDN", "--max_datapoints", "3",
            "--stage", "pretrain", "--dagger_streams", "4"]
    jns = vars(JCFG.build_arg_parser().parse_args(argv))
    tns = vars(TCFG.build_arg_parser().parse_args(argv + ["--device",
                                                          "cpu"]))
    assert tns.pop("device") == "cpu" and tns == jns
    cfg = TCFG.load_yaml_config(ROOT / "configs/multi.yaml")
    a = TCFG.TrainArgs().sync_from_config(cfg)
    b = JCFG.TrainArgs().sync_from_config(cfg)
    assert {k: v for k, v in a.__dict__.items() if k != "device"} \
        == b.__dict__


def test_read_args_and_the_resume_probe(tmp_path):
    argv = ["--cfg_file", str(ROOT / "configs/multi.yaml"), "--output_dir",
            str(tmp_path / "out"), "--seed", "3"]
    args, cfg = TCFG.read_args(argv + ["--device", "cpu"])
    jargs, jcfg = JCFG.read_args(argv)
    assert cfg == jcfg and args.device == "cpu"
    assert {k: v for k, v in args.__dict__.items() if k != "device"} \
        == jargs.__dict__
    assert args.resume_from_checkpoint is None
    # a checkpoint run_training wrote: read_args resumes from it
    TC.save_checkpoint(tmp_path / "out" / "latest",
                       {"w": torch.zeros(2)}, epoch=0)
    args, _ = TCFG.read_args(argv)
    assert args.resume_from_checkpoint == str(tmp_path / "out" / "latest")
    with pytest.raises(SystemExit):
        TCFG.read_args(["--output_dir", str(tmp_path)])


# ------------------------------------------------------- checkpoints --- #
@pytest.fixture(scope="module")
def tiny():
    tok = NavTokenizer(max_length=2048, pad_to_multiple=128)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0))
    trees = [JNM.init_nav_params(jax.random.PRNGKey(k), jcfg) for k in (0, 1)]
    return tok, jcfg, tcfg, trees


def _port_model(tiny, key):
    tcfg, pj = tiny[2], tiny[3][key]
    return TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                              device="cpu"))


def _port_opt_after_a_step(model, seed):
    tx = make_optimizer(dict(model.named_parameters()), lr=LR,
                        num_warmup_steps=2)
    g = torch.Generator().manual_seed(seed)
    tx.step({n: torch.randn(p.shape, generator=g, dtype=p.dtype)
             for n, p in model.named_parameters()})
    return tx


def test_jax_checkpoint_restores_into_port(tiny, tmp_path):
    params = tiny[3][0]
    tx = j_optimizer(lr=LR, num_warmup_steps=2)
    state = tx.init(params)
    # the state after one step: count 1, moments from a seed
    rng = np.random.RandomState(0)
    adam = state[1][0]
    adam = adam._replace(
        count=jnp.asarray(1, jnp.int32),
        mu=jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                        adam.mu),
        nu=jax.tree.map(lambda x: rng.rand(*x.shape).astype(np.float32),
                        adam.nu))
    state = (state[0], (adam,) + tuple(state[1][1:]))
    JC.save_checkpoint(tmp_path / "ck", params, state, epoch=4)
    assert (tmp_path / "ck.npz").exists()

    model = _port_model(tiny, 1)
    opt = make_optimizer(dict(model.named_parameters()), lr=LR,
                         num_warmup_steps=2)
    _, _, resume = TC.load_checkpoint(tmp_path / "ck", model, opt)
    assert resume == 5 and opt.count == 1
    want = flatten_tree(jax.tree.map(np.asarray, params))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    adam = state[1][0]
    mu = flatten_tree(jax.tree.map(np.asarray, adam.mu))
    nu = flatten_tree(jax.tree.map(np.asarray, adam.nu))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(opt.mu[name].numpy(), mu[name])
        np.testing.assert_array_equal(opt.nu[name].numpy(), nu[name])


def test_port_checkpoint_restores_into_jax(tiny, tmp_path):
    model = _port_model(tiny, 0)
    opt = _port_opt_after_a_step(model, 2)
    TC.save_checkpoint(tmp_path / "ck", model, opt, epoch=2)
    header = json.loads((tmp_path / "ck.json").read_text())
    assert header == {"epoch": 2, "backend": "npz", "has_opt": True}

    live = tiny[3][1]
    tx = j_optimizer(lr=LR, num_warmup_steps=2)
    params, state, resume = JC.load_checkpoint(tmp_path / "ck", live,
                                               tx.init(live))
    assert resume == 3
    assert int(state[1][0].count) == 1 and int(state[1][2].count) == 1
    got = flatten_tree(jax.tree.map(np.asarray, params))
    mu = flatten_tree(jax.tree.map(np.asarray, state[1][0].mu))
    nu = flatten_tree(jax.tree.map(np.asarray, state[1][0].nu))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(got[name], p.detach().numpy())
        np.testing.assert_array_equal(mu[name], opt.mu[name].numpy())
        np.testing.assert_array_equal(nu[name], opt.nu[name].numpy())


def test_torch_backend_is_bit_exact_in_bf16(tiny, tmp_path, monkeypatch):
    tok = tiny[0]
    llm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=torch.bfloat16)
    cfg = TNM.NavModelConfig(llm=llm, pano=PanoConfig.tiny(
        output_size=llm.hidden_size, dtype=torch.bfloat16))
    from navillm_tpu_torch.convert import init_nav_params

    def model(seed):
        return TNM.NavModel(cfg, init_nav_params(
            cfg, torch.Generator().manual_seed(seed), device="cpu"))
    src = model(0)
    opt = _port_opt_after_a_step(src, 3)
    # above the threshold "auto" picks the torch backend
    monkeypatch.setattr(TC, "TORCH_THRESHOLD_BYTES", 1)
    TC.save_checkpoint(tmp_path / "ck", src, opt, epoch=0)
    assert json.loads((tmp_path / "ck.json").read_text())["backend"] \
        == "torch"
    assert (tmp_path / "ck.pt").exists()
    assert not (tmp_path / "ck.npz").exists()
    state_bytes = sum(p.numel() * p.element_size() for p in src.parameters())
    assert os.path.getsize(tmp_path / "ck.pt") < 3 * state_bytes + 2 ** 20

    dst = model(1)
    opt2 = make_optimizer(dict(dst.named_parameters()), lr=LR)
    _, _, resume = TC.load_checkpoint(tmp_path / "ck", dst, opt2)
    assert resume == 1 and opt2.count == 1
    for (n, a), b in zip(src.named_parameters(), dst.parameters()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b), n
        assert torch.equal(opt.mu[n], opt2.mu[n])
        assert torch.equal(opt.nu[n], opt2.nu[n])


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *a):
        self.lines.append(msg % a if a else msg)


@pytest.mark.parametrize("backend", ["npz", "torch"])
def test_restore_is_shape_tolerant(tmp_path, backend):
    saved = {"a": torch.arange(6.0).reshape(2, 3), "nest.b": torch.ones(4),
             "nest.c": torch.full((2, 2), 3.0)}
    TC.save_checkpoint(tmp_path / "ck", saved, epoch=None, backend=backend)
    live = {"a": torch.zeros(5, 3), "nest.b": torch.zeros(4),
            "nest.c": torch.zeros(2, 2), "new": torch.zeros(3)}
    log = _Log()
    _, _, resume = TC.load_checkpoint(tmp_path / "ck", live, logger=log)
    assert resume == 0
    assert not live["a"].any() and not live["new"].any()
    assert torch.equal(live["nest.b"], saved["nest.b"])
    assert torch.equal(live["nest.c"], saved["nest.c"])
    assert log.lines == ["Ignore weight params/a: (2, 3) (model wants "
                         "(5, 3))"]
    if backend == "npz":     # the JAX restore skips it too
        jlive = {"a": jnp.zeros((5, 3)), "nest": {"b": jnp.zeros(4),
                                                  "c": jnp.zeros((2, 2))}}
        p, _, _ = JC.load_checkpoint(tmp_path / "ck", jlive)
        assert not np.asarray(p["a"]).any()
        np.testing.assert_array_equal(np.asarray(p["nest"]["c"]), 3.0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_round_trips_byte_for_byte(tiny, tmp_path, bits):
    tcfg = tiny[2]
    src = TNM.NavModel(tcfg, quantize_nav_params(_port_model(tiny, 0), bits))
    TC.save_checkpoint(tmp_path / "ck", src)
    dst = TNM.NavModel(tcfg, quantize_nav_params(_port_model(tiny, 1), bits))
    TC.load_checkpoint(tmp_path / "ck", dst)
    kinds = set()
    for (n, a), b in zip(src.named_parameters(), dst.parameters()):
        kinds.add(a.dtype)
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert {torch.int8, torch.uint8} & kinds


def test_orbax_checkpoint_raises(tmp_path):
    (tmp_path / "big.orbax").mkdir()
    (tmp_path / "big.json").write_text(json.dumps({"epoch": 1,
                                                   "backend": "orbax"}))
    assert TC.checkpoint_exists(tmp_path / "big")
    with pytest.raises(RuntimeError, match="orbax"):
        TC.load_checkpoint(tmp_path / "big", {"w": torch.zeros(1)})


# ----------------------------------------- registries, loaders, helpers --- #
def test_registries_loaders_and_helpers(train_args, task_config, data_dir):
    world = WorldModel(str(data_dir / "connectivity"))
    jworld = JWorld(str(data_dir / "connectivity"))
    args = TCFG.TrainArgs(data_dir=str(data_dir), batch_size=2, device="cpu")
    # every task of the JAX package is registered, dataset and agent; a
    # name JAX does not register ("coco": a feature store's key) raises
    # KeyError in both
    for name in ("coco", "nope"):
        for build in (lambda n: load_agent(n, args, world, None),
                      lambda n: load_dataset(n, args, task_config),
                      lambda n: j_load_dataset(n, train_args, task_config)):
            with pytest.raises(KeyError):
                build(name)
    for name, source in (("reverie", "REVERIE"), ("soon", "SOON"),
                         ("cvdn", "CVDN"), ("scanqa", "ScanQA"),
                         ("llava", "LLaVA")):
        ds = load_dataset(name, args, task_config, source=source,
                          world=world)
        jds = j_load_dataset(name, train_args, task_config, source=source,
                             world=jworld)
        assert ds.alldata == jds.alldata and ds.name == name
        assert AGENTS.get(name).name == name
    for name in ("r2r_aug", "reverie_aug", "eqa"):
        assert AGENTS.get(name).name == name

    for training in (True, False):
        ds = load_dataset("r2r", args, task_config, training=training,
                          source="R2R", world=world)
        jds = j_load_dataset("r2r", train_args, task_config,
                             training=training, source="R2R", world=jworld)
        assert ds.split == jds.split and ds.alldata == jds.alldata

    cfg = TCFG.ConfigDict({**task_config, "Multi": {
        "SOURCE": ["R2R"], "Ratio": [3]}})
    jcfg = JCFG.ConfigDict(cfg)
    loaders, datasets = create_dataloaders(
        args, cfg, training=True, world=world,
        feat_dbs={"mp3d": SyntheticImageFeaturesDB(32)}, stage="multi")
    jloaders, _ = j_create_dataloaders(
        train_args, jcfg, training=True, world=jworld,
        feat_dbs={"mp3d": JFeatures(32)}, stage="multi")
    (loader, ratio), = loaders.values()
    (jloader, jratio), = jloaders.values()
    assert ratio == jratio == 3.0 and len(loader) == len(jloader)
    assert [b["instr_id"] for b in loader] == [b["instr_id"] for b in jloader]

    assert merge_dist_results(all_gather_objects([1, 2])) == [1, 2]
    assert TTL.build_mesh_plan(args) is None
    with pytest.raises(ValueError, match="one process per card"):
        TTL.build_mesh_plan(dataclasses.replace(args, tp_size=2))
    res = {"R2R": {"spl": 30.0}}
    score_cfg = JCFG.ConfigDict({"Multi": {"SOURCE": ["R2R", "CVDN"]}})
    assert TTL.calc_overall_score(res, score_cfg) \
        == JTL.calc_overall_score(res, score_cfg) == 0.5


def test_build_runner_and_the_cli(tmp_path, monkeypatch):
    args = TCFG.TrainArgs(device="cpu", seed=1)
    runner = TTL.build_runner(args, None)
    assert runner.device.type == "cpu"
    shapes = {n: tuple(p.shape) for n, p in runner.model.named_parameters()}
    jtiny = JNM.NavModelConfig.tiny(vocab_size=runner.tok.vocab_size,
                                    use_obj=False)
    want = flatten_tree(jax.tree.map(
        lambda x: tuple(x.shape),
        JNM.init_nav_params(jax.random.PRNGKey(0), jtiny)))
    assert shapes == want
    # a pretrained path is read (tests/test_torch_pretrained.py); one with
    # no tokenizer.json raises
    for kw, err, match in ((dict(pretrained_model_name_or_path="x"),
                            FileNotFoundError, "tokenizer.json"),
                           (dict(quantize_llm=True), ValueError,
                            "eval-only")):
        with pytest.raises(err, match=match):
            TTL.build_runner(dataclasses.replace(args, **kw), None)

    seen = {}
    monkeypatch.setattr(TRAIN, "run_training",
                        lambda a, c, logger: seen.update(args=a, cfg=c)
                        or {"R2R": {"spl": 1.0}})
    out = TRAIN.main(["--cfg_file", str(ROOT / "configs/multi.yaml"),
                      "--output_dir", str(tmp_path), "--device", "cpu",
                      "--stage", "multi"])
    assert out == {"R2R": {"spl": 1.0}}
    assert seen["args"].device == "cpu" and seen["args"].stage == "multi"
    assert seen["cfg"].Multi.SOURCE[0] == "R2R"
    assert (tmp_path / "train.log").exists()


def test_the_card_config_is_one_the_kernels_take():
    """build_runner's card model: every LLM layer must pass the attention
    kernels' input check (bf16, head_dim 64 or 128); the CPU model is
    JAX's f32 tiny one, which the check refuses."""
    args = TCFG.TrainArgs()
    card = TTL.tiny_config(args, 512, "cuda")
    cpu = TTL.tiny_config(args, 512, "cpu")
    assert cpu == TNM.NavModelConfig(
        llm=TL.LlamaConfig.tiny(vocab_size=512),
        pano=PanoConfig.tiny(output_size=128), angle_feat_size=4)
    assert card.llm.dtype == card.pano.dtype == torch.bfloat16
    assert card.llm.head_dim == 64 and card.llm.num_layers == 2
    assert card.pano.output_size == card.llm.hidden_size
    mask = torch.ones((1, 8), dtype=torch.bool)
    for c, ok in ((card, True), (cpu, False)):
        q = torch.zeros((1, 8, c.llm.num_heads, c.llm.head_dim),
                        dtype=c.llm.dtype)
        if ok:
            _check_kernel_inputs(q, q, q, mask, True)
        else:
            with pytest.raises(ValueError):
                _check_kernel_inputs(q, q, q, mask, True)
    with pytest.raises(ValueError, match="bf16"):
        TTL.tiny_config(dataclasses.replace(args, precision="fp32"), 512,
                        "cuda")


def _other_value(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v + 1
    return 3 if v is None else v + "_x"


@pytest.mark.parametrize("flag", sorted(TCFG.UNPORTED))
def test_unported_flags_raise_naming_their_item(flag):
    """A flag of a path the port does not run parses as in JAX, and
    run_training refuses it set to anything but its default."""
    default = getattr(TCFG.TrainArgs(), flag)
    assert getattr(JCFG.TrainArgs(), flag) == default
    args = dataclasses.replace(TCFG.TrainArgs(device="cpu"),
                               **{flag: _other_value(default)})
    match = "neither" if flag == "workers" else "ROADMAP A"
    with pytest.raises(NotImplementedError, match=match):
        TTL.run_training(args, None)
    TCFG.check_ported(TCFG.TrainArgs())


# ------------------------------------------------------ run_training --- #
def _run_args(cls, data_dir, out, **kw):
    return cls(**{**dict(data_dir=str(data_dir), output_dir=str(out),
                         num_epochs=1, num_steps_per_epoch=2,
                         gradient_accumulation_step=2, batch_size=2,
                         val_batch_size=2, image_feat_size=32, lr=LR,
                         feat_dropout=0.0, fused_rows_per_call=3, seed=0),
                  **kw})


def test_run_training_pretrain_matches_jax(tiny, data_dir, tmp_path,
                                           monkeypatch):
    """One pretrain epoch of 2 batches (one optimizer step), validation
    and the periodic checkpoint, JAX and port on the same weights with
    dropout off: the same losses, scores and checkpoint."""
    tok, jcfg, tcfg, (pj, _) = tiny
    common = dict(stage="pretrain", save_ckpt_per_epochs=1)
    losses = {}

    def recorder(module, key, pick):
        orig = module.train_one_epoch

        def wrapped(*a, **k):
            out = orig(*a, **k)
            losses[key] = pick(out)
            return out
        monkeypatch.setattr(module, "train_one_epoch", wrapped)

    recorder(JTL, "jax", lambda out: out[1])
    recorder(TTL, "port", lambda out: out[0])

    jrunner = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok,
                      dims=JDims.tiny(), feat_dropout=0.0)
    jres = JTL.run_training(
        _run_args(JCFG.TrainArgs, data_dir, tmp_path / "jax", **common),
        JCFG.ConfigDict(yaml.safe_load(RUN_CFG)), world=JWorld(
            str(data_dir / "connectivity")),
        feat_dbs={"mp3d": JFeatures(32)}, obj_feat_dbs={}, runner=jrunner)

    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    runner = NavModelRunner(tcfg, model, tok, dims=RolloutDims.tiny(),
                            feat_dropout=0.0)
    res = TTL.run_training(
        _run_args(TCFG.TrainArgs, data_dir, tmp_path / "port", device="cpu",
                  **common),
        TCFG.load_yaml_text(RUN_CFG), world=WorldModel(
            str(data_dir / "connectivity")),
        feat_dbs={"mp3d": SyntheticImageFeaturesDB(32)}, runner=runner)

    assert losses["port"] == pytest.approx(losses["jax"], rel=1e-4)
    assert list(res) == list(jres) == ["R2R"]
    for k, v in jres["R2R"].items():
        assert res["R2R"][k] == pytest.approx(float(v), rel=1e-6, abs=1e-9), k
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) \
        == ["pretrain_0.json", "pretrain_0.npz"]
    got = np.load(tmp_path / "port" / "pretrain_0.npz")
    want = np.load(tmp_path / "jax" / "pretrain_0.npz")
    assert sorted(got.files) == sorted(want.files)
    # one Adam step moves a weight by ~LR; where the two gradients are
    # both ~0 their last digits decide, so hold 99% of the weights to 1%
    # of the step and all to the step
    close = total = 0
    for k in want.files:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 1.01 * LR, k
        close += int((d <= 0.01 * LR).sum())
        total += d.size
    assert close > 0.99 * total
    init = flatten_tree(jax.tree.map(np.asarray, pj))
    assert any(np.abs(got["params/" + n.replace(".", "/")] - v).max() > 0
               for n, v in init.items())          # the step moved them


def test_run_training_multi_retention_and_resume(data_dir, tmp_path,
                                                 monkeypatch):
    """Stage multi through build_runner (teacher and DAgger batches): the
    optimizer steps, SR is reported, max_saved_checkpoints=1 keeps only
    the best epoch over 2, latest is written, and a run with
    resume_from_checkpoint continues from latest's epoch + 1 with its
    weights and AdamW state."""
    cfg = TCFG.load_yaml_text(RUN_CFG)
    args = _run_args(TCFG.TrainArgs, data_dir, tmp_path, device="cpu",
                     stage="multi", num_epochs=2, max_saved_checkpoints=1,
                     save_latest_states=True)
    args.sync_from_config(cfg)
    runner = TTL.build_runner(args, cfg)
    before = {n: p.detach().clone()
              for n, p in runner.model.named_parameters()}
    # a better score each epoch, so epoch 0's checkpoint gives way
    scores = iter([0.1, 0.2, 0.3])
    monkeypatch.setattr(TTL, "calc_overall_score",
                        lambda results, cfg: next(scores))
    epochs = []
    orig = TTL.train_one_epoch

    def recorded(*a, **k):
        epochs.append(a[8])
        return orig(*a, **k)
    monkeypatch.setattr(TTL, "train_one_epoch", recorded)
    feats = {"mp3d": SyntheticImageFeaturesDB(32)}
    res = TTL.run_training(args, cfg, feat_dbs=feats, runner=runner)

    assert epochs == [0, 1] and "sr" in res["R2R"]
    assert any(not torch.equal(before[n], p)
               for n, p in runner.model.named_parameters())
    assert runner.cached_steps > 0                # the DAgger half ran
    assert not TC.checkpoint_exists(tmp_path / "epoch_0")
    assert TC.checkpoint_exists(tmp_path / "epoch_1")
    assert TC.checkpoint_exists(tmp_path / "latest")
    assert json.loads((tmp_path / "latest.json").read_text()) == {
        "epoch": 1, "backend": "npz", "has_opt": True}

    saved = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    resumed = TTL.build_runner(args, cfg)       # fresh weights, same seed
    epochs.clear()
    loaded = {}
    orig_load = TTL.load_checkpoint

    def load(path, params, opt, logger):
        out = orig_load(path, params, opt, logger)
        loaded.update({n: p.detach().clone()
                       for n, p in params.named_parameters()})
        loaded["count"] = opt.count
        return out
    monkeypatch.setattr(TTL, "load_checkpoint", load)
    args3 = dataclasses.replace(args, num_epochs=3, resume_from_checkpoint=str(
        tmp_path / "latest"))
    TTL.run_training(args3, cfg, feat_dbs=feats, runner=resumed)
    assert epochs == [2] and loaded.pop("count") == 2
    for n, p in saved.items():
        assert torch.equal(loaded[n], p), n
    # the resumed run ranks its own epochs: it keeps epoch_2 beside epoch_1
    assert TC.checkpoint_exists(tmp_path / "epoch_2")
