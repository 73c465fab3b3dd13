"""The port's R2R teacher-forcing training against the JAX package's.

Both sides get the same world, features, converted weights and dropout
off (feature dropout and the pano encoder's hidden dropout), and the
identity candidate permutation, as tests/test_fused_teacher.py does: the
two then compute the same function, so the loss and every accumulated
gradient leaf must agree (testing.assert_grads_close), and one optimizer
step must give the same parameters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import load_agent  # noqa: E402
from navillm_tpu.agents.fused_teacher import \
    rollout_teacher_fused as j_rollout  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset  # noqa: E402
from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu.data.loaders import Dataloader, MetaLoader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu.sim import WorldModel  # noqa: E402
from navillm_tpu.training import train_loop as JTL  # noqa: E402
from navillm_tpu.training.optim import make_optimizer as j_optimizer  # noqa
from navillm_tpu.utils.config import ConfigDict  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.fused_teacher import \
    rollout_teacher_fused  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import R2RAgent, TrainArgs  # noqa
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.training.optim import make_optimizer  # noqa: E402

torch.set_num_threads(1)
MAX_ACTION_LEN = 4
ROWS_PER_CALL = 3      # several grad chunks per batch, the last one padded
# f32 on both sides: matmul sums differ in order only (JAX's own fused-vs-
# per-step test holds gradients to rtol 2e-3). Every port test holds its
# gradients to JAX's under testing.assert_grads_close at these values: the
# bound scales with the element's row where the element cancels (see
# testing.GRAD_ROW_C)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5


class _IdentityRng:
    """np_rng stand-in whose permutation is the identity."""

    def permutation(self, x):
        return np.asarray(x)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, tokenizer), dropout off."""
    tok = NavTokenizer(max_length=2048, pad_to_multiple=128)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pj, tcfg, tok


def _jax_side(models, data_dir, task_config, train_args):
    jcfg, pj, _, tok = models
    # a copy: the JAX optimizer step donates (deletes) the tree it updates
    runner = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok,
                     dims=JDims.tiny(), feat_dropout=0.0)
    args = train_args
    args.image_feat_size = jcfg.pano.image_feat_size
    args.fused_rows_per_call = ROWS_PER_CALL
    world = WorldModel(str(data_dir / "connectivity"))
    ds = load_dataset("r2r", args, task_config, training=True, source="R2R",
                      world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(jcfg.pano.image_feat_size))
    agent = load_agent("r2r", args, world, runner)
    agent.np_rng = _IdentityRng()
    return runner, agent, ds, args


def _port_side(models, data_dir, **kw):
    _, pj, tcfg, tok = models
    model = TNM.NavModel(tcfg, params_from_jax(
        jax.tree.map(np.asarray, pj), device="cpu"))
    runner = NavModelRunner(tcfg, model, tok, dims=RolloutDims.tiny(),
                            feat_dropout=0.0)
    args = TrainArgs(seed=0, image_feat_size=tcfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL, **kw)
    world = WorldModel(str(data_dir / "connectivity"))
    ds = R2RDataset(data_dir / "R2R" / "annotations" / "R2R_train_enc.json",
                    world, training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(tcfg.pano.image_feat_size))
    agent = R2RAgent(args, world, runner)
    agent.np_rng = _IdentityRng()
    return runner, agent, ds, args


def _assert_trees_close(got, want, rtol, atol, what):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def test_fused_teacher_batch_matches_jax(models, data_dir, task_config,
                                         train_args):
    jrunner, jagent, jds, jargs = _jax_side(models, data_dir, task_config,
                                            train_args)
    jrunner.zero_grads()
    jloss, jtraj = j_rollout(
        jagent, jargs, "R2R", ConfigDict({"train_max_action_len": {
            "R2R": MAX_ACTION_LEN}}), next(iter(Dataloader(jds, 2, False))),
        dataset=jds, train_ml=1.0)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jrunner.take_grads()))

    runner, agent, ds, args = _port_side(models, data_dir)
    runner.zero_grads()
    loss, traj = rollout_teacher_fused(
        agent, args, "R2R", T.train_config(MAX_ACTION_LEN).Optim,
        next(iter(Dataloader(ds, 2, False))), dataset=ds, train_ml=1.0)
    grads = grads_to_numpy(runner.model)

    assert [t["path"] for t in traj] == [t["path"] for t in jtraj]
    assert max(len(t["path"]) for t in traj) > 1
    assert runner.grad_calls > 1              # several chunks were run
    assert torch.is_tensor(loss) and loss.dim() == 0
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert sorted(grads) == sorted(jgrads), (sorted(grads), sorted(jgrads))
    T.assert_grads_close(grads, jgrads, GRAD_RTOL, GRAD_ATOL, err_msg="grad")
    # the navigation loss reaches the LLM, the heads and the pano encoder
    for name in ("llm.layers.wq", "llm.embed", "out_head.w", "pano.mapper.w",
                 "pano.encoder.qkv.w", "gmap_pos.w"):
        assert np.abs(grads[name]).sum() > 0, name


def test_train_one_epoch_matches_jax_opt_step(models, data_dir, task_config,
                                              train_args):
    """Two batches with gradient accumulation 2: one optimizer step, whose
    parameters must match make_opt_step's (warmup on, so the step's LR is
    half the peak)."""
    lr, warmup = 1e-3, 2
    stage = {"SOURCE": ["R2R"], "LOSS_COEF": {}}
    optim = {"train_max_action_len": {"R2R": MAX_ACTION_LEN}}

    jrunner, jagent, jds, jargs = _jax_side(models, data_dir, task_config,
                                            train_args)
    jargs.stage = "pretrain"
    tx = j_optimizer(lr=lr, num_warmup_steps=warmup)
    _, jloss = JTL.train_one_epoch(
        jargs, ConfigDict({"Pretrain": stage, "Multi": stage,
                           "Optim": optim}),
        jrunner, tx, tx.init(jrunner.params), JTL.make_opt_step(tx),
        MetaLoader({"R2R": (Dataloader(jds, 2, False), 1.0)}),
        {"R2R": jagent}, {"R2R": jds}, 0, None, num_batches=2)
    jparams = flatten_tree(jax.tree.map(np.asarray, jrunner.params))

    runner, agent, ds, args = _port_side(models, data_dir, stage="pretrain")
    params = dict(runner.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    ttx = make_optimizer(params, lr=lr, num_warmup_steps=warmup)
    step = TTL.make_opt_step(ttx)
    seen = {}

    def opt_step(grads):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return step(grads)

    loss, norms = TTL.train_one_epoch(
        args, T.train_config(MAX_ACTION_LEN), runner, ttx, opt_step,
        MetaLoader({"R2R": (Dataloader(ds, 2, False), 1.0)}),
        {"R2R": agent}, {"R2R": ds}, 0, None, num_batches=2)

    assert loss == pytest.approx(jloss, rel=1e-4)
    assert len(norms) == 1 and torch.isfinite(norms[0]) and norms[0] > 0
    got = {n: p.detach().numpy() for n, p in params.items()}
    assert any(not torch.equal(before[n], p) for n, p in params.items())
    # a first Adam step moves a weight by lr/2 * g / (|g| + 1e-8): by lr/2
    # where |g| >> 1e-8, by a size set by g's last digits where |g| is near
    # 1e-8. Hold the weights whose |g| > 1e-6 to 1% of the step (nearly all
    # of them), the others to the step itself.
    assert sorted(got) == sorted(jparams)
    step_size = lr / warmup
    n_held = 0
    for name, want in jparams.items():
        firm = seen[name].abs().numpy() > 1e-6
        n_held += int(firm.sum())
        np.testing.assert_allclose(got[name][firm], want[firm], rtol=0,
                                   atol=0.01 * step_size, err_msg=name)
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=1.01 * step_size, err_msg=name)
    trained = sum(int((g != 0).sum()) for g in seen.values())
    assert n_held > 0.99 * trained


def test_remat_gives_the_same_gradients(models):
    """Activation checkpointing changes memory, not the gradient."""
    _, pj, tcfg, tok = models
    batch = T.synthetic_nav_batch(tcfg, b=2, tlen=48, seed=4)
    del batch["vp_img_embeds"]
    batch["attention_mask"][1, :9] = False               # left padding
    pano = {"view_img_fts": np.random.RandomState(5).randn(
        2, 7, tcfg.pano.image_feat_size).astype(np.float32),
        "view_lens": np.array([7, 4], np.int32),
        "loc_fts": np.zeros((2, 7, 7), np.float32),
        "nav_types": np.ones((2, 7), np.int32)}
    targets = np.array([2, 3])
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, llm=dataclasses.replace(
            tcfg.llm, remat=remat))
        model = TNM.NavModel(cfg, params_from_jax(
            jax.tree.map(np.asarray, pj), device="cpu"))
        runner = NavModelRunner(cfg, model, tok, dims=RolloutDims.tiny())
        runner.zero_grads()
        loss = runner.pano_navigation_train(pano, 7, batch, targets, 0.5)
        assert torch.isfinite(loss) and loss > 0
        grads.append(grads_to_numpy(model))
    _assert_trees_close(grads[1], grads[0], 1e-6, 1e-7, "remat grad")
    assert np.abs(grads[1]["llm.layers.w_down"]).sum() > 0


def test_navigation_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 12).astype(np.float32)
    logits[:, 9:] = -1e30                                 # masked slots
    targets = np.array([0, 3, -100, 8, 1])
    for reduction in ("sum", "mean"):
        want = JNM.navigation_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   -100, reduction)
        got = TNM.navigation_loss(torch.from_numpy(logits),
                                  torch.from_numpy(targets), -100, reduction)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_pano_dropout_is_seeded_and_off_at_rate_zero(models):
    """Training-mode panorama: the same seed draws the same masks (phase 2
    and its phase-5 recompute rely on it), another seed other masks; at
    rate 0, or deterministic, it is the eval forward."""
    _, pj, tcfg, tok = models
    model = TNM.NavModel(tcfg, params_from_jax(
        jax.tree.map(np.asarray, pj), device="cpu"))
    pano = {"view_img_fts": np.random.RandomState(1).randn(
        3, 6, tcfg.pano.image_feat_size).astype(np.float32),
        "view_lens": np.array([6, 3, 5], np.int32),
        "loc_fts": np.zeros((3, 6, 7), np.float32),
        "nav_types": np.ones((3, 6), np.int32)}

    def embeds(cfg, feat_dropout, seed, deterministic=False):
        r = NavModelRunner(cfg, model, tok, dims=RolloutDims.tiny(),
                           feat_dropout=feat_dropout)
        return r.panorama_dev_dict(pano, deterministic, seed=seed)[
            "pano_embeds"]

    wet = dataclasses.replace(tcfg, pano=dataclasses.replace(
        tcfg.pano, hidden_dropout_prob=0.1))
    ref = embeds(tcfg, 0.0, 0)
    torch.testing.assert_close(embeds(wet, 0.4, 0, deterministic=True), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(embeds(tcfg, 0.0, 1), ref, rtol=0, atol=0)
    a, b = embeds(wet, 0.4, 3), embeds(wet, 0.4, 3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, embeds(wet, 0.4, 4))
    assert not torch.equal(a, ref)
    # padded views stay zero in training mode too
    assert not a[1, 3:].any()
