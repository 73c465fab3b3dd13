"""Data and tensor parallelism of the port (navillm_tpu_torch/parallel/
mesh.py, the TP collectives of models/llama.py, ZeRO-1 in
training/optim.py, sharded checkpoints, run_training) over real gloo
process groups of two or four CPU processes, against one port process and
against the JAX package's mesh (tests/conftest.py's 8 virtual devices).

Each test spawns its processes once (navillm_tpu_torch.testing.spawn_gloo);
the workers import no JAX. Tolerances: port against port in f32 rtol 1e-5,
atol 1e-6 (the collectives only reassociate sums), the atol of a gradient
leaf 2e-6 times its largest magnitude (the embedding's gradient sums
every position's, up to ~5 here); the ZeRO-1 parameters
rtol 1e-5, atol 1e-7 as tests/test_mesh.py holds them; losses against
JAX's mesh 1e-4 relative as tests/test_mesh.py; gradients against JAX at
the repository's port-vs-JAX gradient tolerance (tests/test_torch_train.py:
rtol 2e-3, atol 2e-5).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import flatten_tree, params_from_jax  # noqa
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu_torch.parallel import mesh as M  # noqa: E402
from navillm_tpu_torch.training.optim import make_optimizer  # noqa: E402

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-5, atol=1e-6)
GRAD_VS_JAX = dict(rtol=2e-3, atol=2e-5)
# the clip binds, so the global norm over the model group matters; the
# 8-bit runs do not clip (the norms of two packages part in their last
# ulps, which can flip a code: tests/test_torch_optim8.py)
LR, CLIP, NO_CLIP = 1e-3, 0.05, 40.0
STOP_BIAS = -0.8


def _tok():
    return NavTokenizer(max_length=2048, pad_to_multiple=128)


def _tcfg(hidden=128, inter=256, act_int8=False):
    llm = TL.LlamaConfig.tiny(vocab_size=_tok().vocab_size,
                              hidden_size=hidden, intermediate_size=inter,
                              act_int8=act_int8)
    return TNM.NavModelConfig(llm=llm, pano=PanoConfig.tiny(
        output_size=hidden, hidden_dropout_prob=0.0, use_obj=False))


def _jcfg(hidden=128, inter=256, act_int8=False):
    from navillm_tpu.models import nav_model as JNM
    from navillm_tpu.models.pano_encoder import PanoConfig as JPano
    llm = JNM.L.LlamaConfig.tiny(vocab_size=_tok().vocab_size,
                                 hidden_size=hidden, intermediate_size=inter,
                                 act_int8=act_int8)
    return JNM.NavModelConfig(llm=llm, pano=JPano.tiny(
        output_size=hidden, hidden_dropout_prob=0.0, use_obj=False))


def _jax_side(hidden=128, inter=256, bits=16, act_int8=False,
              stop_bias=None):
    """(JAX cfg, JAX params, the params as a numpy tree)."""
    import jax
    from navillm_tpu.models import nav_model as JNM
    from navillm_tpu.models import quant as JQ
    jcfg = _jcfg(hidden, inter, act_int8)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    if stop_bias is not None:
        pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(stop_bias)
    if bits != 16:
        pj = dict(pj, llm=JQ._quantize_llama_impl(pj["llm"], bits))
    return jcfg, pj, jax.tree.map(np.asarray, pj)


def _jax_mesh(dp, tp):
    import jax
    from navillm_tpu.parallel.mesh import make_mesh
    return make_mesh(dp_size=dp, tp_size=tp,
                     devices=jax.devices()[: dp * tp])


# the byte tokenizer's R2R prompts outgrow RolloutDims.tiny()'s prefix
MAX_PREFIX = 1024


def _runner(tree, cfg, plan=None):
    model = TNM.NavModel(cfg, params_from_jax(tree, device="cpu"))
    dims = dataclasses.replace(RolloutDims.tiny(), max_prefix=MAX_PREFIX)
    return NavModelRunner(cfg, model, _tok(), dims=dims, feat_dropout=0.0,
                          mesh_plan=plan)


def _grad_close(got, want, name):
    """Port against port gradients: TIGHT, the atol per unit of the leaf's
    largest magnitude."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6 * scale,
                               err_msg=name)


def _whole(t, spec, plan):
    """A model-split shard made whole (the model group's all-gather)."""
    ax = M.tp_axis(spec)
    return t if ax is None else plan.model.all_gather(t, dim=ax)


def _whole_params(runner, plan):
    return {n: _whole(p.detach(), runner.param_specs.get(n, ()), plan)
            .float().numpy() for n, p in runner.model.named_parameters()}


class _IdentityRng(np.random.RandomState):
    """np_rng whose candidate permutation is the identity (the other draws
    are RandomState's)."""

    def permutation(self, x):
        return np.asarray(x)


# ------------------------------------------------ specs and local shards -- #
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_partition_specs_match_jax(bits):
    import jax
    from navillm_tpu.parallel.mesh import nav_param_specs as j_specs
    cfg = _tcfg()
    quantized = bits != 16
    got = M.nav_param_specs(cfg, quantized=quantized,
                            bits=bits if quantized else 8)
    want = j_specs(_jcfg(), quantized=quantized,
                   bits=bits if quantized else 8)
    flat_got = M.flat_specs(got)
    flat_want = {".".join(k.key for k in path): tuple(spec)
                 for path, spec in jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(
                         x, jax.sharding.PartitionSpec))[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for name, spec in flat_want.items():
        if bits == 4 and name.endswith(".s") and ".layers." in name:
            # JAX replicates the int4 group scales; the port slices them
            # with their weight
            assert flat_got[name] == flat_got[name[:-2] + ".q4p"], name
            assert spec == (None, None, None), name
        else:
            assert flat_got[name] == spec, name


def _fake_plan(tp_rank, tp=2):
    """A plan's coordinates without a process group (local_slice and
    shard_params read only the sizes and ranks)."""
    one = M.Group([0], None, "none")
    return M.MeshPlan(dp_size=1, tp_size=tp, rank=tp_rank, world_size=tp,
                      data=one, model=one, device=torch.device("cpu"),
                      backend="none")


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_local_shards_rebuild_the_tree(bits):
    """Every rank's shard has the split shape (test_mesh.py:18-31's wq
    (L, h, o/2)), the shards concatenate to the whole leaf, and the
    unsplit leaves (the panorama encoder, the norms) stay whole."""
    _, _, tree = _jax_side(hidden=256, inter=512, bits=bits)
    cfg = _tcfg(hidden=256, inter=512)
    quantized = bits != 16
    specs = M.nav_param_specs(cfg, quantized=quantized,
                              bits=bits if quantized else 8)
    full = flatten_tree(params_from_jax(tree, device="cpu"))
    shards = [flatten_tree(M.shard_params(params_from_jax(tree, "cpu"),
                                          specs, _fake_plan(r)))
              for r in (0, 1)]
    flat = M.flat_specs(specs)
    wq = "llm.layers.wq" + {16: "", 8: ".q", 4: ".q4p"}[bits]
    L, h, o = full[wq].shape
    assert shards[0][wq].shape == (L, h, o // 2)
    for name, leaf in full.items():
        ax = M.tp_axis(flat.get(name, ()))
        if ax is None:
            assert all(torch.equal(s[name], leaf) for s in shards), name
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], ax),
                               leaf), name
            assert all(s[name].is_contiguous() for s in shards)
    assert shards[0]["pano.mapper.w"].shape == full["pano.mapper.w"].shape


def test_int4_splits_keep_pairs_and_groups():
    """A column split must leave whole nibble pairs, a row split whole
    128-wide groups."""
    spec = {"w": {"q4p": (None, "model"), "s": (None, "model")}}
    odd = {"w": {"q4p": torch.zeros((128, 3), dtype=torch.uint8),
                 "s": torch.ones((1, 6))}}
    with pytest.raises(ValueError, match="nibble pair"):
        M.shard_params(odd, spec, _fake_plan(0))
    row = {"w": {"q4p": ("model", None), "s": ("model", None)}}
    one_group = {"w": {"q4p": torch.zeros((128, 4), dtype=torch.uint8),
                       "s": torch.ones((1, 8))}}
    with pytest.raises(ValueError, match="int4 groups"):
        M.shard_params(one_group, row, _fake_plan(0))


# ------------------------------------------------------ the train step -- #
def _w_train_step(rank, tree, batch, dp, tp):
    plan = M.make_mesh(dp, tp, device="cpu")
    runner = _runner(tree, _tcfg(), plan)
    b = batch["input_ids"].shape[0] // dp
    local = {k: v[plan.dp_rank * b:(plan.dp_rank + 1) * b]
             for k, v in batch.items()}
    runner.zero_grads()
    logits, _, loss = runner.navigation(local, targets=np.full((b,), 2),
                                        coef=1.0 / b, train=True)
    grads = runner.take_grads()
    return {"loss": loss, "logits": logits, "dp_rank": plan.dp_rank,
            "grads": {n: _whole(g, runner.param_specs.get(n, ()), plan)
                      .numpy() for n, g in grads.items()}}


@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2)], ids=["dp2", "dp2xtp2"])
def test_train_step_matches_jax_mesh(dp, tp):
    """Each data-group rank takes its half of a 4-row batch with its own
    coefficient 1/2; the gradients averaged over the data group are the
    gradient of the concatenated batch at 1/4: JAX's mesh step on it and
    one port process on it."""
    from navillm_tpu.agents.runner import NavModelRunner as JRunner
    from navillm_tpu.agents.runner import RolloutDims as JDims
    from navillm_tpu.testing import synthetic_nav_batch
    import jax
    jcfg, pj, tree = _jax_side()
    batch = synthetic_nav_batch(jcfg, b=4, g=12, v=8, c=8, hh=4, tlen=64)
    targets = np.full((4,), 2, np.int64)
    plan = _jax_mesh(dp, tp)
    jr = JRunner(jcfg, pj, _tok(), dims=JDims.tiny(), mesh_plan=plan)
    jr.zero_grads()
    with plan.mesh:
        jlogits, _, jloss = jr.navigation(batch, targets=targets,
                                          coef=0.25, train=True)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))

    one = _runner(tree, _tcfg())
    one.zero_grads()
    logits1, _, loss1 = one.navigation(batch, targets=targets, coef=0.25,
                                       train=True)
    grads1 = {n: g.numpy() for n, g in one.take_grads().items()}

    res = T.spawn_gloo(_w_train_step, dp * tp, tree, batch, dp, tp)
    by_dp = {r["dp_rank"]: r for r in res}
    loss = sum(r["loss"] for r in by_dp.values()) / dp
    assert loss == pytest.approx(loss1, rel=1e-5)
    assert loss == pytest.approx(jloss, rel=1e-4)
    np.testing.assert_allclose(np.concatenate(
        [by_dp[d]["logits"] for d in range(dp)]), logits1, **TIGHT)
    np.testing.assert_allclose(logits1, jlogits, rtol=2e-4, atol=2e-4)
    for r in res[1:]:                 # every rank holds the same gradient
        for n, g in r["grads"].items():
            np.testing.assert_array_equal(g, res[0]["grads"][n])
    for n, g in res[0]["grads"].items():
        _grad_close(g, grads1[n], n)
        np.testing.assert_allclose(g, jgrads[n], err_msg=n, **GRAD_VS_JAX)
    assert np.abs(res[0]["grads"]["llm.layers.wq"]).sum() > 0


# ------------------------------------------------------------- ZeRO-1 --- #
def _grads(tree, seed):
    """Synthetic whole gradients {name: f32 array} of a numpy tree."""
    flat = flatten_tree(tree)
    return {n: (np.random.RandomState(seed * 1000 + i).randn(*v.shape)
                * 0.01).astype(np.float32)
            for i, (n, v) in enumerate(sorted(flat.items()))}


def _steps(runner, tx, tree, plan=None, n=2):
    for seed in range(n):
        g = _grads(tree, seed)
        tx.step({k: (M.local_slice(torch.from_numpy(g[k]),
                                   runner.param_specs.get(k, ()), plan)
                     if plan is not None else torch.from_numpy(g[k]))
                 .clone() for k in g})


def _optimizer(runner, plan, bits8, zero1=True):
    tx = make_optimizer(dict(runner.model.named_parameters()), lr=LR,
                        grad_clip_norm=NO_CLIP if bits8 else CLIP,
                        moments_8bit=bits8)
    if plan is not None:
        tx.set_plan(plan, runner.param_specs)
        if zero1:
            M.zero1_shard_opt_state(tx, plan, min_size=1024)
    return tx


def _w_zero1(rank, tree, dp, tp, bits8):
    plan = M.make_mesh(dp, tp, device="cpu")
    runner = _runner(tree, _tcfg(), plan)
    tx = _optimizer(runner, plan, bits8)
    rep = _optimizer(_runner(tree, _tcfg(), plan), plan, bits8, zero1=False)
    _steps(runner, tx, tree, plan)
    return {"params": _whole_params(runner, plan),
            "moment_bytes": tx.moment_bytes(),
            "replicated_bytes": rep.moment_bytes(),
            "axes": {n: ax for n, (_, ax) in tx.layout.items()}}


@pytest.mark.parametrize("dp,tp,bits8", [(2, 1, False), (2, 2, False),
                                         (2, 1, True)],
                         ids=["adamw-dp2", "adamw-dp2xtp2", "adamq8-dp2"])
def test_zero1_matches_replicated_and_jax(dp, tp, bits8):
    """Two ZeRO-1 steps (moments sliced over the data group, the clip's
    norm over the model group) give the parameters of the replicated
    single-process steps and of JAX's zero1_shard_opt_state path."""
    import jax
    import jax.numpy as jnp
    from navillm_tpu.parallel.mesh import zero1_shard_opt_state
    from navillm_tpu.training.optim import make_optimizer as j_optimizer
    from navillm_tpu.training.train_loop import make_opt_step
    from navillm_tpu.agents.runner import NavModelRunner as JRunner
    from navillm_tpu.agents.runner import RolloutDims as JDims
    jcfg, pj, tree = _jax_side()

    one = _runner(tree, _tcfg())
    tx1 = _optimizer(one, None, bits8)
    _steps(one, tx1, tree)
    want = {n: p.detach().numpy() for n, p in one.model.named_parameters()}

    plan = _jax_mesh(dp, tp)
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), _tok(),
                 dims=JDims.tiny(), mesh_plan=plan)
    jtx = j_optimizer(lr=LR, grad_clip_norm=NO_CLIP if bits8 else CLIP,
                      moments_8bit=bits8)
    jopt = zero1_shard_opt_state(jtx.init(jr.params), plan, min_size=1024)
    step = make_opt_step(jtx, jr.params, jopt)
    jp = jr.params
    leaves, treedef = jax.tree.flatten(jp)
    names = sorted(flatten_tree(tree))
    for seed in range(2):
        g = _grads(tree, seed)
        gtree = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(
                g[".".join(k.key for k in path)], leaf.dtype), jp)
        with plan.mesh:
            jp, jopt = step(jp, jopt, gtree)
    jwant = flatten_tree(jax.tree.map(np.asarray, jp))
    assert sorted(jwant) == names

    # JAX's sharded 8-bit step may round one moment code the other way
    # (XLA fuses the sharded update differently): one code of m moves a
    # step by at most LR/127, so two steps stay within 2 LR/127
    vs_jax = 2 * LR / 127 if bits8 else 1e-6
    res = T.spawn_gloo(_w_zero1, dp * tp, tree, dp, tp, bits8)
    for r in res:
        for n, p in r["params"].items():
            np.testing.assert_allclose(p, want[n], rtol=1e-5, atol=1e-7,
                                       err_msg=n)
            np.testing.assert_allclose(p, jwant[n], rtol=1e-5, atol=vs_jax,
                                       err_msg=n)
        # the big leaves' moments are sliced; the whole state shrinks
        assert r["axes"]["llm.layers.wq"] == 0
        assert r["moment_bytes"] < 0.75 * r["replicated_bytes"]
    for n in want:                # the steps moved every parameter
        assert np.abs(res[0]["params"][n] - flatten_tree(tree)[n]).max() > 0


# ------------------------------------------------- tp=2 evaluation --- #
def _eval_world(root):
    T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=3)
    return root / "R2R" / "annotations" / "val.json"


def _port_eval(runner, anno, kv8):
    agent, ds, args = T.r2r_eval(anno, runner, n_slots=2, image_feat_size=32,
                                 prefix_cache=kv8)
    args = dataclasses.replace(args, kv_int8=kv8)
    agent.args = args
    preds = agent.validate_streaming("R2R", args, T.eval_config(5),
                                     T.Dataloader(ds, 2, False), dataset=ds)
    return {p["instr_id"]: p["trajectory"] for p in preds}


EVAL_CASES = {"dense": (16, False, False), "int8": (8, False, False),
              "int4": (4, False, False), "kv8": (8, False, True),
              "w8a8": (8, True, False)}


def _w_eval(rank, tree, anno, hidden, inter, act_int8, kv8, batch):
    plan = M.make_mesh(1, 2, device="cpu")
    runner = _runner(tree, _tcfg(hidden, inter, act_int8), plan)
    logits, _, _ = runner.navigation(batch)
    return {"traj": _port_eval(runner, anno, kv8), "logits": logits,
            "cached": runner.cached_steps, "steps": runner.eval_steps}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_tp2_streaming_eval_matches(case, tmp_path):
    """tp=2 streaming evaluation gives the trajectories of one port
    process and of JAX's tp=2 mesh run, and one navigation forward's
    logits within TIGHT of one process's."""
    from navillm_tpu.agents import load_agent
    from navillm_tpu.agents.runner import NavModelRunner as JRunner
    from navillm_tpu.agents.runner import RolloutDims as JDims
    from navillm_tpu.data.datasets import load_dataset
    from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu.data.loaders import Dataloader
    from navillm_tpu.sim import WorldModel
    from navillm_tpu.testing import synthetic_nav_batch
    from navillm_tpu.utils.config import ConfigDict, TrainArgs
    bits, act_int8, kv8 = EVAL_CASES[case]
    # int4 row splits need whole 128-wide groups: hidden 256, MLP 512
    hidden, inter = (256, 512) if bits == 4 else (128, 256)
    # a stop bias at which the policy stops at mixed steps
    jcfg, pj, tree = _jax_side(hidden, inter, bits, act_int8,
                               stop_bias=1.0 if bits == 4 else STOP_BIAS)
    anno = _eval_world(tmp_path)
    batch = synthetic_nav_batch(jcfg, b=2, g=12, v=8, c=8, hh=4, tlen=64)

    one = _runner(tree, _tcfg(hidden, inter, act_int8))
    logits1, _, _ = one.navigation(batch)
    single = _port_eval(one, anno, kv8)

    feat = 32
    args = TrainArgs(data_dir=str(tmp_path), val_batch_size=2, seed=0,
                     prefix_cache=kv8, kv_int8=kv8)
    args.image_feat_size = feat
    world = WorldModel(str(tmp_path / "connectivity"))
    ds = load_dataset("r2r", args, ConfigDict({
        "Feature": {"image_feat_size": feat, "angle_feat_size": 4},
        "R2R": {"DIR": "R2R", "SPLIT": {"val_unseen": "annotations/val.json"}}
    }), training=False, source="R2R", world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(feat))
    plan = _jax_mesh(1, 2)
    jr = JRunner(jcfg, pj, _tok(), dims=dataclasses.replace(
        JDims.tiny(), max_prefix=MAX_PREFIX), mesh_plan=plan)
    with plan.mesh:
        jpreds = load_agent("r2r", args, world, jr).validate_streaming(
            "R2R", args, ConfigDict({"Optim": {"val_max_action_len": {
                "R2R": 5}}}), Dataloader(ds, 2, False), dataset=ds)
    jtraj = {p["instr_id"]: p["trajectory"] for p in jpreds}

    res = T.spawn_gloo(_w_eval, 2, tree, anno, hidden, inter, act_int8, kv8,
                       batch)
    assert len(single) == 6 and len({len(t) for t in single.values()}) > 1
    for r in res:
        assert r["traj"] == single == jtraj
        np.testing.assert_allclose(r["logits"], logits1, **TIGHT)
        assert (r["cached"] > 0) == kv8 and r["steps"] + r["cached"] > 0


# ------------------------------------------------- tp=2 fused teacher --- #
def _teacher(runner, data_dir):
    from navillm_tpu_torch.agents.fused_teacher import rollout_teacher_fused
    from navillm_tpu_torch.agents.mp3d_agent import R2RAgent, TrainArgs
    from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu_torch.data.r2r import R2RDataset
    from navillm_tpu_torch.sim import WorldModel
    args = TrainArgs(seed=0, image_feat_size=32, fused_rows_per_call=3)
    world = WorldModel(str(data_dir / "connectivity"))
    ds = R2RDataset(data_dir / "R2R" / "annotations" / "R2R_train_enc.json",
                    world, training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(32))
    agent = R2RAgent(args, world, runner)
    agent.np_rng = _IdentityRng(0)
    runner.zero_grads()
    loss, traj = rollout_teacher_fused(
        agent, args, "R2R", T.train_config(4).Optim,
        next(iter(T.Dataloader(ds, 2, False))), dataset=ds, train_ml=1.0)
    return float(loss), [t["path"] for t in traj], runner.take_grads()


def _w_teacher(rank, tree, data_dir):
    plan = M.make_mesh(1, 2, device="cpu")
    runner = _runner(tree, _tcfg(), plan)
    loss, paths, grads = _teacher(runner, data_dir)
    return {"loss": loss, "paths": paths, "grad_calls": runner.grad_calls,
            "grads": {n: _whole(g, runner.param_specs.get(n, ()), plan)
                      .numpy() for n, g in grads.items()}}


def test_tp2_fused_teacher_step(data_dir):
    """One fused teacher batch at tp=2 (several grad chunks): the loss, the
    trajectories and every gradient of one port process, which
    tests/test_torch_train.py holds against JAX."""
    _, _, tree = _jax_side()
    loss1, paths1, grads1 = _teacher(_runner(tree, _tcfg()), data_dir)
    for r in T.spawn_gloo(_w_teacher, 2, tree, data_dir):
        assert r["paths"] == paths1 and r["grad_calls"] > 1
        assert r["loss"] == pytest.approx(loss1, rel=1e-5)
        for n, g in grads1.items():
            _grad_close(r["grads"][n], g.numpy(), n)


# --------------------------------------------------------- checkpoints --- #
def _w_ckpt(rank, tree, out):
    from navillm_tpu_torch.training import checkpoints as C
    plan = M.make_mesh(2, 1, device="cpu")
    runner = _runner(tree, _tcfg(), plan)
    tx = _optimizer(runner, plan, False)
    _steps(runner, tx, tree, plan)
    C.save_checkpoint(out / "zero1", runner.model, tx, 0, plan=plan,
                      specs=runner.param_specs)
    again = _runner(tree, _tcfg(), plan)
    tx2 = _optimizer(again, plan, False)
    _, _, epoch = C.load_checkpoint(out / "zero1", again.model, tx2,
                                    plan=plan, specs=again.param_specs)
    same = all(torch.equal(a, b) for a, b in zip(
        again.model.parameters(), runner.model.parameters()))
    for field, tree_ in tx.state_trees().items():
        for n, t in tree_.items():
            same &= torch.equal(tx2.state_trees()[field][n], t)
    return {"restored": same and tx2.count == tx.count, "epoch": epoch,
            "axes": [ax for _, ax in tx.layout.values()]}


def test_zero1_checkpoint_equals_single_process_save(tmp_path):
    """Rank 0 writes the file a single-card run writes (every tensor byte
    for byte: the moments gathered from the data group); resumed at dp=2,
    each rank gets its slices back."""
    from navillm_tpu_torch.training import checkpoints as C
    _, _, tree = _jax_side()
    one = _runner(tree, _tcfg())
    tx = _optimizer(one, None, False)
    _steps(one, tx, tree)
    C.save_checkpoint(tmp_path / "single", one.model, tx, 0)

    res = T.spawn_gloo(_w_ckpt, 2, tree, tmp_path)
    assert all(r["restored"] and r["epoch"] == 1 for r in res)
    assert any(ax is not None for ax in res[0]["axes"])
    got = np.load(tmp_path / "zero1.npz")
    want = np.load(tmp_path / "single.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert json.loads((tmp_path / "zero1.json").read_text()) == \
        json.loads((tmp_path / "single.json").read_text())


# ------------------------------------------------------- run_training --- #
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


def _run_args(data_dir, out, **kw):
    from navillm_tpu_torch.utils.config import TrainArgs
    return TrainArgs(**{**dict(
        device="cpu", data_dir=str(data_dir), output_dir=str(out),
        stage="multi", num_epochs=1, num_steps_per_epoch=2,
        gradient_accumulation_step=2, batch_size=2, val_batch_size=2,
        image_feat_size=32, lr=LR, feat_dropout=0.0, fused_rows_per_call=3,
        seed=0, save_pred_results=True, save_latest_states=True), **kw})


def _identity_agents(TTL):
    """Make run_training's agents draw identity candidate permutations:
    the agents' permutations come from one RandomState in the order the
    episodes are met, so a sharded validation would otherwise permute an
    episode's candidates differently from one process."""
    orig = TTL.build_agents

    def build(args, *a, **k):
        agents = orig(args, *a, **k)
        for agent in agents.values():
            agent.np_rng = _IdentityRng(args.seed)
        return agents
    TTL.build_agents = build
    return orig


def _w_run_training(rank, data_dir, out):
    from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu_torch.training import train_loop as TTL
    from navillm_tpu_torch.utils.config import load_yaml_text
    cfg = load_yaml_text(RUN_CFG)
    args = _run_args(data_dir, out)
    args.sync_from_config(cfg)
    out.mkdir(parents=True, exist_ok=True)
    seen = {}
    orig = TTL.build_runner
    orig_agents = _identity_agents(TTL)

    def keep(*a, **k):
        seen["runner"] = orig(*a, **k)
        return seen["runner"]
    TTL.build_runner = keep
    try:
        res = TTL.run_training(args, cfg,
                               feat_dbs={"mp3d": SyntheticImageFeaturesDB(32)})
    finally:
        TTL.build_runner, TTL.build_agents = orig, orig_agents
    runner = seen["runner"]
    return {"results": res, "rank": args.rank, "world": args.world_size,
            "dp": args.dp_size, "grad_calls": runner.grad_calls,
            "params": {n: p.detach().numpy()
                       for n, p in runner.model.named_parameters()}}


def test_run_training_dp2(data_dir, tmp_path):
    """run_training at dp=2 end to end (stage multi, one optimizer step,
    ZeRO-1 on): the ranks end the epoch with the same parameters, rank 0
    writes the whole checkpoint and the merged predictions, which cover
    every validation episode once and equal one process's validation of
    the same weights."""
    from navillm_tpu_torch.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu_torch.training import train_loop as TTL
    from navillm_tpu_torch.utils.config import load_yaml_text
    out = tmp_path / "dp2"
    res = T.spawn_gloo(_w_run_training, 2, data_dir, out)
    assert [(r["rank"], r["world"], r["dp"]) for r in res] == \
        [(0, 2, 2), (1, 2, 2)]
    assert "R2R" in res[0]["results"] and res[1]["results"] is None
    assert all(r["grad_calls"] > 0 for r in res)
    for n, p in res[0]["params"].items():
        np.testing.assert_array_equal(res[1]["params"][n], p)
    merged = json.loads((out / "R2R_val_unseen.json").read_text())
    ids = [p["instr_id"] for p in merged]
    val = json.loads((data_dir / "R2R" / "annotations" /
                      "R2R_val_unseen_enc.json").read_text())
    assert len(ids) == len(set(ids))
    assert len(ids) == sum(len(x.get("instructions", [0])) for x in val)

    cfg = load_yaml_text(RUN_CFG)
    args = _run_args(data_dir, tmp_path / "one", mode="test",
                     resume_from_checkpoint=str(out / "latest"),
                     save_latest_states=False)
    args.sync_from_config(cfg)
    (tmp_path / "one").mkdir()
    orig = _identity_agents(TTL)
    try:
        one = TTL.run_training(
            args, cfg, feat_dbs={"mp3d": SyntheticImageFeaturesDB(32)})
    finally:
        TTL.build_agents = orig
    single = json.loads((tmp_path / "one" / "R2R_val_unseen.json")
                        .read_text())
    key = lambda p: p["instr_id"]  # noqa: E731
    assert sorted(merged, key=key) == sorted(single, key=key)
    assert one["R2R"] == pytest.approx(res[0]["results"]["R2R"])
