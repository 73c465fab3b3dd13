"""The port's fused DAgger half and its on-card sampler against the JAX
package's.

Both sides get the same world, features, converted weights, dropout off
and the identity candidate permutation, and follow the same trajectory:
the actions a JAX per-step sample-feedback rollout takes with a
deterministic "sampler" (recorded as tests/test_fused_dagger.py does),
forced on both sides through ``forced_actions``. The two then compute the same function,
so trajectories, loss and every accumulated gradient leaf must agree
(testing.assert_grads_close). The
sampled actions themselves cannot match (torch cannot replay
jax.random): the sampler is held to its distribution instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import load_agent  # noqa: E402
from navillm_tpu.agents.fused_teacher import \
    rollout_dagger_fused as j_dagger  # noqa: E402
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
from navillm_tpu_torch.agents import device_memory as DM  # noqa: E402
from navillm_tpu_torch.agents import prompts as PR  # noqa: E402
from navillm_tpu_torch.agents.fused_teacher import \
    rollout_dagger_fused  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import (CLS_TOKEN_TEXT,  # noqa
                                                 R2RAgent, TrainArgs)
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.ops.masking import NEG_INF  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.training.optim import make_optimizer  # noqa: E402

torch.set_num_threads(1)
MAX_ACTION_LEN = 4
ROWS_PER_CALL = 3      # several grad chunks per group, the last one padded
# f32 on both sides; the tolerances of tests/test_torch_train.py
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
# the sampler's frequencies: each bin within 5 sigma of N p
N_DRAWS = 20000


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


class _RecordingRng(_IdentityRng):
    """JAX's per-step path samples on the host from np_rng.choice: take
    the likeliest candidate other than stop instead (a random policy
    mostly stops at once), stop on the calls in ``stop_calls`` (so one
    episode ends early), and record each choice."""

    def __init__(self, stop_calls=(5,)):
        self.actions = []
        self.stop_calls = set(stop_calls)

    def choice(self, n, p=None):
        p = np.asarray(p)
        a = 0
        if len(self.actions) not in self.stop_calls and p[1:].max() > 0:
            a = 1 + int(np.argmax(p[1:]))
        self.actions.append(a)
        return a


def _optim(max_action_len=MAX_ACTION_LEN):
    return ConfigDict({"train_max_action_len": {"R2R": max_action_len},
                       "val_max_action_len": {"R2R": max_action_len}})


@pytest.fixture(scope="module")
def models():
    tok = NavTokenizer(max_length=2048, pad_to_multiple=128)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pj, tcfg, tok


def _jax_side(models, data_dir, task_config, train_args, dims=None, **kw):
    jcfg, pj, _, tok = models
    runner = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok,
                     dims=dims or JDims.tiny(), feat_dropout=0.0)
    args = train_args
    args.image_feat_size = jcfg.pano.image_feat_size
    args.fused_rows_per_call = ROWS_PER_CALL
    args.dagger_sample_quant = False
    for k, v in kw.items():
        setattr(args, k, v)
    world = WorldModel(str(data_dir / "connectivity"))
    ds = load_dataset("r2r", args, task_config, training=True, source="R2R",
                      world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(jcfg.pano.image_feat_size))
    return runner, load_agent("r2r", args, world, runner), ds, args


def _port_side(models, data_dir, dims=None, **kw):
    _, pj, tcfg, tok = models
    model = TNM.NavModel(tcfg, params_from_jax(
        jax.tree.map(np.asarray, pj), device="cpu"))
    runner = NavModelRunner(tcfg, model, tok, dims=dims or RolloutDims.tiny(),
                            feat_dropout=0.0)
    args = TrainArgs(seed=0, image_feat_size=tcfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL, device="cpu", **kw)
    world = WorldModel(str(data_dir / "connectivity"))
    ds = R2RDataset(data_dir / "R2R" / "annotations" / "R2R_train_enc.json",
                    world, training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(tcfg.pano.image_feat_size))
    return runner, R2RAgent(args, world, runner), ds, args


def _batch(ds, b, index=0):
    return list(Dataloader(ds, b, False))[index]


def _record_forced(models, data_dir, task_config, train_args, b, index=0):
    """[T][B] actions of JAX's per-step sample-feedback rollout under
    _RecordingRng's choice."""
    runner, agent, ds, args = _jax_side(models, data_dir, task_config,
                                        train_args)
    rec = _RecordingRng()
    runner.zero_grads()
    agent.rollout(args, "R2R", _optim(), _batch(ds, b, index), dataset=ds,
                  feedback="sample", train_ml=1.0, np_rng=rec)
    runner.take_grads()
    assert rec.actions and len(rec.actions) % b == 0
    return [np.asarray(rec.actions[t * b:(t + 1) * b], np.int64)
            for t in range(len(rec.actions) // b)]


def _jax_dagger(models, data_dir, task_config, train_args, b, forced,
                dims=None, **kw):
    runner, agent, ds, args = _jax_side(models, data_dir, task_config,
                                        train_args, dims=dims, **kw)
    runner.zero_grads()
    loss, traj = j_dagger(agent, args, "R2R", _optim(), _batch(ds, b),
                          dataset=ds, train_ml=1.0, forced_actions=forced,
                          np_rng=_IdentityRng())
    grads = flatten_tree(jax.tree.map(np.asarray, runner.take_grads()))
    return float(loss), grads, [t["path"] for t in traj]


def _port_dagger(models, data_dir, b, forced, dims=None, **kw):
    runner, agent, ds, args = _port_side(models, data_dir, dims=dims, **kw)
    runner.zero_grads()
    loss, traj = rollout_dagger_fused(agent, args, "R2R", _optim(),
                                      _batch(ds, b), dataset=ds, train_ml=1.0,
                                      forced_actions=forced,
                                      np_rng=_IdentityRng())
    assert torch.is_tensor(loss) and loss.dim() == 0
    return (float(loss), grads_to_numpy(runner.model),
            [t["path"] for t in traj], runner, agent)


def _assert_same(got, want):
    loss, grads, paths = got[:3]
    wloss, wgrads, wpaths = want[:3]
    assert paths == wpaths
    assert max(len(p) for p in paths) > 1
    assert loss == pytest.approx(wloss, rel=LOSS_REL)
    assert sorted(grads) == sorted(wgrads)
    T.assert_grads_close(grads, wgrads, GRAD_RTOL, GRAD_ATOL)
    for name in ("llm.layers.wq", "out_head.w", "pano.mapper.w"):
        assert np.abs(grads[name]).sum() > 0, name


@pytest.fixture(scope="module")
def forced4(models, data_dir, task_config):
    from navillm_tpu.utils.config import TrainArgs as JArgs
    return _record_forced(models, data_dir, task_config,
                          JArgs(data_dir=str(data_dir), seed=0), 4)


# the one-group port runs, shared by the tests that compare with them
PORT_RUNS = {}


def _one_group(models, data_dir, forced4, cached):
    key = "cached" if cached else "uncached"
    if key not in PORT_RUNS:
        PORT_RUNS[key] = _port_dagger(models, data_dir, 4, forced4,
                                      dagger_streams=1,
                                      dagger_prefix_cache=cached)
    return PORT_RUNS[key]


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_fused_dagger_matches_jax(models, data_dir, task_config, train_args,
                                  forced4, cached):
    want = _jax_dagger(models, data_dir, task_config, train_args, 4, forced4,
                       dagger_streams=1, dagger_prefix_cache=cached)
    got = _one_group(models, data_dir, forced4, cached)
    _assert_same(got, want)
    runner = got[3]
    # the sampling pass took the step asked for, and no draw (forced)
    if cached:
        assert runner.cached_steps > 0 and runner.prefill_calls > 0
        assert runner.eval_steps == 0 and got[4].dagger_bailouts == 0
        assert len(got[4]._dagger_cache_pool) == 1
    else:
        assert runner.eval_steps > 0 and runner.cached_steps == 0


def test_fused_dagger_two_groups_match_one_and_jax(models, data_dir,
                                                   task_config, train_args,
                                                   forced4):
    """dagger_streams=2 splits the batch of 4 into two slot groups run
    round-robin; with the batch's loss denominator the sum over groups is
    the one-group loss and gradient."""
    want = _jax_dagger(models, data_dir, task_config, train_args, 4, forced4,
                       dagger_streams=2, dagger_prefix_cache=True)
    two = _port_dagger(models, data_dir, 4, forced4, dagger_streams=2,
                       dagger_prefix_cache=True)
    _assert_same(two, want)
    _assert_same(two, _one_group(models, data_dir, forced4, True))
    # one [2, P] cache per group, both back in the pool
    assert [(b, p) for b, p, _ in two[4]._dagger_cache_pool] \
        == [(2, RolloutDims.tiny().max_prefix)] * 2


def _prefix_len(tok, instruction, hist_num):
    """The cacheable prefix of a navigation prompt (what
    _cached_prompt_windows caches): up to the last <hist>, or at refill
    the common prefix with the one-more-history probe."""
    def ids(h):
        return np.asarray(tok.encode(PR.navigation_prompt(
            "r2r", instruction=instruction, hist_num=h, cand_num=3,
            cls_token=CLS_TOKEN_TEXT), add_bos=True))
    cur = ids(hist_num)
    hp = np.nonzero(cur == tok.hist_id)[0]
    if len(hp):
        return int(hp[-1]) + 1
    nxt = ids(hist_num + 1)
    m = min(len(cur), len(nxt))
    return int(np.argmax(cur[:m] != nxt[:m]))


def test_fused_dagger_mid_batch_bailout_matches_jax(models, data_dir,
                                                    task_config, train_args,
                                                    forced4):
    """A prefix that outgrows max_prefix after the first step: the cached
    sampling step runs once, _cached_prompt_windows raises, the buffer
    goes back to the pool and the rest of the batch takes the full-prompt
    step; the result equals JAX's (which bails out at the same step) and
    the never-cached run (test_fused_dagger_matches_jax[uncached])."""
    tok = models[3]
    _, _, ds, _ = _port_side(models, data_dir)
    instr = [ob["instruction"] for ob in _batch(ds, 4)["observations"]]
    at0 = max(_prefix_len(tok, x, 0) for x in instr)
    at1 = max(_prefix_len(tok, x, 1) for x in instr)
    assert at1 > at0 + 1
    kw = dict(max_gmap_nodes=16, max_views=40, max_cands=8, max_hist=8,
              max_prefix=at0 + 1)
    want = _jax_dagger(models, data_dir, task_config, train_args, 4, forced4,
                       dims=JDims(**kw), dagger_streams=1,
                       dagger_prefix_cache=True)
    got = _port_dagger(models, data_dir, 4, forced4, dims=RolloutDims(**kw),
                       dagger_streams=1, dagger_prefix_cache=True)
    _assert_same(got, want)
    _assert_same(got, _one_group(models, data_dir, forced4, False))
    runner, agent = got[3], got[4]
    assert agent.dagger_bailouts == 1
    assert runner.cached_steps == 1 and runner.eval_steps > 0
    assert [(b, p) for b, p, _ in agent._dagger_cache_pool] \
        == [(4, at0 + 1)]


def _logits(rng, b, g, n_masked):
    x = rng.randn(b, g).astype(np.float32)
    x[:, g - n_masked:] = NEG_INF
    return torch.from_numpy(x)


def test_sampler_tiny_temperature_is_argmax():
    logits = _logits(np.random.RandomState(0), 64, 12, 4)
    gen = torch.Generator().manual_seed(1)
    got = DM.sample_actions(logits, 1e-6, gen)
    assert got.dtype == torch.int32
    assert torch.equal(got, logits.argmax(-1).int())
    # T below the floor is clamped to 1e-6, not divided through to inf/NaN
    assert torch.equal(DM.sample_actions(logits, 0.0, gen), got)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampler_frequencies_match_softmax(temperature):
    """N_DRAWS draws of one row: every bin within 5 sigma of N p, p =
    softmax(logits / T); masked candidates never drawn."""
    row = torch.tensor([[0.3, -1.2, 1.5, 0.0, 2.1, -0.4, NEG_INF, NEG_INF]])
    logits = row.expand(N_DRAWS, -1).contiguous()
    gen = torch.Generator().manual_seed(7)
    draws = DM.sample_actions(logits, temperature, gen)
    counts = np.bincount(draws.numpy(), minlength=row.shape[1])
    p = torch.softmax(row[0] / temperature, -1).double().numpy()
    sigma = np.sqrt(N_DRAWS * p * (1 - p))
    assert counts[6:].sum() == 0
    assert np.all(np.abs(counts - N_DRAWS * p) <= 5 * sigma + 1e-9), \
        (counts, N_DRAWS * p)


def test_sampler_never_draws_masked_candidates():
    logits = _logits(np.random.RandomState(3), N_DRAWS, 10, 7)
    for temperature in (1.0, 1e-6, 100.0):
        draws = DM.sample_actions(logits, temperature,
                                  torch.Generator().manual_seed(2))
        assert int(draws.max()) < 3


def test_sampler_override_wins_and_seed_repeats():
    logits = _logits(np.random.RandomState(4), 32, 9, 3)
    override = torch.full((32,), -1, dtype=torch.int32)
    override[::3] = 5
    a = DM.select_actions(logits, override, True, 1.0,
                          torch.Generator().manual_seed(11))
    b = DM.select_actions(logits, override, True, 1.0,
                          torch.Generator().manual_seed(11))
    c = DM.select_actions(logits, override, True, 1.0,
                          torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[::3], override[::3])
    greedy = DM.select_actions(logits, override, False, 1.0, None)
    want = logits.argmax(-1).int()
    want[::3] = 5
    assert torch.equal(greedy, want)


def test_runner_sampled_step_is_seeded_and_valid(models, data_dir):
    """runner.eval_step(do_sample=True) draws from a generator seeded by
    the runner's seed: the same seed draws the same actions, each a valid
    candidate of its row."""
    _, pj, tcfg, tok = models
    runner, agent, ds, args = _port_side(models, data_dir)
    batch = _batch(ds, 4)
    obs = batch["observations"]
    from navillm_tpu_torch.agents.graph_map import GraphMap
    gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
    for g, ob in zip(gmaps, obs):
        g.update_graph(ob)
    pano = agent.panorama_inputs(obs)
    V = pano["view_img_fts"].shape[1]
    masks = np.arange(V)[None] < pano["view_lens"][:, None]
    gin = agent.nav_gmap_inputs(obs, gmaps)
    vp = agent.nav_vp_inputs(obs, gmaps, masks, pano["cand_vpids"])
    order, prompts, _ = agent.cand_order_and_prompts(
        gin, [ob["instruction"] for ob in obs], [[]] * 4, rng=_IdentityRng())
    tb, cp, hp, clp = runner.tokenize_with_positions(prompts)
    nav = {k: gin[k] for k in ("gmap_step_ids", "gmap_pos_fts", "gmap_masks",
                               "gmap_visited_masks")}
    nav.update(vp_pos_fts=vp["vp_pos_fts"], pano_masks=vp["pano_masks"],
               local_match_slot=agent.local_match_slots(
                   gin["gmap_vpids"], vp["vp_cand_vpids"], gmaps, V + 1),
               cand_order=order, cand_positions=cp, hist_positions=hp,
               input_ids=tb.input_ids, attention_mask=tb.attention_mask,
               cls_pos=clp, slot_ids=np.full(gin["gmap_masks"].shape, -1,
                                             np.int32))
    draws = []
    for _ in range(2):
        runner.rng.manual_seed(5)
        acts = []
        for _ in range(8):
            _, a_t, logits = runner.eval_step(
                runner.memory_init(4), pano, nav, np.zeros(4, bool),
                np.full(4, -1, np.int32), np.full((4, V), -1, np.int32),
                np.ones(4, bool), do_sample=True, temperature=1.0)
            acts.append(a_t)
        draws.append(np.stack(acts))
    assert np.array_equal(draws[0], draws[1])
    valid = (logits > NEG_INF / 2).numpy()
    assert all(valid[i, a] for step in draws[0] for i, a in enumerate(step))
    assert len(np.unique(draws[0])) > 1          # it does draw


def test_train_one_epoch_multi_matches_jax(models, data_dir, task_config,
                                           train_args, forced4):
    """Stage multi, two batches with accumulation 2: a teacher batch, then
    a DAgger batch whose actions are pinned on both sides through train's
    keyword arguments (forced_actions, np_rng); the batch losses and the
    parameters after the one optimizer step must match."""
    lr, warmup = 1e-3, 2
    stage = {"SOURCE": ["R2R"], "LOSS_COEF": {}}
    cfg = ConfigDict({"Pretrain": stage, "Multi": stage, "Optim": _optim()})
    # the second batch of 2 is the last two episodes of forced4's batch,
    # whose per-row choices do not depend on the other rows
    forced = [f[2:] for f in forced4]

    def pin(agent, losses):
        train = agent.train

        def pinned(name, batch, args, config, dataset, step=0, **kw):
            if step % 2:
                kw.update(forced_actions=forced, np_rng=_IdentityRng())
            loss = train(name, batch, args, config, dataset, step=step, **kw)
            losses.append(loss)
            return loss
        agent.train = pinned
        agent.np_rng = _IdentityRng()

    jrunner, jagent, jds, jargs = _jax_side(models, data_dir, task_config,
                                            train_args, stage="multi")
    jlosses = []
    pin(jagent, jlosses)
    tx = j_optimizer(lr=lr, num_warmup_steps=warmup)
    _, jloss = JTL.train_one_epoch(
        jargs, cfg, jrunner, tx, tx.init(jrunner.params),
        JTL.make_opt_step(tx),
        MetaLoader({"R2R": (Dataloader(jds, 2, False), 1.0)}),
        {"R2R": jagent}, {"R2R": jds}, 0, None, num_batches=2)
    jparams = flatten_tree(jax.tree.map(np.asarray, jrunner.params))

    runner, agent, ds, args = _port_side(models, data_dir, stage="multi")
    losses = []
    pin(agent, losses)
    params = dict(runner.model.named_parameters())
    ttx = make_optimizer(params, lr=lr, num_warmup_steps=warmup)
    seen = {}
    step = TTL.make_opt_step(ttx)

    def opt_step(grads):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return step(grads)

    loss, norms = TTL.train_one_epoch(
        args, T.train_config(MAX_ACTION_LEN), runner, ttx, opt_step,
        MetaLoader({"R2R": (Dataloader(ds, 2, False), 1.0)}),
        {"R2R": agent}, {"R2R": ds}, 0, None, num_batches=2)

    # the DAgger half ran, on the prefix-cached sampling step (default)
    assert runner.cached_steps > 0 and agent.dagger_bailouts == 0
    assert len(losses) == len(jlosses) == 2
    for got, want in zip(losses, jlosses):
        assert float(got) == pytest.approx(float(want), rel=LOSS_REL)
    assert loss == pytest.approx(jloss, rel=LOSS_REL)
    assert len(norms) == 1 and torch.isfinite(norms[0]) and norms[0] > 0
    # the rule of test_torch_train.py: weights whose gradient is > 1e-6
    # within 1% of the step, the others within the step
    step_size = lr / warmup
    got = {n: p.detach().numpy() for n, p in params.items()}
    assert sorted(got) == sorted(jparams)
    for name, want in jparams.items():
        firm = seen[name].abs().numpy() > 1e-6
        np.testing.assert_allclose(got[name][firm], want[firm], rtol=0,
                                   atol=0.01 * step_size, err_msg=name)
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=1.01 * step_size, err_msg=name)


def test_unported_dagger_paths_raise(models, data_dir):
    """The DAgger paths that once named an item of the roadmap run: the
    W8A8 sampling policy (A9: one quantization for the batch), the per-step
    DAgger (no fused_dagger) and the fused DAgger on a host-memory runner
    (A8) train the batch with a finite, positive loss and gradients."""
    runner, agent, ds, args = _port_side(models, data_dir)
    cfg = T.train_config(MAX_ACTION_LEN)
    sample_q = TrainArgs(**{**args.__dict__, "dagger_sample_quant": True})
    per_step = TrainArgs(**{**args.__dict__, "fused_dagger": False})
    for a, dev_mem in ((sample_q, True), (per_step, True), (args, False)):
        runner, agent, ds, _ = _port_side(models, data_dir)
        runner.device_memory = dev_mem
        runner.zero_grads()
        loss = agent.train("R2R", _batch(ds, 2), a, cfg, dataset=ds, step=1)
        assert np.isfinite(float(loss)) and float(loss) > 0
        assert runner.grad_calls > 0
        assert runner.sampling_quantizations == int(a.dagger_sample_quant)
        assert np.abs(grads_to_numpy(runner.model)["out_head.w"]).sum() > 0
