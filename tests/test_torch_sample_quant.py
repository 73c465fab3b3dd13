"""The fused DAgger's W8A8 sampling policy (--dagger_sample_quant) in the
port, against its own off case and the JAX package.

The policy only changes which actions are sampled; the loss pass runs on
the live weights. So with the trajectory forced (the actions a JAX
per-step rollout takes, as tests/test_torch_dagger.py records them), the
on and off cases give the same trajectories, loss (rel 1e-4) and gradients
(testing.assert_grads_close at rtol 2e-3, atol 2e-5): the tolerances of
tests/test_fused_dagger.py's
test_quant_sampling_policy. The JAX package's forced run with the policy on
agrees at the same tolerances. Port-only, because the port's optimizers
update the parameters in place (JAX's build a new tree): the int8 copy is
made again after an optimizer step, and not before, so a stage-multi epoch
quantizes once per optimizer step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the fixtures forced4 and models come with the helpers
from test_torch_dagger import (GRAD_ATOL, GRAD_RTOL, LOSS_REL,  # noqa
                               MAX_ACTION_LEN, _batch, _IdentityRng,
                               _jax_dagger, _one_group, _port_dagger,
                               _port_side, forced4, models)
from navillm_tpu.data.loaders import MetaLoader  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.convert import grads_to_numpy  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models.quant import quantize_nav_params  # noqa
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.training.optim import make_optimizer  # noqa: E402

torch.set_num_threads(1)


def _assert_same(got, want):
    loss, grads, paths = got[:3]
    assert paths == want[2] and max(len(p) for p in paths) > 1
    assert loss == pytest.approx(want[0], rel=LOSS_REL)
    assert sorted(grads) == sorted(want[1])
    T.assert_grads_close(grads, want[1], GRAD_RTOL, GRAD_ATOL)


class _PolicySpy:
    """Counts the runner's sampling calls by policy: (prefills, steps) on
    the W8A8 policy and on the live one."""

    def __init__(self, runner):
        self.calls = {True: [0, 0], False: [0, 0]}
        for name, slot in (("prefill", 0), ("eval_step", 1),
                           ("eval_step_cached", 1)):
            fn = getattr(runner, name)

            def wrapped(*a, _fn=fn, _slot=slot, quant=False, **kw):
                self.calls[quant][_slot] += 1
                return _fn(*a, quant=quant, **kw)
            setattr(runner, name, wrapped)


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_quant_sampling_forced_matches_the_off_case(models, data_dir,
                                                    forced4, cached):
    """Forced trajectory, one slot group: on equals off; every sampling
    step (and on the cached path every prefill) ran on the W8A8 policy,
    quantized once."""
    from navillm_tpu_torch.agents import fused_teacher as FT
    runner, agent, ds, args = _port_side(
        models, data_dir, dagger_streams=1, dagger_prefix_cache=cached,
        dagger_sample_quant=True)
    spy = _PolicySpy(runner)
    runner.zero_grads()
    loss, traj = FT.rollout_dagger_fused(
        agent, args, "R2R", T.train_config(MAX_ACTION_LEN).Optim,
        _batch(ds, 4), dataset=ds, train_ml=1.0, forced_actions=forced4,
        np_rng=_IdentityRng())
    got = (float(loss), grads_to_numpy(runner.model),
           [t["path"] for t in traj])
    _assert_same(got, _one_group(models, data_dir, forced4, cached))
    assert runner.sampling_quantizations == 1
    assert spy.calls[False] == [0, 0]
    prefills, steps = spy.calls[True]
    assert steps > 0 and (prefills > 0) == cached
    assert (runner.cached_steps > 0) == cached


def test_quant_sampling_forced_matches_jax(models, data_dir, task_config,
                                           train_args, forced4):
    """The same forced batch with the policy on, on both packages."""
    want = _jax_dagger(models, data_dir, task_config, train_args, 4, forced4,
                       dagger_streams=1, dagger_sample_quant=True)
    got = _port_dagger(models, data_dir, 4, forced4, dagger_streams=1,
                       dagger_sample_quant=True)
    _assert_same(got, want)
    assert got[3].sampling_quantizations == 1


def test_unforced_quant_sampling_trains_valid_trajectories(models,
                                                           data_dir):
    """Drawn actions (two slot groups, cached sampling) on the W8A8
    policy: the loss is finite and positive, and the gradients reach the
    LLM and the heads."""
    runner, agent, ds, args = _port_side(models, data_dir,
                                         dagger_sample_quant=True)
    agent.np_rng = np.random.RandomState(3)
    batch = _batch(ds, 4)
    runner.zero_grads()
    loss = agent.train("R2R", batch, args, T.train_config(MAX_ACTION_LEN),
                       dataset=ds, step=1)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert runner.sampling_quantizations == 1 and runner.cached_steps > 0
    grads = grads_to_numpy(runner.model)
    for name in ("llm.layers.wq", "out_head.w"):
        assert np.abs(grads[name]).sum() > 0, name


def test_sampling_copy_is_remade_after_an_optimizer_step(models, data_dir):
    """The copy is the current LLM at int8 (the panorama encoder and the
    heads are the live ones); it is reused until an optimizer step moves
    the weights in place, then made again with new codes."""
    runner, _, _, _ = _port_side(models, data_dir)
    q1 = runner.sampling_params()
    assert runner.sampling_quantizations == 1
    assert runner.sampling_params() is q1
    assert runner.sampling_quantizations == 1
    assert q1["pano"] is runner.model["pano"]
    assert q1["out_head"] is runner.model["out_head"]
    assert runner.cfg_q.llm.act_int8 and not runner.cfg.llm.act_int8
    codes1 = q1["llm"]["layers"]["wq"]["q"].clone()
    params = dict(runner.model.named_parameters())
    tx = make_optimizer(params, lr=1e-2, num_warmup_steps=0)
    runner.zero_grads()
    for p in params.values():
        p.grad.normal_(generator=torch.Generator().manual_seed(0))
    tx.step(runner.take_grads())
    q2 = runner.sampling_params()
    assert q2 is not q1 and runner.sampling_quantizations == 2
    assert not torch.equal(q2["llm"]["layers"]["wq"]["q"], codes1)
    want = quantize_nav_params(runner.model, 8)["llm"]
    for k in ("wq", "w_down"):
        for leaf in ("q", "s"):
            assert torch.equal(q2["llm"]["layers"][k][leaf],
                               want["layers"][k][leaf])
    assert torch.equal(q2["llm"]["lm_head"]["q"], want["lm_head"]["q"])


def test_stage_multi_quantizes_once_per_optimizer_step(models, data_dir):
    """train_one_epoch at stage multi, 4 batches (teacher, DAgger, teacher,
    DAgger) with accumulation 2: two optimizer steps, each preceded by a
    DAgger batch's sampling on a fresh copy, so two quantizations."""
    runner, agent, ds, args = _port_side(models, data_dir, stage="multi",
                                         dagger_sample_quant=True,
                                         gradient_accumulation_step=2)
    params = dict(runner.model.named_parameters())
    tx = make_optimizer(params, lr=1e-3, num_warmup_steps=2)
    steps = []
    step = TTL.make_opt_step(tx)

    def opt_step(grads):
        steps.append(runner.sampling_quantizations)
        return step(grads)

    agent.np_rng = np.random.RandomState(5)
    assert runner.sampling_quantizations == 0
    _, norms = TTL.train_one_epoch(
        args, T.train_config(MAX_ACTION_LEN), runner, tx, opt_step,
        MetaLoader({"R2R": (Dataloader(ds, 2, False), 1.0)}),
        {"R2R": agent}, {"R2R": ds}, 0, None, num_batches=4)
    assert len(norms) == len(steps) == 2
    # one copy before each optimizer step, made by that step's DAgger batch
    assert steps == [1, 2]
    assert runner.sampling_quantizations == len(steps)
    assert all(torch.isfinite(n) and n > 0 for n in norms)
