"""The host-memory runner (``NavModelRunner(..., device_memory=False)``):
streaming evaluation, the fused teacher, the fused DAgger and per-step
training, each held against the device-memory runner in the port (the
twins of tests/test_streaming_eval.py:140, tests/test_fused_teacher.py:126
and tests/test_fused_dagger.py:124) and against JAX's host-memory runner;
and the per-stage structure of the fused trainers and of streaming
evaluation against JAX's, on both memories.

The harness is tests/test_torch_perstep.py's (same world, features,
converted f32 weights, BPE prompts, RandomState). Trajectories must be
equal, losses agree to rtol 1e-4 and gradients to rtol 2e-3, atol 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_perstep import (assert_same, batch_of, models,  # noqa
                                perstep, result, side, structure, worlds)

from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu_torch.agents import fused_teacher as FT  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402

STOP_BIAS = 2.0


def _stream(port, models, root, task, device_memory, **flags):
    s = side(port, models, root, task, training=False,
             device_memory=device_memory, stop_bias=STOP_BIAS, **flags)
    loader = (Dataloader if port else JLoader)(s.ds, 2, False)
    preds = s.agent.validate_streaming(task, s.args, s.cfg, loader,
                                       dataset=s.ds)
    return {p["instr_id"]: p for p in preds}, structure(s.agent.timer), s


@pytest.mark.parametrize("task", ["R2R", "EQA"])
def test_streaming_host_memory(models, worlds, task):
    """Streaming evaluation on the host memory (one slot group; the
    panorama comes down each step, the graph maps pool the node
    embeddings, runner.navigation runs the step; on EQA the answer heads
    read the slots' host history): the predictions of the device-memory
    run in one slot group (which draws its candidate permutations in the
    same order), and JAX's host-memory run's predictions and stage counts.
    On the device memory, in two slot groups, the stage counts are JAX's
    too."""
    host, stages, s = _stream(True, models, worlds, task, False)
    dev, _, _ = _stream(True, models, worlds, task, True, eval_streams=1)
    jhost, jstages, _ = _stream(False, models, worlds, task, False)
    _, dev_stages, _ = _stream(True, models, worlds, task, True)
    _, jdev_stages, _ = _stream(False, models, worlds, task, True)
    assert host == dev == jhost and len(host) == len(s.ds)
    assert len({len(p["trajectory"]) for p in host.values()}) > 1
    assert stages == jstages and dev_stages == jdev_stages
    assert "pano_device" in stages and "nav_device" in stages
    assert "nav_dispatch" in dev_stages and "pano_device" not in dev_stages
    assert s.runner.eval_steps == 0 and s.runner.forward_calls > 0


def _fused(port, models, root, task, device_memory, dagger=False,
           forced=None, **flags):
    s = side(port, models, root, task, device_memory=device_memory, **flags)
    s.runner.zero_grads()
    mod = FT if port else JFT
    fn = mod.rollout_dagger_fused if dagger else mod.rollout_teacher_fused
    kw = dict(forced_actions=forced) if dagger else {}
    loss, traj = fn(s.agent, s.args, task, s.cfg.Optim, batch_of(s),
                    dataset=s.ds, train_ml=1.0, **kw)
    return result(s, loss, traj)


@pytest.mark.parametrize("task", ["R2R", "EQA"])
def test_fused_teacher_host_memory(models, worlds, task):
    """The fused teacher on the host memory (phase 2's panorama comes down,
    the graph maps replay the node embeddings, one fusion call gives the
    history): the device-memory run's loss and gradients, and JAX's
    host-memory run's, stage counts included; on EQA batches the answer
    head runs at the final step."""
    host = _fused(True, models, worlds, task, False)
    assert_same(host, _fused(True, models, worlds, task, True), stages=False)
    assert_same(host, _fused(False, models, worlds, task, False))
    assert_same(_fused(True, models, worlds, task, True),
                _fused(False, models, worlds, task, True))
    assert host.runner.gen_grad_calls == (task == "EQA")


def _drawn_actions(models, worlds):
    """[T][B]: the actions the port's host-memory DAgger draws from the
    agent's RandomState (recorded from its phase 1)."""
    steps_of = []
    train = FT._fused_trajectory_train

    def capture(agent, args, *, steps, traj, **kw):
        steps_of.append(steps)
        return train(agent, args, steps=steps, traj=traj, **kw)

    FT._fused_trajectory_train = capture
    try:
        got = _fused(True, models, worlds, "R2R", False, dagger=True)
    finally:
        FT._fused_trajectory_train = train
    steps, = steps_of
    return got, [s["actions"] for s in steps]


def test_fused_dagger_host_memory(models, worlds):
    """The fused DAgger on the host memory (one group, runner.navigation
    per step, the draw on the host from the agent's RandomState): JAX's
    host-memory run draws the same actions from its RandomState, and so
    its trajectories, loss, gradients and stage counts are the port's.
    With those actions forced (no draw then takes numbers from the
    RandomState between its candidate permutations), the host-memory run
    and the device-memory run in one prefix-cached group (its
    permutations drawn in the same order) give the same loss and
    gradients; in two groups the device-memory run's stage counts and
    numbers are JAX's."""
    host, drawn = _drawn_actions(models, worlds)
    assert_same(host, _fused(False, models, worlds, "R2R", False,
                             dagger=True))
    forced = _fused(True, models, worlds, "R2R", False, dagger=True,
                    forced=drawn)
    assert forced.paths == host.paths
    assert_same(_fused(True, models, worlds, "R2R", True, dagger=True,
                       forced=drawn, dagger_streams=1), forced, stages=False)
    dev = _fused(True, models, worlds, "R2R", True, dagger=True,
                 forced=drawn)
    assert_same(dev, _fused(False, models, worlds, "R2R", True, dagger=True,
                            forced=drawn))
    assert host.stages["dagger_sample"] == host.runner.forward_calls
    assert "dagger_sync" not in host.stages and dev.stages["dagger_sync"]


def test_perstep_host_memory(models, worlds):
    """Per-step teacher training on the host memory (the panorama twice
    per step under one seed, runner.pano_navigation_train): the device
    memory's loss and gradients, and JAX's host-memory run's."""
    host = perstep(True, models, worlds, "R2R", device_memory=False)
    assert_same(host, perstep(True, models, worlds, "R2R"), stages=False)
    assert_same(host, perstep(False, models, worlds, "R2R",
                              device_memory=False))
    assert host.stages["nav_device"] == host.runner.grad_calls
