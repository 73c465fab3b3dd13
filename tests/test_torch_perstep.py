"""The port's per-step rollout against the JAX package's: teacher forcing
(R2R with the summarization and FGR2R heads, REVERIE with the OG head,
EQA with its answer head), sampled actions drawn on the host, the
interleaved DAgger streams, train()'s routing, _split_batch_dict and the
per-stage timer's structure.

Both sides get the same world (testing.make_r2r_world's annotations),
synthetic features, converted f32 weights with dropout off, BPE prompts
and a RandomState of the same seed for the candidate permutations and the
draws, so they compute the same function: trajectories must be equal,
losses agree to rtol 1e-4 and every accumulated gradient leaf under
testing.assert_grads_close at rtol 2e-3, atol 2e-5
(tests/test_torch_train.py). The timers must hold the
same stage names with the same counts.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents.mp3d_agent import \
    _split_batch_dict as j_split  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data import feature_db as JFDB  # noqa: E402
from navillm_tpu.data.datasets import load_dataset as j_load  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import PanoConfig as JPano  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import fused_teacher as FT  # noqa: E402
from navillm_tpu_torch.agents import load_agent  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import \
    _split_batch_dict  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.data import feature_db as FDB  # noqa: E402
from navillm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import PanoConfig  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
FEAT, OBJ_FEAT, N_OBJECTS = 32, 16, 4
MAX_ACTION_LEN = 5
ROWS_PER_CALL = 4
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
PERM_SEED = 7
EXT = {"R2R": "json", "REVERIE": "json", "EQA": "json"}


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, JAX tokenizer, port tokenizer): the
    panorama's object branch on, dropout off."""
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pj, tcfg, tok, ttok


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("perstep")
    T.make_r2r_world(root, n_episodes=8, rows=4, cols=4, seed=3,
                     split="train")
    T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=4, split="val")
    return root


def _config(task):
    ext = EXT[task]
    sec = {"DIR": task, "SPLIT": {"train": f"annotations/train.{ext}",
                                  "val_unseen": f"annotations/val.{ext}"}}
    if task == "REVERIE":
        sec["bbox_file"] = "annotations/BBoxes.json"
    if task == "EQA":
        sec["ANSWER_VOCAB"] = "annotations/answer_vocab.json"
    stage = {"SOURCE": [task], "LOSS_COEF": {}}
    return {"Feature": {"image_feat_size": FEAT, "angle_feat_size": 4,
                        "obj_feat_size": OBJ_FEAT, "max_objects": N_OBJECTS},
            task: sec, "Multi": stage, "Pretrain": stage,
            "Optim": {"val_max_action_len": {task: MAX_ACTION_LEN},
                      "train_max_action_len": {task: MAX_ACTION_LEN}}}


def side(port, models, root, task, training=True, device_memory=True,
         stop_bias=None, **flags):
    """One package's runner, agent (a RandomState(PERM_SEED) for its
    permutations and draws), dataset with features, args and config.
    stop_bias sets the stop logit's bias (evaluation: episodes that end at
    mixed steps)."""
    jcfg, pj, tcfg, tok, ttok = models
    if stop_bias is not None:
        pj = dict(pj, out_head=dict(
            pj["out_head"], b=pj["out_head"]["b"].at[0].set(stop_bias)))
    kw = dict(dict(data_dir=str(root), val_batch_size=2, seed=0,
                   image_feat_size=FEAT, obj_feat_size=OBJ_FEAT,
                   fused_rows_per_call=ROWS_PER_CALL), **flags)
    if port:
        model = TNM.NavModel(tcfg, params_from_jax(
            jax.tree.map(np.asarray, pj), device="cpu"))
        runner = NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny(),
                                feat_dropout=0.0,
                                device_memory=device_memory)
        args, cfg = TCFG.TrainArgs(device="cpu", **kw), TCFG.ConfigDict(
            _config(task))
        world = WorldModel(str(root / "connectivity"))
        load, fdb, agent_of = load_dataset, FDB, load_agent
    else:
        runner = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok,
                         dims=JDims.tiny(), feat_dropout=0.0,
                         device_memory=device_memory)
        args, cfg = TrainArgs(dagger_sample_quant=False, **kw), ConfigDict(
            _config(task))
        world = JWorld(str(root / "connectivity"))
        load, fdb, agent_of = j_load, JFDB, j_load_agent
    ds = load(task.lower(), args, cfg, training=training, source=task,
              world=world)
    objects = [fdb.synthetic_object_db("reverie", OBJ_FEAT, N_OBJECTS)] \
        if task == "REVERIE" else []
    ds.init_feat_db(fdb.SyntheticImageFeaturesDB(FEAT), *objects)
    agent = agent_of(task.lower(), args, world, runner)
    agent.np_rng = np.random.RandomState(PERM_SEED)
    return types.SimpleNamespace(port=port, runner=runner, agent=agent,
                                 ds=ds, args=args, cfg=cfg)


def batch_of(s, b=4, index=0):
    np.random.seed(11)
    return list((Dataloader if s.port else JLoader)(s.ds, b, False))[index]


def grads_of(s):
    if s.port:
        return grads_to_numpy(s.runner.model)
    return flatten_tree(jax.tree.map(np.asarray, s.runner.take_grads()))


def structure(timer):
    """{stage: calls}: what the rollout's loop shape fixes."""
    return {k: v["count"] for k, v in timer.summary().items()}


def result(s, loss, traj):
    return types.SimpleNamespace(
        loss=float(loss), grads=grads_of(s), stages=structure(s.agent.timer),
        paths=[(t["path"], t.get("pred_objid")) for t in traj],
        runner=s.runner)


def perstep(port, models, root, task, feedback="teacher", **flags):
    s = side(port, models, root, task, **flags)
    s.runner.zero_grads()
    loss, traj = s.agent.rollout(s.args, task, s.cfg.Optim, batch_of(s),
                                 dataset=s.ds, feedback=feedback,
                                 train_ml=1.0)
    return result(s, loss, traj)


def assert_same(got, want, stages=True):
    assert got.paths == want.paths
    assert max(len(p[0]) for p in got.paths) > 2
    assert got.loss == pytest.approx(want.loss, rel=LOSS_REL)
    assert sorted(got.grads) == sorted(want.grads)
    T.assert_grads_close(got.grads, want.grads, GRAD_RTOL, GRAD_ATOL)
    if stages:
        assert got.stages == want.stages


HEADS = {"R2R": dict(enable_summarize=True, enable_fgr2r=True),
         "REVERIE": dict(enable_og=True), "EQA": {}}


@pytest.mark.parametrize("task", sorted(HEADS))
def test_perstep_teacher_matches_jax(models, worlds, task):
    """rollout(feedback="teacher") on the device memory, one grad call per
    step plus the task's heads: trajectories, loss, every gradient leaf
    and the per-stage structure are JAX's."""
    got = perstep(True, models, worlds, task, **HEADS[task])
    assert_same(got, perstep(False, models, worlds, task, **HEADS[task]))
    r = got.runner
    steps = got.stages["nav_dispatch"]
    assert got.stages["nav_sync"] == steps == got.stages["pano_assemble"]
    assert got.stages["nav_assemble"] == 2 * steps
    heads = {"R2R": r.gen_grad_calls, "REVERIE": r.og_grad_calls,
             "EQA": r.gen_grad_calls}[task]
    assert heads >= 1 and r.grad_calls == steps + heads
    if task == "REVERIE":
        assert any(p[1] is not None for p in got.paths)
    # the heads moved what navigation alone does not
    name = "pano.obj_projector.w" if task == "REVERIE" else "llm.lm_head"
    assert np.abs(got.grads[name]).sum() > 0


def test_perstep_sample_matches_jax(models, worlds):
    """rollout(feedback="sample"): each draw is numpy's choice over the
    host softmax from the same RandomState, so the port replays JAX's
    trajectory (a uniform falling within float error of a CDF edge would
    part them: none does here), the loss and the gradients."""
    got = perstep(True, models, worlds, "R2R", feedback="sample")
    want = perstep(False, models, worlds, "R2R", feedback="sample")
    assert_same(got, want)
    teacher = perstep(True, models, worlds, "R2R")
    assert got.paths != teacher.paths          # the draws left the expert


def _interleaved(port, models, root, n_streams, sequential=False):
    s = side(port, models, root, "R2R")
    b = 6 if n_streams == 3 else 4
    halves = (_split_batch_dict if port else j_split)(batch_of(s, b),
                                                      n_streams)
    rngs = [np.random.RandomState(100 + k) for k in range(len(halves))]
    s.runner.zero_grads()
    if sequential:
        loss, traj = 0.0, []
        for h, rng in zip(halves, rngs):
            part, t = s.agent.rollout(s.args, "R2R", s.cfg.Optim, h,
                                      dataset=s.ds, feedback="sample",
                                      train_ml=1.0, loss_denom=b,
                                      np_rng=rng)
            loss, traj = loss + part, traj + t
    else:
        loss, traj = s.agent.rollout_interleaved(
            s.args, "R2R", s.cfg.Optim, halves, dataset=s.ds,
            feedback="sample", train_ml=1.0, stream_rngs=rngs)
    return result(s, loss, traj)


@pytest.mark.parametrize("n_streams", [2, 3])
def test_interleaved_matches_jax_and_sequential(models, worlds, n_streams):
    """rollout_interleaved over 2 or 3 streams with the same stream_rngs:
    JAX's trajectories, loss and gradients; and, in the port, draining the
    same streams in sequence gives them too, up to the order of
    accumulation (the gradient tolerance). Twin of
    tests/test_dagger_pipeline.py:71 and :246."""
    got = _interleaved(True, models, worlds, n_streams)
    assert_same(got, _interleaved(False, models, worlds, n_streams))
    assert_same(got, _interleaved(True, models, worlds, n_streams,
                                  sequential=True))
    assert got.stages["nav_dispatch"] == got.stages["nav_sync"]


ROUTES = {
    # name: (flags, step, batch rows, device_memory, route)
    "fused_teacher": ({}, 0, 4, True, "teacher_fused"),
    "perstep_teacher": (dict(fused_teacher=False), 0, 4, True, "rollout"),
    "fused_dagger": ({}, 1, 4, True, "dagger_fused"),
    "streams1": (dict(fused_dagger=False, dagger_streams=1), 1, 4, True,
                 "rollout"),
    "streams2": (dict(fused_dagger=False, dagger_streams=2), 1, 4, True,
                 "interleaved"),
    "streams3": (dict(fused_dagger=False, dagger_streams=3), 1, 6, True,
                 "interleaved"),
    "no_pipeline": (dict(fused_dagger=False, dagger_pipeline=False), 1, 4,
                    True, "rollout"),
    "few_rows": (dict(fused_dagger=False), 1, 2, True, "rollout"),
    "host_memory": (dict(fused_dagger=False), 1, 4, False, "rollout"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_train_routes_as_jax(models, worlds, case, monkeypatch):
    """train() picks the rollout JAX picks (mp3d_agent.py:537-585) for each
    flag: the fused teacher or the per-step teacher on even steps; on odd
    steps of stage multi the fused DAgger, the interleaved streams
    (dagger_pipeline, device memory, >= 2 streams, >= 4 rows; the batch
    split by _split_batch_dict) or the serial rollout."""
    flags, step, rows, dev_mem, route = ROUTES[case]
    seen = {}
    for port in (True, False):
        s = side(port, models, worlds, "R2R", device_memory=dev_mem, **flags)
        calls = []

        def stub(kind):
            def fn(*a, **kw):
                calls.append((kind, kw.get("feedback")))
                if kind == "interleaved":
                    halves = a[3]
                    calls.append(("streams", [h["batch_size"]
                                              for h in halves]))
                return 0.5, []
            return fn

        mod = FT if port else JFT
        monkeypatch.setattr(mod, "rollout_teacher_fused",
                            stub("teacher_fused"))
        monkeypatch.setattr(mod, "rollout_dagger_fused",
                            stub("dagger_fused"))
        monkeypatch.setattr(s.agent, "rollout", stub("rollout"))
        monkeypatch.setattr(s.agent, "rollout_interleaved",
                            stub("interleaved"))
        loss = s.agent.train("R2R", batch_of(s, rows), s.args, s.cfg,
                             dataset=s.ds, step=step)
        assert float(loss) == 0.5 * s.args.gradient_accumulation_step
        seen[port] = calls
    assert seen[True] == seen[False]
    assert seen[True][0][0] == route


def test_split_batch_dict_matches_jax():
    batch = {"observations": list(range(10)), "env": list(range(10)),
             "item": np.arange(10), "data_type": ["r2r"] * 10,
             "instr_id": list(range(10)), "batch_size": 10,
             "shared": "x"}
    for n in (1, 2, 3, 4, 99):
        got, want = _split_batch_dict(batch, n), j_split(batch, n)
        assert len(got) == len(want) == min(n, 10)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["shared"] == "x"
            for k in g:
                assert np.array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_panorama_seed_with_dropout(models, worlds):
    """With feature and hidden dropout on, the host-memory per-step step
    runs the panorama twice under one seed: the copy that feeds the graph
    memory equals the embeddings in the grad call's graph; the next step
    draws other masks. On the device memory the grad call's one panorama
    feeds both. Several steps train through (a graph kept across steps
    would fail the second backward)."""
    jcfg, pj, tcfg, tok, ttok = models
    wet = TNM.NavModelConfig(llm=tcfg.llm, pano=PanoConfig.tiny(
        output_size=tcfg.llm.hidden_size, hidden_dropout_prob=0.1,
        use_obj=True))
    for dev_mem in (False, True):
        s = side(True, models, worlds, "R2R", device_memory=dev_mem)
        runner = NavModelRunner(wet, s.runner.model, ttok,
                                dims=RolloutDims.tiny(), feat_dropout=0.4,
                                device_memory=dev_mem)
        s.agent.runner = runner
        seen = []
        apply = runner.pano_apply

        def recording(pano_dev, generator, deterministic):
            out = apply(pano_dev, generator, deterministic)
            seen.append((generator.initial_seed(), deterministic,
                         out["pano_embeds"].detach().clone()))
            return out

        runner.pano_apply = recording
        runner.zero_grads()
        loss, _ = s.agent.rollout(s.args, "R2R", s.cfg.Optim, batch_of(s),
                                  dataset=s.ds, feedback="teacher",
                                  train_ml=1.0)
        assert np.isfinite(float(loss))
        assert all(not det for _, det, _ in seen)
        if dev_mem:
            assert len(seen) == runner.grad_calls
            continue
        # (memory copy, grad call) pairs of each step, then the next step
        assert len(seen) == 2 * runner.grad_calls >= 4
        for (s1, _, a), (s2, _, b) in zip(seen[::2], seen[1::2]):
            assert s1 == s2
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert seen[0][0] != seen[2][0]
        assert not torch.equal(seen[0][2], seen[2][2])


# ------------------------------------------------ the runner's API --- #
def _tree(x):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in x.items()}


def test_runner_memory_api_matches_jax(models, worlds):
    """panorama_device -> memory_update -> navigation_from_memory ->
    history_append -> memory_reset_slots, and navigation (inference and
    train) and fuse_embeds_only on the same inputs: JAX's numbers."""
    s, js = (side(port, models, worlds, "R2R") for port in (True, False))
    cfg = s.runner.cfg
    b, V, G = 2, 7, 12
    r = np.random.RandomState(3)
    pano = {"view_img_fts": r.randn(b, V, FEAT).astype(np.float32),
            "view_lens": np.array([7, 4], np.int32),
            "loc_fts": r.randn(b, V, 7).astype(np.float32),
            "nav_types": (np.arange(V)[None] < 3).repeat(b, 0)
            .astype(np.int32)}
    nav = T.synthetic_nav_batch(cfg, b=b, g=G, v=V + 1,
                                hh=s.runner.dims.max_hist, tlen=64, seed=4)
    embeds = {k: nav.pop(k) for k in ("gmap_img_embeds", "vp_img_embeds",
                                      "hist_embeds")}
    cur = np.array([3, -1], np.int32)
    cand = np.full((b, V), -1, np.int32)
    cand[0, :3], cand[1, :2] = [5, 6, 7], [2, 3]
    slot_ids = np.full((b, G), -1, np.int32)
    slot_ids[:, 1:6] = [[3, 5, 6, 7, 9], [2, 3, 4, 5, 6]]
    out = {}
    for x in (s, js):
        runner = x.runner
        pe, pm = runner.panorama_device(pano, deterministic=True)
        st = runner.memory_update(runner.memory_init(b), pe, pm, cur, cand)
        logits, fuse = runner.navigation_from_memory(
            st, {**nav, "slot_ids": slot_ids}, pe)
        appended = runner.history_append(st, fuse, np.array([2, -100]))
        reset = runner.memory_reset_slots(appended, np.array([False, True]))
        full = {**nav, **embeds}
        inf_logits, inf_fuse, _ = runner.navigation(full)
        runner.zero_grads()
        tr_logits, _, loss = runner.navigation(
            full, targets=np.array([2, 0]), coef=0.5, train=True)
        out[x.port] = dict(pe=pe, pm=pm, logits=logits, fuse=fuse,
                           inf_logits=inf_logits, inf_fuse=inf_fuse,
                           tr_logits=tr_logits, loss=loss,
                           fuse_only=runner.fuse_embeds_only(full),
                           grads=grads_of(x),
                           **{f"st.{k}": v for k, v in _tree(st).items()},
                           **{f"app.{k}": v
                              for k, v in _tree(appended).items()},
                           **{f"rst.{k}": v
                              for k, v in _tree(reset).items()})
    got, want = out[True], out[False]
    for k in want:
        if k == "grads":
            T.assert_grads_close(got[k], want[k], GRAD_RTOL, GRAD_ATOL)
            continue
        g = got[k].detach().cpu().numpy() if torch.is_tensor(got[k]) \
            else np.asarray(got[k])
        np.testing.assert_allclose(g, np.asarray(want[k], g.dtype),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["app.hist_cnt"].tolist() == [1, 0]
    assert not got["rst.mem_sum"][1].any() and got["rst.mem_sum"][0].any()
    assert s.runner.forward_calls == 2 and s.runner.grad_calls == 1


def test_runner_generation_matches_jax(models, worlds):
    """runner.generation: the generation loss on a batch carrying its
    panorama embeds, without and with training (the gradient into every
    parameter the loss reaches), against JAX's."""
    s, js = (side(port, models, worlds, "R2R") for port in (True, False))
    r = np.random.RandomState(6)
    b, t, v, c, hh = 2, 64, 14, 12, 3
    h = s.runner.cfg.hidden_size
    ids = r.randint(3, s.runner.tok.vocab_size - 1, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, :6] = False
    labels = ids.astype(np.int64)
    labels[:, :40] = -100
    labels[~mask] = -100
    cand_pos = np.full((b, c), -1, np.int32)
    cand_pos[:, :c] = np.arange(8, 8 + c)
    hist_pos = np.full((b, hh), -1, np.int32)
    hist_pos[0, :2] = [25, 26]
    vp_masks = np.zeros((b, v), bool)
    vp_masks[:, :12] = True
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "cand_positions": cand_pos, "hist_positions": hist_pos,
             "hist_embeds": r.randn(b, hh, h).astype(np.float32),
             "vp_masks": vp_masks,
             "vp_img_embeds": r.randn(b, v, h).astype(np.float32)}
    out = {}
    for x in (s, js):
        plain = x.runner.generation(batch)
        x.runner.zero_grads()
        trained = x.runner.generation(batch, coef=0.5, train=True)
        out[x.port] = (plain, trained, grads_of(x))
    (p, tr, grads), (jp, jtr, jgrads) = out[True], out[False]
    assert p == pytest.approx(jp, rel=LOSS_REL)
    assert tr == pytest.approx(jtr, rel=LOSS_REL) and tr == \
        pytest.approx(0.5 * p, rel=1e-5)
    T.assert_grads_close(grads, jgrads, GRAD_RTOL, GRAD_ATOL)
    assert np.abs(grads["llm.lm_head"]).sum() > 0
    assert s.runner.gen_grad_calls == 1 and s.runner.forward_calls == 1
