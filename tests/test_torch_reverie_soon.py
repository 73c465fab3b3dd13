"""The port's REVERIE and SOON paths against the JAX package: the datasets
(items, observations with objects, training resampling, eval_metrics),
streaming evaluation with object grounding (enable_og; argmax, and sampled
at T = 0.01) and the fused trainer's OG head on a teacher batch and on a
forced DAgger batch.

Both sides get the same world (testing.make_r2r_world's REVERIE and SOON
annotations, or the conftest fixture's), synthetic image and object
features, converted f32 weights with dropout off and the identity
candidate permutation. Trajectories and pred_objid must be identical;
losses agree to rtol 1e-4 and gradients under testing.assert_grads_close
at rtol 2e-3 (tests/test_torch_train.py).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import load_agent as j_load_agent  # noqa: E402
from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
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
from navillm_tpu_torch.ops.masking import NEG_INF  # noqa: E402
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
TASKS = ["REVERIE", "SOON"]
STYLE = {"REVERIE": "reverie", "SOON": "soon"}
FEAT, OBJ_FEAT, N_OBJECTS = 32, 16, 4
MAX_ACTION_LEN = 5
ROWS_PER_CALL = 4
LOSS_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
OBJ_COEF = 0.7
# sampled evaluation at this temperature is held to JAX's greedy run where
# every step's top-2 logit margin exceeds MARGIN_TEMPS temperatures (a
# Gumbel-max draw then leaves the argmax with probability < e^-20)
TEMPERATURE = 0.01
MARGIN_TEMPS = 20


class _IdentityRng:
    def permutation(self, x):
        return np.asarray(x)


def _sparse(store_cls):
    """A synthetic object store that has no objects at every third
    viewpoint (by the key's hash), so some episodes end where there is
    nothing to ground."""
    class Sparse(store_cls):
        def get(self, key):
            if int.from_bytes(key.encode()[-3:], "little") % 3 == 0:
                return None
            return super().get(key)
    return Sparse


def _obj_db(port, task, sparse=False):
    mod = FDB if port else JFDB
    if not sparse:
        return mod.synthetic_object_db(STYLE[task], OBJ_FEAT, N_OBJECTS)
    store = _sparse(mod._SyntheticObjectStore)(OBJ_FEAT, N_OBJECTS,
                                               STYLE[task])
    cls = mod.REVERIEObjectFeatureDB if task == "REVERIE" \
        else mod.SOONObjectFeatureDB
    return cls("", OBJ_FEAT, store=store)


def _config(task, max_action_len=MAX_ACTION_LEN, max_objects=N_OBJECTS):
    ext = "json" if task == "REVERIE" else "jsonl"
    sec = {"DIR": task, "SPLIT": {"train": f"annotations/train.{ext}",
                                  "val_unseen": f"annotations/val.{ext}"}}
    if task == "REVERIE":
        sec["bbox_file"] = "annotations/BBoxes.json"
    return {"Feature": {"image_feat_size": FEAT, "angle_feat_size": 4,
                        "obj_feat_size": OBJ_FEAT,
                        "max_objects": max_objects},
            task: sec,
            "Optim": {"val_max_action_len": {task: max_action_len},
                      "train_max_action_len": {task: max_action_len}}}


def _side(port, root, task, training, cfg=None, sparse=False, **flags):
    """(args, cfg, world, dataset with features) of one package."""
    cfg = cfg if cfg is not None else _config(task)
    kw = dict(data_dir=str(root), val_batch_size=2, seed=0,
              image_feat_size=FEAT, obj_feat_size=OBJ_FEAT,
              fused_rows_per_call=ROWS_PER_CALL, obj_loss_coef=OBJ_COEF,
              **flags)
    if port:
        args, cfg = TCFG.TrainArgs(device="cpu", **kw), TCFG.ConfigDict(cfg)
        world = WorldModel(str(root / "connectivity"))
        ds = load_dataset(task.lower(), args, cfg, training=training,
                          source=task, world=world)
        ds.init_feat_db(FDB.SyntheticImageFeaturesDB(FEAT),
                        _obj_db(True, task, sparse))
    else:
        args, cfg = TrainArgs(**kw), ConfigDict(cfg)
        world = JWorld(str(root / "connectivity"))
        ds = j_load(task.lower(), args, cfg, training=training, source=task,
                    world=world)
        ds.init_feat_db(JFDB.SyntheticImageFeaturesDB(FEAT),
                        _obj_db(False, task, sparse))
    return args, cfg, world, ds


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("objects")
    T.make_r2r_world(root, n_episodes=8, rows=4, cols=4, seed=3,
                     split="train")
    T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=4, split="val")
    return root


@pytest.fixture(scope="module")
def models():
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jllm = JNM.L.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    jcfg = JNM.NavModelConfig(llm=jllm, pano=JPano.tiny(
        output_size=jllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    tllm = TL.LlamaConfig.tiny(vocab_size=tok.vocab_size)
    tcfg = TNM.NavModelConfig(llm=tllm, pano=PanoConfig.tiny(
        output_size=tllm.hidden_size, hidden_dropout_prob=0.0, use_obj=True))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    # decisive navigation logits (a wide out_head) and a stop bias, so that
    # episodes end at mixed steps and every step's top-2 margin is wide
    pj["out_head"]["w"] = pj["out_head"]["w"] * 30.0
    pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(42.0)
    return jcfg, pj, tcfg, tok, ttok


def _runners(models, feat_dropout=0.0):
    jcfg, pj, tcfg, tok, ttok = models
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok, dims=JDims.tiny(),
                 feat_dropout=feat_dropout)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    tr = NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny(),
                        feat_dropout=feat_dropout)
    return jr, tr


# ------------------------------------------------------------ datasets --- #
def _fixture_config(task_config):
    return {k: task_config[k] for k in ("Feature", "REVERIE", "SOON")}


@pytest.mark.parametrize("task", TASKS)
def test_datasets_match_jax(task, worlds, data_dir, task_config):
    """Items, gt_trajs (REVERIE's obj2vps), observations with the objects
    of the viewpoint (gt_obj_id where the target is seen), training
    resampling from numpy's global RNG (REVERIE's end viewpoints, SOON's
    heading and end viewpoint), eval_metrics and save_json, on the
    conftest fixture's annotations and on make_r2r_world's."""
    for root, cfg in ((data_dir, _fixture_config(task_config)),
                      (worlds, _config(task))):
        for training in (False, True):
            sides = [_side(port, root, task, training, cfg=cfg)
                     for port in (True, False)]
            (_, _, _, ds), (_, _, _, jds) = sides
            assert ds.alldata == jds.alldata and ds.split == jds.split
            assert ds.gt_trajs == jds.gt_trajs
            assert ds.max_objects == jds.max_objects
            if task == "REVERIE":
                assert ds.obj2vps == jds.obj2vps
            np.random.seed(5)
            got = [ds[k] for k in range(len(ds))]
            np.random.seed(5)
            want = [jds[k] for k in range(len(jds))]
            for g, w in zip(got, want):
                assert g["item"]["path"] == w["item"]["path"]
                assert g["item"].get("heading") == w["item"].get("heading")
                ob, job = g["observations"], w["observations"]
                assert ob.keys() == job.keys() and "obj_img_fts" in ob
                for k, v in job.items():
                    if k == "candidate":
                        continue
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(ob[k], v, err_msg=k)
                    else:
                        assert ob[k] == v, k
    # make_r2r_world's targets are among the objects at their goals
    for x in ds.alldata:
        goal = x["path"][-1]
        target = x["objId"] if task == "REVERIE" \
            else x["image_id_to_obj_label"][goal]["obj_id"]
        assert str(target) in [str(i) for i in ds.obj_feat_db.load_feature(
            x["scan"], goal)[1]["obj_ids"]]
    # scores of predictions that end on each path's k-th node, with the
    # k-th object (SOON: its direction) predicted
    preds = []
    for k, x in enumerate(jds.alldata):
        pred = {"instr_id": x["instr_id"],
                "trajectory": [[p] for p in x["path"][:k % len(x["path"])
                                                      + 1]]}
        if task == "REVERIE":
            pred["pred_objid"] = x["objId"] if k % 2 else None
        else:
            c = jds.gt_trajs[x["instr_id"]]["bboxes"]
            vp = next(iter(c))
            pred["pred_obj_direction"] = [c[vp]["heading"],
                                          c[vp]["elevation"]] \
                if k % 2 else None
        preds.append(pred)
    (avg, per), (javg, jper) = ds.eval_metrics(preds, None, task), \
        jds.eval_metrics(preds, None, task)
    assert avg.keys() == javg.keys()
    for k in javg:
        assert avg[k] == pytest.approx(javg[k], rel=1e-9), k
    assert dict(per) == dict(jper)
    assert avg["rgs" if task == "REVERIE" else "det_sr"] > 0


# ------------------------------------------------- streaming evaluation --- #
def _stream(port, runner, root, task, record=None, **flags):
    """validate_streaming with enable_og on one package: {instr_id:
    prediction}, the scores and the dataset."""
    args, cfg, world, ds = _side(port, root, task, False, sparse=True,
                                 enable_og=True, **flags)
    agent_of, loader = (load_agent, Dataloader) if port \
        else (j_load_agent, JLoader)
    agent = agent_of(task.lower(), args, world, runner)
    preds = agent.validate_streaming(task, args, cfg, loader(ds, 2, False),
                                     dataset=ds)
    scores, _ = ds.eval_metrics(preds, None, task)
    return {p["instr_id"]: p for p in preds}, scores, ds


def _check_objects(preds, ds, task):
    """pred_objid is one of the final viewpoint's objects, or None exactly
    where it has none; SOON's direction rides along."""
    db = ds.obj_feat_db
    nones = 0
    for p in preds.values():
        vp = p["trajectory"][-1][-1]
        scan = ds.gt_trajs[p["instr_id"]][0] if task == "REVERIE" \
            else ds.gt_trajs[p["instr_id"]]["scan"]
        ids = db.load_feature(scan, vp)[1].get("obj_ids", [])
        if len(ids):
            assert p["pred_objid"] in list(ids)
            if task == "SOON":
                assert all(np.isfinite(p["pred_obj_direction"]))
        else:
            nones += 1
            assert p["pred_objid"] is None
            assert p["pred_obj_direction"] is None
    return nones


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["uncached", "cached"])
@pytest.mark.parametrize("task", TASKS)
def test_streaming_og_matches_jax(models, worlds, task, prefix_cache):
    """Argmax streaming evaluation with the OG queue: trajectories,
    pred_objid and pred_obj_direction identical to JAX's (episodes that
    end where there is no object get None), the scores too; one OG call
    per flush of the two-slot width."""
    jr, tr = _runners(models)
    got, scores, ds = _stream(True, tr, worlds, task,
                              prefix_cache=prefix_cache)
    want, jscores, _ = _stream(False, jr, worlds, task,
                               prefix_cache=prefix_cache)
    assert got.keys() == want.keys() and len(got) == len(ds) == 6
    for k, p in want.items():
        assert got[k]["trajectory"] == p["trajectory"], k
        assert got[k]["pred_objid"] == p["pred_objid"], k
        assert got[k]["pred_obj_direction"] == p["pred_obj_direction"], k
    assert len({len(p["trajectory"]) for p in got.values()}) > 1
    _check_objects(got, ds, task)
    for k in jscores:
        assert scores[k] == pytest.approx(jscores[k], rel=1e-9), k
    assert tr.og_calls == 3
    if prefix_cache:
        assert tr.cached_steps and not tr.eval_steps


@pytest.mark.parametrize("task", TASKS)
def test_sampled_eval_matches_jax_greedy(models, worlds, task):
    """do_sample at T = 0.01 on the card's sampler against JAX's greedy
    run: JAX's logits show every step's top-2 margin above MARGIN_TEMPS
    temperatures, so the draws are the argmax and the trajectories and
    pred_objid are JAX's."""
    jr, tr = _runners(models)
    margins = []
    step = jr.eval_step

    def recording_step(*a, **kw):
        out = step(*a, **kw)
        logits, active = np.asarray(out[2]), np.asarray(a[6])
        for row in logits[active]:
            top = np.sort(row[row > NEG_INF / 2])[::-1]
            margins.append(top[0] - top[1] if len(top) > 1 else np.inf)
        return out

    jr.eval_step = recording_step
    want, _, _ = _stream(False, jr, worlds, task)
    got, _, ds = _stream(True, tr, worlds, task, do_sample=True,
                         temperature=TEMPERATURE)
    assert margins and min(margins) > MARGIN_TEMPS * TEMPERATURE
    assert got == want
    assert _check_objects(got, ds, task) < len(got)


# ------------------------------------------------------- fused training --- #
def _batch(ds, b=4, index=0):
    np.random.seed(11)
    return list(Dataloader(ds, b, False))[index]


def _jbatch(ds, b=4, index=0):
    np.random.seed(11)
    return list(JLoader(ds, b, False))[index]


def _train(port, models, worlds, task, dagger=False, forced=None, **flags):
    jr, tr = _runners(models)
    runner = tr if port else jr
    args, cfg, world, ds = _side(port, worlds, task, True,
                                 **{"enable_og": True, **flags})
    agent = (load_agent if port else j_load_agent)(task.lower(), args,
                                                   world, runner)
    agent.np_rng = _IdentityRng()
    batch = (_batch if port else _jbatch)(ds)
    if port:
        fn = FT.rollout_dagger_fused if dagger else FT.rollout_teacher_fused
        optim = T.train_config(MAX_ACTION_LEN, task).Optim
    else:
        fn = JFT.rollout_dagger_fused if dagger else JFT.rollout_teacher_fused
        optim = cfg.Optim
    kw = dict(forced_actions=forced, np_rng=_IdentityRng()) if dagger else {}
    runner.zero_grads()
    loss, traj = fn(agent, args, task, optim, batch, dataset=ds,
                    train_ml=1.0, **kw)
    if port:
        grads = grads_to_numpy(tr.model)
    else:
        grads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))
    paths = [(t["path"], t.get("pred_objid"), t.get("pred_obj_direction"))
             for t in traj]
    return float(loss), grads, paths, runner


def _assert_same(got, want, og_calls):
    loss, grads, paths, runner = got
    wloss, wgrads, wpaths, _ = want
    assert paths == wpaths
    assert any(p[1] is not None for p in paths)
    assert loss == pytest.approx(wloss, rel=LOSS_REL)
    assert sorted(grads) == sorted(wgrads)
    T.assert_grads_close(grads, wgrads, GRAD_RTOL, GRAD_ATOL)
    # the head's loss reached the object branch and the history-reading
    # position MLP
    for name in ("pano.obj_projector.w", "obj_pos.w", "llm.layers.wq"):
        assert np.abs(grads[name]).sum() > 0, name
    assert runner.og_grad_calls == og_calls


@pytest.mark.parametrize("task", TASKS)
def test_fused_teacher_og_head_matches_jax(models, worlds, task):
    """A teacher batch of 4 with enable_og: the expert reaches every goal,
    so the OG head has targets; the trajectories, pred_objid, loss and
    every gradient leaf are JAX's. The leaves are held by
    testing.assert_grads_close: a few llm.embed elements cancel to 1e-5 to
    1.3e-3 of their row's RMS, and there the two libraries' summation
    orders part by more than rtol of the element (2.8e-5 to 2.6e-4 off
    across the instruction-set settings of scripts/parity_sweep.sh); JAX
    under SSE4_2 against JAX under default XLA, on the same weights, parts
    at such elements by as much (scripts/parity_isa_probe.py)."""
    got = _train(True, models, worlds, task)
    _assert_same(got, _train(False, models, worlds, task), og_calls=1)
    base = _train(True, models, worlds, task, enable_og=False)
    assert got[0] > base[0] and base[3].og_grad_calls == 0


def _expert_forced(models, worlds, task):
    """[T][B] forced actions: the expert's target at each step of the
    teacher batch (recorded from the port's phase 1), and 1 after a row's
    episode ended, so that ended rows keep appending history."""
    steps_of = []
    train = FT._fused_trajectory_train

    def capture(agent, args, *, steps, traj, **kw):
        steps_of.append(steps)
        return 0.0, traj

    FT._fused_trajectory_train = capture
    try:
        _train(True, models, worlds, task, enable_og=False)
    finally:
        FT._fused_trajectory_train = train
    steps, = steps_of
    return [np.where(s["targets"] < 0, 1, s["targets"]).astype(np.int64)
            for s in steps], [s["ended"] for s in steps]


@pytest.mark.parametrize("task", TASKS)
def test_fused_dagger_og_head_matches_jax(models, worlds, task,
                                          monkeypatch):
    """A DAgger batch of 4 (two slot groups, prefix-cached sampling) with
    the expert's actions forced: in each group a row ends while the other
    walks on, its drawn actions still appending history, which the OG
    head reads, so the loss pass compacts nothing (JAX
    fused_teacher.py:746-758). Trajectories, pred_objid, loss and every
    gradient leaf are JAX's (testing.assert_grads_close, for the reason
    the teacher test gives: on the REVERIE batch JAX under SSE4_2 against
    JAX under default XLA, on the same weights, puts 3 llm.embed elements
    over the elementwise bound, one of them 0.021 off by 6.4e-5 in a row
    of RMS 2.56); compacting the ended rows anyway moves the OG logits and
    the loss."""
    forced, ended = _expert_forced(models, worlds, task)
    ended = np.asarray(ended)                         # [T, B]
    for g in (slice(0, 2), slice(2, 4)):
        part = ended[:-1, g]
        assert (part.any(1) & ~part.all(1)).any(), \
            "a group's row must end while the other walks on"
    want = _train(False, models, worlds, task, dagger=True, forced=forced)
    got = _train(True, models, worlds, task, dagger=True, forced=forced)
    _assert_same(got, want, og_calls=2)
    live_rows = FT._live_rows
    monkeypatch.setattr(FT, "_live_rows",
                        lambda steps, feedback, run_og:
                        live_rows(steps, "teacher", run_og))
    compacted = _train(True, models, worlds, task, dagger=True,
                       forced=forced)
    assert compacted[2] == got[2]
    assert compacted[0] != pytest.approx(got[0], rel=1e-3)


def test_object_grounding_helpers(models, worlds, tmp_path):
    """The OG head's evaluation branch (_object_grounding_step with
    training off) writes JAX's pred_objid and direction for a batch of
    observations with 0-3 history embeds; teacher_object marks the
    target's option (index + 1) where the viewpoint sees it, ignoreid
    elsewhere; save_json writes the leaderboard formats."""
    jr, tr = _runners(models)
    for task in TASKS:
        args, _, world, ds = _side(True, worlds, task, False, enable_og=True,
                                   sparse=True)
        jargs, _, jworld, jds = _side(False, worlds, task, False,
                                      enable_og=True, sparse=True)
        agent = load_agent(task.lower(), args, world, tr)
        jagent = j_load_agent(task.lower(), jargs, jworld, jr)
        obs = [ds[k]["observations"] for k in range(len(ds))]
        jobs = [jds[k]["observations"] for k in range(len(jds))]
        r = np.random.RandomState(2)
        hist_vis = [list(r.randn(k % 4, jr.cfg.hidden_size)
                         .astype(np.float32)) for k in range(len(obs))]
        history = [["<hist>"] * len(h) for h in hist_vis]
        instr = [ob["instruction"] for ob in obs]
        traj = [{} for _ in obs]
        jtraj = [{} for _ in obs]
        assert agent._object_grounding_step(args, obs, instr, history,
                                            hist_vis, traj, False) == 0.0
        jagent._object_grounding_step(jargs, jobs, None, None, instr,
                                      history, hist_vis, None, jtraj,
                                      len(jobs), validate=True,
                                      training=False)
        assert traj == jtraj and any(t["pred_objid"] is None for t in traj)
        assert any(t["pred_objid"] is not None for t in traj)
        ob = dict(obs[0], gt_end_vps=[obs[0]["viewpoint"]],
                  gt_obj_id=obs[0]["obj_ids"][2])
        targets = agent.teacher_object([ob, dict(ob, gt_end_vps=[]),
                                        dict(ob, obj_ids=[])])
        assert targets.tolist() == [3, args.ignoreid, args.ignoreid]
        preds = [{"instr_id": x["instr_id"], "trajectory": [[x["path"][0]]],
                  "pred_objid": "7", "pred_obj_direction": [0.25, 0.5]}
                 for x in ds.alldata]
        ds.save_json(preds, tmp_path / f"{task}.json")
        out = json.loads((tmp_path / f"{task}.json").read_text())
        if task == "REVERIE":
            assert out[0]["predObjId"] == 7
        else:
            assert out[0]["trajectory"][0]["obj_heading"] == [0.25]
