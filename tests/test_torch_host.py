"""The port's host layer against the JAX package's: the same inputs through
navillm_tpu_torch.{sim, data.metrics, data.loaders, data.feature_db,
models.tokenization, eval.captioning} and the CVDN, ScanQA, LLaVA and
augmented datasets, and their navillm_tpu twins give identical results
(integers, strings, paths and float64 distances compared exactly), the
object stores and the REVERIE/SOON/CVDN scorers included.
"""
import json
import random

import numpy as np
import pytest

pytest.importorskip("torch")

from navillm_tpu.data import feature_db as JF  # noqa: E402
from navillm_tpu.data import loaders as JLD  # noqa: E402
from navillm_tpu.data import metrics as JM  # noqa: E402
from navillm_tpu.models import tokenization as JT  # noqa: E402
from navillm_tpu.sim import env as JE  # noqa: E402
from navillm_tpu.sim import geometry as JG  # noqa: E402
from navillm_tpu.sim import graph as JGR  # noqa: E402

from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.prompts import navigation_prompt  # noqa: E402
from navillm_tpu_torch.data import feature_db as PF  # noqa: E402
from navillm_tpu_torch.data import loaders as PLD  # noqa: E402
from navillm_tpu_torch.data import metrics as PM  # noqa: E402
from navillm_tpu_torch.models import tokenization as PT  # noqa: E402
from navillm_tpu_torch.sim import env as PE  # noqa: E402
from navillm_tpu_torch.sim import geometry as PG  # noqa: E402
from navillm_tpu_torch.sim import graph as PGR  # noqa: E402
from navillm_tpu_torch.sim import native as PN  # noqa: E402

SCANS = ["scan0", "scan1"]


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages' graphs on their native library, or both on NumPy."""
    if request.param == "numpy":
        monkeypatch.setattr(JGR, "load_library", lambda: None)
        monkeypatch.setattr(PGR, "load_library", lambda: None)
    elif PN.load_library() is None:
        pytest.skip("no C++ toolchain: the native library cannot build")
    return request.param


def _assert_same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b, (a, b)


def test_geometry_matches():
    r = np.random.RandomState(0)
    h, e = r.uniform(-7, 7, 50), r.uniform(-1.5, 1.5, 50)
    a, pts = r.randn(3), r.randn(20, 3)
    for size in (4, 8, 12):
        _assert_same(PG.angle_feature(h, e, size), JG.angle_feature(h, e, size))
        _assert_same(PG.all_point_angle_features(size),
                     JG.all_point_angle_features(size))
    _assert_same(PG.rel_heading_elevation_dist(a, pts, 0.3, -0.2),
                 JG.rel_heading_elevation_dist(a, pts, 0.3, -0.2))
    dist, steps = r.uniform(0, 20, 20), r.randint(0, 9, 20)
    _assert_same(PG.rel_pos_features(a, pts, dist, steps, 0.4, 0.1),
                 JG.rel_pos_features(a, pts, dist, steps, 0.4, 0.1))
    for x in h:
        for name in ("normalize_angle", "convert_heading",
                     "convert_elevation"):
            _assert_same(getattr(PG, name)(x), getattr(JG, name)(x))
    _assert_same(PG.position_distance(a, pts[0]),
                 JG.position_distance(a, pts[0]))


def _candidate_fields(cands):
    return [(c.viewpoint_id, c.point_id, c.normalized_heading,
             c.normalized_elevation, c.position, c.distance, c.index)
            for c in cands]


def test_world_candidates_match(world_dir, backend):
    pw, jw = PE.WorldModel(world_dir, scans=SCANS), \
        JE.WorldModel(world_dir, scans=SCANS)
    for scan in SCANS:
        pg, jg = pw.graph(scan), jw.graph(scan)
        assert pg.ids == jg.ids
        _assert_same(pg.positions, jg.positions)
        _assert_same(pg.distance_matrix(), jg.distance_matrix())
        for a in pg.ids:
            _assert_same(pg.neighbors(a), jg.neighbors(a))
            _assert_same(_candidate_fields(pw.candidates(scan, a)),
                         _candidate_fields(jw.candidates(scan, a)))
            for b in pg.ids:
                _assert_same(pg.path(a, b), jg.path(a, b))
                _assert_same(pg.distance(a, b), jg.distance(a, b))


def test_episode_batch_teleports_and_headings_match(world_dir):
    pb = PE.EpisodeBatch(PE.WorldModel(world_dir, scans=SCANS), 3)
    jb = JE.EpisodeBatch(JE.WorldModel(world_dir, scans=SCANS), 3)
    r = random.Random(0)
    starts = (["scan0", "scan1", "scan0"], ["vp_0_0", "vp_1_2", "vp_3_3"],
              [0.0, 2.5, -1.0], [0.0, 0.4, -0.6])
    pb.new_episodes(*starts)
    jb.new_episodes(*starts)
    for _ in range(12):
        for i in range(3):
            pc, jc = pb.candidates(i), jb.candidates(i)
            _assert_same(_candidate_fields(pc), _candidate_fields(jc))
            c = r.choice(pc)
            pb.teleport(i, c.viewpoint_id, c.point_id)
            jb.teleport(i, c.viewpoint_id, c.point_id)
        _assert_same([vars(s) for s in pb.get_states()],
                     [vars(s) for s in jb.get_states()])
    for h, e in ((0.1, 0.0), (3.3, 0.7), (-2.0, -0.9)):
        _assert_same(PE.discretize(h, e), JE.discretize(h, e))


def test_episode_graph_matches(world_dir, backend):
    """A random walk that discovers the graph as a rollout does: edges to
    every neighbour, update() at each visited node."""
    world = JE.WorldModel(world_dir, scans=["scan1"])
    g = world.graph("scan1")
    pe, je = PGR.EpisodeGraph(capacity=32), JGR.EpisodeGraph(capacity=32)
    r = random.Random(1)
    vp, seen = g.ids[0], [g.ids[0]]
    for _ in range(10):
        for n in g.neighbors(vp):
            w = g.distance(vp, n)
            pe.add_edge(vp, n, w)
            je.add_edge(vp, n, w)
            if n not in seen:
                seen.append(n)
        pe.update(vp)
        je.update(vp)
        assert pe.ids == je.ids
        for a in seen:
            _assert_same(pe.visited(a), je.visited(a))
            for b in seen:
                _assert_same(pe.distance(a, b), je.distance(a, b))
                _assert_same(pe.path(a, b), je.path(a, b))
        _assert_same(pe.dist_steps(vp, seen), je.dist_steps(vp, seen))
        _assert_same(pe.pair_distances(seen), je.pair_distances(seen))
        vp = r.choice(g.neighbors(vp))


def test_native_library_is_the_ports_own():
    lib = PN.load_library()
    if lib is None:
        pytest.skip("no C++ toolchain: the native library cannot build")
    path = PN._library_path()
    assert path.exists() and path.parent.name == "navillm_tpu_torch" \
        and path.parent.parent.name == "build"
    assert lib._name == str(path)


def test_r2r_metrics_match(world_dir):
    g = JE.WorldModel(world_dir, scans=["scan0"]).graph("scan0")
    r = random.Random(2)
    items = []
    for _ in range(20):
        start, goal = r.sample(g.ids, 2)
        gt = g.path(start, goal)
        traj, vp = [[start]], start
        for _ in range(r.randint(0, 5)):
            nxt = r.choice(g.neighbors(vp))
            traj.append(g.path(vp, nxt)[1:])
            vp = nxt
        pi = PM.eval_r2r_item(g.distance, traj, gt)
        _assert_same(pi, JM.eval_r2r_item(g.distance, traj, gt))
        items.append(pi)
    _assert_same(PM.aggregate_r2r(items), JM.aggregate_r2r(items))
    assert 0 <= PM.aggregate_r2r(items)["spl"] <= PM.aggregate_r2r(
        items)["sr"] <= PM.aggregate_r2r(items)["oracle_sr"]


def _walks(g, r, n):
    """n (start, goal, ground-truth path, random walk from start)."""
    out = []
    for _ in range(n):
        start, goal = r.sample(g.ids, 2)
        traj, vp = [[start]], start
        for _ in range(r.randint(0, 5)):
            nxt = r.choice(g.neighbors(vp))
            traj.append(g.path(vp, nxt)[1:])
            vp = nxt
        out.append((start, goal, g.path(start, goal), traj))
    return out


def test_reverie_metrics_match(world_dir):
    g = JE.WorldModel(world_dir, scans=["scan0"]).graph("scan0")
    r = random.Random(4)
    items = []
    for start, goal, gt, traj in _walks(g, r, 20):
        goals = [goal] + r.sample(g.ids, r.randint(0, 2))
        pred = r.choice(["7", "8", None])
        pi = PM.eval_reverie_item(g.distance, traj, pred, gt, "7", goals)
        _assert_same(pi, JM.eval_reverie_item(g.distance, traj, pred, gt,
                                              "7", goals))
        items.append(pi)
    _assert_same(PM.aggregate_reverie(items), JM.aggregate_reverie(items))
    assert 0 < PM.aggregate_reverie(items)["rgs"] < 100


def test_soon_metrics_match(world_dir):
    g = JE.WorldModel(world_dir, scans=["scan0"]).graph("scan0")
    r = random.Random(5)
    items = []
    for start, goal, gt, traj in _walks(g, r, 20):
        end = traj[-1][-1]
        bb = {"heading": r.random(), "elevation": r.random(),
              "target": {c: {"heading": r.random(), "elevation": r.random()}
                         for c in ("left_top", "right_top", "right_bottom",
                                   "left_bottom")}}
        boxes = {end if r.random() < 0.7 else goal: bb}
        oh, oe = (None, None) if r.random() < 0.2 else (r.random(),
                                                        r.random())
        pi = PM.eval_soon_item(g.distance, traj, gt, boxes, oh, oe)
        _assert_same(pi, JM.eval_soon_item(g.distance, traj, gt, boxes, oh,
                                           oe))
        items.append(pi)
    _assert_same(PM.aggregate_soon(items), JM.aggregate_soon(items))


def test_point_in_polygon_matches_on_and_off_the_boundary():
    """Inside, outside, the vertices and points on each edge of a square
    and of a concave polygon: the port's ray casting answers as the JAX
    package's (the even-odd rule counts a point on a left or bottom edge
    in and one on a right or top edge out)."""
    square = [(0.2, 0.6), (0.6, 0.6), (0.6, 0.2), (0.2, 0.2)]
    concave = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.5, 0.4), (0.0, 1.0)]
    r = np.random.RandomState(6)
    for poly in (square, concave):
        pts = [tuple(p) for p in poly]
        for (x1, y1), (x2, y2) in zip(poly, poly[1:] + poly[:1]):
            pts += [((x1 + x2) / 2, (y1 + y2) / 2),
                    (x1 + 0.25 * (x2 - x1), y1 + 0.25 * (y2 - y1))]
        pts += [tuple(p) for p in r.uniform(-0.2, 1.2, (200, 2))]
        got = [PM.point_in_polygon(x, y, poly) for x, y in pts]
        assert got == [JM.point_in_polygon(x, y, poly) for x, y in pts]
        assert any(got) and not all(got)
    assert PM.point_in_polygon(0.4, 0.4, square)
    assert not PM.point_in_polygon(0.7, 0.4, square)
    assert not PM.point_in_polygon(0.5, 0.6, concave)


def _slice_prompts():
    """Navigation prompts as the slice builds them, plus a prompt/answer
    pair and one prompt past max_length (left truncation)."""
    r = random.Random(3)
    prompts = [navigation_prompt("r2r", T._instruction(r), hist, cand,
                                 "<cls_1>")
               for hist, cand in ((0, 4), (3, 7), (9, 12), (1, 1))]
    return prompts + [(prompts[0], "walk forward</s>"), prompts[2] * 3]


@pytest.mark.parametrize("max_length,multiple", [(1024, 128), (512, 64)])
def test_tokenizer_matches(max_length, multiple):
    pt = PT.NavTokenizer(max_length=max_length, pad_to_multiple=multiple)
    jt = JT.NavTokenizer(max_length=max_length, pad_to_multiple=multiple)
    for name in ("bos_id", "eos_id", "pad_id", "unk_id", "cand_id",
                 "hist_id", "obj_id", "cls_ids", "special_token_ids",
                 "true_vocab_size", "vocab_size"):
        _assert_same(getattr(pt, name), getattr(jt, name))
    _assert_same(pt.special_logit_mask(), jt.special_logit_mask())
    texts = _slice_prompts()
    for pad_to in (None, max_length):
        pb, jb = pt(texts, pad_to=pad_to), jt(texts, pad_to=pad_to)
        for f in ("input_ids", "attention_mask", "token_type_ids"):
            _assert_same(getattr(pb, f), getattr(jb, f))
    for t in texts[:4]:
        ids = pt.encode(t)
        _assert_same(ids, jt.encode(t))
        _assert_same(pt.decode(ids), jt.decode(ids))
        _assert_same(pt.decode(ids, skip_special_tokens=False),
                     jt.decode(ids, skip_special_tokens=False))


def test_tokenizer_subword_backends_raise(tmp_path):
    """A directory whose only tokenizer is a tokenizer.model that is no
    sentencepiece model raises, naming the file, and one with no tokenizer
    at all raises too (the fast-tokenizer reader is held against HF's in
    tests/test_torch_pretrained.py, the sentencepiece reader in
    tests/test_torch_sentencepiece.py); the vendored BPE is the port's own
    (tests/test_torch_tokenizer.py)."""
    (tmp_path / "tokenizer.model").write_bytes(b"\0")
    with pytest.raises(ValueError, match="tokenizer.model: not a "
                                         "sentencepiece model"):
        PT.NavTokenizer.from_pretrained(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        PT.NavTokenizer.from_pretrained(str(tmp_path / "vicuna"))
    assert isinstance(PT.NavTokenizer.bpe().backend, PT.BPETokenizer)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    def collate_batch(self, samples):
        return list(samples)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, seed=7),
    dict(shuffle=True, seed=3, drop_last=True),
    dict(shuffle=True, seed=5, rank=1, world_size=3),
], ids=["ordered", "shuffled", "drop_last", "sharded"])
def test_dataloader_order_matches(kw):
    pl, jl = PLD.Dataloader(_Items(23), 4, **kw), \
        JLD.Dataloader(_Items(23), 4, **kw)
    for epoch in range(3):
        pl.set_epoch(epoch)
        jl.set_epoch(epoch)
        assert len(pl) == len(jl)
        _assert_same(list(pl), list(jl))


def test_metaloader_order_matches():
    def loaders(mod):
        return {"R2R": (mod.Dataloader(_Items(9), 2, True, seed=1), 2.0),
                "CVDN": (mod.Dataloader(_Items(5), 3, True, seed=2), 1.0)}
    pm = PLD.MetaLoader(loaders(PLD), seed=4)
    jm = JLD.MetaLoader(loaders(JLD), seed=4)
    _assert_same([next(pm) for _ in range(40)], [next(jm) for _ in range(40)])
    assert pm.epochs == jm.epochs and min(pm.epochs.values()) > 0


def test_feature_dbs_match(tmp_path):
    keys = [("scan0", "vp_0_0"), ("scan1", "vp_2_4"), ("scan0", "vp_3_1")]
    p, j = PF.SyntheticImageFeaturesDB(24), JF.SyntheticImageFeaturesDB(24)
    _assert_same(p.get_batch_features(keys), j.get_batch_features(keys))
    _assert_same(p.get_image_feature("scan9"), j.get_image_feature("scan9"))
    cfg = {"mp3d": "feats/mp3d.hdf5", "abs": str(tmp_path / "x.hdf5")}
    pd, jd = PF.create_feature_db(cfg, 16, str(tmp_path)), \
        JF.create_feature_db(cfg, 16, str(tmp_path))
    assert {k: (v.img_ft_file, v.image_feat_size) for k, v in pd.items()} \
        == {k: (v.img_ft_file, v.image_feat_size) for k, v in jd.items()}


@pytest.mark.parametrize("style", ["reverie", "soon"])
def test_object_feature_dbs_match(style, tmp_path):
    """synthetic_object_db in either layout: the raw store, load_feature
    (cached, cut to max_objects) and get_object_feature (angle and bbox
    features, ids, SOON's directions) as the JAX package's; a viewpoint
    the store lacks has no objects; create_object_feature_db opens an
    LMDB store at build time, which without lmdb raises ImportError."""
    p, j = PF.synthetic_object_db(style, 12, 5), \
        JF.synthetic_object_db(style, 12, 5)
    assert type(p).__name__ == type(j).__name__
    for scan, vp in (("scan0", "vp_0_0"), ("grid0", "vp_3_1")):
        _assert_same(p.store.get(f"{scan}_{vp}"), j.store.get(f"{scan}_{vp}"))
        for mo in (None, 3):
            _assert_same(p.load_feature(scan, vp, mo),
                         j.load_feature(scan, vp, mo))
            _assert_same(p.get_object_feature(scan, vp, 0.7, -0.2, 4, mo),
                         j.get_object_feature(scan, vp, 0.7, -0.2, 4, mo))

    class Empty:
        def get(self, key):
            return None
    cls = PF.REVERIEObjectFeatureDB if style == "reverie" \
        else PF.SOONObjectFeatureDB
    jcls = getattr(JF, cls.__name__)
    _assert_same(cls("", 12, store=Empty()).get_object_feature(
        "s", "v", 0.0, 0.0, 4), jcls("", 12, store=Empty())
        .get_object_feature("s", "v", 0.0, 0.0, 4))
    _assert_same(PF._bbox_size_fts(30.0, 20.0, 640, 480),
                 JF._bbox_size_fts(30.0, 20.0, 640, 480))
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            PF.create_object_feature_db({style: "obj"}, 12, str(tmp_path))
    assert PF.create_object_feature_db({"other": "x"}, 12, "") == {}


def test_r2r_world_is_written_by_the_ports_sim(tmp_path):
    """make_r2r_world's shortest paths come from the port's ScanGraph and
    agree with the JAX package's on the same connectivity."""
    anno = T.make_r2r_world(tmp_path, n_episodes=6, rows=3, cols=4)
    g = JGR.ScanGraph.from_connectivity(tmp_path / "connectivity", "grid0")
    for item in json.loads(anno.read_text()):
        assert item["path"] == g.path(item["path"][0], item["path"][-1])


def test_cvdn_metrics_match(world_dir):
    """eval_cvdn_item over flattened random walks (goal progress against
    1-3 end panoramas, the planner's goal apart from the trusted path's)
    and aggregate_cvdn."""
    g = JE.WorldModel(world_dir, scans=["scan0"]).graph("scan0")
    r = random.Random(6)
    items = []
    for start, goal, gt, traj in _walks(g, r, 20):
        path = JM.flatten_trajectory(traj)
        planner = g.path(start, r.choice(g.ids))
        ends = [goal] + r.sample(g.ids, r.randint(0, 2))
        pi = PM.eval_cvdn_item(g.distance, path, gt, planner, ends)
        _assert_same(pi, JM.eval_cvdn_item(g.distance, path, gt, planner,
                                           ends))
        items.append(pi)
    _assert_same(PM.flatten_trajectory(traj), path)
    _assert_same(PM.aggregate_cvdn(items), JM.aggregate_cvdn(items))
    agg = PM.aggregate_cvdn(items)
    assert 0 < agg["sr"] < 100 and agg["dist_to_end_reduction"] != 0


# references of five questions: repeated answers, one-word answers, an
# empty hypothesis and one longer than every reference
CAPTION_REFS = {"a": ["two chairs", "two chairs", "2"],
                "b": ["the red sofa by the window", "a sofa"],
                "c": ["brown"], "d": ["on the table near the lamp"],
                "e": ["kitchen", "the kitchen"]}
CAPTION_HYPS = {"a": ["two chairs"], "b": ["a red sofa near the window"],
                "c": [""], "d": ["on the table on the table near a lamp"],
                "e": ["kitchen"]}


@pytest.mark.parametrize("scorer", ["Bleu", "Rouge", "Cider"])
def test_caption_scorers_match(scorer):
    """Each scorer of eval/captioning.py gives JAX's corpus score and
    per-item scores exactly, on the whole set and on one item."""
    from navillm_tpu.eval import captioning as JC
    from navillm_tpu_torch.eval import captioning as PC
    for keys in (list(CAPTION_REFS), ["c"]):
        refs = {k: CAPTION_REFS[k] for k in keys}
        hyps = {k: CAPTION_HYPS[k] for k in keys}
        got = getattr(PC, scorer)().compute_score(refs, hyps)
        want = getattr(JC, scorer)().compute_score(refs, hyps)
        _assert_same(got[0], want[0])
        _assert_same(got[1], want[1])
    assert getattr(PC, scorer)().compute_score(CAPTION_REFS, CAPTION_HYPS)[
        0] != 0


def test_meteor_availability_matches(monkeypatch, tmp_path):
    """METEOR runs only where java and the jar are: both packages agree on
    .available(), and scoring without them raises."""
    from navillm_tpu.eval import captioning as JC
    from navillm_tpu_torch.eval import captioning as PC
    for jar in (str(tmp_path / "missing.jar"), None):
        if jar:
            monkeypatch.setenv("METEOR_JAR", jar)
        assert PC.Meteor().available() == JC.Meteor().available()
    monkeypatch.setenv("METEOR_JAR", str(tmp_path / "missing.jar"))
    with pytest.raises(RuntimeError):
        PC.Meteor().compute_score({"a": ["x"]}, {"a": ["x"]})


def _dataset_pair(name, source, root, cfg, training, **flags):
    from navillm_tpu.data.datasets import load_dataset as j_load
    from navillm_tpu.utils import config as JCFG
    from navillm_tpu_torch.data.datasets import load_dataset as p_load
    from navillm_tpu_torch.utils import config as PCFG
    kw = dict(data_dir=str(root), image_feat_size=32, **flags)
    ds = p_load(name, PCFG.TrainArgs(device="cpu", **kw),
                PCFG.ConfigDict(cfg), training=training, source=source,
                world=PE.WorldModel(str(root / "connectivity")))
    jds = j_load(name, JCFG.TrainArgs(**kw), JCFG.ConfigDict(cfg),
                 training=training, source=source,
                 world=JE.WorldModel(str(root / "connectivity")))
    key = {"scanqa": "scan_qa", "llava": "coco"}.get(name, "mp3d")
    ds.init_feat_db(T.feature_dbs(32)[key])
    jds.init_feat_db(JF.SyntheticImageFeaturesDB(
        32, num_views=36 if key == "mp3d" else 1))
    return ds, jds


def _same_samples(ds, jds):
    """Every sample of both datasets, each read after the same seeds of
    Python's and numpy's global RNGs (ScanQA's frames, the training
    resamplings), twice: the samples and alldata agree after each pass."""
    for _ in range(2):
        random.seed(4)
        np.random.seed(4)
        got = [ds[i] for i in range(len(ds))]
        random.seed(4)
        np.random.seed(4)
        want = [jds[i] for i in range(len(jds))]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if k == "env":
                    continue
                if k == "observations":
                    assert g[k].keys() == w[k].keys()
                    for kk, v in w[k].items():
                        if kk != "candidate":
                            _assert_same(g[k][kk], v)
                else:
                    _assert_same(g[k], w[k])
        assert ds.alldata == jds.alldata
    return got


def _task_config(tmp, aug_ext=".jsonl"):
    split = {"train": "annotations/train{}", "val_unseen":
             "annotations/val{}"}
    cfg = {"Feature": {"image_feat_size": 32, "angle_feat_size": 4,
                       "max_objects": 4},
           "REVERIE": {"DIR": "REVERIE", "bbox_file":
                       "annotations/BBoxes.json"}}
    for task in ("CVDN", "ScanQA", "LLaVA"):
        cfg[task] = {"DIR": task, "SPLIT": {k: v.format(".json")
                                            for k, v in split.items()}}
    for task, d in (("R2R_AUG", "R2R"), ("REVERIE_AUG", "REVERIE")):
        cfg[task] = {"DIR": d, "SPLIT": {"train": "annotations/train_aug"
                                         + aug_ext}}
    return cfg


@pytest.fixture(scope="module")
def qa_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("new_tasks")
    T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=3,
                     split="train")
    T.make_r2r_world(root, n_episodes=5, rows=4, cols=4, seed=4, split="val")
    return root


@pytest.mark.parametrize("name,source,training", [
    ("cvdn", "CVDN", True), ("cvdn", "CVDN", False),
    ("scanqa", "ScanQA", True), ("scanqa", "ScanQA", False),
    ("llava", "LLaVA", True)])
def test_new_datasets_match(name, source, training, qa_world, data_dir,
                            task_config):
    """CVDN (the dialog instruction, the trusted-path correction, the
    128-word cut written back into alldata, seen by the second pass),
    ScanQA (36 of 40-48 frames from the global random) and LLaVA: items,
    gt_trajs and samples of both packages, on the conftest fixture's
    annotations and on make_r2r_world's."""
    for root, cfg in ((data_dir, dict(task_config)),
                      (qa_world, _task_config(qa_world))):
        ds, jds = _dataset_pair(name, source, root, cfg, training)
        assert ds.alldata == jds.alldata and ds.split == jds.split
        if name == "cvdn":
            assert ds.gt_trajs == jds.gt_trajs
        before = [x.get("instruction") for x in ds.alldata]
        samples = _same_samples(ds, jds)
    if name == "cvdn":
        cut = [i for i, x in enumerate(ds.alldata)
               if x["instruction"] != before[i]]
        assert cut and all(len(ds.alldata[i]["instruction"].split()) == 128
                           for i in cut)
        corrected = [x for x in ds.alldata
                     if x["path"] != x["planner_path"]]
        assert corrected and all(x["path"][-1] in x["end_panos"]
                                 for x in corrected)
    if name == "scanqa":
        assert {s["features"].shape[0] for s in samples} == {36}


@pytest.mark.parametrize("flags", [dict(max_datapoints=2),
                                   dict(path_type="planner_path")])
def test_cvdn_flags_match(flags, qa_world):
    """--max_datapoints cuts every new dataset the same way in both
    packages, and a path_type other than trusted_path leaves the planner's
    paths as they are."""
    cfg = _task_config(qa_world)
    for name, source in (("cvdn", "CVDN"), ("scanqa", "ScanQA"),
                         ("llava", "LLaVA")):
        ds, jds = _dataset_pair(name, source, qa_world, cfg, True, **flags)
        assert ds.alldata == jds.alldata
        if "max_datapoints" in flags:
            assert len(ds) == 2
        elif name == "cvdn":
            assert all(x["path"] == x["planner_path"] for x in ds.alldata)


@pytest.mark.parametrize("name,source", [("r2r_aug", "R2R_AUG"),
                                         ("reverie_aug", "REVERIE_AUG")])
@pytest.mark.parametrize("ext", [".jsonl", ".json"])
def test_aug_datasets_match(name, source, ext, qa_world, monkeypatch):
    """The augmented sets: .jsonl token ids through an injected decoder
    (pos_vps as the end viewpoints, objId None) and the .json
    fall-through to the parent loader, items and samples of both packages
    (REVERIE's training resampling from numpy's global RNG)."""
    from navillm_tpu.data.datasets import aug as JA
    from navillm_tpu_torch.data import aug as PA
    for mod in (JA, PA):
        for cls in (mod.R2RAugDataset, mod.REVERIEAugDataset):
            monkeypatch.setattr(cls, "decoder",
                                staticmethod(T.aug_decoder))
    ds, jds = _dataset_pair(name, source, qa_world,
                            _task_config(qa_world, ext), True)
    assert ds.alldata == jds.alldata and ds.gt_trajs == jds.gt_trajs
    assert ds.scans == jds.scans
    _same_samples(ds, jds)
    types = {x["data_type"] for x in ds.alldata}
    if ext == ".jsonl":
        assert types == {name}
        assert all(x["instruction"] == T.aug_decoder(x["instr_encoding"])
                   for x in ds.alldata)
    else:
        assert types == {name.split("_")[0]}
