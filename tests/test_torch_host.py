"""The port's host layer against the JAX package's: the same inputs through
navillm_tpu_torch.{sim, data.metrics, data.loaders, data.feature_db,
models.tokenization} and their navillm_tpu twins give identical results
(integers, strings, paths and float64 distances compared exactly).
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


def test_tokenizer_subword_backends_raise():
    """The HF backend still raises (no transformers on the card); the
    vendored BPE is the port's own (tests/test_torch_tokenizer.py)."""
    with pytest.raises(NotImplementedError, match="byte tokenizer"):
        PT.NavTokenizer.from_pretrained("vicuna")
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


def test_r2r_world_is_written_by_the_ports_sim(tmp_path):
    """make_r2r_world's shortest paths come from the port's ScanGraph and
    agree with the JAX package's on the same connectivity."""
    anno = T.make_r2r_world(tmp_path, n_episodes=6, rows=3, cols=4)
    g = JGR.ScanGraph.from_connectivity(tmp_path / "connectivity", "grid0")
    for item in json.loads(anno.read_text()):
        assert item["path"] == g.path(item["path"][0], item["path"][-1])
