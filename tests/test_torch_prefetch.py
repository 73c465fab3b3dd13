"""The port's feature prefetcher against the JAX package's.

First the prefetcher alone: both packages' FeaturePrefetcher on the same
counting fake store must fetch the same keys, each once per call, nothing
once the cache holds cache_limit entries, swallow a failed read, and
drain every pending fetch.

Then every rollout that prefetches in JAX (the fused teacher, the fused
DAgger, the per-step rollout and streaming evaluation) over an
ImageFeaturesDB on a small HDF5 file (the same values as the synthetic
store). The harness is tests/test_torch_perstep.py's (converted f32
weights, dropout off, BPE prompts, the same RandomState); the DAgger's
actions are forced. The port must match JAX (trajectories equal, losses
to rtol 1e-4, gradients to rtol 2e-3, atol 2e-5), give the same numbers
bit for bit with its prefetcher held off, and after a drain hold the same
keys in the store's cache as JAX's store.
"""
import sys
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from test_torch_hostmem import _drawn_actions  # noqa: E402
from test_torch_perstep import (FEAT, assert_same, batch_of,  # noqa: E402
                                models, result, side, worlds)

from navillm_tpu.agents import fused_teacher as JFT  # noqa: E402
from navillm_tpu.data.feature_db import \
    ImageFeaturesDB as JImageFeaturesDB  # noqa: E402
from navillm_tpu.data.loaders import Dataloader as JLoader  # noqa: E402
from navillm_tpu.data.prefetch import \
    FeaturePrefetcher as JPrefetcher  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import fused_teacher as FT  # noqa: E402
from navillm_tpu_torch.data.feature_db import (  # noqa: E402
    ImageFeaturesDB, SyntheticImageFeaturesDB)
from navillm_tpu_torch.data.loaders import Dataloader  # noqa: E402
from navillm_tpu_torch.data.prefetch import FeaturePrefetcher  # noqa: E402

PREFETCHERS = {"jax": JPrefetcher, "port": FeaturePrefetcher}
STOP_BIAS = 2.0      # evaluation: episodes end at mixed steps


class _CountingDB:
    """A feature store that records every read; ``_store`` is its cache
    (left out with store=False), reads of ``fail_on`` raise, and with a
    gate every read waits for it."""

    def __init__(self, store=True, fail_on=(), gate=None):
        if store:
            self._store = {}
        self.calls = []
        self.fail_on = set(fail_on)
        self.gate = gate

    def get_image_feature(self, scan, vp):
        if self.gate is not None:
            assert self.gate.wait(10.0)
        self.calls.append((scan, vp))
        if (scan, vp) in self.fail_on:
            raise OSError("corrupt shard")
        return (scan, vp)       # the read's own key, for the cache's checks


def _obs(scan, *cands):
    return {"scan": scan, "candidate": [{"viewpointId": c} for c in cands]}


OBS = [_obs("s0", "a", "b", "a"), _obs("s0", "b", "c"), _obs("s1", "a"),
       {"scan": "s1"}]


def _both(obs, workers=2, cache_limit=4096, **db_kw):
    """{package: (the store, Counter of its reads)} after prefetch + drain;
    db_kw may hold a ``prefill`` dict for the cache."""
    prefill = db_kw.pop("prefill", {})
    out = {}
    for name, cls in PREFETCHERS.items():
        db = _CountingDB(**db_kw)
        if hasattr(db, "_store"):
            db._store.update(prefill)
        pf = cls(db, workers=workers, cache_limit=cache_limit)
        pf.prefetch_candidates(obs)
        pf.drain()
        out[name] = (db, Counter(db.calls))
    return out


def test_fetched_keys_match_jax():
    got = _both(OBS)
    want = {("s0", "a"), ("s0", "b"), ("s0", "c"), ("s1", "a")}
    for db, calls in got.values():
        assert set(calls) == want
        assert db._store == {f"{s}_{v}": (s, v) for s, v in want}
    assert got["port"][1] == got["jax"][1]


def test_duplicates_fetched_once_per_call():
    for db, calls in _both(OBS + OBS).values():
        assert set(calls.values()) == {1}


def test_no_fetch_after_cache_limit():
    # at the limit: nothing is read
    full = _both(OBS, cache_limit=3,
                 prefill={f"k{i}": None for i in range(3)})
    # one short of it, one worker: the first key gets in, then none
    short = _both(OBS, workers=1, cache_limit=3,
                  prefill={f"k{i}": None for i in range(2)})
    for name in PREFETCHERS:
        db, calls = full[name]
        assert not calls and len(db._store) == 3
        db, calls = short[name]
        assert sum(calls.values()) == 1 and len(db._store) == 3
    assert short["port"][1] == short["jax"][1] == Counter({("s0", "a"): 1})


def test_failed_read_is_swallowed():
    got = _both(OBS, fail_on={("s0", "b")})
    for db, calls in got.values():
        assert calls[("s0", "b")] == 1
        assert "s0_b" not in db._store and "s0_c" in db._store
    assert got["port"][1] == got["jax"][1]


def test_store_less_db_is_read_and_thrown_away():
    got = _both(OBS, store=False)
    for db, calls in got.values():
        assert len(calls) == 4 and not hasattr(db, "_store")
    assert got["port"][1] == got["jax"][1]


@pytest.mark.parametrize("package", sorted(PREFETCHERS))
def test_drain_waits_on_every_future(package):
    gate = threading.Event()
    db = _CountingDB(gate=gate)
    pf = PREFETCHERS[package](db, workers=2)
    pf.prefetch_candidates(OBS)
    pending = list(pf._pending)
    assert len(pending) == 4 and not db.calls
    opener = threading.Timer(0.2, gate.set)
    opener.start()
    pf.drain()
    assert all(f.done() for f in pending) and pf._pending == []
    assert len(db.calls) == 4 and len(db._store) == 4
    opener.join()


@pytest.mark.parametrize("package", sorted(PREFETCHERS))
def test_workers_lose_no_write(package):
    """16 workers writing one dict under a short switch interval: every
    key lands once with its own value, and the cap (checked before each
    read, without a lock, as in JAX) is passed by at most workers - 1."""
    workers, n = 16, 600
    obs = [_obs(f"s{i % 7}", *(f"v{i}_{j}" for j in range(3)))
           for i in range(n // 3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        db = _CountingDB()
        pf = PREFETCHERS[package](db, workers=workers)
        pf.prefetch_candidates(obs)
        pf.drain()
        capped = _CountingDB()
        pc = PREFETCHERS[package](capped, workers=workers, cache_limit=50)
        pc.prefetch_candidates(obs)
        pc.drain()
    finally:
        sys.setswitchinterval(interval)
    assert len(db.calls) == len(db._store) == n
    assert all(k == f"{s}_{v}" for k, (s, v) in db._store.items())
    assert 50 <= len(capped._store) <= 50 + workers - 1


# ---------------- the rollouts over an HDF5 store ----------------

@pytest.fixture(scope="module")
def h5_file(worlds, tmp_path_factory):
    """Every viewpoint of the world, [36, FEAT] f32: the synthetic store's
    values, so the harness's recorded actions stay valid."""
    path = tmp_path_factory.mktemp("features") / "views.hdf5"
    synth = SyntheticImageFeaturesDB(FEAT)
    scan = "grid0"
    with h5py.File(path, "w") as f:
        for r in range(4):
            for c in range(4):
                vp = f"vp_{r}_{c}"
                f[f"{scan}_{vp}"] = synth.get_image_feature(scan, vp)
    return path


def _with_store(port, models, worlds, h5_file, prefetch=True, **side_kw):
    s = side(port, models, worlds, "R2R", **side_kw)
    s.ds.init_feat_db((ImageFeaturesDB if port else JImageFeaturesDB)(
        h5_file, FEAT))
    if not prefetch:
        T.hold_off_prefetch(s.agent)
    return s


def _keys(s):
    """The store's cached keys once every prefetch has landed."""
    s.agent._prefetcher.drain()
    return set(s.ds.feat_db._store)


def _train(port, models, worlds, h5_file, kind, prefetch=True,
           forced=None):
    s = _with_store(port, models, worlds, h5_file, prefetch)
    s.runner.zero_grads()
    batch = batch_of(s)
    if kind == "perstep":
        loss, traj = s.agent.rollout(s.args, "R2R", s.cfg.Optim, batch,
                                     dataset=s.ds, feedback="teacher",
                                     train_ml=1.0)
    else:
        mod = FT if port else JFT
        fn = mod.rollout_dagger_fused if kind == "dagger" \
            else mod.rollout_teacher_fused
        kw = dict(forced_actions=forced) if kind == "dagger" else {}
        loss, traj = fn(s.agent, s.args, "R2R", s.cfg.Optim, batch,
                        dataset=s.ds, train_ml=1.0, **kw)
    return result(s, loss, traj), s, loss


@pytest.fixture(scope="module")
def forced(models, worlds):
    return _drawn_actions(models, worlds)[1]


@pytest.mark.parametrize("kind", ["teacher", "dagger", "perstep"])
def test_training_with_prefetch_matches_jax(models, worlds, h5_file, forced,
                                            kind):
    got, s, loss = _train(True, models, worlds, h5_file, kind,
                          forced=forced)
    want, js, _ = _train(False, models, worlds, h5_file, kind, forced=forced)
    off, s_off, loss_off = _train(True, models, worlds, h5_file, kind,
                                  prefetch=False, forced=forced)
    assert isinstance(s.agent._prefetcher, FeaturePrefetcher)
    assert_same(got, want, stages=False)
    # held off: the same numbers, bit for bit
    assert got.paths == off.paths
    assert torch.equal(torch.as_tensor(loss), torch.as_tensor(loss_off))
    assert sorted(got.grads) == sorted(off.grads)
    for name, g in got.grads.items():
        assert np.array_equal(g, off.grads[name]), name
    # the cache: JAX's keys; without the prefetcher the store (cache=False)
    # caches nothing
    keys = _keys(s)
    assert keys == _keys(js) and len(keys) > len(batch_of(s)["item"])
    assert not s_off.ds.feat_db._store


def _stream(port, models, worlds, h5_file, prefetch=True):
    s = _with_store(port, models, worlds, h5_file, prefetch, training=False,
                    stop_bias=STOP_BIAS)
    loader = (Dataloader if port else JLoader)(s.ds, 2, False)
    preds = s.agent.validate_streaming("R2R", s.args, s.cfg, loader,
                                       dataset=s.ds)
    return {p["instr_id"]: p for p in preds}, s


def test_streaming_eval_with_prefetch_matches_jax(models, worlds, h5_file):
    got, s = _stream(True, models, worlds, h5_file)
    want, js = _stream(False, models, worlds, h5_file)
    off, s_off = _stream(True, models, worlds, h5_file, prefetch=False)
    assert got == want == off and len(got) == len(s.ds)
    assert len({len(p["trajectory"]) for p in got.values()}) > 1
    keys = _keys(s)
    assert keys == _keys(js) and keys
    assert not s_off.ds.feat_db._store


def test_npy_store_reads_as_hdf5(models, worlds, h5_file, tmp_path):
    """testing.NpyFeaturesDB (the card's disk-backed store): the HDF5
    store's values; its main-thread reads hit the cache only where a
    prefetcher filled it, and the fused teacher's numbers do not move."""
    root = T.write_npy_features(tmp_path / "npy", worlds / "connectivity",
                                FEAT)
    h5 = ImageFeaturesDB(h5_file, FEAT)
    npy = T.NpyFeaturesDB(root, FEAT)
    for vp in ("vp_0_0", "vp_3_2"):
        assert np.array_equal(npy.get_image_feature("grid0", vp),
                              h5.get_image_feature("grid0", vp))
    assert npy.reads == 2 and npy.hits == 0 and not npy._store

    runs = {}
    for prefetch in (True, False):
        s = side(True, models, worlds, "R2R")
        s.ds.init_feat_db(T.NpyFeaturesDB(root, FEAT))
        if not prefetch:
            T.hold_off_prefetch(s.agent)
        s.runner.zero_grads()
        loss, traj = FT.rollout_teacher_fused(
            s.agent, s.args, "R2R", s.cfg.Optim, batch_of(s), dataset=s.ds,
            train_ml=1.0)
        s.agent._prefetcher.drain()
        runs[prefetch] = (float(loss), s.ds.feat_db)
    (loss_on, on), (loss_off, off) = runs[True], runs[False]
    assert loss_on == loss_off
    assert on.reads == off.reads > 0
    assert 0 < on.hits <= on.reads and off.hits == 0
    assert len(on._store) > 0 and not off._store
