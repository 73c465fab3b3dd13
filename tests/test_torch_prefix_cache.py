"""The port's prefix-cached eval path vs its own full forward and the JAX
package's cached path.

Weights are the JAX init converted with params_from_jax; inputs are numpy
from a seed; f32, tiny dims (2 layers, hidden 128). Hidden states and
logits are held to rtol 2e-4, atol 2e-4 against the full forward (a
different summation order over the same tokens, as the JAX package's own
chunk parity test) and to rtol 1e-4, atol 1e-5 against JAX's cached path
(the same function); actions, cache lengths and trajectories must be
identical.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import device_memory as JDM  # noqa: E402
from navillm_tpu.agents import load_agent  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset  # noqa: E402
from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu.data.loaders import Dataloader  # noqa: E402
from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models import quant as JQ  # noqa: E402
from navillm_tpu.models.pano_encoder import forward_panorama  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa: E402
from navillm_tpu.sim import WorldModel  # noqa: E402
from navillm_tpu.testing import synthetic_nav_batch  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import device_memory as TDM  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import EvalArgs, R2RAgent  # noqa
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims  # noqa
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa: E402

torch.set_num_threads(1)
FULL_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = 300


@functools.lru_cache(maxsize=None)
def _nav_params():
    jcfg = JNM.NavModelConfig.tiny(vocab_size=VOCAB, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=VOCAB, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                                   device="cpu"))
    return jcfg, tcfg, pj, model


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _window_mask(lens, width):
    return np.arange(width)[None, :] < np.asarray(lens)[:, None]


def _full_hidden(model, tcfg, rows):
    """The port's full forward of each token row alone."""
    out = []
    for row in rows:
        ids = _t(np.asarray(row, np.int32)[None])
        emb = TL.embed_with_injection(model.llm, ids)
        out.append(TL.forward_hidden(model.llm, tcfg.llm, emb,
                                     torch.ones(ids.shape, dtype=torch.bool)
                                     )[0].numpy())
    return out


def _prefill_kv(model, tcfg, ids, lens, pad):
    """forward_hidden(return_kv) over right-padded prefixes, the cache
    grown by ``pad`` empty slots."""
    pm = _window_mask(lens, ids.shape[1])
    emb = TL.embed_with_injection(model.llm, _t(ids)) * _t(pm)[..., None]
    _, kv = TL.forward_hidden(model.llm, tcfg.llm, emb, _t(pm),
                              return_kv=True)
    return {k: torch.cat([v, v.new_zeros((*v.shape[:2], pad, *v.shape[3:]))],
                         dim=2) for k, v in kv.items()}


def test_forward_hidden_return_kv_matches_jax():
    jcfg, tcfg, pj, model = _nav_params()
    r = np.random.RandomState(0)
    b, t = 3, 20
    ids = r.randint(9, VOCAB, (b, t)).astype(np.int32)
    mask = _window_mask([20, 7, 0], t)          # right padding, one empty row
    emb_j = JL.embed_with_injection(pj["llm"], ids) * mask[..., None]
    hj, kvj = JL.forward_hidden(pj["llm"], jcfg.llm, emb_j, mask,
                                return_kv=True)
    emb_t = TL.embed_with_injection(model.llm, _t(ids)) * _t(mask)[..., None]
    with torch.no_grad():
        ht, kvt = TL.forward_hidden(model.llm, tcfg.llm, emb_t, _t(mask),
                                    return_kv=True)
        plain = TL.forward_hidden(model.llm, tcfg.llm, emb_t, _t(mask))
    assert kvt["k"].shape == (2, b, t, 4, 32)
    for name in ("k", "v"):
        np.testing.assert_allclose(kvt[name].numpy(),
                                   np.asarray(kvj[name]), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    assert torch.isfinite(ht).all()                 # the all-false row too
    torch.testing.assert_close(ht, plain, rtol=0, atol=0)


def test_chunk_forward_cached_matches_full_forward_and_jax():
    """Twin of tests/test_llama.py's chunk parity: ragged prefixes
    prefilled, a written history-append window, then a read-only suffix
    window; against the port's full forward and JAX's cached path."""
    jcfg, tcfg, pj, model = _nav_params()
    rng = np.random.RandomState(3)
    B, P, A, S, pad = 3, 24, 4, 8, 6
    pre_lens, app_lens, suf_lens = [10, 24, 5], [3, 0, 2], [7, 4, 6]
    ids = {k: rng.randint(9, VOCAB, (B, n)).astype(np.int32)
           for k, n in (("pre", P), ("app", A), ("suf", S))}
    full = _full_hidden(model, tcfg, [
        np.concatenate([ids["pre"][b, :pre_lens[b]],
                        ids["app"][b, :app_lens[b]],
                        ids["suf"][b, :suf_lens[b]]]) for b in range(B)])

    with torch.no_grad():
        cache = _prefill_kv(model, tcfg, ids["pre"], pre_lens, pad)
        jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
        prefix_mask = _window_mask(pre_lens, P + pad)
        am = _window_mask(app_lens, A)
        pos = np.asarray(pre_lens)[:, None] + np.arange(A)[None, :]
        emb = TL.embed_with_injection(model.llm, _t(ids["app"])) \
            * _t(am)[..., None]
        h_app, cache = TL.chunk_forward_cached(
            model.llm, tcfg.llm, emb, cache, _t(prefix_mask), _t(am),
            _t(pos), write_offsets=_t(np.asarray(pre_lens, np.int32)))
        jh_app, jcache = JL.chunk_forward_cached(
            pj["llm"], jcfg.llm, jnp.asarray(emb.numpy()), jcache,
            prefix_mask, am, pos,
            write_offsets=jnp.asarray(pre_lens, jnp.int32))
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)

        ext = np.asarray(pre_lens) + np.asarray(app_lens)
        sm = _window_mask(suf_lens, S)
        pos = ext[:, None] + np.arange(S)[None, :]
        emb = TL.embed_with_injection(model.llm, _t(ids["suf"])) \
            * _t(sm)[..., None]
        before = {k: v.clone() for k, v in cache.items()}
        h_suf, cache = TL.chunk_forward_cached(
            model.llm, tcfg.llm, emb, cache, _t(_window_mask(ext, P + pad)),
            _t(sm), _t(pos))
        jh_suf, _ = JL.chunk_forward_cached(
            pj["llm"], jcfg.llm, jnp.asarray(emb.numpy()), jcache,
            _window_mask(ext, P + pad), sm, pos)
    for k in cache:              # no write_offsets: the cache is untouched
        torch.testing.assert_close(cache[k], before[k], rtol=0, atol=0)
    np.testing.assert_allclose(h_suf.numpy(), np.asarray(jh_suf), **TOL)
    np.testing.assert_allclose(h_app.numpy(), np.asarray(jh_app), **TOL)
    for b in range(B):
        if app_lens[b]:
            np.testing.assert_allclose(
                h_app[b, :app_lens[b]].numpy(),
                full[b][pre_lens[b]: pre_lens[b] + app_lens[b]], **FULL_TOL)
        np.testing.assert_allclose(h_suf[b, :suf_lens[b]].numpy(),
                                   full[b][ext[b]:], **FULL_TOL)


@pytest.mark.parametrize("window", [6, 40], ids=["S<P", "S>P"])
def test_append_that_fills_the_cache_drops_the_rest(window):
    """Row 0's append ends exactly at the cache's last slot, row 1's runs
    past it: in-range writes land, out-of-range ones are dropped (never
    clamped onto slot P-1), and slots outside the append keep their old
    content bit for bit; the same as JAX's scatter(mode="drop")."""
    jcfg, tcfg, pj, model = _nav_params()
    rng = np.random.RandomState(4)
    B, P = 2, 16
    pre_lens = [12, 14]
    app_lens = [4, 5]                       # 12 + 4 = P; 14 + 5 > P
    ids = rng.randint(9, VOCAB, (B, P)).astype(np.int32)
    app = rng.randint(9, VOCAB, (B, window)).astype(np.int32)
    am = _window_mask(app_lens, window)
    pos = np.asarray(pre_lens)[:, None] + np.arange(window)[None, :]
    with torch.no_grad():
        cache = _prefill_kv(model, tcfg, ids, pre_lens, 0)
        jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
        old = {k: v.clone() for k, v in cache.items()}
        emb = TL.embed_with_injection(model.llm, _t(app)) * _t(am)[..., None]
        h, cache = TL.chunk_forward_cached(
            model.llm, tcfg.llm, emb, cache, _t(_window_mask(pre_lens, P)),
            _t(am), _t(pos), write_offsets=_t(np.asarray(pre_lens, np.int32)))
    jh, jcache = JL.chunk_forward_cached(
        pj["llm"], jcfg.llm, jnp.asarray(emb.numpy()), jcache,
        _window_mask(pre_lens, P), am, pos,
        write_offsets=jnp.asarray(pre_lens, jnp.int32))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
        # the slots before each append are untouched, bit for bit
        for b in range(B):
            torch.testing.assert_close(cache[k][:, b, :pre_lens[b]],
                                       old[k][:, b, :pre_lens[b]],
                                       rtol=0, atol=0)
        # row 1's last two slots hold its first two appended tokens
        assert not torch.equal(cache[k][:, 1, 14:], old[k][:, 1, 14:])


def _prefill_inputs():
    r = np.random.RandomState(6)
    ids = r.randint(9, VOCAB, (3, 64)).astype(np.int32)
    mask = _window_mask([40, 17, 0], 64)
    ids[~mask] = 0
    return ids, mask, np.array([2, 0, 1], np.int32), np.array([1, 1, 0], bool)


def test_prefill_prefix_matches_jax_and_keeps_invalid_rows():
    jcfg, tcfg, pj, model = _nav_params()
    ids, mask, rows, valid = _prefill_inputs()
    # a cache whose row 1 already holds a prefix (the padding entry's row)
    r = np.random.RandomState(7)
    base = {"pkv_k": r.randn(2, 3, 96, 4, 32).astype(np.float32),
            "pkv_v": r.randn(2, 3, 96, 4, 32).astype(np.float32),
            "plen": np.array([5, 33, 9], np.int32)}
    jout = JDM.prefill_prefix(pj, jcfg.llm, {k: jnp.asarray(v)
                                            for k, v in base.items()},
                              ids, mask, rows, valid)
    cache = {k: _t(v.copy()) for k, v in base.items()}
    with torch.no_grad():
        out = TDM.prefill_prefix(model, tcfg.llm, cache, _t(ids), _t(mask),
                                 _t(rows), _t(valid))
    assert out["pkv_k"] is cache["pkv_k"]                  # in place
    np.testing.assert_array_equal(out["plen"].numpy(), [17, 33, 40])
    np.testing.assert_array_equal(out["plen"].numpy(),
                                  np.asarray(jout["plen"]))
    for k in ("pkv_k", "pkv_v"):
        assert torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), **TOL)
        # valid=False keeps the row's old content bit for bit
        np.testing.assert_array_equal(out[k][:, 1].numpy(), base[k][:, 1])
        # only [:, rows, :Pw] is written
        np.testing.assert_array_equal(out[k][:, :, 64:].numpy(),
                                      base[k][:, :, 64:])


def _cached_step_inputs(jcfg, seed, app_lens, suf_len=12):
    """One eval_step_cached's inputs for 3 rows: the fusion batch of
    synthetic_nav_batch, an append window whose last token is <hist>
    (on rows with app_lens > 0) and a suffix with 4 <cand> tokens and
    <cls_1>."""
    b, v, g, c, hist_id, cand_id, cls_id = 3, 6, 10, 4, 5, 4, 7
    r = np.random.RandomState(seed)
    pano = {"view_img_fts": r.randn(b, v, jcfg.pano.image_feat_size)
            .astype(np.float32),
            "view_lens": r.randint(2, v + 1, b).astype(np.int32),
            "loc_fts": r.randn(b, v, jcfg.pano.loc_size).astype(np.float32),
            "nav_types": r.randint(0, 2, (b, v)).astype(np.int32)}
    batch = synthetic_nav_batch(jcfg, b=b, g=g, v=v + 1, c=c, hh=4, tlen=8,
                                seed=seed)
    for k in ("gmap_img_embeds", "vp_img_embeds", "hist_embeds",
              "input_ids", "attention_mask", "cand_positions",
              "hist_positions", "cls_pos"):
        del batch[k]
    slot_ids = np.full((b, g), -1, np.int32)
    for i in range(b):
        slot_ids[i, 1:6] = r.choice(16, 5, replace=False)
    batch["slot_ids"] = slot_ids
    a_w = 8
    app_ids = np.zeros((b, a_w), np.int32)
    app_hist = np.full(b, -1, np.int32)
    for i, n in enumerate(app_lens):
        app_ids[i, :n] = r.randint(9, VOCAB, n)
        if n:
            app_ids[i, n - 1] = hist_id
            app_hist[i] = n - 1
    suf = r.randint(9, VOCAB, (b, 16)).astype(np.int32)
    suf[:, 1:9:2] = cand_id
    suf[:, suf_len - 1] = cls_id
    batch.update(app_ids=app_ids, app_mask=_window_mask(app_lens, a_w),
                 app_hist_pos=app_hist, suf_ids=suf,
                 suf_mask=_window_mask([suf_len] * b, 16),
                 cand_positions=np.tile(np.arange(1, 9, 2, dtype=np.int32),
                                        (b, 1)),
                 cls_pos=np.full(b, suf_len - 1, np.int32))
    cur_ids = r.randint(0, 16, b).astype(np.int32)
    cand_ids = r.randint(-1, 16, (b, v)).astype(np.int32)
    return pano, batch, cur_ids, cand_ids


def test_eval_step_cached_matches_jax():
    """Two cached steps after a prefill (the first with empty append
    windows, the second appending history with an injected <hist>), then
    a third with an inactive row and a forced action; state, cache,
    actions and logits against JAX's eval_step_cached."""
    jcfg, tcfg, pj, model = _nav_params()

    def pano_apply(params, rng, pano_in, deterministic):
        return forward_panorama(params["pano"], jcfg.pano,
                                pano_in["view_img_fts"], pano_in["view_lens"],
                                loc_fts=pano_in["loc_fts"],
                                nav_types=pano_in["nav_types"])

    h, b = jcfg.hidden_size, 3
    sj = JDM.init_memory(b, 16, 4, h, jnp.float32)
    st = TDM.init_memory(b, 16, 4, h, torch.float32)
    cj = JDM.init_prefix_cache(jcfg.llm, b, 96)
    ct = TDM.init_prefix_cache(tcfg.llm, b, 96)
    ids, mask, _, _ = _prefill_inputs()
    mask[2, :30] = True                        # three real prefixes
    rows, valid = np.array([0, 1, 2], np.int32), np.ones(3, bool)
    cj = JDM.prefill_prefix(pj, jcfg.llm, cj, ids, mask, rows, valid)
    with torch.no_grad():
        ct = TDM.prefill_prefix(model, tcfg.llm, ct, _t(ids), _t(mask),
                                _t(rows), _t(valid))
    no = np.zeros(b, bool)
    steps = [([0, 0, 0], no, ~no, [-1, -1, -1]),
             ([3, 5, 2], no, ~no, [-1, -1, -1]),
             ([2, 0, 4], no, np.array([True, True, False]), [2, -1, -1])]
    for n, (app_lens, reset, active, override) in enumerate(steps):
        pano, batch, cur, cand = _cached_step_inputs(jcfg, 20 + n, app_lens)
        override = np.asarray(override, np.int32)
        sj, cj, aj, lj = JDM.eval_step_cached(
            pj, jcfg, pano_apply, sj, cj, pano, batch, reset, cur, cand,
            active, override, None, False, 1.0)
        with torch.no_grad():
            st, ct, at, lt = TDM.eval_step_cached(
                model, tcfg, st, ct, {k: _t(v) for k, v in pano.items()},
                {k: _t(v) for k, v in batch.items()}, _t(reset), _t(cur),
                _t(cand), _t(active), _t(override))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_array_equal(ct["plen"].numpy(),
                                      np.asarray(cj["plen"]))
        for k in ("pkv_k", "pkv_v"):
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                       err_msg=f"step {n} {k}", **TOL)
        for k in sj:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       err_msg=f"step {n} {k}", **TOL)
    np.testing.assert_array_equal(ct["plen"].numpy(), [45, 22, 36])


@pytest.mark.parametrize("batch,max_prefix,n_caches,fits", [
    (2, 448, 2, True), (7, 768, 2, True), (8, 768, 2, False),
    (14, 768, 1, True), (15, 768, 1, False)])
def test_prefix_cache_enabled_matches_jax(batch, max_prefix, n_caches, fits):
    """The memory policy on the CPU (ceiling 12e9, as JAX's) at sizes on
    both sides of it: f32 caches of a 32-layer, 4096-wide LLM take 0.8 GB
    per slot at 768 tokens."""
    jcfg, tcfg, pj, model = _nav_params()
    tok = JTok(max_length=1024, pad_to_multiple=128)
    big = dataclasses.replace(jcfg.llm, num_layers=32, hidden_size=4096,
                              num_heads=32, num_kv_heads=32)
    tbig = dataclasses.replace(tcfg.llm, num_layers=32, hidden_size=4096,
                               num_heads=32, num_kv_heads=32)
    jr = JRunner(dataclasses.replace(jcfg, llm=big), pj, tok,
                 dims=JDims.tiny())
    tr = NavModelRunner(dataclasses.replace(tcfg, llm=tbig), model, tok,
                        dims=RolloutDims.tiny())
    want = jr.prefix_cache_enabled(batch, max_prefix, n_caches=n_caches)
    assert tr.prefix_cache_enabled(batch, max_prefix,
                                   n_caches=n_caches) == want
    assert want == fits


# ------------------------------------------------- the slice, end to end ---
def _make_runners(bits=16, stop_bias=2.0):
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jcfg = JNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    # a stop bias, so that the random policy stops at mixed steps
    pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(stop_bias)
    if bits != 16:
        pj = dict(pj, llm=JQ._quantize_llama_impl(pj["llm"], bits))
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                                   device="cpu"))
    return (JRunner(jcfg, pj, tok, dims=JDims.tiny()),
            NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny()))


def _run_port(trunner, root, split, max_action_len, prefix_cache):
    feat = trunner.cfg.pano.image_feat_size
    world = WorldModel(str(root / "connectivity"))
    ds = R2RDataset(root / "R2R" / split, world)
    ds.init_feat_db(SyntheticImageFeaturesDB(feat))
    args = EvalArgs(seed=0, val_batch_size=2, image_feat_size=feat,
                    prefix_cache=prefix_cache)
    preds = R2RAgent(args, world, trunner).validate_streaming(
        "R2R", args, T.eval_config(max_action_len),
        Dataloader(ds, 2, False), dataset=ds)
    return {p["instr_id"]: p["trajectory"] for p in preds}


def _run_jax(jrunner, root, split, max_action_len):
    feat = jrunner.cfg.pano.image_feat_size
    tcfg = ConfigDict({
        "Feature": {"image_feat_size": feat, "angle_feat_size": 4},
        "R2R": {"DIR": "R2R", "SPLIT": {"val_unseen": split}}})
    optim = {"Optim": {"val_max_action_len": {"R2R": max_action_len}}}
    args = TrainArgs(data_dir=str(root), val_batch_size=2, seed=0)
    args.image_feat_size = feat
    args.prefix_cache = True
    world = WorldModel(str(root / "connectivity"))
    ds = load_dataset("r2r", args, tcfg, training=False, source="R2R",
                      world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(feat))
    preds = load_agent("r2r", args, world, jrunner).validate_streaming(
        "R2R", args, ConfigDict(optim), Dataloader(ds, 2, False), dataset=ds)
    return {p["instr_id"]: p["trajectory"] for p in preds}


@pytest.mark.parametrize("bits", [16, 4], ids=["f32", "w4"])
def test_cached_slice_matches_uncached_and_jax(bits, tmp_path):
    """Twin of tests/test_streaming_eval.py's prefix-cache A/B, on the BPE
    tokenizer with refills: the port's cached run equals its uncached run
    trajectory for trajectory (and ran the cached path: prefills and
    cached steps, no whole-prompt step), and equals JAX's cached run."""
    T.make_r2r_world(tmp_path, n_episodes=6, rows=4, cols=4, seed=3)
    jrunner, trunner = _make_runners(bits)
    split = "annotations/val.json"
    cached = _run_port(trunner, tmp_path, split, 5, True)
    assert trunner.eval_steps == 0
    assert trunner.cached_steps > 0 and trunner.prefill_calls > 0
    uncached = _run_port(trunner, tmp_path, split, 5, False)
    assert len(cached) == 6 and cached == uncached
    assert len({len(t) for t in cached.values()}) > 1     # mixed lengths
    assert cached == _run_jax(jrunner, tmp_path, split, 5)
