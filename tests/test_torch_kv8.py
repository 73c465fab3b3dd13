"""The int8 K/V (kv_int8) of the port vs the JAX package.

kv_quantize, quantize_kv_stack and init_prefix_cache(kv_int8=True) are
held exactly (codes bit for bit, f32 scales bit for bit: both packages
take the same f32 operations in the same order, and round half to even).
So are the codes and scales that prefill_prefix and chunk_forward_cached
write, against JAX's kv_quantize of the K/V the port computed. Against
JAX's own path, whose K/V differ from the port's by float rounding (other
summation orders, ~1e-6 relative), the scales agree to rtol 2e-6 and the
codes are equal except at one named place: an element whose value sits
within 1e-3 of a rounding boundary of its grid may land on the other side,
one code apart (one such element of 73,728 in the prefill test).
chunk_forward_cached on an int8 cache and
decode_step on an int8 prompt stack are held to rtol 1e-5, atol 1e-5 (f32,
tiny dims; hidden states are O(1) after the final norm, and the two
packages sum the same products in other orders). The window's round trip
is held by the merged [append | suffix] window against the same tokens in
two passes (append written, then the suffix read from the cache): equal to
1e-5 with the round trip, int8 noise apart without it. generate with
kv_int8 must give JAX's tokens. Weights are the JAX init converted with
params_from_jax; inputs are numpy from a seed.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import device_memory as JDM  # noqa: E402
from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.decoding import generate as j_generate  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu.models.trie import DenseTrie as JTrie  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import device_memory as TDM  # noqa: E402
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.models import decoding as TD  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.trie import DenseTrie  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TOK = NavTokenizer()
VOCAB = TOK.vocab_size


@functools.lru_cache(maxsize=None)
def _nav_params():
    jcfg = JNM.NavModelConfig.tiny(vocab_size=VOCAB, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=VOCAB, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                                   device="cpu"))
    return jcfg, tcfg, pj, model


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else x)


def _window_mask(lens, width):
    return np.arange(width)[None, :] < np.asarray(lens)[:, None]


def _assert_written(q, sc, src, jq=None, jsc=None):
    """q, sc: the codes and scales the port wrote for the K/V ``src`` (f32
    numpy, computed by the port). Exact against JAX's kv_quantize of src;
    against JAX's codes and scales from its own K/V (jq, jsc), as the
    module docstring says (testing.assert_codes_near)."""
    wq, ws = JL.kv_quantize(jnp.asarray(src))
    np.testing.assert_array_equal(q, np.asarray(wq))
    np.testing.assert_array_equal(sc, np.asarray(ws))
    if jq is not None:
        T.assert_codes_near(q, sc, src, jq, jsc)


def _kv_data(seed, shape=(2, 5, 3, 128)):
    """K/V-like values: per head different magnitudes, a zero head (the
    1e-6 floor), and values placed on the .5 boundaries of their grid."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x *= np.exp(np.random.RandomState(seed + 1).randn(*shape[:-1], 1) * 2)
    rows = x.reshape(-1, shape[-1])
    rows[7] = 0.0
    amax = np.abs(rows[5]).max()
    rows[5, :8] = (np.arange(8) - 3.5) * amax / 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_codes_and_scales_match_jax_exactly(dtype):
    x = _kv_data(0)
    xj = jnp.asarray(x, dtype)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qj, sj = JL.kv_quantize(xj)
    qt, st = TL.kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == (2, 5, 3, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # one rounding from f32 to the compute dtype, as JAX
    np.testing.assert_array_equal(
        TL.kv_dequantize(qt, st, torch.float32).numpy(),
        np.asarray(JL.kv_dequantize(qj, sj, jnp.float32)))
    assert TL.kv_dequantize(qt, st, torch.bfloat16).dtype == torch.bfloat16


def test_quantize_kv_stack_matches_jax_exactly():
    kv = {n: _kv_data(s, (3, 2, 6, 4, 32)) for n, s in (("k", 4), ("v", 6))}
    qj = JL.quantize_kv_stack({n: jnp.asarray(v) for n, v in kv.items()})
    qt = TL.quantize_kv_stack({n: _t(v) for n, v in kv.items()})
    assert TL.kv_is_quantized(qt) and not TL.kv_is_quantized(
        {n: _t(v) for n, v in kv.items()})
    assert sorted(qt) == sorted(qj) == ["k", "ks", "v", "vs"]
    for n in qj:
        assert qt[n].dtype == (torch.int8 if len(n) == 1 else torch.float32)
        np.testing.assert_array_equal(qt[n].numpy(), np.asarray(qj[n]))


def test_init_prefix_cache_kv8_matches_jax_structure():
    jcfg, tcfg, _, _ = _nav_params()
    cj = JDM.init_prefix_cache(jcfg.llm, 3, 40, kv_int8=True)
    ct = TDM.init_prefix_cache(tcfg.llm, 3, 40, kv_int8=True, device="cpu")
    assert sorted(ct) == sorted(cj) == ["pkv_k", "pkv_ks", "pkv_v",
                                        "pkv_vs", "plen"]
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        assert str(ct[k].dtype).split(".")[-1] == str(cj[k].dtype), k
        assert not ct[k].any()
    view = TDM._cache_kv_view(ct)
    assert sorted(view) == ["k", "ks", "v", "vs"]
    assert view["ks"] is ct["pkv_ks"]
    back = TDM._cache_from_kv(view, ct["plen"])
    assert all(back[k] is ct[k] for k in ct)


def test_prefill_prefix_kv8_matches_jax_and_keeps_invalid_rows():
    """Codes and scales of the valid rows equal JAX's bit for bit; the
    padding entry (valid False) writes its row's old codes and scales back
    bit for bit; nothing past the prefill's width moves."""
    jcfg, tcfg, pj, model = _nav_params()
    r = np.random.RandomState(6)
    ids = r.randint(9, VOCAB, (3, 64)).astype(np.int32)
    mask = _window_mask([40, 17, 0], 64)
    ids[~mask] = 0
    rows, valid = np.array([2, 0, 1], np.int32), np.array([1, 1, 0], bool)
    shape = (2, 3, 96, 4, 32)
    base = {"pkv_k": r.randint(-127, 128, shape).astype(np.int8),
            "pkv_v": r.randint(-127, 128, shape).astype(np.int8),
            "pkv_ks": r.rand(*shape[:-1], 1).astype(np.float32),
            "pkv_vs": r.rand(*shape[:-1], 1).astype(np.float32),
            "plen": np.array([5, 33, 9], np.int32)}
    jout = JDM.prefill_prefix(pj, jcfg.llm, {k: jnp.asarray(v)
                                            for k, v in base.items()},
                              ids, mask, rows, valid)
    cache = {k: _t(v.copy()) for k, v in base.items()}
    with torch.no_grad():
        out = TDM.prefill_prefix(model, tcfg.llm, cache, _t(ids), _t(mask),
                                 _t(rows), _t(valid))
        emb = TL.embed_with_injection(model.llm, _t(ids)) * _t(mask)[..., None]
        _, src = TL.forward_hidden(model.llm, tcfg.llm, emb, _t(mask),
                                   return_kv=True)
    assert out["pkv_ks"] is cache["pkv_ks"]                 # in place
    np.testing.assert_array_equal(out["plen"].numpy(), [17, 33, 40])
    np.testing.assert_array_equal(out["plen"].numpy(),
                                  np.asarray(jout["plen"]))
    for n in ("k", "v"):
        q, sc = out[f"pkv_{n}"], out[f"pkv_{n}s"]
        assert q.dtype == torch.int8 and sc.dtype == torch.float32
        for j in (0, 1):                                    # valid entries
            r_ = rows[j]
            _assert_written(q[:, r_, :64].numpy(), sc[:, r_, :64].numpy(),
                            src[n][:, j].numpy(),
                            np.asarray(jout[f"pkv_{n}"])[:, r_, :64],
                            np.asarray(jout[f"pkv_{n}s"])[:, r_, :64])
    for k in ("pkv_k", "pkv_v", "pkv_ks", "pkv_vs"):
        # valid=False keeps the row's old codes and scales bit for bit
        np.testing.assert_array_equal(out[k][:, 1].numpy(), base[k][:, 1])
        # only [:, rows, :Pw] is written
        np.testing.assert_array_equal(out[k][:, :, 64:].numpy(),
                                      base[k][:, :, 64:])


class _Recorder:
    """Wraps llama.kv_quantize and keeps every input it was given (the
    window's K and V of each layer, in order)."""

    def __init__(self, monkeypatch):
        self.inputs = []
        fn = TL.kv_quantize
        monkeypatch.setattr(TL, "kv_quantize",
                            lambda x: self.inputs.append(x.clone()) or fn(x))

    def check_appended(self, cache, jcache, offsets, lens):
        """The codes and scales written at offsets[b] + j (j < lens[b],
        below P) against the recorded K/V, as _assert_written holds
        them."""
        p = cache["k"].shape[2]
        n_layers = cache["k"].shape[0]
        assert len(self.inputs) == 2 * n_layers
        for i in range(n_layers):
            for n, src in (("k", self.inputs[2 * i]),
                           ("v", self.inputs[2 * i + 1])):
                for b, (off, ln) in enumerate(zip(offsets, lens)):
                    ln = min(ln, p - off)
                    if ln <= 0:
                        continue
                    sl = slice(off, off + ln)
                    _assert_written(
                        cache[n][i, b, sl].numpy(),
                        cache[n + "s"][i, b, sl].numpy(),
                        src[b, :ln].numpy(),
                        np.asarray(jcache[n])[i, b, sl],
                        np.asarray(jcache[n + "s"])[i, b, sl])
        self.inputs.clear()


def _prefill_q(model, tcfg, ids, lens, pad):
    """forward_hidden(return_kv) over right-padded prefixes, quantized, the
    cache grown by ``pad`` empty slots."""
    pm = _window_mask(lens, ids.shape[1])
    emb = TL.embed_with_injection(model.llm, _t(ids)) * _t(pm)[..., None]
    _, kv = TL.forward_hidden(model.llm, tcfg.llm, emb, _t(pm),
                              return_kv=True)
    q = TL.quantize_kv_stack(kv)
    return {k: torch.cat([v, v.new_zeros((*v.shape[:2], pad, *v.shape[3:]))],
                         dim=2) for k, v in q.items()}


def _chunk(model, tcfg, pj, jcfg, ids, cache, jcache, prefix_lens, win_lens,
           write=None):
    """One chunk_forward_cached call on both packages on the same int8
    cache (copied for JAX): (hidden, cache, JAX hidden, JAX cache)."""
    w = ids.shape[1]
    pmax = cache["k"].shape[2]
    wm = _window_mask(win_lens, w)
    pos = np.asarray(prefix_lens)[:, None] + np.arange(w)[None, :]
    emb = TL.embed_with_injection(model.llm, _t(ids)) * _t(wm)[..., None]
    kw = {} if write is None else dict(
        write_offsets=_t(np.asarray(prefix_lens, np.int32)),
        write_mask=_t(write))
    jkw = {} if write is None else dict(
        write_offsets=jnp.asarray(prefix_lens, jnp.int32), write_mask=write)
    h, cache = TL.chunk_forward_cached(
        model.llm, tcfg.llm, emb, cache, _t(_window_mask(prefix_lens, pmax)),
        _t(wm), _t(pos), **kw)
    jh, jcache = JL.chunk_forward_cached(
        pj["llm"], jcfg.llm, _j(emb), jcache,
        _window_mask(prefix_lens, pmax), wm, pos, **jkw)
    return h, cache, jh, jcache


def test_chunk_forward_cached_kv8_matches_jax(monkeypatch):
    """Ragged prefixes prefilled into an int8 cache, a written append
    window (the appended codes and scales equal JAX's), then a read-only
    suffix window: hidden states against JAX."""
    jcfg, tcfg, pj, model = _nav_params()
    rng = np.random.RandomState(3)
    B, P, A, S, pad = 3, 24, 4, 8, 6
    pre, app, suf = [10, 24, 5], [3, 0, 2], [7, 4, 6]
    ids = {k: rng.randint(9, VOCAB, (B, n)).astype(np.int32)
           for k, n in (("pre", P), ("app", A), ("suf", S))}
    with torch.no_grad():
        cache = _prefill_q(model, tcfg, ids["pre"], pre, pad)
        jcache = {k: _j(v) for k, v in cache.items()}
        rec = _Recorder(monkeypatch)
        h_app, cache, jh_app, jcache = _chunk(
            model, tcfg, pj, jcfg, ids["app"], cache, jcache, pre, app,
            write=_window_mask(app, A))
        rec.check_appended(cache, jcache, pre, app)
        ext = np.asarray(pre) + np.asarray(app)
        before = {k: v.clone() for k, v in cache.items()}
        h_suf, cache, jh_suf, _ = _chunk(model, tcfg, pj, jcfg, ids["suf"],
                                         cache, jcache, ext, suf)
    for k in cache:              # no write_offsets: the cache is untouched
        torch.testing.assert_close(cache[k], before[k], rtol=0, atol=0)
    for b in range(B):
        np.testing.assert_allclose(h_app[b, :app[b]].numpy(),
                                   np.asarray(jh_app)[b, :app[b]], **TOL)
        np.testing.assert_allclose(h_suf[b, :suf[b]].numpy(),
                                   np.asarray(jh_suf)[b, :suf[b]], **TOL)


def test_chunk_forward_cached_kv8_window_reads_its_writes_round_trip():
    """The merged [append | suffix] window (appends written, the suffix
    not) gives the suffix what the two-pass form gives it (append written,
    then the suffix reading it from the int8 cache): the window reads its
    written columns through the int8 round trip. JAX agrees."""
    jcfg, tcfg, pj, model = _nav_params()
    rng = np.random.RandomState(8)
    B, P, A, S, pad = 2, 20, 5, 7, 12
    pre, app, suf = [9, 20], [5, 3], [7, 6]
    ids = {k: rng.randint(9, VOCAB, (B, n)).astype(np.int32)
           for k, n in (("pre", P), ("app", A), ("suf", S))}
    merged = np.zeros((B, A + S), np.int32)
    for b in range(B):
        merged[b, :app[b] + suf[b]] = np.concatenate(
            [ids["app"][b, :app[b]], ids["suf"][b, :suf[b]]])
    with torch.no_grad():
        c1 = _prefill_q(model, tcfg, ids["pre"], pre, pad)
        c2 = {k: v.clone() for k, v in c1.items()}
        j1 = {k: _j(v) for k, v in c1.items()}
        wm = np.zeros((B, A + S), bool)
        wm[:, :A] = _window_mask(app, A)
        h_m, c1, jh_m, j1 = _chunk(model, tcfg, pj, jcfg, merged, c1, j1,
                                   pre, np.add(app, suf), write=wm)
        _, c2, _, _ = _chunk(model, tcfg, pj, jcfg, ids["app"], c2,
                             {k: _j(v) for k, v in c2.items()}, pre, app,
                             write=_window_mask(app, A))
        ext = np.add(pre, app)
        h_s, _, _, _ = _chunk(model, tcfg, pj, jcfg, ids["suf"], c2,
                              {k: _j(v) for k, v in c2.items()}, ext, suf)
    for k in c1:                              # the same appended cache
        torch.testing.assert_close(c1[k], c2[k], rtol=0, atol=0)
    for b in range(B):
        sl = slice(app[b], app[b] + suf[b])
        np.testing.assert_allclose(h_m[b, sl].numpy(),
                                   h_s[b, :suf[b]].numpy(), **TOL)
        np.testing.assert_allclose(h_m[b].numpy()[:app[b] + suf[b]],
                                   np.asarray(jh_m)[b, :app[b] + suf[b]],
                                   **TOL)


@pytest.mark.parametrize("window", [6, 40], ids=["S<P", "S>P"])
def test_kv8_append_that_fills_the_cache_drops_the_rest(window,
                                                       monkeypatch):
    """Row 0's append ends exactly at the cache's last slot, row 1's runs
    past it: codes and scales land at the same in-range slots, the rest is
    dropped, and the slots before each append keep their old codes and
    scales bit for bit; the same as JAX's scatter(mode="drop")."""
    jcfg, tcfg, pj, model = _nav_params()
    rng = np.random.RandomState(4)
    B, P = 2, 16
    pre, app = [12, 14], [4, 5]            # 12 + 4 = P; 14 + 5 > P
    ids = rng.randint(9, VOCAB, (B, P)).astype(np.int32)
    win = rng.randint(9, VOCAB, (B, window)).astype(np.int32)
    with torch.no_grad():
        cache = _prefill_q(model, tcfg, ids, pre, 0)
        old = {k: v.clone() for k, v in cache.items()}
        rec = _Recorder(monkeypatch)
        h, cache, jh, jcache = _chunk(
            model, tcfg, pj, jcfg, win, cache,
            {k: _j(v) for k, v in cache.items()}, pre, app,
            write=_window_mask(app, window))
    rec.check_appended(cache, jcache, pre, app)
    for k in ("k", "ks", "v", "vs"):
        for b in range(B):
            torch.testing.assert_close(cache[k][:, b, :pre[b]],
                                       old[k][:, b, :pre[b]], rtol=0, atol=0)
        # row 0's four appended tokens fill slots 12-15, row 1's first two
        # slots 14-15; codes and scales alike
        assert not torch.equal(cache[k][:, 0, 12:], old[k][:, 0, 12:])
        assert not torch.equal(cache[k][:, 1, 14:], old[k][:, 1, 14:])
    for b in range(B):
        np.testing.assert_allclose(h[b, :app[b]].numpy(),
                                   np.asarray(jh)[b, :app[b]], **TOL)


def test_decode_step_on_an_int8_prompt_stack_matches_jax():
    jcfg, tcfg, pj, model = _nav_params()
    jl, tl = pj["llm"], model.llm
    b, t, n_new = 3, 20, 4
    r = np.random.RandomState(1)
    ids = r.randint(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.arange(t)[None, :] >= np.array([0, 5, 11])[:, None]
    fed = r.randint(3, 250, (b, n_new)).astype(np.int32)
    with torch.no_grad():
        _, kv_t = TL.forward_hidden(tl, tcfg.llm, TL.embed_with_injection(
            tl, _t(ids)), _t(mask), return_kv=True)
    qkv_t = TL.quantize_kv_stack(kv_t)
    qkv_j = {k: _j(v) for k, v in qkv_t.items()}
    dec_j = JL.init_decode_cache(jcfg.llm, b, n_new)
    dec_t = TL.init_decode_cache(tcfg.llm, b, n_new)
    lens = mask.sum(-1)
    for i in range(n_new):
        pos = (lens + i)[:, None].astype(np.int32)
        hj, dec_j = JL.decode_step(
            jl, jcfg.llm, JL.embed_rows(jl["embed"], fed[:, i])[:, None],
            qkv_j, mask, dec_j, i, pos)
        with torch.no_grad():
            ht, dec_t = TL.decode_step(
                tl, tcfg.llm, TL.embed_rows(tl["embed"], _t(fed[:, i])
                                            .long())[:, None],
                qkv_t, _t(mask), dec_t, i, _t(pos))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(dec_t["k"].numpy(),
                                   np.asarray(dec_j["k"]), **TOL)


@pytest.mark.parametrize("use_trie", [False, True], ids=["free", "trie"])
def test_generate_kv_int8_tokens_match_jax(use_trie):
    """generate(kv_int8=True): the prompt K/V quantized once after the
    prefill; greedy tokens equal JAX's, and they are what the bf16 prompt
    stack would give on all but near-ties (checked on this input: equal)."""
    jcfg, tcfg, pj, model = _nav_params()
    b, t, n_new = 3, 45, 12
    r = np.random.RandomState(5)
    ids = r.randint(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.arange(t)[None, :] >= np.array([0, 9, 30])[:, None]
    ids[~mask] = TOK.pad_id
    answers = ["red", "blue", "green", "dark brown", "two", "kitchen"]
    seqs = [TOK.encode(w, add_bos=True) for w in answers]
    jt, tt = (JTrie(seqs, eos_id=TOK.eos_id),
              DenseTrie(seqs, eos_id=TOK.eos_id)) if use_trie else (None,
                                                                    None)
    kw = dict(eos_id=TOK.eos_id, pad_id=TOK.pad_id, max_new_tokens=n_new)
    want = np.asarray(j_generate(pj["llm"], jcfg.llm, ids, mask, trie=jt,
                                 kv_int8=True, **kw))
    got = TD.generate(model.llm, tcfg.llm, ids, mask, trie=tt, kv_int8=True,
                      **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    dense = TD.generate(model.llm, tcfg.llm, ids, mask, trie=tt, **kw)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
