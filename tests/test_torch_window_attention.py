"""The prefix-cached step's window attention (ops/attention.py:
window_attention, csrc/flash_attn_window_fwd.cu) and its call site,
llama.chunk_forward_cached.

On the CPU: the wrapper's plain version equals the eager attention
chunk_forward_cached ran over the concatenated K/V (and an f64 per-row
softmax over the keys each query may see); the input checks raise; a
cached forward counts ``window_eager`` once per layer. On a Hopper card:
the kernel against its plain version at the prefix-cached cell's shapes,
rows that see no valid key finite, and chunk_forward_cached through the
kernel against the eager path from the same cache (bf16 and int8). This
file imports no jax, so on the card it runs without the repository's
conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_window_attention.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from navillm_tpu_torch.convert import init_llama_params  # noqa: E402
from navillm_tpu_torch.models import llama as L  # noqa: E402
from navillm_tpu_torch.ops import attention as A  # noqa: E402
from navillm_tpu_torch.testing import attn_excess  # noqa: E402
from navillm_tpu_torch.utils import profiling as P  # noqa: E402


def _require_sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 (Hopper)")


def _lengths_mask(lens, width, device="cpu"):
    """[B, width] bool, row b's first lens[b] entries set."""
    return torch.arange(width, device=device)[None, :] \
        < torch.as_tensor(lens, device=device)[:, None]


def _window_inputs(plens, app_lens, suf_lens, p, a, s_suf, nh, nkv, d,
                   dtype, device="cpu", seed=0):
    """q, K/V of a cache of P slots and of an [append A | suffix] window,
    the prefix mask (row b's first plens[b] slots) and the window mask
    ([append pad | suffix pad]: padding inside the window)."""
    r = np.random.RandomState(seed)
    b, s = len(plens), a + s_suf

    def mk(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)) \
            .to(device=device, dtype=dtype)

    q = mk(b, s, nh, d)
    kp, vp, kw, vw = mk(b, p, nkv, d), mk(b, p, nkv, d), mk(b, s, nkv, d), \
        mk(b, s, nkv, d)
    pm = _lengths_mask(plens, p, device)
    wm = torch.cat([_lengths_mask(app_lens, a, device),
                    _lengths_mask(suf_lens, s_suf, device)], dim=1)
    return q, kp, vp, pm, kw, vw, wm


def _seen(pm, wm):
    """[B, S]: how many valid keys each window query sees."""
    return A.window_mask(pm, wm).sum(-1)


def _per_row_softmax(q, kp, vp, pm, kw, vw, wm, scale):
    """f64 attention, each (row, query, head) over the keys it may see,
    listed one by one: every valid prefix key, the valid window keys up to
    the query. Rows that see none are left at zero."""
    q, kp, vp, kw, vw = (x.double() for x in (q, kp, vp, kw, vw))
    b, s, nh, d = q.shape
    rep = nh // kp.shape[2]
    out = torch.zeros_like(q)
    for bi in range(b):
        for i in range(s):
            keys = [kp[bi, j] for j in range(kp.shape[1]) if pm[bi, j]] \
                + [kw[bi, j] for j in range(i + 1) if wm[bi, j]]
            vals = [vp[bi, j] for j in range(kp.shape[1]) if pm[bi, j]] \
                + [vw[bi, j] for j in range(i + 1) if wm[bi, j]]
            if not keys:
                continue
            kk = torch.stack(keys).repeat_interleave(rep, 1)   # [n, NH, D]
            vv = torch.stack(vals).repeat_interleave(rep, 1)
            w = torch.softmax((kk * q[bi, i][None]).sum(-1) * scale, 0)
            out[bi, i] = (w[..., None] * vv).sum(0)
    return out


# (nh, nkv, d): MHA and grouped-query 4:1 (32/8-like), D 64 and 128
HEADS = [(4, 4, 64), (8, 2, 64), (4, 4, 128), (8, 2, 128)]


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: "%d-%d-d%d" % h)
def test_plain_version_is_the_eager_window_attention(heads):
    """On CPU tensors window_attention is the eager path chunk_forward_cached
    ran: the K/V concatenated, [B, S, P+S] mask, attention_eager; bit for
    bit. Prefix lengths 0 through P (one row each), a window with padding
    inside it; in f64 it equals a softmax over each query's visible keys."""
    nh, nkv, d = heads
    p, a, s_suf = 7, 4, 5
    plens = list(range(p + 1))
    app = [0, 4, 2, 3, 1, 0, 4, 2]
    suf = [5, 1, 3, 0, 5, 2, 4, 5]
    for dtype in (torch.float32, torch.float64):
        q, kp, vp, pm, kw, vw, wm = _window_inputs(
            plens, app, suf, p, a, s_suf, nh, nkv, d, dtype)
        # multi_head_attention's default scale, as chunk_forward_cached's
        scale = 1.0 / math.sqrt(d)
        got = A.window_attention(q, kp, vp, pm, kw, vw, wm, scale=scale)
        # the mask and concatenation chunk_forward_cached built inline
        b, s = wm.shape
        qi = torch.arange(s)[:, None]
        sm = (qi >= qi.T)[None] & wm[:, None, :]
        kv_mask = torch.cat([pm[:, None, :].expand(b, s, p), sm], dim=-1)
        want = A.multi_head_attention(
            q, torch.cat([kp, kw], 1), torch.cat([vp, vw], 1),
            kv_mask=kv_mask, causal=False, impl="eager")
        assert torch.equal(got, want)
        if dtype == torch.float64:
            seen = _seen(pm, wm) > 0
            ref = _per_row_softmax(q, kp, vp, pm, kw, vw, wm, scale)
            torch.testing.assert_close(got[seen], ref[seen], rtol=1e-10,
                                       atol=1e-10)
            # the only queries that see nothing: the empty prefix's row,
            # its padded append columns
            nothing = torch.zeros_like(seen)
            nothing[0, :a] = True
            assert torch.equal(~seen, nothing)


def test_window_input_checks_raise():
    """What the kernel does not take raises before any launch (the checks
    compare against q's device, so they run on CPU tensors too)."""
    args = _window_inputs([3, 5], [2, 1], [3, 3], 8, 4, 4, 4, 2, 64,
                          torch.bfloat16)
    A._check_window_inputs(*args)
    q, kp, vp, pm, kw, vw, wm = args
    bad = [
        (q.float(), kp, vp, pm, kw, vw, wm),                 # f32 q
        (q, kp, vp, pm, kw.float(), vw, wm),                 # f32 window K
        (q[..., :32], kp[..., :32], vp[..., :32], pm,        # D = 32
         kw[..., :32], vw[..., :32], wm),
        (q[:, :, :3], kp, vp, pm, kw, vw, wm),               # 3 heads over 2
        (q, kp[:, :6], vp, pm, kw, vw, wm),                  # K/V prefix
        (q, kp, vp, pm, kw[:, :7], vw[:, :7], wm),           # window length
        (q, kp, vp, pm.int(), kw, vw, wm),                   # int mask
        (q, kp, vp, pm, kw, vw, wm[:, :7]),                  # mask length
        (q, kp, vp, pm.t().contiguous().t(), kw, vw, wm),    # strided mask
        (q.transpose(2, 3), kp, vp, pm, kw, vw, wm),         # strided last
    ]
    for case in bad:
        with pytest.raises(ValueError):
            A._check_window_inputs(*case)


def _tiny_cached_forward(cfg, params, plens, app, suf, p, quant=False,
                         device="cpu", seed=1):
    """One chunk_forward_cached call over an [append | suffix] window that
    writes its append columns at plen, from a random cache. Returns
    (hidden, the cache before, the cache after)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b, a, s_suf = len(plens), max(app), max(suf)
    nkv, d = cfg.num_kv_heads, cfg.head_dim
    shape = (cfg.num_layers, b, p, nkv, d)
    cache = {n: torch.randn(shape, generator=g).to(device, cfg.dtype)
             for n in ("k", "v")}
    if quant:
        cache = L.quantize_kv_stack(cache)
    before = {n: x.clone() for n, x in cache.items()}
    emb = torch.randn((b, a + s_suf, cfg.hidden_size), generator=g) \
        .to(device, cfg.dtype)
    pm = _lengths_mask(plens, p, device)
    am = _lengths_mask(app, a, device)
    wm = torch.cat([am, _lengths_mask(suf, s_suf, device)], dim=1)
    plen = torch.as_tensor(plens, device=device)
    app_len = torch.as_tensor(app, device=device)
    pos = torch.cat([plen[:, None] + torch.arange(a, device=device),
                     (plen + app_len)[:, None]
                     + torch.arange(s_suf, device=device)], dim=1)
    write = torch.cat([am, torch.zeros_like(wm[:, a:])], dim=1)
    hidden, after = L.chunk_forward_cached(
        params, cfg, emb, cache, pm, wm, pos, write_offsets=plen.int(),
        write_mask=write)
    return hidden, before, after


def test_cached_forward_counts_eager_calls_per_layer():
    """On the CPU every layer's window attention is the eager path: one
    ``window_eager`` per layer while a profiler records, no kernel."""
    cfg = L.LlamaConfig.tiny(num_layers=3, num_heads=4, num_kv_heads=2)
    params = init_llama_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    P.TRACE.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _tiny_cached_forward(cfg, params, [3, 0, 6], [2, 1, 0], [3, 2, 3], 8)
    assert dict(P.TRACE.counters) == {"window_eager": 3}
    assert P.TRACE.spans["window_attn"].count == 3


# the prefix-cached cell's shapes (mistral-7b-v0.3.r2r_eval_cached): 16
# slots, 32 query heads over 8 KV heads of 128, a 192-slot cache holding
# 45-115 valid tokens, windows of 73-99 columns; deepseek's MHA 32/32; D=64
CARD_CASES = [(16, 32, 8, 128, 73), (16, 32, 8, 128, 99),
              (16, 32, 32, 128, 99), (4, 8, 2, 64, 140)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_window_kernel_matches_reference(case):
    _require_sm90()
    b, nh, nkv, d, s = case
    r = np.random.RandomState(s)
    p, a = 192, 24
    plens = r.randint(45, 116, b).tolist()
    plens[0] = 0                                   # an empty prefix
    plens[2] = p                                   # a full one: 2 tiles
    app = r.randint(0, a + 1, b).tolist()
    app[0] = 0
    suf = r.randint(s - a - 20, s - a + 1, b).tolist()
    suf[1] = s - a
    args = _window_inputs(plens, app, suf, p, a, s - a, nh, nkv, d,
                          torch.bfloat16, device="cuda", seed=s)
    scale = d ** -0.5
    with torch.inference_mode():
        before = A.window_attention.launches
        got = A.window_attention(*args, scale=scale)
        torch.cuda.synchronize()
        assert A.window_attention.launches == before + 1
        want = A.window_attention_reference(*args, scale=scale)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    seen = _seen(args[3], args[6])
    assert (seen == 0).any()                    # row 0's padded queries
    assert attn_excess(got, want, seen > 0) <= 1


@pytest.mark.cuda
def test_window_kernel_rows_that_see_nothing_are_finite():
    """Every key hidden (prefix and window): O is finite everywhere."""
    _require_sm90()
    q, kp, vp, pm, kw, vw, wm = _window_inputs(
        [0, 0], [0, 0], [0, 0], 192, 8, 80, 8, 2, 128, torch.bfloat16,
        device="cuda")
    with torch.inference_mode():
        o = A.window_attention(q, kp, vp, pm, kw, vw, wm, scale=0.1)
        torch.cuda.synchronize()
    assert torch.isfinite(o).all()


@pytest.mark.cuda
def test_window_kernel_rejects_what_it_does_not_take():
    _require_sm90()
    q, kp, vp, pm, kw, vw, wm = _window_inputs(
        [3], [2], [3], 8, 4, 4, 4, 2, 128, torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        A.window_attention(q.float(), kp, vp, pm, kw, vw, wm, scale=0.1)
    with pytest.raises(ValueError):
        A.window_attention(q, kp, vp, pm.cpu(), kw, vw, wm, scale=0.1)


def _layer0_fault(monkeypatch):
    """chunk_forward_cached's attention with one planted fault in layer 0
    (its first call): the window's first column (the first appended token,
    whose K/V layer 0 writes to the cache) hidden from every query. Later
    layers run the eager path."""
    calls = []

    def faulty(q, kp, vp, pm, kw, vw, wm, *, scale):
        if not calls:
            wm = wm.clone()
            wm[:, 0] = False
        calls.append(1)
        return A.window_attention_reference(q, kp, vp, pm, kw, vw, wm,
                                            scale=scale)
    monkeypatch.setattr(L, "window_attention", faulty)


def _cached_excess(got, want, plens, app, suf, p, quant):
    """(hidden states, layer 1's written K/V) of one cached forward against
    another from the same cache, as excesses of the kernels' gate. The
    append columns land at plen .. plen + app - 1 of every layer; layer
    1's written slots are compared under the gate (int8: dequantized, each
    side's codes within half a step of its own K/V, so the values may part
    by one step beyond the K/V's own difference: the gate sees what is
    left over)."""
    (h_g, _, a_g), (h_w, _, a_w) = got, want
    b = len(plens)
    wm = torch.cat([_lengths_mask(app, max(app), "cuda"),
                    _lengths_mask(suf, max(suf), "cuda")], dim=1)
    slots = torch.zeros((b, p), dtype=torch.bool, device="cuda")
    for bi in range(b):
        slots[bi, plens[bi]:plens[bi] + app[bi]] = True
    out = [attn_excess(h_g[:, :, None], h_w[:, :, None], wm)]
    for name in ("k", "v"):
        g, w = a_g[name][1].float(), a_w[name][1].float()
        if quant:
            sg, sw = a_g[name + "s"][1], a_w[name + "s"][1]
            g, w = g * sg, w * sw
            g = w + ((g - w).abs() - (sg + sw) / 2).clamp(min=0)
        out.append(attn_excess(g, w, slots))
    return out[0], max(out[1:]), slots


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cached_forward_kernel_matches_eager_path(quant, monkeypatch):
    """chunk_forward_cached on the card through the window kernel against
    the eager path, from the same cache: hidden states under the kernels'
    gate; the cache writes at the same slots, every slot of layer 0 (whose
    K/V both paths compute from the same input) and every slot not
    written bit for bit, layer 1's written slots under the same gate (int8:
    beyond one quantization step; scales within 2^-5). One window key
    hidden in layer 0 must fail the gate on the hidden states and on layer
    1's written slots, the int8 one with its slack."""
    _require_sm90()
    cfg = L.LlamaConfig(vocab_size=512, hidden_size=1024,
                        intermediate_size=2048, num_layers=2, num_heads=8,
                        num_kv_heads=2, dtype=torch.bfloat16, remat=False)
    params = init_llama_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda")
    r = np.random.RandomState(5)
    b, p = 8, 192
    plens = r.randint(45, 116, b).tolist()
    app = r.randint(0, 25, b).tolist()
    suf = r.randint(50, 76, b).tolist()
    runs = {}
    for path in ("kernel", "eager", "fault"):
        if path == "eager":
            monkeypatch.setattr(L, "window_attention",
                                A.window_attention_reference)
        elif path == "fault":
            _layer0_fault(monkeypatch)
        P.TRACE.reset()
        with torch.inference_mode(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            hidden, before, after = _tiny_cached_forward(
                cfg, params, plens, app, suf, p, quant=quant,
                device="cuda")
            torch.cuda.synchronize()
        runs[path] = (hidden, before, after)
        if path == "kernel":
            assert dict(P.TRACE.counters) == {"window_kernel": 2}
    h_ex, kv_ex, slots = _cached_excess(runs["kernel"], runs["eager"],
                                        plens, app, suf, p, quant)
    assert h_ex <= 1 and kv_ex <= 1
    (_, b_k, a_k), (_, b_e, a_e) = runs["kernel"], runs["eager"]
    for name in b_k:
        assert torch.equal(b_k[name], b_e[name])
        for after in (a_k[name], a_e[name]):
            assert torch.equal(after[:, ~slots], b_k[name][:, ~slots])
            assert (after[:, slots] != b_k[name][:, slots]).flatten(2) \
                .any(-1).all()
        assert torch.equal(a_k[name][0], a_e[name][0])
    for name in ("ks", "vs") if quant else ():
        torch.testing.assert_close(a_k[name][1][slots], a_e[name][1][slots],
                                   rtol=2 ** -5, atol=0)
    h_bad, kv_bad, _ = _cached_excess(runs["fault"], runs["eager"], plens,
                                      app, suf, p, quant)
    assert h_bad > 1 and kv_bad > 1
