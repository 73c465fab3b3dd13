"""Port attention (navillm_tpu_torch.ops.attention) vs the JAX package.

Same inputs, made with numpy from a seed, go through the JAX function and
its torch counterpart in f32; the Pallas kernel runs in interpret mode.
Tolerance 2e-4 on valid rows, as tests/test_attention.py: rows that see
no valid key are don't-care (the JAX paths themselves disagree there),
but every row must be finite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from navillm_tpu.ops.attention import (_attention_xla,  # noqa: E402
                                       _flash_attention, _repeat_kv)
from navillm_tpu_torch.ops.attention import (  # noqa: E402
    attention_eager, flash_attention_fwd_reference, multi_head_attention)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, t, s, nh, nkv, d, pads, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(b, t, nh, d).astype(np.float32)
    k = r.randn(b, s, nkv, d).astype(np.float32)
    v = r.randn(b, s, nkv, d).astype(np.float32)
    mask = np.arange(s)[None, :] >= np.asarray(pads)[:, None]   # left pad
    return q, k, v, mask


def _valid_rows(mask, t, causal):
    keys = np.broadcast_to(mask[:, None, :], (mask.shape[0], t,
                                              mask.shape[1])).copy()
    if causal:
        keys &= np.tril(np.ones((t, mask.shape[1]), bool), mask.shape[1] - t)
    return keys.any(-1)


def _t(x):
    return torch.from_numpy(x)


# (b, t, s, nh, nkv, d, causal, left pads)
CASES = [
    (2, 200, 200, 4, 2, 32, True, [0, 70]),      # ragged T, GQA, masked rows
    (2, 128, 128, 2, 2, 64, False, [5, 128]),    # a fully-masked batch row
    (1, 64, 64, 4, 4, 16, True, [0]),
]


@pytest.mark.parametrize("case", CASES)
def test_eager_matches_attention_xla(case):
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads)
    scale = d ** -0.5
    want = np.asarray(_attention_xla(
        q, _repeat_kv(k, nh // nkv), _repeat_kv(v, nh // nkv),
        jnp.asarray(mask), causal, scale))
    got = attention_eager(_t(q), _t(k), _t(v), _t(mask), causal, scale)
    assert torch.isfinite(got).all()
    # same convention on fully-masked rows, so every row is compared
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_flash_reference_matches_pallas_interpret(case):
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, seed=1)
    scale = d ** -0.5
    rep = nh // nkv
    o_j, lse_j = _flash_attention(
        jnp.asarray(q), _repeat_kv(jnp.asarray(k), rep),
        _repeat_kv(jnp.asarray(v), rep), jnp.asarray(mask), causal, scale,
        interpret=True, return_lse=True)
    lse_j = np.asarray(lse_j).reshape(b, nh, -1)[:, :, :t]     # [B, NH, T]
    o, lse = flash_attention_fwd_reference(_t(q), _t(k), _t(v), _t(mask),
                                           causal, scale)
    assert o.shape == (b, t, nh, d) and lse.shape == (b, nh, t)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    ok = _valid_rows(mask, t, causal)
    np.testing.assert_allclose(o.numpy()[ok], np.asarray(o_j)[ok], **TOL)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[ok],
                               lse_j.transpose(0, 2, 1)[ok], **TOL)


def test_eager_takes_per_query_masks_and_offset_causal():
    """[B, T, S] masks (the cached window's form) and causal with
    T < S (queries aligned to the end of the keys)."""
    b, t, s, nh, d = 2, 8, 24, 2, 16
    q, k, v, _ = _inputs(b, t, s, nh, nh, d, [0, 0], seed=2)
    r = np.random.RandomState(3)
    mask3 = r.rand(b, t, s) > 0.3
    mask3[..., -1] = True
    for mask, causal in ((mask3, False), (np.ones((b, s), bool), True)):
        want = np.asarray(_attention_xla(q, k, v, jnp.asarray(mask), causal,
                                         0.25))
        got = attention_eager(_t(q), _t(k), _t(v), _t(mask), causal, 0.25)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dispatch_on_cpu():
    """auto runs the eager path on CPU tensors; impl='kernel' refuses
    them (the CUDA kernel has no CPU version)."""
    q, k, v, mask = (_t(x) for x in _inputs(2, 16, 16, 4, 2, 16, [0, 3]))
    got = multi_head_attention(q, k, v, kv_mask=mask, causal=True)
    want = attention_eager(q, k, v, mask, True, 16 ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, kv_mask=mask, causal=True,
                             impl="kernel")
