"""The port's differentiable flash attention against the JAX package's.

On CPU tensors ``FlashAttention`` runs the plain forward and the plain
backward (``flash_attention_bwd_reference``, the math of the dK/dV and dQ
kernels). Its gradients are held against ``jax.vjp`` of
``_flash_differentiable(..., interpret=True)``, the Pallas forward and
backward kernels run in interpret mode, and against torch autograd through
the eager path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.ops.attention import _flash_differentiable  # noqa: E402
from navillm_tpu_torch.ops.attention import (  # noqa: E402
    FlashAttention, attention_eager, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd)

torch.set_num_threads(1)


def _valid_rows(mask, t, causal):
    """[B, T] bool: query rows that see at least one valid key."""
    keys = np.broadcast_to(mask[:, None, :], (mask.shape[0], t,
                                              mask.shape[1])).copy()
    if causal:
        keys &= np.tril(np.ones((t, mask.shape[1]), bool), mask.shape[1] - t)
    return keys.any(-1)


def _grads(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fn(q, k, v).backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax_vjp(causal):
    """The shapes of tests/test_attention.py::test_flash_backward_matches_xla
    (b=2, t=256, 2 heads of 128, f32), plus left padding that leaves the
    first rows of the second sequence without a valid key under causal."""
    rng = np.random.RandomState(7)
    b, t, nh, d = 2, 256, 2, 128
    q, k, v, g = (rng.randn(b, t, nh, d).astype(np.float32)
                  for _ in range(4))
    mask = rng.rand(b, t) > 0.2
    mask[0, :2] = True
    mask[1, :5] = False
    scale = d ** -0.5

    def f_jax(q, k, v):
        return _flash_differentiable(q, k, v, jnp.asarray(mask), causal,
                                     scale, interpret=True)

    _, vjp = jax.vjp(f_jax, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _grads(lambda q, k, v: FlashAttention.apply(
        q, k, v, torch.from_numpy(mask), causal, scale), q, k, v, g)

    ok = _valid_rows(mask, t, causal)[:, :, None, None]
    # f32 on both sides; the Pallas forward's online softmax and block sums
    # differ from the plain version in summation order only
    for name, a, w in zip("qkv", got, want):
        if name == "q":       # rows with no valid key are don't-care
            a, w = np.where(ok, a, 0), np.where(ok, w, 0)
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name} causal={causal}")


# (b, t, s, nh, nkv, d, causal, left pads per row)
EAGER_CASES = [
    (2, 48, 48, 4, 4, 16, True, [0, 7]),
    (2, 40, 40, 8, 2, 16, True, [3, 0]),       # GQA, 4 query heads per kv
    (2, 24, 40, 4, 2, 8, False, [0, 11]),      # cross-attention, GQA
]


@pytest.mark.parametrize("case", EAGER_CASES)
def test_plain_backward_matches_eager_autograd(case):
    """FlashAttention (plain forward + plain backward) against autograd
    through attention_eager. The cotangent is zero on rows that see no
    valid key: there the two conventions differ (the eager softmax averages
    every key, the flash rule gives P = 0), and in the model such rows
    carry no gradient."""
    b, t, s, nh, nkv, d, causal, pads = case
    rng = np.random.RandomState(11)
    q = rng.randn(b, t, nh, d).astype(np.float32)
    k, v = (rng.randn(b, s, nkv, d).astype(np.float32) for _ in range(2))
    mask = np.arange(s)[None, :] >= np.asarray(pads)[:, None]
    g = rng.randn(b, t, nh, d).astype(np.float32)
    g *= _valid_rows(mask, t, causal)[:, :, None, None]
    m = torch.from_numpy(mask)
    scale = d ** -0.5
    got = _grads(lambda q, k, v: FlashAttention.apply(q, k, v, m, causal,
                                                      scale), q, k, v, g)
    want = _grads(lambda q, k, v: attention_eager(q, k, v, m, causal, scale),
                  q, k, v, g)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name} {case}")


def test_backward_wrapper_is_its_plain_version_on_cpu():
    """On CPU tensors flash_attention_bwd runs the plain version and counts
    no launch; bf16 inputs come back in their own dtypes."""
    from navillm_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq)
    rng = np.random.RandomState(3)
    b, t, nh, nkv, d = 2, 32, 4, 2, 16
    q = torch.from_numpy(rng.randn(b, t, nh, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(b, t, nkv, d).astype(np.float32))
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = torch.arange(t)[None, :] >= torch.tensor([0, 9])[:, None]
    o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=0.25)
    do = torch.from_numpy(rng.randn(b, t, nh, d).astype(np.float32)) \
        .to(torch.bfloat16)
    before = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, mask, o, lse, do, causal=True,
                              scale=0.25)
    want = flash_attention_bwd_reference(q, k, v, mask, o, lse, do, True, 0.25)
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == before
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # keys hidden by the mask get no gradient
    assert not got[1][1, :9].float().any() and not got[2][1, :9].float().any()
