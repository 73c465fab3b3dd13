"""The int4 matmul's plain version (ops/matmul_q4.py) vs the JAX package.

matmul_q4_reference is held against the Pallas kernel in interpret mode
(navillm_tpu.ops.matmul_q4.matmul_q4(..., interpret=True)) at the shapes
of tests/test_matmul_q4.py, and the port's llama._mm against the JAX
llama._mm (its XLA fallback) on bf16-scale trees. Weights come from the
JAX quantizer on numpy weights from a seed. Tolerances: f32 x, 1e-5 of
max(|ref|, 1) (both sum f32 products in other orders); int8 x, rtol 1e-6
against a float64 per-group reference (every group's integer product is
exact in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models.quant import (_quant_one4,  # noqa: E402
                                      unpack_int4_host)
from navillm_tpu.ops.matmul_q4 import matmul_q4 as j_matmul_q4  # noqa: E402
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.ops.matmul_q4 import (matmul_q4,  # noqa: E402
                                             matmul_q4_reference)

torch.set_num_threads(1)
SHAPES = [(40, 256, 512), (7, 384, 256), (256, 256, 256)]


def _make(h, o, seed=0):
    """(q4p uint8, s f32, s bf16 as numpy, dequantized weight f32)."""
    w = (np.random.RandomState(seed).randn(h, o) * 0.02).astype(np.float32)
    q4p, s16 = _quant_one4(jnp.asarray(w, jnp.bfloat16))
    q4p, s = np.asarray(q4p), np.asarray(s16.astype(jnp.float32))
    g = h // s.shape[0]
    wd = (unpack_int4_host(q4p).reshape(s.shape[0], g, o)
          * s[:, None, :]).reshape(h, o)
    return q4p, s, np.asarray(s16), wd


def _t(a):
    return params_from_jax({"a": np.asarray(a)}, device="cpu")["a"]


@pytest.mark.parametrize("m,h,o", SHAPES)
def test_reference_matches_pallas_interpret_f32(m, h, o):
    q4p, s, _, wd = _make(h, o)
    x = np.random.RandomState(1).randn(m, h).astype(np.float32)
    want = np.asarray(j_matmul_q4(jnp.asarray(x), jnp.asarray(q4p),
                                  jnp.asarray(s), interpret=True))
    got = matmul_q4_reference(_t(x), _t(q4p), _t(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, o)
    bound = 1e-5 * max(np.abs(want).max(), 1.0)
    assert np.abs(got.numpy() - want).max() <= bound
    assert np.abs(got.numpy() - x @ wd).max() <= 1e-4 * max(
        np.abs(want).max(), 1.0)


@pytest.mark.parametrize("m,h,o", SHAPES)
def test_reference_int8_mode_is_exact(m, h, o):
    """int8 x: int32 group products, f32 out, rtol 1e-6 against float64."""
    q4p, s, _, _ = _make(h, o, seed=2)
    xa = np.random.RandomState(3).randint(-127, 128, (m, h)).astype(np.int8)
    got = matmul_q4_reference(_t(xa), _t(q4p), _t(s))
    assert got.dtype == torch.float32
    g = h // s.shape[0]
    qh = unpack_int4_host(q4p).astype(np.int32)
    part = np.einsum("mgk,gko->mgo", xa.astype(np.int32).reshape(m, -1, g),
                     qh.reshape(-1, g, o))
    ref = (part.astype(np.float64) * s[None].astype(np.float64)).sum(1)
    np.testing.assert_allclose(got.numpy(), ref.astype(np.float32), rtol=1e-6)
    want = np.asarray(j_matmul_q4(jnp.asarray(xa), jnp.asarray(q4p),
                                  jnp.asarray(s), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_reference_leading_dims_and_odd_rows():
    q4p, s, _, wd = _make(256, 256, seed=4)
    x = np.random.RandomState(5).randn(3, 5, 256).astype(np.float32)
    want = np.asarray(j_matmul_q4(jnp.asarray(x), jnp.asarray(q4p),
                                  jnp.asarray(s), interpret=True))
    got = matmul_q4_reference(_t(x), _t(q4p), _t(s))
    assert tuple(got.shape) == (3, 5, 256)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(
        np.abs(want).max(), 1.0)


@pytest.mark.parametrize("a8", [False, True])
def test_mm_matches_jax_fallback_on_bf16_scales(a8):
    """The port's llama._mm against the JAX one's XLA form, bf16 scales."""
    q4p, _, s16, wd = _make(256, 512, seed=6)
    x = np.random.RandomState(7).randn(9, 256).astype(np.float32)
    want = np.asarray(JL._mm(jnp.asarray(x), {"q4p": jnp.asarray(q4p),
                                              "s": jnp.asarray(s16)}, a8))
    got = TL._mm(_t(x), {"q4p": _t(q4p), "s": _t(s16)}, a8).numpy()
    # test_mm4_fallback_unchanged's bound against the dequantized weight
    assert np.abs(got - x @ wd).max() <= 2e-2 * max(np.abs(got).max(), 1.0)
    # and the two packages agree far inside it
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)


def test_act_q_matches_jax():
    x = (np.random.RandomState(8).randn(4, 6, 64) * 3).astype(np.float32)
    x[1, 2] = 0.0                           # an all-zero row: the 1e-6 floor
    qj, sj = JL._act_q(jnp.asarray(x))
    qt, st = TL._act_q(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and tuple(st.shape) == (4, 6, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_mm_int8_weight_only_matches_jax_and_refuses_a8():
    from navillm_tpu.models.quant import _quant_weight
    w = (np.random.RandomState(9).randn(64, 48) * 0.1).astype(np.float32)
    wq = _quant_weight(jnp.asarray(w))
    x = np.random.RandomState(10).randn(5, 64).astype(np.float32)
    tw = {"q": _t(wq["q"]), "s": _t(wq["s"])}
    np.testing.assert_allclose(TL._mm(_t(x), tw).numpy(),
                               np.asarray(JL._mm(jnp.asarray(x), wq)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        TL._mm(_t(x), tw, a8=True)


def test_wrapper_on_cpu_is_the_plain_version():
    """CPU tensors: the plain version, no launch counted; out dtypes follow
    the JAX contract; a shape that does not fit raises."""
    q4p, s, s16, _ = _make(128, 64, seed=11)
    x = torch.from_numpy(np.random.RandomState(12).randn(2, 3, 128)
                         .astype(np.float32))
    before = matmul_q4.launches
    got = matmul_q4(x, _t(q4p), _t(s))
    assert matmul_q4.launches == before
    torch.testing.assert_close(got, matmul_q4_reference(x, _t(q4p), _t(s)),
                               rtol=0, atol=0)
    assert matmul_q4(x.bfloat16(), _t(q4p), _t(s16)).dtype == torch.bfloat16
    assert matmul_q4(x.to(torch.int8), _t(q4p), _t(s)).dtype == torch.float32
    assert matmul_q4(x, _t(q4p), _t(s),
                     out_dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        matmul_q4(x[..., :96], _t(q4p), _t(s))
    with pytest.raises(ValueError):
        matmul_q4(x, _t(q4p), _t(s)[:, :32])
    with pytest.raises(ValueError, match="q4_impl"):
        TL._mm4(x, {"q4p": _t(q4p), "s": _t(s)}, False, "kernel")
