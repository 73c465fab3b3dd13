"""Port quantizer (navillm_tpu_torch.models.quant) vs the JAX package.

Both quantize the same weights, made with numpy from a seed. The int grid
may differ by one step where a value sits on a rounding edge (the f32 amax
reduction order can move the last ulp of a scale): at most one step apart,
with >= 99% of the values equal, as tests/test_quant4.py allows between
two JAX forms. Scales agree to rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models import quant as JQ  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu_torch.agents.runner import NavModelRunner  # noqa: E402
from navillm_tpu_torch.convert import (flatten_tree,  # noqa: E402
                                       params_from_jax)
from navillm_tpu_torch.models import quant as TQ  # noqa: E402
from navillm_tpu_torch.models.nav_model import (NavModel,  # noqa: E402
                                                NavModelConfig)
from navillm_tpu_torch.ops.matmul_q4 import unpack_q4  # noqa: E402

torch.set_num_threads(1)


def _to_torch(a):
    return params_from_jax({"a": np.asarray(a)}, device="cpu")["a"]


def _grid(a):
    """Integer grid values of a q or q4p leaf, as int32 numpy."""
    a = np.asarray(a)
    if a.dtype == np.uint8:
        a = JQ.unpack_int4_host(a)
    return a.astype(np.int32)


def _assert_same_quant(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, k)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (what, k,
                                                              g.dtype)
        if k == "s":
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), rtol=1e-6,
                                       atol=0, err_msg=f"{what}.{k}")
        else:
            d = np.abs(_grid(g.numpy()) - _grid(w))
            assert d.max() <= 1 and (d == 0).mean() >= 0.99, (what, k)


def _weights(shape, dtype, seed=0):
    w = (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)
    wj = jnp.asarray(w, dtype)
    return wj, _to_torch(wj)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(256, 96), (384, 64), (3, 128, 48),
                                   (2, 96, 40)])
def test_quant_weight4_matches_jax(shape, dtype):
    """Group-wise int4, flat and layer-stacked; h = 96 takes G = 32."""
    wj, wt = _weights(shape, dtype)
    _assert_same_quant(TQ._quant_weight4(wt), JQ._quant_weight4(wj),
                       f"int4 {shape}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(128, 40), (3, 64, 24)])
def test_quant_weight8_and_embed_match_jax(shape, dtype):
    wj, wt = _weights(shape, dtype, seed=1)
    _assert_same_quant(TQ._quant_weight(wt), JQ._quant_weight(wj),
                       f"int8 {shape}")
    if len(shape) == 2:
        _assert_same_quant(TQ._quant_embed(wt), JQ._quant_embed(wj),
                           f"embed {shape}")


@pytest.fixture(scope="module")
def nav_tree():
    cfg = JNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), cfg)
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_nav_params_matches_jax(nav_tree, bits):
    pj, pt = nav_tree
    # JQ.quantize_nav_params without its jit, which donates the shared tree
    want = dict(pj, llm=JQ._quantize_llama_impl(pj["llm"], bits))
    got = TQ.quantize_nav_params(pt, bits)
    fw = flatten_tree(jax.tree.map(np.asarray, want))
    fg = flatten_tree(got)
    assert set(fg) == set(fw)
    groups = {}
    for name, leaf in fg.items():
        head, _, key = name.rpartition(".")
        if key in ("q", "q4p", "s") and name.startswith("llm."):
            groups.setdefault(head, {})[key] = name
        else:       # dense leaves pass through untouched
            np.testing.assert_array_equal(leaf.numpy(), fw[name])
    for head, keys in groups.items():
        _assert_same_quant({k: fg[n] for k, n in keys.items()},
                           {k: fw[n] for k, n in keys.items()}, head)
    # embed and lm_head stay int8 at every bits setting
    assert got["llm"]["embed"]["q"].dtype == torch.int8
    assert got["llm"]["lm_head"]["q"].dtype == torch.int8
    assert TQ.is_quantized(got) and TQ.weight_bits(got) == bits
    assert not TQ.is_quantized(pt) and TQ.weight_bits(pt) == 16
    # the input tree is left as it is
    assert pt["llm"]["layers"]["wq"].dtype == torch.float32


def test_params_from_jax_carries_a_quantized_tree_byte_for_byte(nav_tree):
    """A bf16 JAX int4 tree: uint8/int8 values and bf16 scales arrive with
    the same dtypes and bytes."""
    pj, _ = nav_tree
    q = jax.tree.map(np.asarray, JQ._quantize_llama_impl(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj["llm"]), 4))
    got = flatten_tree(params_from_jax(q, device="cpu"))
    for name, want in flatten_tree(q).items():
        assert str(got[name].dtype).split(".")[-1] == want.dtype.name, name
        np.testing.assert_array_equal(
            got[name].contiguous().view(torch.uint8).numpy(),
            np.ascontiguousarray(want).view(np.uint8), err_msg=name)
    assert got["layers.wq.q4p"].dtype == torch.uint8
    assert got["embed.s"].dtype == torch.bfloat16


def test_quantize_takes_a_param_tree(nav_tree):
    """A NavModel on the card quantizes in place of a second init: same
    result as the dict, dense leaves shared rather than copied."""
    _, pt = nav_tree
    cfg = NavModelConfig.tiny(vocab_size=300, use_obj=False)
    model = NavModel(cfg, pt)
    got = TQ.quantize_nav_params(model, 4)
    want = flatten_tree(TQ.quantize_nav_params(pt, 4))

    def plain(tree):
        return {k: (v if isinstance(v, torch.Tensor) else plain(v))
                for k, v in tree.items()}

    got_flat = flatten_tree(plain(got))
    assert set(got_flat) == set(want)
    for name, leaf in want.items():
        torch.testing.assert_close(got_flat[name], leaf, rtol=0, atol=0)
    qmodel = NavModel(cfg, got)
    assert qmodel["llm"]["layers"]["wq"]["q4p"].dtype == torch.uint8
    assert qmodel["pano"] is model["pano"]
    assert qmodel["llm"]["final_norm"].data_ptr() == \
        model["llm"]["final_norm"].data_ptr()
    n_q = sum(p.numel() * p.element_size() for p in qmodel.llm.parameters())
    n_d = sum(p.numel() * p.element_size() for p in model.llm.parameters())
    assert n_q < n_d / 3     # f32 tiny tree: 0.5 byte + scales per weight


def test_pack_unpack_nibble_contract():
    r = np.random.RandomState(7)
    q = r.randint(-7, 8, (5, 16, 10)).astype(np.int8)
    packed = TQ.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (5, 16, 5)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(TQ.unpack_int4_host(packed.numpy()), q)
    np.testing.assert_array_equal(unpack_q4(packed).numpy(), q)
    np.testing.assert_array_equal(
        unpack_q4(packed).numpy(), np.asarray(JL._unpack_q4(packed.numpy())))
    # explicit contract: byte 0 of a pair = channels (0, 1)
    one = TQ.pack_int4(torch.tensor([[3, -5]], dtype=torch.int8))
    assert int(one[0, 0]) == (3 | ((-5) & 0xF) << 4)
    # every byte value unpacks as the JAX host inverse does
    every = np.arange(256, dtype=np.uint8)[None, :]
    np.testing.assert_array_equal(unpack_q4(torch.from_numpy(every)).numpy(),
                                  JQ.unpack_int4_host(every))


def _tiny_runner(params, **llm_kw):
    tok = NavTokenizer(max_length=512)
    cfg = NavModelConfig.tiny(vocab_size=300, use_obj=False)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **llm_kw))
    return NavModelRunner(cfg, NavModel(cfg, params), tok)


def test_runner_refuses_training_a_quantized_tree(nav_tree):
    _, pt = nav_tree
    runner = _tiny_runner(TQ.quantize_nav_params(pt, 4))
    with pytest.raises(ValueError, match="int8 weights are not "
                                         "differentiable"):
        runner.zero_grads()
    assert not runner.grads_open
    _tiny_runner(pt).zero_grads()       # a dense tree trains


def test_runner_refuses_act_int8_on_a_dense_tree(nav_tree):
    _, pt = nav_tree
    with pytest.raises(ValueError, match="act_int8 needs a quantized LLM"):
        _tiny_runner(pt, act_int8=True)
    _tiny_runner(TQ.quantize_nav_params(pt, 4), act_int8=True)
