"""The port's parameter builders (navillm_tpu_torch/convert.py) put their
tensors on the card unless the caller names a device, raise where there is
no card and none was named, and on ``device="cpu"`` build what they always
built: the JAX tree's values, or the generator's draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from navillm_tpu_torch import convert as C  # noqa: E402
from navillm_tpu_torch.models import llama as L  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402

torch.set_num_threads(1)


def _cfg():
    return TNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)


def _jax_tree():
    r = np.random.RandomState(0)
    return {"w": r.randn(3, 4).astype(np.float32),
            "sub": {"q": r.randint(-8, 8, (5,)).astype(np.int8),
                    "p": r.randint(0, 256, (2, 3)).astype(np.uint8),
                    "h": np.asarray(jnp.asarray(r.randn(4), jnp.bfloat16))}}


NAMES = ["params_from_jax", "init_nav_params", "init_llama_params",
         "init_pano_params"]


def _build(name, device=None):
    """The builder ``name`` on ``device`` (None: its default), with a
    generator on the device it builds on."""
    kw = {} if device is None else {"device": device}
    on_card = device is None and torch.cuda.is_available()
    gen = torch.Generator(device="cuda" if on_card else "cpu").manual_seed(0)
    cfg = _cfg()
    if name == "params_from_jax":
        return C.params_from_jax(_jax_tree(), **kw)
    if name == "init_nav_params":
        return C.init_nav_params(cfg, gen, **kw)
    if name == "init_llama_params":
        return C.init_llama_params(cfg.llm, gen, **kw)
    return C.init_pano_params(cfg.pano, gen, **kw)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("name", NAMES)
def test_builder_defaults_to_the_card_and_raises_without_one(name):
    if torch.cuda.is_available():
        assert all(x.is_cuda for x in _leaves(_build(name)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _build(name)


@pytest.mark.parametrize("name", NAMES)
def test_builder_on_cpu_when_asked(name):
    assert all(x.device.type == "cpu" for x in _leaves(_build(name, "cpu")))


def test_params_from_jax_on_cpu_keeps_every_value_and_dtype():
    src, got = _jax_tree(), C.params_from_jax(_jax_tree(), device="cpu")
    assert got["w"].dtype == torch.float32
    assert got["sub"]["q"].dtype == torch.int8
    assert got["sub"]["p"].dtype == torch.uint8
    assert got["sub"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].numpy(), src["w"])
    np.testing.assert_array_equal(got["sub"]["q"].numpy(), src["sub"]["q"])
    np.testing.assert_array_equal(got["sub"]["p"].numpy(), src["sub"]["p"])
    np.testing.assert_array_equal(got["sub"]["h"].float().numpy(),
                                  src["sub"]["h"].astype(np.float32))


def test_init_nav_params_on_cpu_draws_from_the_generator():
    """The first draw is the first layer weight of the LLM's spec, at its
    fan-in scale; the same seed gives the same tree."""
    cfg = _cfg()
    a = C.init_nav_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = C.init_nav_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    key, spec = next(iter(L.weight_spec(cfg.llm)["layers"].items()))
    shape = spec[0]
    scale = spec[1] if len(spec) > 1 and spec[1] is not None \
        else shape[-2] ** -0.5
    want = torch.randn(shape, generator=torch.Generator().manual_seed(0),
                       dtype=cfg.llm.dtype).mul_(scale)
    assert torch.equal(a["llm"]["layers"][key], want)
