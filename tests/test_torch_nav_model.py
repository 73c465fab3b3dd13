"""Port panorama encoder and nav model vs the JAX package.

Weights: params_from_jax of the JAX init_nav_params tree; batches:
navillm_tpu.testing.synthetic_nav_batch; f32, tolerance 1e-4 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import (  # noqa: E402
    forward_panorama as j_forward_panorama)
from navillm_tpu.testing import synthetic_nav_batch  # noqa: E402
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import (  # noqa: E402
    forward_panorama as t_forward_panorama)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = JNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    pt = params_from_jax(jax.tree.map(np.asarray, pj))
    return jcfg, pj, tcfg, pt


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_panorama_matches_jax(models, bf16):
    """f32 at 1e-4; bf16 (the 7B encoder's dtype: the port casts features
    at upload) within a few bf16 ulps of values up to ~4."""
    jcfg, pj, tcfg, pt = models
    tol = TOL
    if bf16:
        jcfg = dataclasses.replace(jcfg, pano=dataclasses.replace(
            jcfg.pano, dtype=jnp.bfloat16))
        tcfg = dataclasses.replace(tcfg, pano=dataclasses.replace(
            tcfg.pano, dtype=torch.bfloat16))
        pj = {"pano": jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                   pj["pano"])}
        pt = {"pano": params_from_jax(jax.tree.map(np.asarray, pj["pano"]))}
        tol = dict(rtol=2e-2, atol=5e-2)
    r = np.random.RandomState(0)
    b, v = 3, 9
    view = r.randn(b, v, jcfg.pano.image_feat_size).astype(np.float32)
    lens = np.array([9, 4, 1], np.int32)
    loc = r.randn(b, v, jcfg.pano.loc_size).astype(np.float32)
    nav = r.randint(0, 2, (b, v)).astype(np.int32)
    want = j_forward_panorama(pj["pano"], jcfg.pano, view, lens,
                              loc_fts=loc, nav_types=nav)
    got = t_forward_panorama(pt["pano"], tcfg.pano, torch.from_numpy(view),
                             torch.from_numpy(lens), torch.from_numpy(loc),
                             torch.from_numpy(nav))
    np.testing.assert_array_equal(got["pano_masks"].numpy(),
                                  np.asarray(want["pano_masks"]))
    np.testing.assert_allclose(
        got["pano_embeds"].float().numpy(),
        np.asarray(want["pano_embeds"]).astype(np.float32), **tol)


def test_fuse_gmap_local_matches_jax(models):
    jcfg, pj, tcfg, pt = models
    batch = synthetic_nav_batch(jcfg, b=3, g=12, v=8, seed=1)
    fj, cj = JNM.fuse_gmap_local(pj, jcfg, batch)
    ft, ct = TNM.fuse_gmap_local(pt, tcfg, _torch_batch(batch))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)


def test_forward_navigation_matches_jax(models):
    jcfg, pj, tcfg, pt = models
    batch = synthetic_nav_batch(jcfg, b=3, g=12, v=8, c=8, hh=4, tlen=48,
                                seed=2)
    batch["attention_mask"][1, :5] = False          # left padding
    want = JNM.forward_navigation(pj, jcfg, batch)
    model = TNM.NavModel(tcfg, pt)
    got = model(_torch_batch(batch))
    np.testing.assert_allclose(got["fuse_embeds"].numpy(),
                               np.asarray(want["fuse_embeds"]), **TOL)
    np.testing.assert_allclose(got["fuse_logits"].numpy(),
                               np.asarray(want["fuse_logits"]), **TOL)
    np.testing.assert_array_equal(got["fuse_logits"].argmax(-1).numpy(),
                                  np.asarray(want["fuse_logits"]).argmax(-1))


def test_init_nav_params_has_the_jax_tree(models):
    """The port's own random init builds the JAX init's tree: same keys,
    shapes and dtypes, with norms at one and biases at zero."""
    from navillm_tpu_torch.convert import init_nav_params
    _, pj, tcfg, pt = models
    fresh = init_nav_params(tcfg, torch.Generator().manual_seed(0))

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict)
                    else (tuple(v.shape), str(v.dtype).split(".")[-1]))
                for k, v in tree.items()}
    assert shapes(fresh) == shapes(pt)
    assert torch.equal(fresh["llm"]["final_norm"], pt["llm"]["final_norm"])
    assert not fresh["out_head"]["b"].any()
