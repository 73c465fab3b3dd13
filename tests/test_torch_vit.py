"""The port's ViT (navillm_tpu_torch/vision/vit.py) against the JAX tower
(navillm_tpu/vision/vit.py) on weights carried over by
convert.vit_params_from_jax, against the frozen EVA02 golden activations,
and its converters against HF's CLIPVisionModel and the JAX conversion."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.vision import vit as JV  # noqa: E402
from navillm_tpu_torch.convert import vit_params_from_jax  # noqa: E402
from navillm_tpu_torch.vision import vit as TV  # noqa: E402

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "eva02_golden.npz"


def _cfgs(style, pt_grid):
    kw = dict(image_size=28, patch_size=14, width=64, num_layers=2,
              num_heads=4, style=style, ln_eps=1e-6, rope_pt_grid=pt_grid,
              mlp_ratio=8 / 3 if style == "eva02" else 4.0)
    return JV.ViTConfig(**kw), TV.ViTConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params, cfg, imgs):
    with torch.no_grad():
        return TV.vit_forward_features(params, cfg,
                                       torch.from_numpy(imgs)).numpy()


def _eva02_state_dict(cfg, seed):
    """Random weights under the EVA-CLIP ``visual.*`` names (the layout
    tests/test_vit_parity.py builds)."""
    from test_vit_parity import _make_eva02_state_dict
    return _make_eva02_state_dict(cfg, seed=seed)


@pytest.mark.parametrize("style,pt_grid", [("clip", None), ("eva02", None),
                                           ("eva02", 16)])
def test_forward_matches_jax(style, pt_grid):
    jcfg, tcfg = _cfgs(style, pt_grid)
    jp = JV.init_vit_params(jax.random.PRNGKey(3), jcfg)
    # non-trivial norms, biases and CLS so every leaf shows
    leaves, treedef = jax.tree.flatten(jp)
    r = np.random.RandomState(5)
    jp = jax.tree.unflatten(treedef, [
        np.asarray(x) + 0.05 * r.randn(*x.shape).astype(np.float32)
        for x in leaves])
    imgs = np.random.RandomState(4).randn(3, 28, 28, 3).astype(np.float32)
    ref = np.asarray(JV.vit_forward_features(jp, jcfg, jnp.asarray(imgs)))
    got = _port(vit_params_from_jax(_np_tree(jp), device="cpu"), tcfg, imgs)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pt_grid", [None, 16])
def test_eva02_frozen_golden(pt_grid):
    data = np.load(FIXTURE)
    tag = "none" if pt_grid is None else str(pt_grid)
    _, cfg = _cfgs("eva02", pt_grid)
    sd = _eva02_state_dict(cfg, seed=3)
    params = TV.convert_eva02_clip(sd, cfg, device="cpu")
    got = _port(params, cfg, data[f"imgs_{tag}"])
    np.testing.assert_allclose(got, data[f"ref_{tag}"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("pt_grid", [None, 16])
def test_convert_eva02_matches_jax(pt_grid):
    jcfg, tcfg = _cfgs("eva02", pt_grid)
    sd = _eva02_state_dict(tcfg, seed=7)
    # the k projection without a bias, q/v biases under q_bias / v_bias
    ref = _np_tree(JV.convert_eva02_clip({k: v.numpy()
                                          for k, v in sd.items()}, jcfg))
    got = TV.convert_eva02_clip(sd, tcfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree.leaves(got))
    for path, leaf in flat_ref:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_convert_hf_clip_vision_matches_hf():
    from transformers import CLIPVisionConfig, CLIPVisionModel
    hf_cfg = CLIPVisionConfig(hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4,
                              image_size=28, patch_size=14,
                              layer_norm_eps=1e-6, hidden_act="gelu")
    torch.manual_seed(0)
    hf = CLIPVisionModel(hf_cfg).eval()
    cfg = TV.ViTConfig(image_size=28, patch_size=14, width=64, num_layers=2,
                       num_heads=4, mlp_ratio=2.0, style="clip", ln_eps=1e-6)
    params = TV.convert_hf_clip_vision(hf.state_dict(), cfg, device="cpu")
    imgs = np.random.RandomState(0).randn(3, 28, 28, 3).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(
            imgs.transpose(0, 3, 1, 2))).pooler_output.numpy()
    np.testing.assert_allclose(_port(params, cfg, imgs), ref, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("style", ["clip", "eva02"])
def test_feature_independent_of_batch(style):
    cfg = TV.ViTConfig.tiny(style=style, rope_pt_grid=16
                            if style == "eva02" else None)
    params = TV.init_vit_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    imgs = np.random.RandomState(2).randn(4, 28, 28, 3).astype(np.float32)
    full = _port(params, cfg, imgs)
    solo = _port(params, cfg, imgs[2:3])
    assert full.shape == (4, cfg.width) and np.isfinite(full).all()
    np.testing.assert_allclose(full[2:3], solo, rtol=1e-4, atol=1e-5)


def test_init_shapes_match_jax():
    for style in ("clip", "eva02"):
        jcfg, tcfg = _cfgs(style, None)
        jp = _np_tree(JV.init_vit_params(jax.random.PRNGKey(0), jcfg))
        tp = TV.init_vit_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            node = tp
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape, path
        assert len(jax.tree.leaves(jp)) == len(jax.tree.leaves(tp))


def test_vit_params_from_jax_refuses_other_trees():
    with pytest.raises(KeyError):
        vit_params_from_jax({"embed": np.zeros(2, np.float32)}, device="cpu")
