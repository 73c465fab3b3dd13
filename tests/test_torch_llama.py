"""Port Llama (navillm_tpu_torch.models.llama) vs the JAX package.

Weights are the JAX init converted with params_from_jax; inputs are numpy
from a seed; f32, tolerance 1e-4 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = 300


@functools.lru_cache(maxsize=None)
def _llm_params(nkv):
    """JAX LLM params from init_nav_params, and their converted twin."""
    cfg = JNM.NavModelConfig.tiny(vocab_size=VOCAB, use_obj=False)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_kv_heads=nkv))
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), cfg)["llm"]
    return cfg.llm, pj, params_from_jax(jax.tree.map(np.asarray, pj))


def _left_padded_mask(b, t, pads):
    return np.arange(t)[None, :] >= np.asarray(pads)[:, None]


@pytest.mark.parametrize("nkv", [4, 2])
def test_forward_hidden_matches_jax(nkv):
    jcfg, pj, pt = _llm_params(nkv)
    tcfg = TL.LlamaConfig.tiny(vocab_size=VOCAB, num_kv_heads=nkv)
    r = np.random.RandomState(0)
    b, t = 3, 40
    emb = r.randn(b, t, jcfg.hidden_size).astype(np.float32)
    mask = _left_padded_mask(b, t, [0, 9, 39])     # fully-masked rows too
    want, _ = JL.forward_hidden(pj, jcfg, emb, mask)
    got = TL.forward_hidden(pt, tcfg, torch.from_numpy(emb),
                            torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the module holds the same weights under weight_spec's names
    module = TL.Llama(tcfg, pt)
    names = {n for n, _ in module.named_parameters()}
    spec = TL.weight_spec(tcfg)
    assert names == {"embed", "final_norm", "lm_head",
                     *(f"layers.{k}" for k in spec["layers"]),
                     "layers.attn_norm", "layers.mlp_norm"}
    torch.testing.assert_close(
        module(torch.from_numpy(emb), torch.from_numpy(mask)), got,
        rtol=0, atol=0)


def test_embed_with_injection_matches_jax():
    _, pj, pt = _llm_params(4)
    r = np.random.RandomState(1)
    b, t, k, h = 2, 24, 5, pj["embed"].shape[1]
    ids = r.randint(0, VOCAB, (b, t)).astype(np.int32)
    pos = np.full((b, k), -1, np.int32)
    pos[0, :3] = [2, 7, 11]
    pos[1, :4] = [0, 1, 20, 23]
    vis = r.randn(b, k, h).astype(np.float32)
    want = JL.embed_with_injection(pj, ids, pos, vis)
    got = TL.embed_with_injection(pt, torch.from_numpy(ids),
                                  torch.from_numpy(pos), torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_and_norm_match_jax():
    jcfg, _, _ = _llm_params(4)
    tcfg = TL.LlamaConfig.tiny(vocab_size=VOCAB)
    r = np.random.RandomState(2)
    pos = np.cumsum(r.rand(2, 17) > 0.2, -1).astype(np.int32)
    x = r.randn(2, 17, tcfg.num_heads, tcfg.head_dim).astype(np.float32)
    cj, sj = JL.rope_tables(jcfg, pos)
    ct, st = TL.rope_tables(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), ct, st).numpy(),
        np.asarray(JL.apply_rope(x, cj, sj)), **TOL)
    w = r.randn(tcfg.head_dim).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(JL.rms_norm(x, w, 1e-6)), **TOL)
