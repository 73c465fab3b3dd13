"""Port generation (trie, decode step, generate, generation loss) vs JAX.

Weights are the JAX init converted with params_from_jax; inputs are numpy
from a seed; f32. Activations and losses at rtol 1e-4 / atol 1e-5,
gradients at rtol 2e-3. Greedy tokens must be identical; the JAX logits
behind every compared pick are held to a top-2 margin above 1e-3, so a
tie broken by summation order cannot pass or fail the test by chance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.decoding import generate as j_generate  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu.models.trie import DenseTrie as JTrie  # noqa: E402
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       params_from_jax)
from navillm_tpu_torch.models import decoding as TD  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.trie import DenseTrie  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
MIN_MARGIN = 1e-3
TOK = NavTokenizer()
ANSWERS = ["red", "blue", "green", "dark brown", "two", "kitchen"]


@pytest.fixture(scope="module")
def models():
    jcfg = JNM.NavModelConfig.tiny(vocab_size=TOK.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=TOK.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return jcfg, pj, tcfg, pt


def _tries():
    seqs = [TOK.encode(w, add_bos=True) for w in ANSWERS]
    return JTrie(seqs, eos_id=TOK.eos_id), DenseTrie(seqs, eos_id=TOK.eos_id)


# ------------------------------------------------------------- trie --- #
def test_dense_trie_tables_advance_and_mask_match_jax():
    jt, tt = _tries()
    np.testing.assert_array_equal(tt.children_tokens.numpy(),
                                  np.asarray(jt.children_tokens))
    np.testing.assert_array_equal(tt.children_next.numpy(),
                                  np.asarray(jt.children_next))
    np.testing.assert_array_equal(tt.is_leaf.numpy(), np.asarray(jt.is_leaf))
    assert tt.fingerprint == jt.fingerprint and tt.width == jt.width
    r = np.random.RandomState(0)
    state_j = jnp.zeros((6,), jnp.int32)
    state_t = torch.zeros(6, dtype=torch.int32)
    for step in range(6):
        mj = np.asarray(jt.logits_mask(state_j, TOK.vocab_size))
        mt = tt.logits_mask(state_t, TOK.vocab_size).numpy()
        np.testing.assert_array_equal(mt, mj)
        # feed an allowed token in most rows, a disallowed one in the last
        tok = np.array([r.choice(np.nonzero(row)[0]) for row in mj],
                       np.int32)
        tok[-1] = r.randint(0, TOK.vocab_size)
        state_j = jt.advance(state_j, jnp.asarray(tok))
        state_t = tt.advance(state_t, torch.from_numpy(tok))
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_j))
    # leaves allow eos alone and absorb
    leaf = int(np.nonzero(np.asarray(jt.is_leaf))[0][0])
    s = torch.tensor([leaf], dtype=torch.int32)
    m = tt.logits_mask(s, TOK.vocab_size)[0]
    assert m.sum() == 1 and m[TOK.eos_id]
    assert tt.advance(s, torch.tensor([TOK.eos_id])).item() == leaf


# ------------------------------------------------------ decode step --- #
def _prompt(b, t, pads, seed):
    r = np.random.RandomState(seed)
    ids = r.randint(3, 250, (b, t)).astype(np.int32)
    mask = np.arange(t)[None, :] >= np.asarray(pads)[:, None]
    ids[~mask] = TOK.pad_id
    return ids, mask


def test_decode_step_matches_jax_and_the_full_forward(models):
    jcfg, pj, tcfg, pt = models
    jl, tl = pj["llm"], pt["llm"]
    b, t, n_new = 3, 20, 4
    ids, mask = _prompt(b, t, [0, 5, 11], 1)
    fed = np.random.RandomState(2).randint(3, 250, (b, n_new)) \
        .astype(np.int32)
    _, kv_j = JL.forward_hidden(jl, jcfg.llm, JL.embed_with_injection(jl, ids),
                                mask, return_kv=True)
    _, kv_t = TL.forward_hidden(tl, tcfg.llm, TL.embed_with_injection(
        tl, torch.from_numpy(ids)), torch.from_numpy(mask), return_kv=True)
    dec_j = JL.init_decode_cache(jcfg.llm, b, n_new)
    dec_t = TL.init_decode_cache(tcfg.llm, b, n_new)
    lens = mask.sum(-1)
    for i in range(n_new):
        pos = (lens + i)[:, None].astype(np.int32)
        hj, dec_j = JL.decode_step(
            jl, jcfg.llm, JL.embed_rows(jl["embed"], fed[:, i])[:, None],
            kv_j, mask, dec_j, i, pos)
        ht, dec_t = TL.decode_step(
            tl, tcfg.llm, TL.embed_rows(tl["embed"], torch.from_numpy(
                fed[:, i]).long())[:, None], kv_t, torch.from_numpy(mask),
            dec_t, i, torch.from_numpy(pos))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(dec_t["k"].numpy(),
                                   np.asarray(dec_j["k"]), **TOL)
        # against one forward over the prompt and the tokens fed so far
        full_ids = np.concatenate([ids, fed[:, : i + 1]], 1)
        full_mask = np.concatenate([mask, np.ones((b, i + 1), bool)], 1)
        hf = TL.forward_hidden(tl, tcfg.llm, TL.embed_with_injection(
            tl, torch.from_numpy(full_ids)), torch.from_numpy(full_mask))
        np.testing.assert_allclose(ht[:, 0].numpy(), hf[:, -1].numpy(),
                                   **TOL)
    # an int8 prompt stack (kv_int8) is read dequantized, as in JAX
    qkv_j, qkv_t = JL.quantize_kv_stack(kv_j), TL.quantize_kv_stack(kv_t)
    emb = fed[:, 0]
    hj, _ = JL.decode_step(jl, jcfg.llm, JL.embed_rows(jl["embed"], emb)[
        :, None], qkv_j, mask, JL.init_decode_cache(jcfg.llm, b, n_new), 0,
        lens[:, None].astype(np.int32))
    ht, _ = TL.decode_step(tl, tcfg.llm, TL.embed_rows(
        tl["embed"], torch.from_numpy(emb).long())[:, None], qkv_t,
        torch.from_numpy(mask), TL.init_decode_cache(tcfg.llm, b, n_new), 0,
        torch.from_numpy(lens[:, None].astype(np.int32)))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


# --------------------------------------------------------- generate --- #
def _jax_margins(jl, jcfg, ids, mask, inj_pos, inj_emb, out, smask, trie,
                 bucket=64):
    """The JAX logits behind every pick of ``out`` up to each row's eos,
    from one teacher-forced forward over the bucketed prompt and the picks
    (special and trie masks applied): their top-2 margins, flattened."""
    b, t = ids.shape
    extra = -(-t // bucket) * bucket - t
    n = out.shape[1]
    full_ids = np.concatenate([np.pad(ids, ((0, 0), (extra, 0)),
                                      constant_values=TOK.pad_id), out], 1)
    full_mask = np.concatenate([np.pad(mask, ((0, 0), (extra, 0))),
                                np.ones((b, n), bool)], 1)
    pos = None if inj_pos is None else np.where(inj_pos >= 0,
                                                inj_pos + extra, -1)
    x = JL.embed_with_injection(jl, full_ids, pos, inj_emb)
    h, _ = JL.forward_hidden(jl, jcfg, x, full_mask)
    logits = np.asarray(JL.logits_from_hidden(jl, jcfg, h, smask))
    state = jnp.zeros((b,), jnp.int32)
    margins = []
    for k in range(n):
        if k:
            state = trie.advance(state, jnp.asarray(out[:, k - 1])) \
                if trie is not None else state
        lk = logits[:, t + extra - 1 + k]
        if trie is not None:
            lk = np.where(np.asarray(trie.logits_mask(
                state, lk.shape[-1])), lk, -np.inf)
        top = np.sort(lk, -1)[:, -2:]
        for i in range(b):
            if TOK.eos_id in out[i, :k]:
                continue                 # the row is done: pads follow
            margins.append(top[i, 1] - top[i, 0])
    return np.asarray(margins)


@pytest.mark.parametrize("special,use_trie", [(False, False), (True, False),
                                              (True, True)])
def test_generate_greedy_tokens_match_jax(models, special, use_trie,
                                         monkeypatch):
    """Ragged left-padded prompts with visual embeds injected: the port's
    greedy tokens equal JAX's, and its early stop once every row is done
    (under the trie, whose answers end within 12 tokens) leaves the pads
    JAX writes."""
    jcfg, pj, tcfg, pt = models
    jl, tl = pj["llm"], pt["llm"]
    b, t, n_new = 3, 45, 24 if use_trie else 12
    steps = []
    decode_step = TL.decode_step
    monkeypatch.setattr(TL, "decode_step",
                        lambda *a: steps.append(a[6]) or decode_step(*a))
    ids, mask = _prompt(b, t, [0, 9, 30], 5)
    r = np.random.RandomState(4)
    inj_pos = np.full((b, 4), -1, np.int32)
    inj_pos[0, :3] = [3, 10, 40]
    inj_pos[1, :2] = [12, 44]
    inj_pos[2, :1] = [31]
    inj_emb = r.randn(b, 4, jcfg.hidden_size).astype(np.float32)
    smask = TOK.special_logit_mask() if special else None
    jt, tt = _tries() if use_trie else (None, None)
    want = np.asarray(j_generate(
        jl, jcfg.llm, ids, mask, inject_positions=inj_pos,
        inject_embeds=inj_emb, special_token_mask=smask, eos_id=TOK.eos_id,
        pad_id=TOK.pad_id, max_new_tokens=n_new, trie=jt))
    got = TD.generate(tl, tcfg.llm, ids, mask, inject_positions=inj_pos,
                      inject_embeds=inj_emb, special_token_mask=None
                      if smask is None else torch.from_numpy(smask),
                      eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                      max_new_tokens=n_new, trie=tt)
    assert got.dtype == torch.int32 and got.shape == (b, n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    margins = _jax_margins(jl, jcfg.llm, ids, mask, inj_pos, inj_emb, want,
                           smask, jt)
    assert margins.size and margins.min() > MIN_MARGIN, margins.min()
    if use_trie:
        words = TD.decode_to_text(TOK, got.numpy())
        assert all(w in ANSWERS for w in words), words
        # every row was done by the check at step 16: the loop stopped there
        assert steps == list(range(2 * TD.STOP_CHECK))
    else:
        assert steps == list(range(n_new - 1))


def test_generate_sampled_draws_from_the_generator(models):
    """do_sample: a Gumbel-max draw from the given generator (the same
    seed repeats; T -> 0 gives the greedy tokens)."""
    _, _, tcfg, pt = models
    ids, mask = _prompt(2, 30, [0, 7], 5)
    kw = dict(eos_id=TOK.eos_id, pad_id=TOK.pad_id, max_new_tokens=6)

    def run(seed, temperature):
        return TD.generate(pt["llm"], tcfg.llm, ids, mask, do_sample=True,
                           temperature=temperature,
                           generator=torch.Generator().manual_seed(seed),
                           **kw)
    greedy = TD.generate(pt["llm"], tcfg.llm, ids, mask, **kw)
    assert torch.equal(run(1, 1.0), run(1, 1.0))
    assert not torch.equal(run(1, 5.0), run(2, 5.0))
    assert torch.equal(run(3, 1e-7), greedy)


# -------------------------------------------------- generation loss --- #
def test_forward_generation_loss_and_grads_match_jax(models):
    """The teacher-forced LM loss through raw panorama embeds (fused by
    prep_generation_embeds) and history embeds, and its gradients with
    respect to every parameter and the panorama embeds."""
    jcfg, pj, tcfg, pt = models
    r = np.random.RandomState(6)
    b, t, v, c, hh = 2, 40, 14, 12, 3
    h = jcfg.hidden_size
    ids, mask = _prompt(b, t, [0, 6], 7)
    labels = ids.astype(np.int64)
    labels[:, :30] = -100
    labels[~mask] = -100
    cand_pos = np.full((b, c), -1, np.int32)
    cand_pos[:, :c] = np.arange(8, 8 + c)
    cand_pos[1, 10:] = -1
    hist_pos = np.full((b, hh), -1, np.int32)
    hist_pos[0, :2] = [25, 26]
    vp_masks = np.zeros((b, v), bool)
    vp_masks[:, :12] = True
    vp_masks[1, 10:] = False
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "cand_positions": cand_pos, "hist_positions": hist_pos,
             "hist_embeds": r.randn(b, hh, h).astype(np.float32),
             "vp_masks": vp_masks,
             "special_token_mask": TOK.special_logit_mask()}
    vp = r.randn(b, v, h).astype(np.float32)

    def j_loss(p, e):
        return JNM.forward_generation_loss(p, jcfg, {**batch,
                                                     "vp_img_embeds": e})
    jout = j_loss(pj, vp)
    (jl, (gp, ge)) = jax.value_and_grad(
        lambda p, e: j_loss(p, e)["loss"], argnums=(0, 1))(pj, vp)

    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                               device="cpu"))
    for p in model.parameters():
        p.requires_grad_(True)
    e = torch.from_numpy(vp).requires_grad_(True)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tout = TNM.forward_generation_loss(model, tcfg, {**tb,
                                                     "vp_img_embeds": e})
    tout["loss"].backward()
    np.testing.assert_allclose(tout["loss"].item(), float(jl), **TOL)
    np.testing.assert_allclose(tout["logits"].detach().numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    want = flatten_tree(jax.tree.map(np.asarray, gp))
    got = grads_to_numpy(model)
    for name in want:
        if name.startswith(("obj_pos", "out_head", "gmap")):
            continue                     # not on this path: no gradient
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    # the embeds feeding the prompt: the fused candidates only
    with torch.no_grad():
        emb = TNM.prep_generation_embeds(model, tcfg, e,
                                         torch.from_numpy(vp_masks))
    np.testing.assert_allclose(emb.numpy(), np.asarray(
        JNM.prep_generation_embeds(pj, jcfg, vp, vp_masks)), **TOL)
    # causal_lm_loss with every label ignored is 0, as in JAX
    zero = TL.causal_lm_loss(tout["logits"], torch.full((b, t), -100))
    assert zero.item() == 0.0
