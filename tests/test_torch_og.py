"""The port's object grounding against the JAX package: the panorama
encoder's object branch (use_obj, fuse_obj), forward_object_grounding and
its gradients, and the runner's OG calls (pano_og_train through the
panorama's object branch, object_grounding).

Weights: params_from_jax of the JAX init_nav_params tree (the object
leaves come across as every other leaf); f32; activations and losses at
rtol 1e-4, atol 1e-5, gradients under testing.assert_grads_close at rtol
2e-3 (tests/test_torch_train.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import \
    forward_panorama as j_panorama  # noqa: E402
from navillm_tpu.models.pano_encoder import init_pano_params as j_init  # noqa
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import (flatten_tree, grads_to_numpy,  # noqa
                                       init_pano_params, params_from_jax)
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models.pano_encoder import \
    forward_panorama as t_panorama  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa
from navillm_tpu_torch.ops.masking import NEG_INF  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
OBJ_COEF = 0.7


def _configs(fuse_obj=False):
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    jcfg = JNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=True)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=True)
    jcfg = dataclasses.replace(jcfg, pano=dataclasses.replace(
        jcfg.pano, fuse_obj=fuse_obj, hidden_dropout_prob=0.0))
    tcfg = dataclasses.replace(tcfg, pano=dataclasses.replace(
        tcfg.pano, fuse_obj=fuse_obj, hidden_dropout_prob=0.0))
    return tok, jcfg, tcfg


@pytest.fixture(scope="module", params=[False, True],
                ids=["use_obj", "fuse_obj"])
def models(request):
    tok, jcfg, tcfg = _configs(request.param)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return tok, jcfg, pj, tcfg, pt


def _pano_inputs(cfg, b=3, v=9, o=5, seed=0):
    """Views and objects; the last row has no objects."""
    r = np.random.RandomState(seed)
    return {"view_img_fts": r.randn(b, v, cfg.pano.image_feat_size)
            .astype(np.float32),
            "view_lens": np.array([v, 4, 2][:b], np.int32),
            "loc_fts": r.randn(b, v, cfg.pano.loc_size).astype(np.float32),
            "nav_types": r.randint(0, 2, (b, v)).astype(np.int32),
            "obj_img_fts": r.randn(b, o, cfg.pano.obj_feat_size)
            .astype(np.float32),
            "obj_lens": np.array([o, 2, 0][:b], np.int32),
            "obj_loc_fts": r.randn(b, o, cfg.pano.loc_size)
            .astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_init_and_conversion_carry_the_object_leaves():
    """init_pano_params draws the JAX tree's object leaves (obj_projector
    and its LN with use_obj, obj_linear and its LN with fuse_obj) at JAX's
    shapes, and params_from_jax brings the JAX ones across unchanged."""
    for fuse in (False, True):
        _, jcfg, tcfg = _configs(fuse)
        pj = j_init(jax.random.PRNGKey(1), jcfg.pano)
        mine = init_pano_params(tcfg.pano, torch.Generator().manual_seed(0),
                                device="cpu")
        want = {k: np.asarray(v).shape for k, v in flatten_tree(pj).items()}
        assert {k: tuple(v.shape) for k, v in flatten_tree(mine).items()} \
            == want
        assert ("obj_linear.w" in want) == fuse and "obj_projector.w" in want
        conv = flatten_tree(params_from_jax(jax.tree.map(np.asarray, pj),
                                            device="cpu"))
        for k, v in flatten_tree(pj).items():
            np.testing.assert_array_equal(conv[k].numpy(), np.asarray(v))


def test_pano_object_branch_matches_jax(models):
    """pano_embeds (which read the objects under fuse_obj), obj_embeds,
    obj_masks and obj_loc_fts as JAX's, and the gradient of a loss over
    both embeddings to every panorama leaf."""
    _, jcfg, pj, tcfg, pt = models
    x = _pano_inputs(jcfg)
    view, lens = x["view_img_fts"], x["view_lens"]
    kw = {k: x[k] for k in ("loc_fts", "nav_types", "obj_img_fts",
                            "obj_lens", "obj_loc_fts")}
    r = np.random.RandomState(1)
    wp = r.randn(3, 9, jcfg.hidden_size).astype(np.float32)
    wo = r.randn(3, 5, jcfg.hidden_size).astype(np.float32)

    def jloss(p):
        out = j_panorama(p, jcfg.pano, view, lens, **kw)
        return (jnp.sum(out["pano_embeds"] * wp)
                + jnp.sum(out["obj_embeds"] * wo)), out
    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(pj["pano"])

    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten_tree(pt["pano"]).items()}
    tree = {}
    for k, v in leaves.items():
        node = tree
        *path, last = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    tx = _t(x)
    got = t_panorama(tree, tcfg.pano, tx["view_img_fts"], tx["view_lens"],
                     **{k: tx[k] for k in kw})
    loss = (got["pano_embeds"] * torch.from_numpy(wp)).sum() \
        + (got["obj_embeds"] * torch.from_numpy(wo)).sum()
    loss.backward()
    for k in ("pano_embeds", "obj_embeds", "obj_loc_fts"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **TOL, err_msg=k)
    for k in ("pano_masks", "obj_masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    jgrads = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(jgrads) == sorted(leaves)
    T.assert_grads_close({k: v.grad.numpy() for k, v in leaves.items()},
                         jgrads, GRAD_RTOL, GRAD_ATOL)
    assert np.abs(leaves["obj_projector.w"].grad.numpy()).sum() > 0
    if jcfg.pano.fuse_obj:
        assert np.abs(leaves["obj_linear.w"].grad.numpy()).sum() > 0
    # without objects the branch is silent, and with fuse_obj the objects
    # move the views
    plain = t_panorama(pt["pano"], tcfg.pano, tx["view_img_fts"],
                       tx["view_lens"], loc_fts=tx["loc_fts"],
                       nav_types=tx["nav_types"])
    assert "obj_embeds" not in plain
    moved = not np.allclose(plain["pano_embeds"].numpy(),
                            got["pano_embeds"].detach().numpy())
    assert moved == jcfg.pano.fuse_obj


def _og_batch(tok, cfg, b=3, o=5, hh=3, seed=0):
    """An object-grounding batch: BPE prompts with one <cand> per valid
    object, the history at <hist>; the last row has no objects."""
    from navillm_tpu_torch.agents import prompts as P
    r = np.random.RandomState(seed)
    obj_lens = np.array([o, 2, 0][:b])
    hist = [2, 0, 3][:b]
    prompts = [P.object_grounding_prompt(
        "reverie", f"find the lamp number {i}", hist[i], int(obj_lens[i]) + 1,
        "<cls_1>") for i in range(b)]
    tb = tok(prompts)
    ids = tb.input_ids
    cand = np.full((b, o), -1, np.int32)
    hpos = np.full((b, hh), -1, np.int32)
    cls = np.zeros(b, np.int32)
    for i in range(b):
        c = np.nonzero(ids[i] == tok.cand_id)[0]
        cand[i, :len(c)] = c
        hp = np.nonzero(ids[i] == tok.hist_id)[0]
        hpos[i, :len(hp)] = hp
        cls[i] = np.nonzero(ids[i] == tok.cls_ids[0])[0][-1]
    return {"obj_embeds": r.randn(b, o, cfg.hidden_size).astype(np.float32),
            "obj_loc_fts": r.randn(b, o, cfg.pano.loc_size)
            .astype(np.float32),
            "obj_masks": np.arange(o)[None, :] < obj_lens[:, None],
            "input_ids": ids, "attention_mask": tb.attention_mask,
            "cand_positions": cand, "hist_positions": hpos,
            "hist_embeds": r.randn(b, hh, cfg.hidden_size)
            .astype(np.float32), "cls_pos": cls}


def test_forward_object_grounding_matches_jax(models):
    """obj_logits on the valid options within TOL, every other option
    exactly NEG_INF (the object-less row keeps option 0 alone), and the
    gradients of the OG loss to every leaf and to obj_embeds."""
    tok, jcfg, pj, tcfg, pt = models
    batch = _og_batch(tok, jcfg)
    targets = np.array([3, 1, 0], np.int32)

    def jloss(p, oe):
        out = JNM.forward_object_grounding(p, jcfg, {**batch,
                                                     "obj_embeds": oe})
        return JNM.navigation_loss(out["obj_logits"], targets) * OBJ_COEF, \
            out["obj_logits"]
    (jl, want), (jg, jgo) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(pj, batch["obj_embeds"])

    model = TNM.NavModel(tcfg, pt)
    for p in model.parameters():
        p.requires_grad_(True)
    tb = _t(batch)
    tb["obj_embeds"].requires_grad_(True)
    out = TNM.forward_object_grounding(model, tcfg, tb)["obj_logits"]
    loss = TNM.navigation_loss(out, torch.from_numpy(targets)) * OBJ_COEF
    loss.backward()
    want = np.asarray(want)
    valid = np.arange(TNM.NUM_CAND_SLOTS)[None, :] \
        <= batch["obj_masks"].sum(1)[:, None]
    assert valid.sum(1).tolist() == [6, 3, 1]
    np.testing.assert_allclose(out.detach().numpy()[valid], want[valid],
                               **TOL)
    assert (out.detach().numpy()[~valid] == NEG_INF).all()
    assert (want[~valid] == NEG_INF).all()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    T.assert_grads_close(tb["obj_embeds"].grad.numpy(), np.asarray(jgo),
                         GRAD_RTOL, GRAD_ATOL, err_msg="obj_embeds")
    grads = grads_to_numpy(model)
    T.assert_grads_close(grads, flatten_tree(jax.tree.map(np.asarray, jg)),
                         GRAD_RTOL, GRAD_ATOL)
    assert np.abs(grads["obj_pos.w"]).sum() > 0


def _runners(tok, jcfg, pj, tcfg, pt):
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jr = JRunner(jcfg, jax.tree.map(jnp.copy, pj), tok, dims=JDims.tiny(),
                 feat_dropout=0.0)
    tr = NavModelRunner(tcfg, TNM.NavModel(tcfg, {k: v for k, v in
                                                  pt.items()}),
                        ttok, dims=RolloutDims.tiny(), feat_dropout=0.0)
    return jr, tr


def test_pano_og_train_matches_jax(models):
    """One OG grad call through the panorama's object branch: the logits,
    the loss and every accumulated gradient leaf, the panorama encoder's
    included, as JAX's pano_og_train (grad to the params and obj_embeds,
    then the object VJP); twice into the same accumulator."""
    tok, jcfg, pj, tcfg, pt = models
    jr, tr = _runners(tok, jcfg, pj, tcfg, pt)
    x = _pano_inputs(jcfg)
    batch = _og_batch(tok, jcfg)
    del batch["obj_embeds"]
    batch["obj_loc_fts"] = x["obj_loc_fts"]
    targets = np.array([2, -100, 0], np.int64)
    jr.zero_grads()
    tr.zero_grads()
    for _ in range(2):
        jl_logits, jl = jr.pano_og_train(x, jax.random.PRNGKey(3), batch,
                                         targets, OBJ_COEF)
        logits, loss = tr.pano_og_train(x, tr.next_seed(), batch, targets,
                                        OBJ_COEF)
        assert torch.is_tensor(loss) and loss.dim() == 0
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
        valid = np.asarray(jl_logits) > NEG_INF / 2
        np.testing.assert_allclose(logits[valid],
                                   np.asarray(jl_logits)[valid], **TOL)
    assert tr.og_grad_calls == tr.grad_calls == 2
    _, loss_only = tr.pano_og_train(x, 0, batch, targets, OBJ_COEF,
                                    need_logits=False)
    assert _ is None and torch.is_tensor(loss_only)
    grads = {k: v.detach().numpy().copy() for k, v in tr.take_grads().items()}
    jgrads = flatten_tree(jax.tree.map(np.asarray, jr.take_grads()))
    assert sorted(grads) == sorted(jgrads)
    # the third call (need_logits=False) accumulated once more: 3/2 of JAX's
    T.assert_grads_close(grads, {k: 1.5 * g for k, g in jgrads.items()},
                         GRAD_RTOL, GRAD_ATOL)
    assert np.abs(grads["pano.obj_projector.w"]).sum() > 0
    assert np.abs(grads["llm.layers.wq"]).sum() > 0


def test_object_grounding_calls_match_jax(models):
    """runner.object_grounding: inference logits, and train=True (the
    gradient stops at obj_embeds) with its loss and gradient leaves."""
    tok, jcfg, pj, tcfg, pt = models
    jr, tr = _runners(tok, jcfg, pj, tcfg, pt)
    batch = _og_batch(tok, jcfg, seed=4)
    want, _ = jr.object_grounding(batch)
    got, zero = tr.object_grounding(batch)
    assert zero == 0.0 and tr.og_calls == 1 and tr.grad_calls == 0
    valid = want > NEG_INF / 2
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    assert (got[~valid] == NEG_INF).all()
    targets = np.array([1, 2, 0], np.int64)
    jr.zero_grads()
    tr.zero_grads()
    _, jl = jr.object_grounding(batch, targets=targets, coef=OBJ_COEF,
                                train=True)
    _, loss = tr.object_grounding(batch, targets=targets, coef=OBJ_COEF,
                                  train=True)
    np.testing.assert_allclose(loss, jl, **TOL)
    grads = {k: v.detach().numpy() for k, v in tr.take_grads().items()}
    T.assert_grads_close(grads, flatten_tree(jax.tree.map(
        np.asarray, jr.take_grads())), GRAD_RTOL, GRAD_ATOL)
    assert np.abs(grads["pano.obj_projector.w"]).sum() == 0
