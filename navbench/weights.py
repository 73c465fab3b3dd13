"""The navigation model's weights, drawn from the seed by the benchmark.

The tree has the layout the port's ``NavModel`` takes (its JAX names and
shapes): ``llm`` (embed, stacked layers, final_norm, lm_head), ``pano``
(the panorama encoder), and the fusion tables and the navigation head.
Every matrix is drawn in one ``torch.randn`` call on the device, in the
dtype the model is served in, and carved into views, each scaled to its
init (0.02 for embeddings, 1/sqrt(fan-in) for projections); norms are
ones and biases zeros. The same seed gives the same tree, so the plain
reference draws it again after the program's run has been freed.

The navigation head's stop column is zero and its bias ``stop_bias``
(the configuration's ``assumed`` list says so): the stop logit is then a
constant against candidates' logits of the same scale on every seed, so
every seed gives episodes of one length distribution.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NUM_CAND_SLOTS = 100      # the navigation head's width (out_head)
MAX_ACTION_STEPS = 100    # the graph-map step embedding table


def _spec(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(dotted name, shape, kind, scale): kind "randn" (scaled normal),
    "ones" or "zeros"."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    n_l, nh, nkv = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"])
    d = h // nh
    pano = cfg["panorama"]
    ph, pi, pn = (pano["hidden_size"], pano["intermediate_size"],
                  pano["num_pano_layers"])
    feat, loc = pano["image_feat_size"], pano["angle_feat_size"] + 3
    a = pano["angle_feat_size"]
    s = []

    def randn(name, shape, scale=None):
        s.append((name, shape, "randn",
                  scale if scale is not None else shape[-2] ** -0.5))

    def const(name, shape, kind):
        s.append((name, shape, kind, 0.0))

    def linear(name, d_in, d_out):
        randn(f"{name}.w", (d_in, d_out))
        const(f"{name}.b", (d_out,), "zeros")

    def ln(name, width):
        const(f"{name}.s", (width,), "ones")
        const(f"{name}.b", (width,), "zeros")

    randn("llm.embed", (v, h), 0.02)
    for name, shape in (("wq", (n_l, h, nh * d)), ("wk", (n_l, h, nkv * d)),
                        ("wv", (n_l, h, nkv * d)), ("wo", (n_l, nh * d, h)),
                        ("w_gate", (n_l, h, i)), ("w_up", (n_l, h, i)),
                        ("w_down", (n_l, i, h))):
        randn(f"llm.layers.{name}", shape)
    const("llm.layers.attn_norm", (n_l, h), "ones")
    const("llm.layers.mlp_norm", (n_l, h), "ones")
    const("llm.final_norm", (h,), "ones")
    randn("llm.lm_head", (h, v))

    linear("pano.img_linear", feat, ph)
    ln("pano.img_ln", ph)
    linear("pano.loc_linear", loc, ph)
    ln("pano.loc_ln", ph)
    randn("pano.nav_type_emb", (3, ph), 0.02)
    ln("pano.ln", ph)
    linear("pano.mapper", ph, h)
    if pn > 0:
        for name, (d_in, d_out) in (("qkv", (ph, 3 * ph)), ("out", (ph, ph)),
                                    ("ffn1", (ph, pi)), ("ffn2", (pi, ph))):
            randn(f"pano.encoder.{name}.w", (pn, d_in, d_out))
            const(f"pano.encoder.{name}.b", (pn, d_out), "zeros")
        for name in ("ln1", "ln2"):
            const(f"pano.encoder.{name}.s", (pn, ph), "ones")
            const(f"pano.encoder.{name}.b", (pn, ph), "zeros")
        ln("pano.encoder_norm", ph)
    if pano["use_obj"]:
        linear("pano.obj_projector", pano["obj_feat_size"], h)
        ln("pano.obj_projector_ln", h)

    randn("token_type_emb", (3, h), 0.02)
    for name, d_in in (("gmap_pos", a + 3), ("vp_pos", 2 * a + 6),
                       ("obj_pos", a + 3)):
        linear(name, d_in, h)
        const(f"{name}.ln_s", (h,), "ones")
        const(f"{name}.ln_b", (h,), "zeros")
    randn("gmap_step_emb", (MAX_ACTION_STEPS, h), 0.02)
    randn("out_head.w", (h, NUM_CAND_SLOTS))
    const("out_head.b", (NUM_CAND_SLOTS,), "zeros")
    return s


def param_count(cfg: Dict) -> Dict[str, int]:
    """Parameters by part: llm_embed (embed and lm_head), llm_layers (the
    stacked layer weights and norms, final_norm), pano, heads."""
    out = {"llm_embed": 0, "llm_layers": 0, "pano": 0, "heads": 0}
    for name, shape, _, _ in _spec(cfg):
        n = 1
        for x in shape:
            n *= x
        if name in ("llm.embed", "llm.lm_head"):
            out["llm_embed"] += n
        elif name.startswith("llm."):
            out["llm_layers"] += n
        elif name.startswith("pano."):
            out["pano"] += n
        else:
            out["heads"] += n
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def draw(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The nested weight tree for ``cfg``, drawn from ``seed`` on
    ``device``: one randn call for every matrix, then views scaled in
    place."""
    spec = _spec(cfg)
    total = sum(_numel(shape) for _, shape, kind, _ in spec
                if kind == "randn")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat_buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat: Dict[str, torch.Tensor] = {}
    pos = 0
    for name, shape, kind, scale in spec:
        n = _numel(shape)
        if kind == "randn":
            flat[name] = flat_buf[pos: pos + n].view(shape).mul_(scale)
            pos += n
        elif kind == "ones":
            flat[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            flat[name] = torch.zeros(shape, device=device, dtype=dtype)
    head = cfg["navigation_head"]
    flat["out_head.w"][:, 0] = 0
    flat["out_head.b"][0] = float(head["stop_bias"])
    return _nest(flat)


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n
