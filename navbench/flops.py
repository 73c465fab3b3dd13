"""Operations and bytes of the navigation model's work, and the bounds.

``bound``, ``attn_pairs``, ``fwd_bound``, ``bwd_bounds`` and ``q4_bound``
are frozen copies of ``chip_smoke.py``'s (commit 20b2d57), with its peaks
of one H100 SXM (bf16 dense tensor cores, HBM3). The rest counts the work
of one evaluation step from the unpadded masks the benchmark sees at the
runner's boundary: 2 FLOP per weight of every matrix product per token
(the LLM's layers, the panorama encoder, the fusion MLPs and the head; the
embedding lookups are no products), plus attention over the keys each row
really has. Padding and recomputation are not counted, so the count is
the same whatever kernels or padding a version of the program uses.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nbytes`` and do ``flops`` at ``peak_flops``."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attn_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs a full key mask leaves, per (batch, head)."""
    return t * (t + 1) // 2 if causal else t * s


def fwd_bound(b, t, s, nh, nkv, d, causal):
    """K1: 2 products of 2 D FLOP per pair; Q, K, V and the mask read once,
    O and lse written once."""
    nbytes = 2 * d * (2 * b * t * nh + 2 * b * s * nkv) + 4 * b * nh * t + b * s
    return bound(4 * d * b * nh * attn_pairs(t, s, causal), nbytes)


def bwd_bounds(b, t, nh, d):
    """(K2, K3), causal with T == S and NKV == NH. K2 does 4 products per
    pair, reads Q, K, V, dO, lse, delta and the mask and writes dK and dV;
    K3 does 3 products per pair and the 2 D FLOP per row of delta, reads
    Q, K, V, dO, O, lse and the mask and writes dQ and delta."""
    pairs = b * nh * attn_pairs(t, t, True)
    tensor = 2 * b * t * nh * d           # one [B, T, NH, D] bf16 tensor
    rows = 4 * b * nh * t                 # one [B, NH, T] f32 tensor
    return (bound(8 * d * pairs, 6 * tensor + 2 * rows + b * t),
            bound(6 * d * pairs + 2 * d * b * nh * t,
                  6 * tensor + 2 * rows + b * t))


def q4_bound(m, h, o, g, mode: str):
    """K4: 2 m h o operations (int8 tensor cores at twice the bf16 rate for
    w4a8, bf16 tensor cores otherwise: the least an f32-x product needs);
    x, the nibbles and the bf16 scales read once, y written once (bf16 for
    w4, f32 for w4a8 and f32 x)."""
    xb, yb = {"w4": (2, 2), "w4a8": (1, 4), "f32": (4, 4)}[mode]
    nbytes = m * h * xb + h * o // 2 + (h // g) * o * 2 + m * o * yb
    return bound(2 * m * h * o, nbytes,
                 2 * PEAK_FLOPS if mode == "w4a8" else PEAK_FLOPS)


# ----------------------------------------------------------- model work


def shapes(cfg: Dict) -> Dict[str, int]:
    """The widths the counts use, from a configuration file."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    pano = cfg["panorama"]
    return {"h": h, "i": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "nh": nh,
            "nkv": cfg["num_key_value_heads"], "d": h // nh,
            "ph": pano["hidden_size"], "pi": pano["intermediate_size"],
            "pnh": pano["num_attention_heads"],
            "pl": pano["num_pano_layers"], "feat": pano["image_feat_size"],
            "a": pano["angle_feat_size"]}


def llm_matmul_weights(cfg: Dict) -> int:
    """Weights of the LLM's layer products (q, k, v, o, gate, up, down),
    all layers: the non-embedding parameters that multiply each token."""
    s = shapes(cfg)
    h, i, d = s["h"], s["i"], s["d"]
    per = h * s["nh"] * d + 2 * h * s["nkv"] * d + s["nh"] * d * h + 3 * h * i
    return s["layers"] * per


def llm_tokens_flops(cfg: Dict, tokens: int) -> float:
    """The LLM's products over ``tokens`` tokens (attention excluded)."""
    return 2.0 * llm_matmul_weights(cfg) * tokens


def llm_attn_flops(cfg: Dict, queries: int, keys_before: int) -> float:
    """Attention of a causal run of ``queries`` tokens that also see
    ``keys_before`` earlier keys (a cached prefix), all layers: QK^T and
    PV, 2 D FLOP each per (query, key) pair and query head."""
    s = shapes(cfg)
    pairs = queries * keys_before + queries * (queries + 1) // 2
    return 4.0 * s["d"] * s["nh"] * pairs * s["layers"]


def pano_flops(cfg: Dict, views: int) -> float:
    """The panorama encoder over one row's ``views`` valid views: the
    image and location projections, the encoder layers (their products and
    attention among the views) and the mapper to the LLM's width."""
    s = shapes(cfg)
    ph, pi, h = s["ph"], s["pi"], s["h"]
    weights = (s["feat"] * ph + (s["a"] + 3) * ph + ph * h
               + s["pl"] * (4 * ph * ph + 2 * ph * pi))
    attn = 4.0 * ph * views * views * s["pl"]
    return 2.0 * weights * views + attn


def fusion_flops(cfg: Dict, gmap_nodes: int, views: int) -> float:
    """The fusion's position MLPs (graph nodes: 7 features; the stop row
    and the views: 14) and the navigation head (one row, 100 slots)."""
    s = shapes(cfg)
    a, h = s["a"], s["h"]
    return 2.0 * h * ((a + 3) * gmap_nodes + (2 * a + 6) * (views + 1)
                      + 100)


def attn_bound_s(cfg: Dict, tokens: int) -> float:
    """fwd_bound's seconds for one unpadded causal row of ``tokens``
    tokens, over every layer (the flash kernel's share of a step)."""
    s = shapes(cfg)
    ms, _ = fwd_bound(1, tokens, tokens, s["nh"], s["nkv"], s["d"], True)
    return 1e-3 * ms * s["layers"]


def step_work(cfg: Dict, rows) -> Tuple[float, float]:
    """(FLOP, attention bound seconds) of one evaluation call over its
    active rows: ``rows`` holds (LLM tokens, keys before them, views,
    graph nodes, through_k1), through_k1 True where the row's attention
    is one causal flash call (an uncached step or a prefill)."""
    flops = bound_s = 0.0
    for tokens, before, views, nodes, k1 in rows:
        flops += (llm_tokens_flops(cfg, tokens)
                  + llm_attn_flops(cfg, tokens, before))
        if views:
            flops += pano_flops(cfg, views) + fusion_flops(cfg, nodes, views)
        if k1:
            bound_s += attn_bound_s(cfg, tokens)
    return flops, bound_s
