"""Weight-only int8 / int4 quantization of the Llama backbone (eval only).

Torch twin of navillm_tpu/models/quant.py, with its formats and rounding
rules:

- int8 (bits=8): per output channel, ``{"q": int8 [..., h, o], "s":
  [..., 1, o]}``; ``x @ w ~= (x @ q) * s``.
- int4 (bits=4, the seven layer matmuls only): group-wise, ``{"q4p": uint8
  [..., h, o/2], "s": [..., h/G, o]}`` with G = gcd(h, 128), values
  nibble-packed along the output axis (low nibble = even channel, two's
  complement); ops/matmul_q4.py computes ``y = sum_g (x_g @ q_g) * s_g``.
- The embedding table is int8 per row (``s`` [V, 1]) and ``lm_head`` int8
  per channel at every bits setting; norm weights stay dense.

Scales are stored in the weight's dtype and the int grid is computed
against that stored, rounded scale, so dequantization uses exactly the
scale the quantizer used. ``torch.round`` rounds half to even, like
``jnp.round``. Stacked [L, h, o] weights quantize one layer at a time (as
``lax.map`` does), so the f32 transient is one layer (~180 MB at 7B). The
functions take nested dicts or ParamTrees, on the CPU or on the card, and
return nested dicts that share the leaves they do not quantize.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# int4 group size along the reduction axis; tiny test dims use gcd(h, 128)
GROUP4 = 128


def _group4(h: int) -> int:
    return math.gcd(h, GROUP4)


def _quant_one(w2d: torch.Tensor, dim: int):
    """Symmetric per-channel int8 along ``dim`` (the reduction axis)."""
    w32 = w2d.float()
    amax = w32.abs().amax(dim=dim, keepdim=True)
    s = (amax.clamp(min=1e-8) / 127.0).to(w2d.dtype)
    q = torch.round(w32 / s.float()).clamp(-127, 127).to(torch.int8)
    return q, s


def _per_layer(fn, w: torch.Tensor):
    """fn over the layers of a stacked [L, ...] weight, into preallocated
    outputs, so only one layer's f32 transient lives at a time."""
    outs = None
    for i in range(w.shape[0]):
        parts = fn(w[i])
        if outs is None:
            outs = [torch.empty((w.shape[0], *t.shape), dtype=t.dtype,
                                device=t.device) for t in parts]
        for out, t in zip(outs, parts):
            out[i] = t
    return outs


def _quant_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[h, o] or layer-stacked [L, h, o] -> {"q", "s"} (scale [..., 1, o])."""
    if w.dim() == 3:
        q, s = _per_layer(lambda wl: _quant_one(wl, 0), w)
    else:
        q, s = _quant_one(w, -2)
    return {"q": q, "s": s}


def _quant_embed(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, H] per-row int8 (scale [V, 1]) for table lookups."""
    q, s = _quant_one(w, -1)
    return {"q": q, "s": s}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack values in [-7, 7] pairwise along the last axis (even):
    out[..., c] = (q[..., 2c] & 0xF) | (q[..., 2c+1] & 0xF) << 4."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got "
                         f"{tuple(q.shape)}")
    q8 = q.to(torch.int8)
    lo = (q8[..., 0::2] & 0xF).to(torch.uint8)
    hi = (q8[..., 1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4_host(p) -> np.ndarray:
    """numpy inverse of pack_int4 (tests, offline inspection)."""
    p = np.asarray(p)
    lo = (p & 0xF).astype(np.int8)
    hi = ((p >> 4) & 0xF).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo)
    hi = np.where(hi >= 8, hi - 16, hi)
    return np.stack([lo, hi], axis=-1).reshape(*p.shape[:-1],
                                               p.shape[-1] * 2)


def _quant_one4(w2d: torch.Tensor):
    """Group-wise int4 of [h, o]: scales [h/G, o], values on the +-7 grid
    of the stored scale, nibble-packed along o."""
    h, o = w2d.shape
    g = _group4(h)
    w32 = w2d.float().reshape(h // g, g, o)
    amax = w32.abs().amax(dim=1)                              # [ng, o]
    s = (amax.clamp(min=1e-8) / 7.0).to(w2d.dtype)
    q = torch.round(w32 / s[:, None, :].float()).clamp(-7, 7)
    return pack_int4(q.reshape(h, o)), s


def _quant_weight4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[h, o] or layer-stacked [L, h, o] -> {"q4p", "s"} (group scales
    [..., h/G, o])."""
    q, s = _per_layer(_quant_one4, w) if w.dim() == 3 else _quant_one4(w)
    return {"q4p": q, "s": s}


@torch.no_grad()
def quantize_llama_params(params, bits: int = 8) -> Dict[str, Any]:
    """The LLM tree with its layer matmuls at ``bits`` (8 or 4) and embed
    and lm_head at int8. The input is left as it is."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qw = _quant_weight4 if bits == 4 else _quant_weight
    layers = dict(params["layers"].items())
    for k in _QUANT_KEYS:
        layers[k] = qw(layers[k])
    return {"embed": _quant_embed(params["embed"]), "layers": layers,
            "final_norm": params["final_norm"],
            "lm_head": _quant_weight(params["lm_head"])}


def quantize_nav_params(params, bits: int = 8) -> Dict[str, Any]:
    """Quantize only the LLM subtree of a navigation tree; the panorama
    encoder and heads stay as they are (shared, not copied)."""
    out = dict(params.items())
    out["llm"] = quantize_llama_params(params["llm"], bits)
    return out


def _llm(params):
    return params["llm"] if "llm" in params else params


def is_quantized(params) -> bool:
    return not isinstance(_llm(params)["lm_head"], torch.Tensor)


def weight_bits(params) -> int:
    """16 (dense), 8 or 4, from the layer matmuls' storage."""
    tree = _llm(params)
    if not is_quantized(tree):
        return 16
    return 4 if "q4p" in tree["layers"]["wq"] else 8
