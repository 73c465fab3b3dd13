"""Llama (Vicuna backbone), dense weights, as torch functions + a module.

Torch twin of navillm_tpu/models/llama.py for the serving path: the
stacked per-layer weights [L, ...] keep the JAX names (``weight_spec``),
the layer scan becomes a loop, and every layer's attention goes through
ops/attention.py:multi_head_attention (the CUDA flash kernel on the card).
Cast order follows the JAX code so bf16 runs round in the same places.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .params import ParamTree

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"   # auto | kernel | eager (ops/attention.py)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def vicuna_7b(cls, vocab_size: int = 32000, **kw) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, **kw)

    @classmethod
    def tiny(cls, vocab_size: int = 512, **kw) -> "LlamaConfig":
        kw.setdefault("hidden_size", 128)
        kw.setdefault("intermediate_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 4)
        kw.setdefault("max_seq_len", 512)
        kw.setdefault("dtype", torch.float32)
        return cls(vocab_size=vocab_size, **kw)


def weight_spec(cfg: LlamaConfig) -> Dict[str, Any]:
    """Shapes + init scales of every dense weight (None = fan-in)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, d, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.num_layers)
    return {
        "embed": ((v, h), 0.02),
        "layers": {
            "wq": ((L, h, nh * d), None),
            "wk": ((L, h, nkv * d), None),
            "wv": ((L, h, nkv * d), None),
            "wo": ((L, nh * d, h), None),
            "w_gate": ((L, h, i), None),
            "w_up": ((L, h, i), None),
            "w_down": ((L, i, h), None),
        },
        "lm_head": ((h, v), None),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """positions: [B, T] -> (cos, sin) [B, T, D/2] f32."""
    d2 = cfg.head_dim // 2
    exps = torch.arange(0, d2, dtype=torch.float32,
                        device=positions.device) / d2
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, T, N, D]; cos/sin: [B, T, D/2]. HF half-rotation convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _qkv(cfg: LlamaConfig, x, lp, cos, sin):
    b, t, _ = x.shape
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = (attn_in @ lp["wq"]).reshape(b, t, nh, d)
    k = (attn_in @ lp["wk"]).reshape(b, t, nkv, d)
    v = (attn_in @ lp["wv"]).reshape(b, t, nkv, d)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _post_attn(cfg: LlamaConfig, x, lp, attn):
    b, t, _ = x.shape
    x = x + attn.reshape(b, t, cfg.num_heads * cfg.head_dim) @ lp["wo"]
    mlp_in = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    gate = F.silu(mlp_in @ lp["w_gate"])
    return x + (gate * (mlp_in @ lp["w_up"])) @ lp["w_down"]


def _layer(cfg: LlamaConfig, x, lp, cos, sin, kv_mask, attn_impl):
    """One transformer block (causal self-attention over x)."""
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    return _post_attn(cfg, x, lp, attn)


def forward_hidden(params, cfg: LlamaConfig, inputs_embeds, attention_mask,
                   positions: Optional[torch.Tensor] = None):
    """Run the transformer stack; returns hidden [B, T, H].

    attention_mask: [B, T] validity over keys; positions default to
    cumsum(mask)-1 clipped at 0 (correct under left padding)."""
    if positions is None:
        positions = torch.cumsum(attention_mask.int(), -1) - 1
        positions = positions.clamp(min=0)
    cos, sin = rope_tables(cfg, positions)
    x = inputs_embeds.to(cfg.dtype)
    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        lp = {k: layers[k][i] for k in LAYER_KEYS}
        x = _layer(cfg, x, lp, cos, sin, attention_mask, cfg.attn_impl)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def embed_with_injection(params, input_ids, special_positions=None,
                         special_embeds=None):
    """inputs_embeds = embed[ids], plus special_embeds [B, K, H] added at
    token positions special_positions [B, K] (-1 = unused slot)."""
    x = params["embed"][input_ids.long()]
    if special_positions is not None:
        b, k = special_positions.shape
        valid = special_positions >= 0
        pos = special_positions.clamp(min=0).long()
        upd = torch.where(valid[..., None], special_embeds.to(x.dtype),
                          torch.zeros((), dtype=x.dtype, device=x.device))
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, k)
        x = x.index_put((bidx, pos), upd, accumulate=True)
    return x


class Llama(ParamTree):
    """The LLM's weights: ``embed``, ``layers`` (stacked [L, ...] under the
    names of ``weight_spec`` plus ``attn_norm``/``mlp_norm``),
    ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any]):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, inputs_embeds, attention_mask, positions=None):
        return forward_hidden(self, self.cfg, inputs_embeds, attention_mask,
                              positions)
