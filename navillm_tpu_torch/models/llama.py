"""Llama (Vicuna backbone), dense weights, as torch functions + a module.

Torch twin of navillm_tpu/models/llama.py for serving and training: the
stacked per-layer weights [L, ...] keep the JAX names (``weight_spec``),
the layer scan becomes a loop, and every layer's attention goes through
ops/attention.py:multi_head_attention (the CUDA flash kernels on the card).
Cast order follows the JAX code so bf16 runs round in the same places.
With ``remat`` (the JAX default) and grad enabled, each layer runs under
activation checkpointing, as ``jax.checkpoint`` wraps the scanned layer.
The layer matmuls go through ``_mm``, which also takes the quantized
leaves of models/quant.py: int8 weight-only, and int4 (w4, or w4a8 with
``act_int8``) through ops/matmul_q4.py (the CUDA int4 kernel on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.matmul_q4 import matmul_q4, matmul_q4_reference
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
    remat: bool = True        # recompute each layer in the backward
    attn_impl: str = "auto"   # auto | kernel | eager (ops/attention.py)
    # int4 trees only: auto (matmul_q4: the kernel on CUDA tensors) or
    # plain (matmul_q4_reference everywhere)
    q4_impl: str = "auto"
    # quantize activations per token to int8 (int4 trees: the w4a8 mode)
    act_int8: bool = False

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
        kw.setdefault("remat", False)
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


def _act_q(x: torch.Tensor):
    """Per-token int8 activations: (xq int8, sx f32 [..., 1]), x ~= xq*sx."""
    xf = x.float()
    sx = xf.abs().amax(-1, keepdim=True).clamp(min=1e-6) * (1.0 / 127.0)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def _mm(x: torch.Tensor, w, a8: bool = False, q4_impl: str = "auto"):
    """x @ w for a dense weight, an int8 weight-only one (``{"q", "s"}``,
    per output channel: ``(x @ q) * s``) or an int4 one (``{"q4p", "s"}``,
    _mm4). a8 (cfg.act_int8) quantizes x per token; dense weights ignore
    it, as in the JAX code."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if "q4p" in w:
        return _mm4(x, w, a8, q4_impl)
    if a8:
        raise NotImplementedError("W8A8 on int8 weights is not ported yet")
    return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)


def _mm4(x: torch.Tensor, w, a8: bool, q4_impl: str):
    """Group-scaled int4 matmul through matmul_q4 (q4_impl "auto") or its
    plain version ("plain"). w4a8: int8 activations, f32 out, then the
    row scale, as the JAX kernel path does."""
    if q4_impl not in ("auto", "plain"):
        raise ValueError(f"unknown q4_impl {q4_impl!r}")
    fn = matmul_q4 if q4_impl == "auto" else matmul_q4_reference
    if a8:
        xq, sx = _act_q(x)
        return (fn(xq, w["q4p"], w["s"]) * sx).to(x.dtype)
    return fn(x, w["q4p"], w["s"], out_dtype=x.dtype)


def _qkv(cfg: LlamaConfig, x, lp, cos, sin):
    b, t, _ = x.shape
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    a8, impl = cfg.act_int8, cfg.q4_impl
    q = _mm(attn_in, lp["wq"], a8, impl).reshape(b, t, nh, d)
    k = _mm(attn_in, lp["wk"], a8, impl).reshape(b, t, nkv, d)
    v = _mm(attn_in, lp["wv"], a8, impl).reshape(b, t, nkv, d)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _post_attn(cfg: LlamaConfig, x, lp, attn):
    b, t, _ = x.shape
    a8, impl = cfg.act_int8, cfg.q4_impl
    x = x + _mm(attn.reshape(b, t, cfg.num_heads * cfg.head_dim), lp["wo"],
                a8, impl)
    mlp_in = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    gate = F.silu(_mm(mlp_in, lp["w_gate"], a8, impl))
    return x + _mm(gate * _mm(mlp_in, lp["w_up"], a8, impl), lp["w_down"],
                   a8, impl)


def _layer(cfg: LlamaConfig, x, lp, cos, sin, kv_mask, attn_impl,
           kv_out=None):
    """One transformer block (causal self-attention over x). kv_out: an
    optional (k, v) pair of [B, T, NKV, D] buffers that receive the
    post-rope K/V."""
    q, k, v = _qkv(cfg, x, lp, cos, sin)
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    return _post_attn(cfg, x, lp, attn)


class _StackSlice(torch.autograd.Function):
    """stack[i] of a trained [L, ...] weight stack. Its backward adds the
    slice's gradient into stack.grad[i] in place: the stock select backward
    would build a zero-filled gradient of the whole stack for each of the L
    layers (1 GB each for wq at 7B)."""

    @staticmethod
    def forward(ctx, stack, i: int):
        ctx.stack, ctx.i = stack, i
        return stack[i]

    @staticmethod
    def backward(ctx, grad):
        stack = ctx.stack
        if stack.grad is None:
            stack.grad = torch.zeros_like(stack)
        stack.grad[ctx.i] += grad
        return None, None


def _layer_weights(layers, i: int):
    """Layer i's weights. A quantized leaf ({"q4p" or "q", "s"} stacks) is
    sliced leaf by leaf; it never trains, so never goes through
    _StackSlice."""
    train = torch.is_grad_enabled()
    out = {}
    for k in LAYER_KEYS:
        w = layers[k]
        if not isinstance(w, torch.Tensor):
            out[k] = {n: leaf[i] for n, leaf in w.items()}
        elif train and w.requires_grad:
            out[k] = _StackSlice.apply(w, i)
        else:
            out[k] = w[i]
    return out


def forward_hidden(params, cfg: LlamaConfig, inputs_embeds, attention_mask,
                   positions: Optional[torch.Tensor] = None,
                   return_kv: bool = False):
    """Run the transformer stack; returns hidden [B, T, H], or with
    return_kv (hidden, {"k", "v"}): the per-layer post-rope K/V stacked
    [L, B, T, NKV, D] in cfg.dtype (the prompt prefill of the prefix cache;
    inference only, so remat is off, as in the JAX code).

    attention_mask: [B, T] validity over keys; positions default to
    cumsum(mask)-1 clipped at 0 (correct under left padding, and under
    right padding for the valid tokens). Attention is cfg.attn_impl (the
    flash kernel on the card) either way. Under grad with cfg.remat, a
    layer keeps only its input and is recomputed in the backward (the
    layer holds no randomness, so no RNG state is kept)."""
    if positions is None:
        positions = torch.cumsum(attention_mask.int(), -1) - 1
        positions = positions.clamp(min=0)
    cos, sin = rope_tables(cfg, positions)
    x = inputs_embeds.to(cfg.dtype)
    layers = params["layers"]
    n_layers = layers["attn_norm"].shape[0]
    kv = None
    if return_kv:
        b, t, _ = x.shape
        shape = (n_layers, b, t, cfg.num_kv_heads, cfg.head_dim)
        kv = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    for i in range(n_layers):
        lp = _layer_weights(layers, i)
        if remat:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, attention_mask,
                           cfg.attn_impl, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(cfg, x, lp, cos, sin, attention_mask, cfg.attn_impl,
                       (kv["k"][i], kv["v"][i]) if return_kv else None)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x, kv) if return_kv else x


def chunk_forward_cached(params, cfg: LlamaConfig, inputs_embeds, prefix_kv,
                         prefix_mask, suffix_mask, positions,
                         write_offsets=None, write_mask=None):
    """Forward an S-token window against a per-row ragged prefix KV cache
    (twin of the JAX chunk_forward_cached, on a bf16/f32 cache).

    inputs_embeds [B, S, H]; prefix_kv {"k", "v"} [L, B, P, NKV, D]
    (post-rope, rows at positions 0..len-1); prefix_mask [B, P] validity;
    suffix_mask [B, S] validity (right-padded); positions [B, S] absolute
    rope positions. Each window token sees the row's valid prefix and the
    window tokens up to itself: a [B, S, P+S] mask, so attention runs the
    eager path (the flash kernel takes [B, S] key masks only), as JAX runs
    impl="xla" here.

    write_offsets [B] (optional): also write the window's post-rope K/V
    into the cache at write_offsets[b] + j for the tokens of write_mask
    [B, S] (default suffix_mask; a per-row prefix of the valid columns).
    Writes that land at or beyond P are dropped, never clamped. The cache
    is updated IN PLACE (each slot group owns its cache, and the card runs
    one stream in order), before the layer's attention, which still reads
    the written slots as window tokens only (they are not in prefix_mask
    yet). Returns (hidden [B, S, H], prefix_kv).
    """
    if "ks" in prefix_kv:
        raise NotImplementedError("the int8 prefix cache (kv_int8) is not "
                                  "ported yet (ROADMAP A9)")
    b, s, _ = inputs_embeds.shape
    p = prefix_kv["k"].shape[2]
    dev = inputs_embeds.device
    cos, sin = rope_tables(cfg, positions)
    qi = torch.arange(s, device=dev)[:, None]
    sm = (qi >= qi.T)[None] & suffix_mask[:, None, :]
    kv_mask = torch.cat([prefix_mask[:, None, :].expand(b, s, p), sm], dim=-1)

    x = inputs_embeds.to(cfg.dtype)
    if write_offsets is not None:
        # only the first min(S, P) columns can land below P. Their slots
        # (off + j) mod P are distinct within a row, and equal off + j
        # wherever the write is kept; a dropped entry rewrites its slot's
        # old content. So no two entries collide and nothing waits on the
        # card for a data-dependent index.
        w = min(s, p)
        j = torch.arange(w, device=dev)[None, :]
        off = write_offsets.long()[:, None]
        wm = (suffix_mask if write_mask is None else write_mask)[:, :w]
        keep = (wm & (off + j < p))[..., None, None]
        widx = (off + j) % p
        bgrid = torch.arange(b, device=dev)[:, None].expand(b, w)

        def scatter(buf, new):
            old = buf[bgrid, widx]
            buf[bgrid, widx] = torch.where(keep, new[:, :w].to(buf.dtype),
                                           old)

    layers = params["layers"]
    for i in range(layers["attn_norm"].shape[0]):
        lp = _layer_weights(layers, i)
        pk, pv = prefix_kv["k"][i], prefix_kv["v"][i]
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        if write_offsets is not None:
            scatter(pk, k)
            scatter(pv, v)
        keys = torch.cat([pk.to(k.dtype), k], dim=1)
        vals = torch.cat([pv.to(v.dtype), v], dim=1)
        attn = multi_head_attention(q, keys, vals, kv_mask=kv_mask,
                                    causal=False, impl="eager")
        x = _post_attn(cfg, x, lp, attn)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), prefix_kv


def embed_with_injection(params, input_ids, special_positions=None,
                         special_embeds=None):
    """inputs_embeds = embed[ids], plus special_embeds [B, K, H] added at
    token positions special_positions [B, K] (-1 = unused slot)."""
    x = embed_rows(params["embed"], input_ids.long())
    if special_positions is not None:
        b, k = special_positions.shape
        valid = special_positions >= 0
        pos = special_positions.clamp(min=0).long()
        upd = torch.where(valid[..., None], special_embeds.to(x.dtype),
                          torch.zeros((), dtype=x.dtype, device=x.device))
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, k)
        x = x.index_put((bidx, pos), upd, accumulate=True)
    return x


def embed_rows(embed, ids: torch.Tensor) -> torch.Tensor:
    """Lookup in a dense table or an int8 per-row one ({"q", "s" [V, 1]})."""
    if isinstance(embed, torch.Tensor):
        return embed[ids]
    return embed["q"][ids].to(embed["s"].dtype) * embed["s"][ids]


def lm_head_dim(params) -> int:
    w = params["lm_head"]
    return (w if isinstance(w, torch.Tensor) else w["q"]).shape[-1]


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
