"""Llama (Vicuna backbone), dense weights, as torch functions + a module.

Torch twin of navillm_tpu/models/llama.py for serving and training: the
stacked per-layer weights [L, ...] keep the JAX names (``weight_spec``),
the layer scan becomes a loop, and every layer's attention goes through
ops/attention.py:multi_head_attention (the CUDA flash kernels on the card).
Cast order follows the JAX code so bf16 runs round in the same places.
With ``remat`` (the JAX default) and grad enabled, each layer runs under
activation checkpointing, as ``jax.checkpoint`` wraps the scanned layer.
The layer matmuls go through ``_mm``, which also takes the quantized
leaves of models/quant.py: int8 (weight-only, or W8A8 with ``act_int8``:
an int8 x int8 -> int32 product through ``torch._int_mm``, as the JAX code
leaves it to XLA), and int4 (w4, or w4a8) through ops/matmul_q4.py (the
CUDA int4 kernel on the card). The prefix cache and the prompt K/V of
generation may be int8 (``kv_quantize``, per token and head, f32 scales).
Generation adds the one-token ``decode_step`` over the prompt's K/V and a
decode region, the LM logits and the causal LM loss.

Tensor parallelism: a tree of local shards (parallel/mesh.py:shard_params
under ``partition_specs``) carries its model group as ``tp`` (``Llama.tp``;
``tp_group`` reads it). Each rank then runs its H/tp heads and its columns
of wq/wk/wv/w_gate/w_up; wo and w_down (split by input row) are followed
by a sum over the model group, embed (split by vocabulary row) is a masked
lookup and a sum, lm_head (split by column) gathers the logits. The norms
are whole on every rank. Under W8A8 the per-token amax of a row-split
input is a max over the group. Gradients cross the collectives by
Megatron's rule (parallel/mesh.py: copy_to_model before a column split,
reduce_from_model after a row split).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention, window_attention
from ..ops.masking import NEG_INF
from ..ops.matmul_q4 import matmul_q4, matmul_q4_reference
from ..parallel.mesh import (copy_to_model, gather_from_model,
                             reduce_from_model)
from ..utils.profiling import span
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


def partition_specs(cfg: LlamaConfig, quantized: bool = False,
                    bits: int = 8) -> Dict[str, Any]:
    """Partition specs (parallel/mesh.py) of the LLM tree: megatron-style
    tensor parallelism over the model group, the JAX package's
    partition_specs as tuples. quantized: the int8 {"q", "s"} leaves (the
    scale drops the reduction axis's split, which has length 1 there), or
    with bits=4 the {"q4p", "s"} layer leaves, whose group scales follow
    the weight's spec (JAX replicates them; the port slices them with the
    weight, shard_params checks the groups); embed and lm_head are int8 at
    every bits setting."""
    col, row = (None, None, "model"), (None, "model", None)
    specs = {
        "embed": ("model", None),
        "layers": {"attn_norm": (None, None), "wq": col, "wk": col,
                   "wv": col, "wo": row, "mlp_norm": (None, None),
                   "w_gate": col, "w_up": col, "w_down": row},
        "final_norm": (None,),
        "lm_head": (None, "model"),
    }
    if not quantized:
        return specs

    def qspec(spec):
        s = list(spec)
        s[-2] = None
        return {"q": spec, "s": tuple(s)}

    def qspec4(spec):
        return {"q4p": spec, "s": spec}

    lq = qspec4 if bits == 4 else qspec
    return {
        "embed": {"q": specs["embed"], "s": ("model", None)},
        "layers": {k: (lq(v) if k not in ("attn_norm", "mlp_norm") else v)
                   for k, v in specs["layers"].items()},
        "final_norm": specs["final_norm"],
        "lm_head": qspec(specs["lm_head"]),
    }


def tp_group(params):
    """The model group a tree of local shards carries (None: whole)."""
    return getattr(params, "tp", None)


def local_heads(params, cfg: LlamaConfig):
    """(query heads, K/V heads) of this rank's shard."""
    n = tp_group(params).size if tp_group(params) is not None else 1
    return cfg.num_heads // n, cfg.num_kv_heads // n


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


def _act_q(x: torch.Tensor, group=None):
    """Per-token int8 activations: (xq int8, sx f32 [..., 1]), x ~= xq*sx.
    group: the model group over which x's features are split (the input
    of a row-split matmul): the amax is the row's over all of them."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    if group is not None:
        amax = group.all_reduce(amax, "max")
    sx = amax.clamp(min=1e-6) * (1.0 / 127.0)
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


# cuBLAS's int8 product (torch._int_mm on the card) takes more than 16
# rows; fewer are padded with zero rows up to this many
INT_MM_MIN_ROWS = 17


def int_mm(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] @ int8 [k, n] -> exact int32 [m, n] through
    ``torch._int_mm``. On the card it needs k and n multiples of 8 (raises
    otherwise: there is no float fallback) and more than 16 rows: fewer
    are padded with zero rows and the result sliced back, counted in
    ``int_mm.padded_calls`` and ``int_mm.padded_rows``."""
    m = xq.shape[0]
    if xq.is_cuda:
        k, n = q.shape
        if k % 8 or n % 8:
            raise ValueError(f"int_mm: torch._int_mm on the card needs k "
                             f"and n multiples of 8, got k={k}, n={n}")
        if m < INT_MM_MIN_ROWS:
            int_mm.padded_calls += 1
            int_mm.padded_rows += INT_MM_MIN_ROWS - m
            xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, q)[:m]


int_mm.padded_calls = 0
int_mm.padded_rows = 0


def _mm(x: torch.Tensor, w, a8: bool = False, q4_impl: str = "auto",
        split_in=None):
    """x @ w for a dense weight, an int8 one (``{"q", "s"}``, per output
    channel: ``(x @ q) * s``) or an int4 one (``{"q4p", "s"}``, _mm4). a8
    (cfg.act_int8) quantizes x per token; on int8 weights the product is
    then int8 x int8 -> int32 (``int_mm``), rescaled in f32 by the row's
    and the channel's scales in the JAX order; dense weights ignore a8, as
    in the JAX code. split_in: the model group when x holds this rank's
    part of the features (a row-split weight; the result is partial)."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if "q4p" in w:
        return _mm4(x, w, a8, q4_impl, split_in)
    if a8:
        xq, sx = _act_q(x, split_in)
        y = int_mm(xq.reshape(-1, xq.shape[-1]), w["q"])
        y = y.reshape(*xq.shape[:-1], y.shape[-1])
        return (y.float() * sx * w["s"].float()).to(x.dtype)
    return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)


def _mm4(x: torch.Tensor, w, a8: bool, q4_impl: str, split_in=None):
    """Group-scaled int4 matmul through matmul_q4 (q4_impl "auto") or its
    plain version ("plain"). w4a8: int8 activations, f32 out, then the
    row scale, as the JAX kernel path does."""
    if q4_impl not in ("auto", "plain"):
        raise ValueError(f"unknown q4_impl {q4_impl!r}")
    fn = matmul_q4 if q4_impl == "auto" else matmul_q4_reference
    if a8:
        xq, sx = _act_q(x, split_in)
        return (fn(xq, w["q4p"], w["s"]) * sx).to(x.dtype)
    return fn(x, w["q4p"], w["s"], out_dtype=x.dtype)


def _qkv(cfg: LlamaConfig, x, lp, cos, sin, tp=None):
    """Post-rope q, k, v [B, T, heads, D] of this rank's heads."""
    b, t, _ = x.shape
    d = cfg.head_dim
    attn_in = copy_to_model(rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps),
                            tp)
    a8, impl = cfg.act_int8, cfg.q4_impl
    q = _mm(attn_in, lp["wq"], a8, impl).reshape(b, t, -1, d)
    k = _mm(attn_in, lp["wk"], a8, impl).reshape(b, t, -1, d)
    v = _mm(attn_in, lp["wv"], a8, impl).reshape(b, t, -1, d)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _post_attn(cfg: LlamaConfig, x, lp, attn, tp=None):
    b, t, _ = x.shape
    a8, impl = cfg.act_int8, cfg.q4_impl
    x = x + reduce_from_model(_mm(attn.reshape(b, t, -1), lp["wo"], a8,
                                  impl, tp), tp)
    mlp_in = copy_to_model(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), tp)
    gate = F.silu(_mm(mlp_in, lp["w_gate"], a8, impl))
    return x + reduce_from_model(_mm(
        gate * _mm(mlp_in, lp["w_up"], a8, impl), lp["w_down"], a8, impl,
        tp), tp)


def _layer(cfg: LlamaConfig, x, lp, cos, sin, kv_mask, attn_impl,
           kv_out=None, tp=None):
    """One transformer block (causal self-attention over x). kv_out: an
    optional (k, v) pair of [B, T, NKV, D] buffers that receive the
    post-rope K/V. tp: the model group of a sharded tree."""
    q, k, v = _qkv(cfg, x, lp, cos, sin, tp)
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    return _post_attn(cfg, x, lp, attn, tp)


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
    tp = tp_group(params)
    layers = params["layers"]
    n_layers = layers["attn_norm"].shape[0]
    kv = None
    if return_kv:
        b, t, _ = x.shape
        shape = (n_layers, b, t, local_heads(params, cfg)[1], cfg.head_dim)
        kv = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    for i in range(n_layers):
        lp = _layer_weights(layers, i)
        if remat:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, attention_mask,
                           cfg.attn_impl, None, tp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(cfg, x, lp, cos, sin, attention_mask, cfg.attn_impl,
                       (kv["k"][i], kv["v"][i]) if return_kv else None, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x, kv) if return_kv else x


def kv_quantize(x: torch.Tensor):
    """Symmetric int8 over head_dim (the last axis): (int8 values, f32
    scales [..., 1]), with the JAX order of the scale's operations, so the
    codes match it exactly (torch.round rounds half to even, as
    jnp.round)."""
    xf = x.float()
    s = xf.abs().amax(-1, keepdim=True).clamp(min=1e-6) * (1.0 / 127.0)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Multiply in the scales' f32 and round once to ``dtype``."""
    return (q.to(s.dtype) * s).to(dtype)


def kv_is_quantized(kv) -> bool:
    return isinstance(kv, dict) and "ks" in kv


def quantize_kv_stack(kv):
    """{"k", "v"} [L, B, T, NKV, D] -> {"k", "ks", "v", "vs"} (int8
    values, f32 scales [L, B, T, NKV, 1]), one layer at a time, so the f32
    transient is one layer's."""
    out = {}
    for name in ("k", "v"):
        src = kv[name]
        q = torch.empty(src.shape, dtype=torch.int8, device=src.device)
        sc = torch.empty((*src.shape[:-1], 1), dtype=torch.float32,
                         device=src.device)
        for i in range(src.shape[0]):
            q[i], sc[i] = kv_quantize(src[i])
        out[name], out[name + "s"] = q, sc
    return out


def chunk_forward_cached(params, cfg: LlamaConfig, inputs_embeds, prefix_kv,
                         prefix_mask, suffix_mask, positions,
                         write_offsets=None, write_mask=None):
    """Forward an S-token window against a per-row ragged prefix KV cache
    (twin of the JAX chunk_forward_cached).

    inputs_embeds [B, S, H]; prefix_kv {"k", "v"} [L, B, P, NKV, D]
    (post-rope, rows at positions 0..len-1) in the compute dtype, or int8
    {"k", "ks", "v", "vs"} with f32 scales [L, B, P, NKV, 1]
    (``kv_quantize``); prefix_mask [B, P] validity; suffix_mask [B, S]
    validity (right-padded); positions [B, S] absolute rope positions.
    Each window token sees the row's valid prefix and the window tokens up
    to itself (ops/attention.py:window_mask). Each layer's attention is
    ops/attention.py:window_attention over the cache's layer view and the
    window's K/V: on CUDA tensors the window kernel, which reads the two
    as separate sources; on CPU tensors the eager path over their
    concatenation under the [B, S, P+S] mask, as JAX runs impl="xla" here.
    An int8 cache is dequantized per layer at read (f32, then one rounding
    to the compute dtype).

    write_offsets [B] (optional): also write the window's post-rope K/V
    into the cache at write_offsets[b] + j for the tokens of write_mask
    [B, S] (default suffix_mask; a per-row prefix of the valid columns).
    Writes that land at or beyond P are dropped, never clamped; an int8
    cache takes the codes and the scales at the same slots. The cache is
    updated IN PLACE (each slot group owns its cache, and the card runs
    one stream in order), before the layer's attention, which still reads
    the written slots as window tokens only (they are not in prefix_mask
    yet). On an int8 cache the window reads its written columns through
    the int8 round trip, as later steps will read them from the cache, so
    the appending step and every later one attend to the same K/V for a
    token. Returns (hidden [B, S, H], prefix_kv).
    """
    quant = kv_is_quantized(prefix_kv)
    b, s, _ = inputs_embeds.shape
    p = prefix_kv["k"].shape[2]
    dev = inputs_embeds.device
    cos, sin = rope_tables(cfg, positions)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    x = inputs_embeds.to(cfg.dtype)
    tp = tp_group(params)
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
        # the window columns written to the cache ([B, S, 1, 1])
        written = F.pad(keep, (0, 0, 0, 0, 0, s - w))

        def scatter(buf, new):
            old = buf[bgrid, widx]
            buf[bgrid, widx] = torch.where(keep, new[:, :w].to(buf.dtype),
                                           old)

    layers = params["layers"]
    for i in range(layers["attn_norm"].shape[0]):
        lp = _layer_weights(layers, i)
        pk, pv = prefix_kv["k"][i], prefix_kv["v"][i]
        q, k, v = _qkv(cfg, x, lp, cos, sin, tp)
        if write_offsets is not None:
            if quant:
                pks, pvs = prefix_kv["ks"][i], prefix_kv["vs"][i]
                kq, ksc = kv_quantize(k)
                vq, vsc = kv_quantize(v)
                scatter(pk, kq)
                scatter(pks, ksc)
                scatter(pv, vq)
                scatter(pvs, vsc)
                k = torch.where(written, kv_dequantize(kq, ksc, k.dtype), k)
                v = torch.where(written, kv_dequantize(vq, vsc, v.dtype), v)
            else:
                scatter(pk, k)
                scatter(pv, v)
        if quant:
            pk = kv_dequantize(pk, prefix_kv["ks"][i], k.dtype)
            pv = kv_dequantize(pv, prefix_kv["vs"][i], v.dtype)
        with span("window_attn", "model", timed=q):
            attn = window_attention(q, pk, pv, prefix_mask, k, v,
                                    suffix_mask, scale=scale)
        x = _post_attn(cfg, x, lp, attn, tp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), prefix_kv


def init_decode_cache(cfg: LlamaConfig, batch_size: int, max_new: int,
                      device=None, num_kv_heads: Optional[int] = None):
    """The decode region {"k", "v"} [L, B, max_new, NKV, D]: only the
    generated tokens' K/V live here; the prompt's stay in the read-only
    stack of forward_hidden(return_kv=True). num_kv_heads: a shard's
    (local_heads), default all."""
    shape = (cfg.num_layers, batch_size, max_new,
             num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params, cfg: LlamaConfig, inputs_embeds, prompt_kv,
                prompt_mask, dec_cache, step_index: int, positions):
    """One-token decode step (twin of the JAX decode_step) against the
    read-only prompt K/V and the decode region.

    inputs_embeds [B, 1, H]; prompt_kv {"k", "v"} [L, B, T, NKV, D], or
    the int8 {"k", "ks", "v", "vs"} of quantize_kv_stack (dequantized per
    layer at read; the decode region stays in the compute dtype);
    prompt_mask [B, T]; dec_cache {"k", "v"} [L, B, N, NKV, D], whose slot
    step_index receives this token's post-rope K/V IN PLACE before the
    layer's attention; positions [B, 1]. Each token sees the valid prompt
    keys and decode slots 0..step_index: a [B, T+N] key mask over the
    concatenated keys, through the eager attention, as JAX runs impl="xla"
    here. Returns (hidden [B, 1, H], dec_cache)."""
    quant = kv_is_quantized(prompt_kv)
    b = inputs_embeds.shape[0]
    n_dec = dec_cache["k"].shape[2]
    dev = inputs_embeds.device
    cos, sin = rope_tables(cfg, positions)
    dec_mask = (torch.arange(n_dec, device=dev) <= step_index)[None, :]
    kv_mask = torch.cat([prompt_mask, dec_mask.expand(b, n_dec)], dim=1)
    x = inputs_embeds.to(cfg.dtype)
    tp = tp_group(params)
    layers = params["layers"]
    for i in range(layers["attn_norm"].shape[0]):
        lp = _layer_weights(layers, i)
        q, k, v = _qkv(cfg, x, lp, cos, sin, tp)
        dk, dv = dec_cache["k"][i], dec_cache["v"][i]
        dk[:, step_index] = k[:, 0]
        dv[:, step_index] = v[:, 0]
        pk, pv = prompt_kv["k"][i], prompt_kv["v"][i]
        if quant:
            pk = kv_dequantize(pk, prompt_kv["ks"][i], k.dtype)
            pv = kv_dequantize(pv, prompt_kv["vs"][i], v.dtype)
        keys = torch.cat([pk, dk], dim=1).to(k.dtype)
        vals = torch.cat([pv, dv], dim=1).to(v.dtype)
        attn = multi_head_attention(q, keys, vals, kv_mask=kv_mask,
                                    causal=False, impl="eager")
        x = _post_attn(cfg, x, lp, attn, tp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), dec_cache


def lm_head(params, cfg: LlamaConfig, hidden):
    """hidden @ lm_head in the matmul's dtype; a column-split lm_head
    gathers every rank's columns."""
    tp = tp_group(params)
    return gather_from_model(_mm(copy_to_model(hidden, tp), params["lm_head"],
                                 cfg.act_int8, cfg.q4_impl), tp)


def logits_from_hidden(params, cfg: LlamaConfig, hidden,
                       special_token_mask=None):
    """LM logits in f32, special-token columns (a [vocab] bool mask) at
    NEG_INF. A column-split lm_head gathers every rank's columns."""
    logits = lm_head(params, cfg, hidden).float()
    if special_token_mask is not None:
        logits = logits.masked_fill(special_token_mask, NEG_INF)
    return logits


def causal_lm_loss(logits, labels, ignore_id: int = -100, group=None):
    """Shifted mean cross-entropy over the labels != ignore_id. group: a
    data group (parallel/mesh.py) whose ranks hold the other rows of the
    batch: the mean is over the valid labels of all of them (summed over
    the group), so the ranks' averaged gradients are the whole batch's."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_id
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, shift_labels.clamp(min=0).long()[..., None])[..., 0]
    total = torch.where(valid, nll, torch.zeros((), device=nll.device)).sum()
    count = valid.sum()
    if group is not None:
        count = group.all_reduce(count)
    return total / count.clamp(min=1)


def embed_with_injection(params, input_ids, special_positions=None,
                         special_embeds=None):
    """inputs_embeds = embed[ids], plus special_embeds [B, K, H] added at
    token positions special_positions [B, K] (-1 = unused slot)."""
    x = embed_rows(params["embed"], input_ids.long(), tp_group(params))
    if special_positions is not None:
        b, k = special_positions.shape
        valid = special_positions >= 0
        pos = special_positions.clamp(min=0).long()
        upd = torch.where(valid[..., None], special_embeds.to(x.dtype),
                          torch.zeros((), dtype=x.dtype, device=x.device))
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, k)
        x = x.index_put((bidx, pos), upd, accumulate=True)
    return x


def embed_rows(embed, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """Lookup in a dense table or an int8 per-row one ({"q", "s" [V, 1]}).
    tp: the model group of a table split by vocabulary row: each rank
    looks up the ids in its rows (zero elsewhere) and the group sums."""
    if tp is None:
        return _lookup(embed, ids)
    rows = (embed if isinstance(embed, torch.Tensor) else embed["q"]) \
        .shape[0]
    local = ids - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = _lookup(embed, local.clamp(0, rows - 1))
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return reduce_from_model(x, tp)


def _lookup(embed, ids):
    if isinstance(embed, torch.Tensor):
        return embed[ids]
    return embed["q"][ids].to(embed["s"].dtype) * embed["s"][ids]


def lm_head_dim(params) -> int:
    """The vocabulary width of the logits (all ranks' columns)."""
    w = params["lm_head"]
    n = tp_group(params).size if tp_group(params) is not None else 1
    return (w if isinstance(w, torch.Tensor) else w["q"]).shape[-1] * n


class Llama(ParamTree):
    """The LLM's weights: ``embed``, ``layers`` (stacked [L, ...] under the
    names of ``weight_spec`` plus ``attn_norm``/``mlp_norm``),
    ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any], tp=None):
        super().__init__(params)
        self.cfg = cfg
        # the model group when the leaves are local shards
        self.tp = tp

    def forward(self, inputs_embeds, attention_mask, positions=None):
        return forward_hidden(self, self.cfg, inputs_embeds, attention_mask,
                              positions)
