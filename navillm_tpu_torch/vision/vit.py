"""Vision transformer of the offline view-feature extraction.

Torch twin of navillm_tpu/vision/vit.py: batched [N, H, W, 3] images ->
[N, width] view features (the CLS token after the final LayerNorm, the
reference's ``forward_features``). Two families behind one config:

  - style="clip": CLIP ViT (pre-LN, exact-GELU MLP, learned position
    embeddings), convertible from a ``CLIPVisionModel`` state dict;
  - style="eva02": the EVA02-CLIP visual tower (no pre-LN, a sub-LN on
    the attention output, SwiGLU with an inner LN, 2D rotary embeddings
    on the patch tokens' q/k), convertible from an EVA-CLIP ``visual.*``
    state dict.

The parameter tree keeps the JAX names and layouts (linear weights
[d_in, d_out], per-layer weights stacked [L, ...]); the layer scan is a
loop. Attention is the port's eager path (ops/attention.py), the
counterpart of the ``impl="xla"`` the JAX tower uses: no flash kernel
runs here. Everything computes in ``cfg.dtype`` (f32 by default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import _Init, target_device
from ..models.pano_encoder import layer_norm
from ..ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    style: str = "clip"            # clip | eva02
    ln_eps: float = 1e-6
    use_cls_token: bool = True
    rope_theta: float = 100.0
    # pretraining patch grid of the rope frequency interpolation (positions
    # arange(grid) / grid * pt_grid); None: positions arange(grid)
    rope_pt_grid: int | None = None
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + (1 if self.use_cls_token else 0)

    @property
    def mlp_dim(self) -> int:
        return int(self.width * self.mlp_ratio)

    @classmethod
    def eva02_clip_l_14_336(cls, **kw) -> "ViTConfig":
        kw.setdefault("style", "eva02")
        kw.setdefault("rope_pt_grid", 16)
        return cls(image_size=336, patch_size=14, width=1024, num_layers=24,
                   num_heads=16, mlp_ratio=4 * 2 / 3, **kw)

    @classmethod
    def clip_l_14_336(cls, **kw) -> "ViTConfig":
        """CLIP ViT-L/14 at 336 px (openai's vision tower)."""
        return cls(image_size=336, patch_size=14, width=1024, num_layers=24,
                   num_heads=16, mlp_ratio=4.0, ln_eps=1e-5, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        return cls(image_size=28, patch_size=14, width=64, num_layers=2,
                   num_heads=4, **kw)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator,
                    device=None) -> Dict[str, Any]:
    """Random weights of the JAX init's shapes and scales (linear weights
    N(0, 1/d_in), zero biases, unit LayerNorms, position embeddings
    N(0, 0.02^2), a zero CLS token) on ``device`` (default: the card; the
    generator must live there too)."""
    init = _Init(generator, target_device(device), cfg.dtype)
    w, L = cfg.width, cfg.num_layers
    p: Dict[str, Any] = {
        "patch_embed": init.linear(cfg.patch_size * cfg.patch_size * 3, w),
        "pos_embed": init.normal((cfg.seq_len, w), 0.02),
        "ln_post": init.ln(w),
    }
    if cfg.style != "eva02":
        # EVA-02 towers have no pre-LN (an identity LayerNorm still
        # normalizes, so it cannot stand in for an absent one)
        p["ln_pre"] = init.ln(w)
    if cfg.use_cls_token:
        p["cls_token"] = init.const((w,), 0.0)

    def stack(make):
        outs = [make() for _ in range(L)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    layers = {
        "ln1": stack(lambda: init.ln(w)),
        "qkv": stack(lambda: init.linear(w, 3 * w)),
        "proj": stack(lambda: init.linear(w, w)),
        "ln2": stack(lambda: init.ln(w)),
    }
    if cfg.style == "eva02":
        layers.update({
            "attn_ln": stack(lambda: init.ln(w)),
            "w1": stack(lambda: init.linear(w, cfg.mlp_dim)),
            "w2": stack(lambda: init.linear(w, cfg.mlp_dim)),
            "ffn_ln": stack(lambda: init.ln(cfg.mlp_dim)),
            "w3": stack(lambda: init.linear(cfg.mlp_dim, w)),
        })
    else:
        layers.update({
            "fc1": stack(lambda: init.linear(w, cfg.mlp_dim)),
            "fc2": stack(lambda: init.linear(cfg.mlp_dim, w)),
        })
    p["layers"] = layers
    return p


def _rope_2d(cfg: ViTConfig, device):
    """2D axial rotary tables [T, head_dim] (f32, f64 for an f64 config)
    for the patch tokens, identity on CLS: the official
    VisionRotaryEmbeddingFast (theta 100, head_dim/4 frequencies per axis,
    interleaved pairs; row angles fill the first half of the head dim,
    column angles the second)."""
    d = cfg.width // cfg.num_heads
    d4 = d // 4
    kw = dict(dtype=torch.promote_types(cfg.dtype, torch.float32),
              device=device)
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, d4, **kw) / d4))
    pos = torch.arange(cfg.grid, **kw)
    if cfg.rope_pt_grid is not None:
        pos = pos / cfg.grid * cfg.rope_pt_grid
    ang = (pos[:, None] * freqs[None, :]).repeat_interleave(2, -1)  # [G, d/2]
    g = cfg.grid
    row = ang[:, None, :].expand(g, g, d // 2).reshape(-1, d // 2)
    col = ang[None, :, :].expand(g, g, d // 2).reshape(-1, d // 2)
    angles = torch.cat([row, col], -1)                             # [G*G, d]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if cfg.use_cls_token:
        cos = torch.cat([torch.ones((1, d), **kw), cos], 0)
        sin = torch.cat([torch.zeros((1, d), **kw), sin], 0)
    return cos, sin


def _apply_rope(x, cos, sin):
    """x [B, T, N, D]; interleaved pairs: (2i, 2i+1) -> (-x_odd, x_even)."""
    xp = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-xp[..., 1], xp[..., 0]], -1).reshape(x.shape)
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return x * c + rot * s


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H/p * W/p, p*p*3]."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _lin(x, p):
    return x @ p["w"] + p["b"]


def _ln(x, p, eps):
    return layer_norm(x, p["s"], p["b"], eps)


def vit_forward_features(params, cfg: ViTConfig, images: torch.Tensor
                         ) -> torch.Tensor:
    """[B, H, W, 3] float images -> [B, width] pooled features."""
    b = images.shape[0]
    x = _lin(patchify(images.to(cfg.dtype), cfg.patch_size),
             params["patch_embed"])
    if cfg.use_cls_token:
        cls = params["cls_token"].expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][None]
    if cfg.style != "eva02":
        x = _ln(x, params["ln_pre"], cfg.ln_eps)

    nh = cfg.num_heads
    d = cfg.width // nh
    rope = _rope_2d(cfg, x.device) if cfg.style == "eva02" else None
    layers = params["layers"]
    for i in range(layers["ln1"]["s"].shape[0]):
        lp = {k: {n: leaf[i] for n, leaf in v.items()}
              for k, v in layers.items()}
        _, t, w_ = x.shape
        qkv = _lin(_ln(x, lp["ln1"], cfg.ln_eps), lp["qkv"])
        q, k, v = (z.reshape(b, t, nh, d) for z in qkv.chunk(3, -1))
        if rope is not None:
            q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        attn = multi_head_attention(q, k, v, causal=False, impl="eager")
        attn = attn.reshape(b, t, w_)
        if cfg.style == "eva02":
            # sub-LN on the attention output (official inner_attn_ln)
            attn = _ln(attn, lp["attn_ln"], cfg.ln_eps)
        x = x + _lin(attn, lp["proj"])
        y = _ln(x, lp["ln2"], cfg.ln_eps)
        if cfg.style == "eva02":
            h = F.silu(_lin(y, lp["w1"])) * _lin(y, lp["w2"])
            x = x + _lin(_ln(h, lp["ffn_ln"], cfg.ln_eps), lp["w3"])
        else:
            x = x + _lin(F.gelu(_lin(y, lp["fc1"])), lp["fc2"])
    x = _ln(x, params["ln_post"], cfg.ln_eps)
    return x[:, 0] if cfg.use_cls_token else x.mean(dim=1)


def _stack(fn, n: int) -> Dict[str, torch.Tensor]:
    outs = [fn(i) for i in range(n)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _converter(get, cfg: ViTConfig, device):
    """(tensor, linear, layernorm) readers over a name -> array getter."""
    device = target_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32)).to(device, cfg.dtype)

    def lin(name):
        return {"w": t(get(name + ".weight").T), "b": t(get(name + ".bias"))}

    def ln(name):
        return {"s": t(get(name + ".weight")), "b": t(get(name + ".bias"))}

    return t, lin, ln


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_hf_clip_vision(state_dict, cfg: ViTConfig, device=None
                           ) -> Dict[str, Any]:
    """A ``CLIPVisionModel``'s ``state_dict()`` (``vision_model.*`` names)
    -> the param tree (style "clip") on ``device``."""
    pre = "vision_model."

    def get(name):
        return _as_numpy(state_dict[pre + name])

    t, lin, ln = _converter(get, cfg, device)
    # conv patch embedding [W, 3, p, p] -> [p*p*3, W] in patchify's order
    conv = get("embeddings.patch_embedding.weight")
    w = conv.transpose(2, 3, 1, 0).reshape(-1, cfg.width)

    def qkv(i):
        base = f"encoder.layers.{i}.self_attn."
        names = ("q_proj", "k_proj", "v_proj")
        return {"w": t(np.concatenate([get(base + n + ".weight").T
                                       for n in names], 1)),
                "b": t(np.concatenate([get(base + n + ".bias")
                                       for n in names], 0))}

    L = cfg.num_layers
    layer = "encoder.layers.{}."
    return {
        "patch_embed": {"w": t(w), "b": t(np.zeros((cfg.width,)))},
        "cls_token": t(get("embeddings.class_embedding")),
        "pos_embed": t(get("embeddings.position_embedding.weight")),
        "ln_pre": ln("pre_layrnorm"),
        "ln_post": ln("post_layernorm"),
        "layers": {
            "ln1": _stack(lambda i: ln(layer.format(i) + "layer_norm1"), L),
            "qkv": _stack(qkv, L),
            "proj": _stack(lambda i: lin(layer.format(i)
                                         + "self_attn.out_proj"), L),
            "ln2": _stack(lambda i: ln(layer.format(i) + "layer_norm2"), L),
            "fc1": _stack(lambda i: lin(layer.format(i) + "mlp.fc1"), L),
            "fc2": _stack(lambda i: lin(layer.format(i) + "mlp.fc2"), L),
        },
    }


def convert_eva02_clip(state_dict, cfg: ViTConfig, device=None
                       ) -> Dict[str, Any]:
    """An EVA-CLIP ``visual.*`` state dict (the EVA02-CLIP-L-14-336
    release: patch_embed.proj, pos_embed, cls_token, blocks.N.{norm1,
    attn.{q_proj, k_proj, v_proj, q_bias, v_bias, inner_attn_ln, proj},
    norm2, mlp.{w1, w2, ffn_ln, w3}}, norm) -> the param tree (style
    "eva02") on ``device``. The k projection has no bias: a zero one is
    stacked between q's and v's."""
    def get(name):
        return _as_numpy(state_dict[name])

    t, lin, ln = _converter(get, cfg, device)
    conv = get("visual.patch_embed.proj.weight")
    w = conv.transpose(2, 3, 1, 0).reshape(-1, cfg.width)
    bias = state_dict.get("visual.patch_embed.proj.bias")

    def qkv(i):
        base = f"visual.blocks.{i}.attn."
        ws = [get(base + n + ".weight").T
              for n in ("q_proj", "k_proj", "v_proj")]
        qb = get(base + "q_bias") if base + "q_bias" in state_dict \
            else get(base + "q_proj.bias")
        vb = get(base + "v_bias") if base + "v_bias" in state_dict \
            else get(base + "v_proj.bias")
        return {"w": t(np.concatenate(ws, 1)),
                "b": t(np.concatenate([qb, np.zeros_like(qb), vb], 0))}

    L = cfg.num_layers
    blk = "visual.blocks.{}."
    return {
        "patch_embed": {
            "w": t(w),
            "b": t(_as_numpy(bias)) if bias is not None
            else t(np.zeros((cfg.width,)))},
        "cls_token": t(get("visual.cls_token").reshape(-1)),
        "pos_embed": t(get("visual.pos_embed").reshape(cfg.seq_len,
                                                       cfg.width)),
        "ln_post": ln("visual.norm"),
        "layers": {
            "ln1": _stack(lambda i: ln(blk.format(i) + "norm1"), L),
            "qkv": _stack(qkv, L),
            "attn_ln": _stack(lambda i: ln(blk.format(i)
                                           + "attn.inner_attn_ln"), L),
            "proj": _stack(lambda i: lin(blk.format(i) + "attn.proj"), L),
            "ln2": _stack(lambda i: ln(blk.format(i) + "norm2"), L),
            "w1": _stack(lambda i: lin(blk.format(i) + "mlp.w1"), L),
            "w2": _stack(lambda i: lin(blk.format(i) + "mlp.w2"), L),
            "ffn_ln": _stack(lambda i: ln(blk.format(i) + "mlp.ffn_ln"), L),
            "w3": _stack(lambda i: lin(blk.format(i) + "mlp.w3"), L),
        },
    }
