"""Panorama/view encoder (torch twin of navillm_tpu/models/pano_encoder.py).

img linear+LN ⊕ loc linear+LN ⊕ nav-type embedding → LN → dropout → N
pre-norm encoder layers (exact GELU) → mapper linear → masked output.
Dropout (hidden_dropout_prob) runs only with training=True, drawing from
the given torch.Generator; the forward is deterministic otherwise or at
rate 0. The encoder's attention is the plain eager path, as it is
``impl="xla"`` in JAX.

Objects (use_obj): their features go through obj_projector + LN to the
LLM width (obj_embeds, with obj_masks and obj_loc_fts beside them). With
fuse_obj they also join the encoder's sequence as nav type 2 (obj_linear +
LN ⊕ loc linear + LN ⊕ type embedding) under one [B, V+O] mask, and the
views read them through attention; the fixed shapes with masks stand for
the reference's ragged repacking, which is the same function because the
encoder has no positional encoding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.masking import gen_seq_masks


@dataclasses.dataclass(frozen=True)
class PanoConfig:
    image_feat_size: int = 1024
    obj_feat_size: int = 768
    angle_feat_size: int = 4
    hidden_size: int = 1024
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_pano_layers: int = 2
    hidden_dropout_prob: float = 0.1
    output_size: int = 4096          # LLM hidden size
    use_obj: bool = False
    fuse_obj: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def loc_size(self) -> int:
        return self.angle_feat_size + 3

    @classmethod
    def tiny(cls, output_size: int = 128, **kw) -> "PanoConfig":
        kw.setdefault("image_feat_size", 32)
        kw.setdefault("obj_feat_size", 16)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        return cls(output_size=output_size, **kw)


def layer_norm(x, scale, bias, eps=1e-12):
    """In f32 (f64 for f64 inputs), rounded back to x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout (twin of _dropout): keep with probability 1-rate,
    scale kept entries by 1/(1-rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _encoder_stack(params, cfg: PanoConfig, x, mask):
    """Pre-norm DETR encoder over [B, T, H] with validity mask [B, T]."""
    enc = params["encoder"]
    nh = cfg.num_attention_heads
    d = cfg.hidden_size // nh
    for i in range(enc["qkv"]["w"].shape[0]):
        b, t, h = x.shape
        y = layer_norm(x, enc["ln1"]["s"][i], enc["ln1"]["b"][i])
        qkv = y @ enc["qkv"]["w"][i] + enc["qkv"]["b"][i]
        q, k, v = (z.reshape(b, t, nh, d) for z in qkv.chunk(3, dim=-1))
        attn = multi_head_attention(q, k, v, kv_mask=mask, causal=False,
                                    impl="eager")
        x = x + attn.reshape(b, t, h) @ enc["out"]["w"][i] + enc["out"]["b"][i]
        y = layer_norm(x, enc["ln2"]["s"][i], enc["ln2"]["b"][i])
        y = F.gelu(y @ enc["ffn1"]["w"][i] + enc["ffn1"]["b"][i])
        x = x + (y @ enc["ffn2"]["w"][i] + enc["ffn2"]["b"][i])
    en = params["encoder_norm"]
    return layer_norm(x, en["s"], en["b"])


def _linear_ln(x, lin, ln):
    return layer_norm(x @ lin["w"] + lin["b"], ln["s"], ln["b"])


def forward_panorama(params, cfg: PanoConfig, view_img_fts, view_lens,
                     loc_fts=None, nav_types=None, obj_img_fts=None,
                     obj_lens=None, obj_loc_fts=None,
                     generator: Optional[torch.Generator] = None,
                     training: bool = False) -> Dict[str, torch.Tensor]:
    """view_img_fts: [B, V, Di]; view_lens: [B]; loc_fts: [B, V, 7];
    nav_types: [B, V] int (0 non-nav, 1 navigable); objects: obj_img_fts
    [B, O, Do], obj_lens [B], obj_loc_fts [B, O, 7]. Returns pano_embeds
    [B, V, output_size] and pano_masks [B, V], and with use_obj and O > 0
    obj_embeds [B, O, output_size], obj_masks [B, O] and obj_loc_fts."""
    b, v, _ = view_img_fts.shape
    dev = view_img_fts.device
    x = layer_norm(view_img_fts.to(cfg.dtype) @ params["img_linear"]["w"]
                   + params["img_linear"]["b"],
                   params["img_ln"]["s"], params["img_ln"]["b"])
    if loc_fts is None:
        loc_fts = torch.zeros((b, v, cfg.loc_size), dtype=cfg.dtype,
                              device=dev)
    x = x + layer_norm(loc_fts.to(cfg.dtype) @ params["loc_linear"]["w"]
                       + params["loc_linear"]["b"],
                       params["loc_ln"]["s"], params["loc_ln"]["b"])
    if nav_types is None:
        nav_types = torch.ones((b, v), dtype=torch.long, device=dev)
    x = x + params["nav_type_emb"][nav_types.long()]
    x = layer_norm(x, params["ln"]["s"], params["ln"]["b"])
    if training and cfg.hidden_dropout_prob > 0:
        x = dropout(x, cfg.hidden_dropout_prob, generator)

    pano_masks = gen_seq_masks(view_lens, v)
    if "encoder" in params:
        if cfg.fuse_obj and obj_img_fts is not None:
            o = obj_img_fts.shape[1]
            oe = _linear_ln(obj_img_fts.to(cfg.dtype), params["obj_linear"],
                            params["obj_linear_ln"])
            oe = oe + _linear_ln(obj_loc_fts.to(cfg.dtype),
                                 params["loc_linear"], params["loc_ln"])
            oe = oe + params["nav_type_emb"][2]
            fmask = torch.cat([pano_masks, gen_seq_masks(obj_lens, o)], 1)
            x = _encoder_stack(params, cfg, torch.cat([x, oe], 1),
                               fmask)[:, :v]
        else:
            x = _encoder_stack(params, cfg, x, pano_masks)
    x = x @ params["mapper"]["w"] + params["mapper"]["b"]
    x = torch.where(pano_masks[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=dev))
    ret = {"pano_embeds": x, "pano_masks": pano_masks}
    if obj_img_fts is not None and obj_img_fts.shape[1] > 0 and cfg.use_obj:
        ret["obj_embeds"] = _linear_ln(obj_img_fts.to(cfg.dtype),
                                       params["obj_projector"],
                                       params["obj_projector_ln"])
        ret["obj_masks"] = gen_seq_masks(obj_lens, obj_img_fts.shape[1])
        ret["obj_loc_fts"] = obj_loc_fts
    return ret

