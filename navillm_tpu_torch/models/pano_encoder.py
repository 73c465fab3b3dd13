"""Panorama/view encoder (torch twin of navillm_tpu/models/pano_encoder.py).

img linear+LN ⊕ loc linear+LN ⊕ nav-type embedding → LN → N pre-norm
encoder layers (exact GELU) → mapper linear → masked output. Eval only:
the forward is deterministic (no dropout). The encoder's attention is the
plain eager path, as it is ``impl="xla"`` in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


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


def forward_panorama(params, cfg: PanoConfig, view_img_fts, view_lens,
                     loc_fts=None, nav_types=None) -> Dict[str, torch.Tensor]:
    """view_img_fts: [B, V, Di]; view_lens: [B]; loc_fts: [B, V, 7];
    nav_types: [B, V] int (0 non-nav, 1 navigable). Returns pano_embeds
    [B, V, output_size] and pano_masks [B, V]. Objects are not ported."""
    if cfg.fuse_obj:
        raise NotImplementedError("object fusion (fuse_obj) is not ported")
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

    pano_masks = gen_seq_masks(view_lens, v)
    if "encoder" in params:
        x = _encoder_stack(params, cfg, x, pano_masks)
    x = x @ params["mapper"]["w"] + params["mapper"]["b"]
    x = torch.where(pano_masks[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=dev))
    return {"pano_embeds": x, "pano_masks": pano_masks}

