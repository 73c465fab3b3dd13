"""NavModel: LLM + panorama encoder + navigation head, and its losses.

Torch twin of the navigation, generation and object-grounding modes of
navillm_tpu/models/nav_model.py.
The JAX scatters keep their semantics: ``.at[].add`` with repeated
indices is ``index_put(..., accumulate=True)``, ``.at[].max`` is
``scatter_reduce("amax", include_self=True)``, and bf16 + f32 promotes
to f32 as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import llama as L
from .pano_encoder import PanoConfig, layer_norm
from .params import ParamTree
from ..ops.masking import NEG_INF

NUM_CAND_SLOTS = 100      # out_head width
MAX_ACTION_STEPS = 100    # gmap step-embedding table


@dataclasses.dataclass(frozen=True)
class NavModelConfig:
    llm: L.LlamaConfig
    pano: PanoConfig
    angle_feat_size: int = 4
    type_vocab_size: int = 3

    @property
    def hidden_size(self) -> int:
        return self.llm.hidden_size

    @classmethod
    def tiny(cls, vocab_size: int = 512, use_obj: bool = True
             ) -> "NavModelConfig":
        llm = L.LlamaConfig.tiny(vocab_size=vocab_size)
        return cls(llm=llm, pano=PanoConfig.tiny(output_size=llm.hidden_size,
                                                 use_obj=use_obj))


def _bgrid(idx: torch.Tensor) -> torch.Tensor:
    """Batch-row index grid matching idx [B, K]."""
    return torch.arange(idx.shape[0], device=idx.device)[:, None] \
        .expand_as(idx)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _pos_mlp(p, x):
    y = x.to(p["w"].dtype) @ p["w"] + p["b"]
    return layer_norm(y, p["ln_s"], p["ln_b"])


def fuse_gmap_local(params, cfg: NavModelConfig, batch: Dict[str, Any]):
    """Global/local fusion. Needs gmap_img_embeds [B,G,H], gmap_step_ids,
    gmap_pos_fts, gmap_masks, gmap_visited_masks [B,G], vp_img_embeds
    [B,V,H], vp_pos_fts, pano_masks [B,V], local_match_slot [B,V] (gmap
    slot of local view j if it is an unvisited node, else -1).
    Returns fuse_embeds [B,G,H], cand_masks [B,G]."""
    gmap = batch["gmap_img_embeds"] \
        + params["gmap_step_emb"][batch["gmap_step_ids"].long()] \
        + _pos_mlp(params["gmap_pos"], batch["gmap_pos_fts"])
    visited = batch["gmap_visited_masks"]
    gmask = batch["gmap_masks"]
    zero_out = visited | ~gmask
    gmap = torch.where(zero_out[..., None], _zero(gmap), gmap)

    vp = batch["vp_img_embeds"] + _pos_mlp(params["vp_pos"],
                                           batch["vp_pos_fts"])
    vp = torch.where(batch["pano_masks"][..., None], vp, _zero(vp))

    b, g, _ = gmap.shape
    slot = batch["local_match_slot"]
    valid = slot >= 0
    slot_safe = slot.clamp(min=0).long()
    bidx = _bgrid(slot_safe)
    upd = torch.where(valid[..., None], vp, _zero(vp)).to(gmap.dtype)
    fuse = gmap.index_put((bidx, slot_safe), upd, accumulate=True)
    matched = torch.zeros((b, g), dtype=torch.int32, device=gmap.device) \
        .index_put((bidx, slot_safe), valid.int(), accumulate=True) > 0

    # token type 1 for unvisited non-stop nodes with no local view
    slot_ids = torch.arange(g, device=gmap.device)[None, :]
    ttype = ((slot_ids > 0) & gmask & ~visited & ~matched).long()
    fuse = fuse + params["token_type_emb"][ttype]
    fuse = torch.where(zero_out[..., None], _zero(fuse), fuse)
    return fuse, gmask & ~visited


def forward_navigation(params, cfg: NavModelConfig, batch: Dict[str, Any]):
    """Navigation step. Beyond fuse_gmap_local's inputs, batch needs
    input_ids / attention_mask [B,T], cand_positions [B,C] (token index of
    the k-th <cand>, -1 pad), cand_order [B,C] (gmap slot injected there),
    hist_positions [B,Hh], hist_embeds [B,Hh,H], cls_pos [B].
    Returns dict(fuse_embeds [B,G,H], fuse_logits [B,G] f32)."""
    fuse, cand_masks = fuse_gmap_local(params, cfg, batch)
    b, g, _ = fuse.shape

    order = batch["cand_order"]
    ovalid = order >= 0
    order_safe = order.clamp(min=0).long()
    bidx = _bgrid(order_safe)
    cand_embeds = torch.where(ovalid[..., None], fuse[bidx, order_safe],
                              _zero(fuse))

    positions = torch.cat([batch["cand_positions"], batch["hist_positions"]],
                          dim=1)
    embeds = torch.cat([cand_embeds, batch["hist_embeds"]], dim=1)
    inputs_embeds = L.embed_with_injection(params["llm"], batch["input_ids"],
                                           positions, embeds)
    hidden = L.forward_hidden(params["llm"], cfg.llm, inputs_embeds,
                              batch["attention_mask"])
    rows = torch.arange(b, device=hidden.device)
    cls_hidden = hidden[rows, batch["cls_pos"].long()]                # [B, H]
    preds = (cls_hidden @ params["out_head"]["w"]
             + params["out_head"]["b"]).float()                       # [B, 100]

    # scatter back: slot 0 <- preds[:, 0]; cand_order[b, k] <- preds[b, k+1]
    logits = torch.full((b, g), NEG_INF, dtype=torch.float32,
                        device=preds.device)
    logits[:, 0] = preds[:, 0]
    upd = torch.where(ovalid, preds[:, 1:1 + order.shape[1]],
                      torch.full((), NEG_INF, device=preds.device))
    logits = logits.scatter_reduce(1, order_safe, upd, "amax",
                                   include_self=True)
    logits = torch.where(cand_masks, logits,
                         torch.full((), NEG_INF, device=preds.device))
    return {"fuse_embeds": fuse, "fuse_logits": logits}


def prep_generation_embeds(params, cfg: NavModelConfig, vp_img_embeds,
                           vp_masks):
    """The pre-LLM path of summarization / EQA: zero position features
    through vp_pos, plus the type-0 token embedding, masked by vp_masks."""
    b, v, _ = vp_img_embeds.shape
    zeros = vp_img_embeds.new_zeros((b, v, cfg.angle_feat_size * 2 + 6))
    x = vp_img_embeds + _pos_mlp(params["vp_pos"], zeros)
    x = x + params["token_type_emb"][0]
    return torch.where(vp_masks[..., None], x, _zero(x))


def forward_generation_loss(params, cfg: NavModelConfig, batch,
                            count_group=None):
    """Teacher-forced LM loss of summarization / EQA / FGR2R (twin of the
    JAX forward_generation_loss). batch: input_ids, attention_mask, labels
    [B, T] (-100 ignored), cand_positions [B, C], hist_positions [B, Hh],
    hist_embeds [B, Hh, H], special_token_mask [vocab] bool, and either
    cand_embeds [B, C, H] or vp_img_embeds [B, V, H] + vp_masks [B, V]
    (fused here by prep_generation_embeds; the valid views are a prefix).
    count_group: the data group whose ranks' batches together make the
    step's batch (the token mean is over all of their valid tokens).
    Returns {"loss": scalar, "logits": [B, T, vocab] f32}."""
    c = batch["cand_positions"].shape[1]
    if "cand_embeds" in batch:
        cand_embeds = batch["cand_embeds"]
    else:
        cand_embeds = prep_generation_embeds(
            params, cfg, batch["vp_img_embeds"], batch["vp_masks"])[:, :c]
    positions = torch.cat([batch["cand_positions"], batch["hist_positions"]],
                          dim=1)
    embeds = torch.cat([cand_embeds, batch["hist_embeds"]], dim=1)
    inputs_embeds = L.embed_with_injection(params["llm"], batch["input_ids"],
                                           positions, embeds)
    hidden = L.forward_hidden(params["llm"], cfg.llm, inputs_embeds,
                              batch["attention_mask"])
    logits = L.logits_from_hidden(params["llm"], cfg.llm, hidden,
                                  batch.get("special_token_mask"))
    return {"loss": L.causal_lm_loss(logits, batch["labels"],
                                     group=count_group),
            "logits": logits}


def forward_object_grounding(params, cfg: NavModelConfig, batch):
    """Object-grounding logits (twin of forward_object_grounding). batch:
    obj_embeds [B, O, H], obj_loc_fts [B, O, A+3], obj_masks [B, O],
    input_ids / attention_mask [B, T], cand_positions [B, O] (token index of
    the k-th object <cand>), hist_positions [B, Hh], hist_embeds [B, Hh, H],
    cls_pos [B]. Object k (0-based) is option k+1; option 0 is "not exist".
    Returns {"obj_logits": [B, 100] f32}, the options past the row's objects
    at NEG_INF."""
    obj = batch["obj_embeds"] + _pos_mlp(params["obj_pos"],
                                         batch["obj_loc_fts"])
    obj = torch.where(batch["obj_masks"][..., None], obj, _zero(obj))
    b = obj.shape[0]
    positions = torch.cat([batch["cand_positions"], batch["hist_positions"]],
                          dim=1)
    embeds = torch.cat([obj, batch["hist_embeds"]], dim=1)
    inputs_embeds = L.embed_with_injection(params["llm"], batch["input_ids"],
                                           positions, embeds)
    hidden = L.forward_hidden(params["llm"], cfg.llm, inputs_embeds,
                              batch["attention_mask"])
    rows = torch.arange(b, device=hidden.device)
    cls_hidden = hidden[rows, batch["cls_pos"].long()]
    preds = (cls_hidden @ params["out_head"]["w"]
             + params["out_head"]["b"]).float()
    cand_nums = batch["obj_masks"].sum(1) + 1          # + "not exist"
    slot = torch.arange(NUM_CAND_SLOTS, device=preds.device)[None, :]
    return {"obj_logits": torch.where(
        slot < cand_nums[:, None], preds,
        torch.full((), NEG_INF, device=preds.device))}


def navigation_loss(fuse_logits, targets, ignore_id: int = -100,
                    reduction: str = "sum"):
    """CE over gmap slots with ignore labels (twin of navigation_loss):
    summed over the batch by default, as the reference's criterion."""
    valid = targets != ignore_id
    logp = torch.log_softmax(fuse_logits, dim=-1)
    nll = -logp.gather(-1, targets.clamp(min=0).long()[:, None])[:, 0]
    total = torch.where(valid, nll, torch.zeros((), device=nll.device)).sum()
    if reduction == "mean":
        return total / valid.sum().clamp(min=1)
    return total


class NavModel(ParamTree):
    """All navigation weights under the JAX names: ``llm`` (a Llama),
    ``pano`` (the panorama encoder's tree), and the fusion/head tables."""

    def __init__(self, cfg: NavModelConfig, params: Dict[str, Any]):
        super().__init__({k: v for k, v in params.items() if k != "llm"})
        self.cfg = cfg
        self.llm = L.Llama(cfg.llm, params["llm"])

    def forward(self, batch: Dict[str, Any]):
        return forward_navigation(self, self.cfg, batch)
