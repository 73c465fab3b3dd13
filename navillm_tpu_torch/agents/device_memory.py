"""Device-resident rollout memory and the fused eval step.

Torch twin of navillm_tpu/agents/device_memory.py (uncached path). Per
episode slot the device keeps
  mem_sum [B, M, H], mem_cnt [B, M] — mean-pooled node embeddings keyed
      by the episode graph's stable node index;
  hist_buf [B, Hh, H], hist_cnt [B]  — history (chosen fuse embeds).
Memory stays f32. The functions return new state dicts (nothing is
updated in place), as in JAX.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import nav_model as NM
from ..models.pano_encoder import forward_panorama

State = Dict[str, torch.Tensor]


def init_memory(batch: int, capacity: int, hist: int, hidden: int, dtype,
                device=None) -> State:
    return {
        "mem_sum": torch.zeros((batch, capacity, hidden), dtype=dtype,
                               device=device),
        "mem_cnt": torch.zeros((batch, capacity), dtype=torch.int32,
                               device=device),
        "hist_buf": torch.zeros((batch, hist, hidden), dtype=dtype,
                                device=device),
        "hist_cnt": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def memory_update(state: State, pano_embeds, pano_masks, cur_ids, cand_ids
                  ) -> State:
    """cur_ids [B] (node id of the current viewpoint, -1 = skip);
    cand_ids [B, V] (node id view j accumulates into, -1 = none)."""
    mem_sum, mem_cnt = state["mem_sum"], state["mem_cnt"]
    b = mem_sum.shape[0]
    bidx = torch.arange(b, device=mem_sum.device)

    denom = pano_masks.sum(1, keepdim=True).clamp(min=1)
    avg = (pano_embeds * pano_masks[..., None]).sum(1) / denom      # [B, H]
    cur_valid = cur_ids >= 0
    cur_safe = cur_ids.clamp(min=0).long()
    # rewrite semantics: sum <- avg, cnt <- 1 (only where valid)
    new_sum = mem_sum.index_put(
        (bidx, cur_safe),
        torch.where(cur_valid[:, None], avg.to(mem_sum.dtype),
                    mem_sum[bidx, cur_safe]))
    new_cnt = mem_cnt.index_put(
        (bidx, cur_safe),
        torch.where(cur_valid, torch.ones_like(cur_ids, dtype=torch.int32),
                    mem_cnt[bidx, cur_safe]))

    cvalid = cand_ids >= 0
    csafe = cand_ids.clamp(min=0).long()
    bgrid = bidx[:, None].expand_as(csafe)
    upd = torch.where(cvalid[..., None], pano_embeds.to(mem_sum.dtype),
                      torch.zeros((), dtype=mem_sum.dtype,
                                  device=mem_sum.device))
    new_sum = new_sum.index_put((bgrid, csafe), upd, accumulate=True)
    new_cnt = new_cnt.index_put((bgrid, csafe), cvalid.int(), accumulate=True)
    return {**state, "mem_sum": new_sum, "mem_cnt": new_cnt}


def assemble_from_memory(state: State, slot_ids, pano_embeds):
    """slot_ids [B, G] (node id per gmap slot, -1 empty) -> gmap_img_embeds
    [B, G, H] f32; pano_embeds [B, V, H] -> vp_img_embeds [B, V+1, H]
    with a zero stop row."""
    mem_sum, mem_cnt = state["mem_sum"], state["mem_cnt"]
    b = slot_ids.shape[0]
    safe = slot_ids.clamp(min=0).long()
    bidx = torch.arange(b, device=safe.device)[:, None].expand_as(safe)
    cnt = mem_cnt[bidx, safe].clamp(min=1)[..., None]
    gmap = torch.where((slot_ids >= 0)[..., None], mem_sum[bidx, safe] / cnt,
                       torch.zeros((), device=safe.device)).float()
    stop = pano_embeds.new_zeros((b, 1, pano_embeds.shape[-1]))
    return gmap, torch.cat([stop, pano_embeds], dim=1)


def hist_append(state: State, fuse_embeds, a_t) -> State:
    """Append fuse_embeds[b, a_t[b]] at hist_cnt[b] (skip where a_t < 0)."""
    hist_buf, hist_cnt = state["hist_buf"], state["hist_cnt"]
    b, hh, _ = hist_buf.shape
    bidx = torch.arange(b, device=hist_buf.device)
    valid = a_t >= 0
    slot = hist_cnt.clamp(max=hh - 1).long()
    chosen = fuse_embeds[bidx, a_t.clamp(min=0).long()]
    new_buf = hist_buf.index_put(
        (bidx, slot), torch.where(valid[:, None], chosen.to(hist_buf.dtype),
                                  hist_buf[bidx, slot]))
    return {**state, "hist_buf": new_buf,
            "hist_cnt": hist_cnt + valid.int()}


def reset_slots(state: State, reset_mask) -> State:
    """Zero the memory of refilled slots (reset_mask [B] bool)."""
    z = reset_mask

    def zero(x, mask):
        return torch.where(mask, torch.zeros((), dtype=x.dtype,
                                             device=x.device), x)

    return {"mem_sum": zero(state["mem_sum"], z[:, None, None]),
            "mem_cnt": zero(state["mem_cnt"], z[:, None]),
            "hist_buf": zero(state["hist_buf"], z[:, None, None]),
            "hist_cnt": zero(state["hist_cnt"], z)}


def nav_step_from_memory(params, cfg, state: State, batch, pano_embeds):
    """Assemble gmap/vp/hist embeddings from memory and run
    forward_navigation. Returns (fuse_logits [B, G], fuse_embeds)."""
    gmap, vp = assemble_from_memory(state, batch["slot_ids"], pano_embeds)
    full = dict(batch)
    full["gmap_img_embeds"] = gmap
    full["vp_img_embeds"] = vp
    full["hist_embeds"] = state["hist_buf"]
    out = NM.forward_navigation(params, cfg, full)
    return out["fuse_logits"], out["fuse_embeds"]


def eval_step(params, cfg, state: State, pano_in, batch, reset_mask, cur_ids,
              cand_ids, active_mask, a_t_override):
    """ONE fused greedy evaluation step: reset refilled slots -> panorama ->
    memory update -> navigation forward -> argmax -> history append.
    a_t_override [B]: force the action for rows >= 0.
    Returns (new_state, a_t [B] int32, logits [B, G] f32)."""
    state = reset_slots(state, reset_mask)
    po = forward_panorama(params["pano"], cfg.pano, pano_in["view_img_fts"],
                          pano_in["view_lens"], loc_fts=pano_in["loc_fts"],
                          nav_types=pano_in["nav_types"])
    pano_embeds, pano_masks = po["pano_embeds"], po["pano_masks"]
    state = memory_update(state, pano_embeds, pano_masks, cur_ids, cand_ids)
    logits, fuse = nav_step_from_memory(params, cfg, state, batch,
                                        pano_embeds)
    a_t = logits.argmax(-1).int()        # first maximum, as jnp.argmax
    a_t = torch.where(a_t_override >= 0, a_t_override.int(), a_t)
    state = hist_append(state, fuse,
                        torch.where(active_mask, a_t, torch.full_like(a_t, -1)))
    return state, a_t, logits
