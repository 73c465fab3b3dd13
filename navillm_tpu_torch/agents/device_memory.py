"""Device-resident rollout memory, the fused eval steps and the prefix cache.

Torch twin of navillm_tpu/agents/device_memory.py (the greedy eval step,
uncached and prefix-cached), and of the body of the fused trainer's
scanned replay (``replay_fuse``). Per episode slot the device keeps
  mem_sum [B, M, H], mem_cnt [B, M] — mean-pooled node embeddings keyed
      by the episode graph's stable node index;
  hist_buf [B, Hh, H], hist_cnt [B]  — history (chosen fuse embeds);
and, on the cached path, a prompt-prefix KV cache per slot group
(``init_prefix_cache``). Memory stays f32. The memory functions return
new state dicts, as in JAX; the prefix cache is updated in place
(``prefill_prefix``, ``eval_step_cached``): each slot group owns its
cache, and the card runs one stream in order.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import llama as L
from ..models import nav_model as NM
from ..models.pano_encoder import forward_panorama
from ..ops.masking import NEG_INF

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


def init_prefix_cache(llm_cfg, batch: int, max_prefix: int,
                      kv_int8: bool = False, device=None):
    """Per-slot ragged prompt-prefix KV cache: {"pkv_k", "pkv_v"} [L, B,
    max_prefix, NKV, D] in the LLM's dtype, and "plen" [B] int32 (each
    row's valid prefix length). The instruction and history part of the
    navigation prompt is append-only within an episode, so each step
    forwards only the new history tokens and the candidates section."""
    if kv_int8:
        raise NotImplementedError("the int8 prefix cache (kv_int8) is not "
                                  "ported yet (ROADMAP A9)")
    shape = (llm_cfg.num_layers, batch, max_prefix, llm_cfg.num_kv_heads,
             llm_cfg.head_dim)
    return {"plen": torch.zeros((batch,), dtype=torch.int32, device=device),
            "pkv_k": torch.zeros(shape, dtype=llm_cfg.dtype, device=device),
            "pkv_v": torch.zeros(shape, dtype=llm_cfg.dtype, device=device)}


def _cache_kv_view(cache):
    """The {"k", "v"} view llama.chunk_forward_cached takes."""
    return {"k": cache["pkv_k"], "v": cache["pkv_v"]}


def _cache_from_kv(kv, plen):
    return {"pkv_k": kv["k"], "pkv_v": kv["v"], "plen": plen}


def prefill_prefix(params, llm_cfg, cache, ids, mask, rows, valid):
    """Prefill refilled rows' instruction prefixes into the cache, in place.

    ids [Bp, Pw] right-padded; mask [Bp, Pw]; rows [Bp] target cache rows,
    ALL DISTINCT (the host points padding entries at rows it is not
    prefilling, with valid[i] False: entry i then writes that row's old
    content back, bit for bit). The prefill is one forward_hidden pass
    (return_kv; causal, through the flash kernel on the card), whose
    padding entries have all-false masks: their rows see no valid key and
    come out finite. Only [:, rows, :Pw] is written; tokens beyond plen
    stay invisible behind the prefix mask whatever they hold. The t=0
    prefix (instruction + history header) holds no special token, so
    nothing is injected. Returns the cache."""
    if "pkv_ks" in cache:
        raise NotImplementedError("the int8 prefix cache (kv_int8) is not "
                                  "ported yet (ROADMAP A9)")
    llm = params["llm"]
    emb = L.embed_with_injection(llm, ids)
    emb = torch.where(mask[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                        device=emb.device))
    _, kv = L.forward_hidden(llm, llm_cfg, emb, mask, return_kv=True)
    p = cache["pkv_k"].shape[2]
    rows = rows.long()
    vmask = valid[None, :, None, None, None]
    for name, new in (("pkv_k", kv["k"][:, :, :p]), ("pkv_v", kv["v"][:, :, :p])):
        buf = cache[name]
        pw = new.shape[2]
        old = buf[:, rows, :pw]
        buf[:, rows, :pw] = torch.where(vmask, new.to(buf.dtype), old)
    plen = cache["plen"]
    plen[rows] = torch.where(valid, mask.sum(1).int(), plen[rows])
    return cache


def eval_step_cached(params, cfg, state: State, cache, pano_in, batch,
                     reset_mask, cur_ids, cand_ids, active_mask,
                     a_t_override):
    """Prefix-cached variant of eval_step (twin of the JAX
    eval_step_cached, greedy): instead of forwarding the whole prompt, one
    merged window [history-append | candidates-suffix] runs against the
    row's cached prefix. The append columns carry this step's new history
    tokens, with hist_buf[b, hist_cnt-1] injected at their <hist> token, at
    positions plen + j, and their K/V are written to the cache at plen;
    the suffix columns carry the candidates section with the fused
    candidate embeds injected, at positions plen + app_len + j, and write
    nothing. Same math as the full forward (causal attention over an
    append-only prefix).

    batch, beyond eval_step's fusion inputs and slot_ids: app_ids /
    app_mask [B, A] (empty on a row's first step), app_hist_pos [B] (the
    window index of its <hist> token, -1 none), suf_ids / suf_mask [B, S],
    suffix-relative cand_positions [B, C] and cls_pos [B]. Refilled rows'
    prefixes are prefilled (prefill_prefix) before this step. The cache is
    updated in place. Returns (state', cache, a_t [B] int32, logits [B, G]
    f32)."""
    state = reset_slots(state, reset_mask)
    b = reset_mask.shape[0]
    llm = params["llm"]
    plen = cache["plen"]
    po = forward_panorama(params["pano"], cfg.pano, pano_in["view_img_fts"],
                          pano_in["view_lens"], loc_fts=pano_in["loc_fts"],
                          nav_types=pano_in["nav_types"])
    pano_embeds, pano_masks = po["pano_embeds"], po["pano_masks"]
    state = memory_update(state, pano_embeds, pano_masks, cur_ids, cand_ids)

    gmap, vp = assemble_from_memory(state, batch["slot_ids"], pano_embeds)
    full = dict(batch)
    full["gmap_img_embeds"] = gmap
    full["vp_img_embeds"] = vp
    fuse, cand_masks = NM.fuse_gmap_local(params, cfg, full)
    g = fuse.shape[1]

    order = batch["cand_order"]
    ovalid = order >= 0
    order_safe = order.clamp(min=0).long()
    rows = torch.arange(b, device=fuse.device)
    bidx = rows[:, None].expand_as(order_safe)
    cand_embeds = torch.where(ovalid[..., None], fuse[bidx, order_safe],
                              NM._zero(fuse))

    pkv = _cache_kv_view(cache)
    pmax = pkv["k"].shape[2]
    prefix_mask = torch.arange(pmax, device=plen.device)[None, :] \
        < plen[:, None]

    def masked(emb, mask):
        return torch.where(mask[..., None], emb, NM._zero(emb))

    app_mask = batch["app_mask"]
    hist_idx = (state["hist_cnt"] - 1).clamp(min=0).long()
    hist_val = state["hist_buf"][rows, hist_idx]                      # [B, H]
    app_emb = masked(L.embed_with_injection(
        llm, batch["app_ids"], batch["app_hist_pos"][:, None],
        hist_val[:, None, :]), app_mask)
    a_w = app_mask.shape[1]
    win = torch.arange(a_w, device=plen.device)[None, :]
    app_len = app_mask.sum(1).int()
    suf_mask = batch["suf_mask"]
    suf_emb = masked(L.embed_with_injection(
        llm, batch["suf_ids"], batch["cand_positions"], cand_embeds),
        suf_mask)
    s_w = suf_mask.shape[1]
    suf_pos = (plen + app_len)[:, None] \
        + torch.arange(s_w, device=plen.device)[None, :]
    win_emb = torch.cat([app_emb, suf_emb], dim=1)
    win_mask = torch.cat([app_mask, suf_mask], dim=1)
    win_pos = torch.cat([plen[:, None] + win, suf_pos], dim=1)
    wmask = torch.cat([app_mask, torch.zeros_like(suf_mask)], dim=1)
    hidden, pkv = L.chunk_forward_cached(
        llm, cfg.llm, win_emb, pkv, prefix_mask, win_mask, win_pos,
        write_offsets=plen, write_mask=wmask)
    plen += app_len

    cls_hidden = hidden[rows, a_w + batch["cls_pos"].long()]
    preds = (cls_hidden @ params["out_head"]["w"]
             + params["out_head"]["b"]).float()
    neg = torch.full((), NEG_INF, device=preds.device)
    logits = torch.full((b, g), NEG_INF, dtype=torch.float32,
                        device=preds.device)
    logits[:, 0] = preds[:, 0]
    upd = torch.where(ovalid, preds[:, 1:1 + order.shape[1]], neg)
    logits = logits.scatter_reduce(1, order_safe, upd, "amax",
                                   include_self=True)
    logits = torch.where(cand_masks, logits, neg)

    a_t = logits.argmax(-1).int()        # first maximum, as jnp.argmax
    a_t = torch.where(a_t_override >= 0, a_t_override.int(), a_t)
    state = hist_append(state, fuse,
                        torch.where(active_mask, a_t, torch.full_like(a_t, -1)))
    return state, _cache_from_kv(pkv, plen), a_t, logits


def replay_fuse(params, cfg, state: State, pe_grid, pm_grid, cur_ids,
                cand_ids, slot_ids, fuse_sts, acts):
    """Replay a trajectory batch on the device, step by step (twin of the
    runner's scanned replay_fuse_scan_fn): memory update -> gmap/vp
    assembly -> graph/local fusion -> history append.

    pe_grid [T, B, V, H]; pm_grid [T, B, V]; cur_ids [T, B]; cand_ids
    [T, B, V]; slot_ids [T, B, G]; fuse_sts: dict of [T, B, ...] fusion
    inputs; acts [T, B] (-1 = no history append). Returns (gmap_seq
    [T, B, G, H], hist_seq [T, B, Hh, H], final_state), hist_seq[t] being
    the history before step t's append. Nothing here is differentiated:
    graph memory and history are detached inputs of the loss pass."""
    gmaps, hists = [], []
    for t in range(pe_grid.shape[0]):
        state = memory_update(state, pe_grid[t], pm_grid[t], cur_ids[t],
                              cand_ids[t])
        gmap, vp = assemble_from_memory(state, slot_ids[t], pe_grid[t])
        full = {k: v[t] for k, v in fuse_sts.items()}
        full["gmap_img_embeds"] = gmap
        full["vp_img_embeds"] = vp
        fuse, _ = NM.fuse_gmap_local(params, cfg, full)
        gmaps.append(gmap)
        hists.append(state["hist_buf"])
        state = hist_append(state, fuse, acts[t])
    return torch.stack(gmaps), torch.stack(hists), state
