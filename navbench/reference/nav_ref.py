"""The plain reference of the navigation model's evaluation step.

Plain PyTorch in float32 (TF32 off on the card), written from the model's
equations: the panorama encoder (view and location projections with
LayerNorm, the navigation-type embedding, pre-norm transformer layers with
exact GELU, the mapper to the LLM's width), the graph memory (a node's
embedding is the mean of its views, refreshed at the current node and
accumulated from candidate views), the global/local fusion (step and
position embeddings, the local views added to their graph slots, token
types), the LLM (LLaMA's equations: RMSNorm, rotary positions in the
half-rotation convention, causal grouped-query attention, SwiGLU), and
the navigation head over the candidate slots. It imports nothing of the
program and takes nothing the program made: it reads the weight tree the
benchmark drew from the seed, and the program's per-step host inputs of
the episodes it checks.

``precision="fp8"`` is the control: every matrix product takes its
inputs rounded to float8 e4m3 (weights per output column, activations per
row, each scaled to the format's largest value), the step that would
tempt a later change below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

NEG = -1e30
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [..., K] @ w [K, N] in f32, or with both rounded to fp8 first."""
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def layer_norm(x, s, b, eps=1e-12):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * s.float() + b.float()


def linear(x, p, precision):
    return mm(x, p["w"], precision) + p["b"].float()


# ------------------------------------------------------------- panorama
def panorama(P: Dict, cfg: Dict, views, view_lens, loc_fts, nav_types,
             precision: str = "f32"):
    """views [N, V, D] f32, view_lens [N], loc_fts [N, V, 7], nav_types
    [N, V] -> (embeds [N, V, H] zero past each row's views, masks)."""
    pc = cfg["panorama"]
    n, v, _ = views.shape
    mask = torch.arange(v, device=views.device)[None, :] < view_lens[:, None]
    x = layer_norm(linear(views, P["img_linear"], precision),
                   P["img_ln"]["s"], P["img_ln"]["b"])
    x = x + layer_norm(linear(loc_fts, P["loc_linear"], precision),
                       P["loc_ln"]["s"], P["loc_ln"]["b"])
    x = x + P["nav_type_emb"].float()[nav_types.long()]
    x = layer_norm(x, P["ln"]["s"], P["ln"]["b"])
    enc = P.get("encoder")
    if enc is not None:
        nh = pc["num_attention_heads"]
        d = pc["hidden_size"] // nh
        for i in range(enc["qkv"]["w"].shape[0]):
            y = layer_norm(x, enc["ln1"]["s"][i], enc["ln1"]["b"][i])
            qkv = mm(y, enc["qkv"]["w"][i], precision) + enc["qkv"]["b"][i]
            q, k, vv = (t.reshape(n, v, nh, d).transpose(1, 2)
                        for t in qkv.chunk(3, dim=-1))
            sc = q @ k.transpose(-1, -2) / math.sqrt(d)
            sc = sc.masked_fill(~mask[:, None, None, :], NEG)
            o = (torch.softmax(sc, -1) @ vv).transpose(1, 2).reshape(n, v, -1)
            x = x + mm(o, enc["out"]["w"][i], precision) + enc["out"]["b"][i]
            y = layer_norm(x, enc["ln2"]["s"][i], enc["ln2"]["b"][i])
            y = F.gelu(mm(y, enc["ffn1"]["w"][i], precision)
                       + enc["ffn1"]["b"][i])
            x = x + mm(y, enc["ffn2"]["w"][i], precision) + enc["ffn2"]["b"][i]
        x = layer_norm(x, P["encoder_norm"]["s"], P["encoder_norm"]["b"])
    x = linear(x, P["mapper"], precision)
    return torch.where(mask[..., None], x, torch.zeros((), device=x.device)), \
        mask


def _pos_mlp(p, x, precision):
    return layer_norm(linear(x, p, precision), p["ln_s"], p["ln_b"])


# --------------------------------------------------------- graph memory
def episode_inputs(Wt: Dict, cfg: Dict, steps: Sequence[Dict], device,
                   precision: str = "f32") -> List[Dict]:
    """Replay one episode's graph memory, fusion and history. ``steps``:
    the program's host inputs of each step of the episode (one row each)
    and the action it took. Returns per step the candidate embeddings in
    prompt order [C, H], the history embeddings [n_hist, H], the
    candidate mask over the graph slots [G] and cand_order [C]."""
    h = cfg["hidden_size"]

    def t(x, dtype=None):
        return torch.as_tensor(x, device=device, dtype=dtype)

    views = torch.stack([t(s["view_img_fts"], torch.float32) for s in steps])
    pe, pm = panorama(Wt["pano"], cfg, views,
                      t([int(s["view_lens"]) for s in steps]),
                      torch.stack([t(s["loc_fts"], torch.float32)
                                   for s in steps]),
                      torch.stack([t(s["nav_types"]) for s in steps]),
                      precision)
    mem_sum: Dict[int, torch.Tensor] = {}
    mem_cnt: Dict[int, int] = {}
    hist: List[torch.Tensor] = []
    out = []
    for k, s in enumerate(steps):
        emb, m = pe[k], pm[k]
        avg = (emb * m[:, None]).sum(0) / m.sum().clamp(min=1)
        cur = int(s["cur_ids"])
        if cur >= 0:
            mem_sum[cur], mem_cnt[cur] = avg, 1
        for j, node in enumerate(s["cand_ids"]):
            node = int(node)
            if node >= 0:
                mem_sum[node] = mem_sum.get(node, torch.zeros(
                    h, device=device)) + emb[j]
                mem_cnt[node] = mem_cnt.get(node, 0) + 1
        slot_ids = s["slot_ids"]
        g = len(slot_ids)
        gmap = torch.zeros(g, h, device=device)
        for j, node in enumerate(slot_ids):
            node = int(node)
            if node >= 0 and node in mem_sum:
                gmap[j] = mem_sum[node] / max(mem_cnt[node], 1)
        gmask = t(s["gmap_masks"]).bool()
        visited = t(s["gmap_visited_masks"]).bool()
        gmap = gmap + Wt["gmap_step_emb"][t(s["gmap_step_ids"]).long()] \
            + _pos_mlp(Wt["gmap_pos"], t(s["gmap_pos_fts"], torch.float32),
                       precision)
        zero_out = visited | ~gmask
        gmap = torch.where(zero_out[:, None], 0.0, gmap)
        vp = torch.cat([torch.zeros(1, h, device=device), emb], 0)
        vp = vp + _pos_mlp(Wt["vp_pos"], t(s["vp_pos_fts"], torch.float32),
                           precision)
        vp = torch.where(t(s["pano_masks"]).bool()[:, None], vp, 0.0)
        fuse = gmap.clone()
        matched = torch.zeros(g, dtype=torch.bool, device=device)
        for j, slot in enumerate(s["local_match_slot"]):
            slot = int(slot)
            if slot >= 0:
                fuse[slot] = fuse[slot] + vp[j]
                matched[slot] = True
        ttype = ((torch.arange(g, device=device) > 0) & gmask & ~visited
                 & ~matched).long()
        fuse = fuse + Wt["token_type_emb"][ttype]
        fuse = torch.where(zero_out[:, None], 0.0, fuse)
        order = [int(o) for o in s["cand_order"]]
        cand = torch.stack([fuse[o] if o >= 0 else torch.zeros(
            h, device=device) for o in order])
        out.append({"cand_embeds": cand,
                    "hist_embeds": (torch.stack(hist) if hist else
                                    torch.zeros(0, h, device=device)),
                    "cand_mask": gmask & ~visited, "cand_order": order})
        hist.append(fuse[int(s["a_t"])])
    return out


# ------------------------------------------------------------------ LLM
def rope(x, pos, theta):
    """x [N, T, heads, D], pos [N, T]: LLaMA's half-rotation."""
    d2 = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(d2, device=x.device,
                                        dtype=torch.float32) / d2))
    ang = pos[..., None].float() * inv
    c, s = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def llm_cls_hidden(L: Dict, cfg: Dict, seqs: List[Dict], device,
                   precision: str = "f32", block: int = 16) -> torch.Tensor:
    """seqs: {"ids" [n] (the prompt's tokens, no padding), "inject"
    [(token index, [H] f32)] added to those tokens' embeddings, "cls"
    (the token whose final hidden state the head reads)} -> [N, H]: the
    final-norm hidden state at each sequence's cls token. Layer by layer
    over blocks of sequences, one layer's weights in f32 at a time."""
    h, nh, nkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    d, eps, theta = h // nh, float(cfg["rms_norm_eps"]), float(
        cfg["rope_theta"])
    n_layers = cfg["num_hidden_layers"]
    lens = [len(s["ids"]) for s in seqs]
    xs = []
    for s in seqs:
        ids = torch.as_tensor(s["ids"], device=device).long()
        x = L["embed"][ids].float()
        for pos, vec in s["inject"]:
            x[pos] = x[pos] + vec
        xs.append(x)
    blocks = [list(range(i, min(i + block, len(seqs))))
              for i in range(0, len(seqs), block)]
    hidden = []
    for idx in blocks:
        tmax = max(lens[i] for i in idx)
        x = torch.zeros(len(idx), tmax, h, device=device)
        valid = torch.zeros(len(idx), tmax, dtype=torch.bool, device=device)
        for r, i in enumerate(idx):
            x[r, :lens[i]] = xs[i]
            valid[r, :lens[i]] = True
        hidden.append((idx, x, valid))
    lay = L["layers"]
    for li in range(n_layers):
        wl = {k: lay[k][li].float() for k in ("wq", "wk", "wv", "wo",
                                              "w_gate", "w_up", "w_down",
                                              "attn_norm", "mlp_norm")}
        for bi, (idx, x, valid) in enumerate(hidden):
            b, t, _ = x.shape
            pos = torch.arange(t, device=device)[None, :].expand(b, t)
            y = rms_norm(x, wl["attn_norm"], eps)
            q = rope(mm(y, wl["wq"], precision).reshape(b, t, nh, d), pos,
                     theta)
            k = rope(mm(y, wl["wk"], precision).reshape(b, t, nkv, d), pos,
                     theta)
            v = mm(y, wl["wv"], precision).reshape(b, t, nkv, d)
            rep = nh // nkv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
            allow = torch.ones(t, t, dtype=torch.bool,
                               device=device).tril()[None, None] \
                & valid[:, None, None, :]
            sc = sc.masked_fill(~allow, NEG)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
            x = x + mm(o.reshape(b, t, h), wl["wo"], precision)
            y = rms_norm(x, wl["mlp_norm"], eps)
            y = F.silu(mm(y, wl["w_gate"], precision)) \
                * mm(y, wl["w_up"], precision)
            x = x + mm(y, wl["w_down"], precision)
            hidden[bi] = (idx, x, valid)
        del wl
    out = torch.zeros(len(seqs), h, device=device)
    for idx, x, _ in hidden:
        for r, i in enumerate(idx):
            out[i] = rms_norm(x[r, seqs[i]["cls"]], L["final_norm"], eps)
    return out


def head_logits(Wt: Dict, cls_hidden, cand_order, cand_mask,
                precision: str = "f32"):
    """[H] -> logits over the graph slots [G]: slot 0 (stop) reads the
    head's slot 0; the k-th candidate in prompt order reads slot k + 1;
    slots that are no candidate are NEG."""
    preds = mm(cls_hidden[None], Wt["out_head"]["w"], precision)[0] \
        + Wt["out_head"]["b"].float()
    g = cand_mask.shape[0]
    logits = torch.full((g,), NEG, device=preds.device)
    logits[0] = preds[0]
    for k, o in enumerate(cand_order):
        if o >= 0:
            logits[o] = torch.maximum(logits[o], preds[k + 1])
    return torch.where(cand_mask, logits, torch.full_like(logits, NEG))
