"""The comparison that decides ``correct`` for the evaluation cells.

Plain PyTorch and numpy; imports nothing of the program. It checks the
episodes the benchmark kept from the timed path (the host inputs and the
logits of every step of a sample of episodes), and the trajectories the
run returned:

- ``logit_err``: the reference (``nav_ref``) recomputes each kept step's
  logits over the graph slots from the episode's start (panorama, graph
  memory, fusion, the whole prompt through the LLM, the head), with the
  program's own actions taken as the served ones; the number is the
  largest gap between a program logit and the reference's, over every
  valid slot of every kept step, as a share of the reference logits' RMS
  over all of them. Where the program streamed on the prefix cache, the
  prompt is its cached prefix, then every append window, then the step's
  suffix, as one causal sequence (the same tokens at the same positions).
- ``action_gap``: the widest gap by which the logit the reference gives
  the program's chosen slot lies below the reference's best, over the kept
  steps, as a share of the same RMS: a greedy action altered where it is
  produced shows here.
- ``masks_differ``: slots that one side counts a candidate and the other
  does not (exact: 0).
- ``views_wrong``: kept steps whose panorama rows are not the 36 views of
  one viewpoint of the feature file, each once (exact: 0). It checks the
  HDF5 read and the panorama's assembly, which the reference takes as
  given.
- ``prompts_wrong``: kept steps whose prompt does not hold one <hist> per
  step taken, one <cls> and at most ``max_cands`` <cand> (exact: 0).
- ``paths_wrong``: returned trajectories that do not start at their
  episode's start or step between viewpoints that are not neighbouring
  cells of the scan's grid, 8-connected (exact: 0).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import nav_ref as R


def view_index(feats: Dict[str, np.ndarray]) -> Dict[bytes, tuple]:
    out = {}
    for key, block in feats.items():
        for vi in range(block.shape[0]):
            out[block[vi].tobytes()] = (key, vi)
    return out


def views_ok(cap: Dict, index: Dict[bytes, tuple], n_views: int = 36
             ) -> bool:
    rows = cap["view_img_fts"]
    n = int(cap["view_lens"])
    if rows is None:
        return False
    hits = [index.get(np.ascontiguousarray(rows[k]).tobytes())
            for k in range(n)]
    if any(h is None for h in hits):
        return False
    keys = {h[0] for h in hits}
    return len(keys) == 1 and sorted(h[1] for h in hits) == list(
        range(n_views))


def prompt_of(cap: Dict, prefix, apps: List[np.ndarray], cached: bool):
    """The ids of one step's prompt, unpadded; on the cached path the
    prefix, every append window so far (this step's included) and the
    suffix."""
    if not cached:
        mask = np.asarray(cap["attention_mask"]).astype(bool)
        return np.asarray(cap["input_ids"])[mask]
    suf = np.asarray(cap["suf_ids"])[np.asarray(cap["suf_mask"]).astype(bool)]
    return np.concatenate([prefix] + apps + [suf])


def sequences(Wt, cfg, ep: Dict, special: Dict, cached: bool, device,
              precision: str):
    """The reference's inputs of every step of one episode, and the
    prompt checks."""
    steps = ep["steps"]
    emb = R.episode_inputs(Wt, cfg, steps, device, precision)
    seqs, wrong = [], 0
    apps: List[np.ndarray] = []
    prefix = ep.get("prefix")
    if cached and prefix is None:
        return [], len(steps)
    for k, (cap, e) in enumerate(zip(steps, emb)):
        if cached:
            apps.append(np.asarray(cap["app_ids"])[
                np.asarray(cap["app_mask"]).astype(bool)])
        ids = prompt_of(cap, prefix, apps, cached)
        cand = np.nonzero(ids == special["cand"])[0]
        hist = np.nonzero(ids == special["hist"])[0]
        cls = np.nonzero(ids == special["cls"])[0]
        if len(hist) != k or len(cls) != 1 \
                or len(cand) > len(e["cand_order"]):
            wrong += 1
        inject = [(int(p), e["cand_embeds"][j]) for j, p in enumerate(cand)
                  if j < len(e["cand_order"])]
        inject += [(int(p), e["hist_embeds"][j]) for j, p in enumerate(hist)
                   if j < e["hist_embeds"].shape[0]]
        seqs.append({"ids": ids, "inject": inject,
                     "cls": int(cls[-1]) if len(cls) else len(ids) - 1,
                     "mask": e["cand_mask"], "order": e["cand_order"],
                     "got": cap["logits"], "a_t": int(cap["a_t"])})
    return seqs, wrong


def reference_logits(Wt, cfg, episodes, special, cached, device,
                     precision="f32"):
    """(the reference's logits per kept step [G], the program's, the
    count of steps whose prompt is wrong)."""
    seqs, wrong = [], 0
    for ep in episodes:
        s, w = sequences(Wt, cfg, ep, special, cached, device, precision)
        seqs += s
        wrong += w
    if not seqs:
        return [], [], wrong, []
    hid = R.llm_cls_hidden(Wt["llm"], cfg, seqs, device, precision)
    refs = [R.head_logits(Wt, hid[i], s["order"], s["mask"], precision)
            for i, s in enumerate(seqs)]
    gots = [s["got"] for s in seqs]
    acts = [s["a_t"] for s in seqs]
    return refs, gots, wrong, acts


def logit_gap(refs, gots, acts=None) -> Dict[str, float]:
    """logit_err (largest |got - ref| over both sides' valid slots, over
    the RMS of the reference's valid logits), action_gap (with the served
    actions ``acts``: the largest ref[best] - ref[served], over the same
    RMS) and masks_differ."""
    num, den, cnt, differ, gap = 0.0, 0.0, 0, 0, 0.0
    for k, (ref, got) in enumerate(zip(refs, gots)):
        ref = ref.detach().double().cpu()
        got = torch.as_tensor(got).detach().double().cpu()
        rv = ref > R.NEG / 2
        gv = got > R.NEG / 2
        differ += int((rv != gv).sum())
        both = rv & gv
        if both.any():
            num = max(num, float((got[both] - ref[both]).abs().max()))
            den += float((ref[both] ** 2).sum())
            cnt += int(both.sum())
        if acts is not None:
            a = acts[k]
            served = float(ref[a]) if 0 <= a < len(ref) and rv[a] \
                else -float("inf")
            gap = max(gap, float(ref[rv].max()) - served)
    rms = (den / cnt) ** 0.5 if cnt else 0.0
    out = {"logit_err": num / rms if rms > 0 else float("inf"),
           "masks_differ": differ, "compared": cnt}
    if acts is not None:
        out["action_gap"] = gap / rms if rms > 0 else float("inf")
    return out


def grid_neighbours(a: str, b: str) -> bool:
    ra, ca = (int(x) for x in a.split("_")[1:3])
    rb, cb = (int(x) for x in b.split("_")[1:3])
    return max(abs(ra - rb), abs(ca - cb)) == 1


def paths_wrong(preds: Sequence[Dict], starts: Dict[str, str]) -> int:
    bad = 0
    for p in preds:
        traj = [vp for step in p["trajectory"] for vp in step] \
            if p["trajectory"] and isinstance(p["trajectory"][0], list) \
            else list(p["trajectory"])
        if not traj or traj[0] != starts.get(p["instr_id"]):
            bad += 1
            continue
        if any(not grid_neighbours(a, b) for a, b in zip(traj, traj[1:])
               if a != b):
            bad += 1
    return bad
