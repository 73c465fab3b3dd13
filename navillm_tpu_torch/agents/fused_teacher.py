"""Fused whole-trajectory teacher forcing: one grad chain per trajectory batch.

Torch twin of navillm_tpu/agents/fused_teacher.py on its device-memory
path (``use_dev=True``) for the teacher half. Under teacher forcing the
whole trajectory is known before any model call, and the history
embeddings fed to the LLM are the pre-LLM graph-fusion embeddings, so:

  1. host: simulate every step of the expert trajectory, recording
     per-step snapshots (nothing in them depends on a model output);
  2. device: panorama over the live (episode, step) rows in fixed-width
     chunks, each chunk with its own dropout seed;
  3. host: the index arrays (current node, candidate nodes, gmap slots)
     that drive the replay;
  4. device: memory replay + fusion + history (runner.replay_fuse_scan);
  5. host prompts + device grad calls in chunks of fused_rows_per_call
     rows, each recomputing its chunk's panorama with the same seed, so
     the replayed embeddings and the differentiated ones agree.

Rows of episodes that already ended are dropped (row compaction): their
targets are ignoreid, so they add nothing to the loss or the gradient.
The losses stay device scalars; train_loop reads them one step later.

Not ported here: the DAgger half (``rollout_dagger_fused``), the host-
memory path, the sub-task heads (object grounding, FGR2R, summarization),
and the G_eff high-water mark of the JAX code: the gmap width keeps the
bucket of 16 (its extra columns are masked).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .graph_map import GraphMap
from .mp3d_agent import CLS_TOKEN_TEXT
from .runner import MEM_CAPACITY


def rollout_teacher_fused(agent, args, name, optim_cfg, batch_dict, dataset,
                          train_ml):
    """Teacher-forcing rollout + fused loss pass over one batch. Returns
    (loss as a device scalar, trajectories)."""
    obs = list(batch_dict["observations"])
    envs = batch_dict["env"]
    items = batch_dict["item"]
    data_type = batch_dict["data_type"]
    if args.enable_og or args.enable_summarize or args.enable_fgr2r \
            or any(d != "r2r" for d in data_type):
        raise NotImplementedError(
            "the fused trainer's sub-task heads (object grounding, FGR2R, "
            "summarization) and non-R2R tasks are not ported")
    B = len(obs)
    max_action_len = optim_cfg.train_max_action_len[name]

    agent.update_scanvp_cands(obs)
    gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
    for i, ob in enumerate(obs):
        gmaps[i].update_graph(ob)
    traj = [{"instr_id": ob["instr_id"], "path": [[ob["viewpoint"]]],
             "details": {}} for ob in obs]
    instructions = [ob["instruction"] for ob in obs]

    # ---------------- phase 1: host trajectory simulation ----------------
    steps: List[Dict[str, Any]] = []
    ended = np.zeros(B, bool)
    t = 0
    while t < max_action_len:
        flag = bool(ended.all() or t == max_action_len - 1)
        for i, gmap in enumerate(gmaps):
            if not ended[i]:
                gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1
        pano_inputs = agent.panorama_inputs(obs)
        gmap_in = agent.nav_gmap_inputs(obs, gmaps)
        nav_targets = agent.teacher_action(
            obs, gmap_in["gmap_vpids"], ended,
            visited_masks=gmap_in["gmap_visited_masks"],
            imitation_learning=True, t=t)
        steps.append({"t": t, "obs": list(obs), "ended": ended.copy(),
                      "pano_inputs": pano_inputs, "gmap_in": gmap_in,
                      "targets": nav_targets,
                      "gmap_vpids": gmap_in["gmap_vpids"]})

        a_t_stop = [ob["viewpoint"] == ob["gt_path"][-1] for ob in obs]
        cpu_a_t: List[Optional[str]] = []
        for i in range(B):
            if a_t_stop[i] or ended[i] or gmap_in["no_vp_left"][i] \
                    or t == max_action_len - 1:
                cpu_a_t.append(None)
            else:
                cpu_a_t.append(gmap_in["gmap_vpids"][i][nav_targets[i]])
        agent.make_equiv_action(cpu_a_t, gmaps, obs, traj, envs)
        obs = [dataset.get_obs(items=[items[i]], env=envs[i],
                               data_type=data_type[i])[0] for i in range(B)]
        agent.update_scanvp_cands(obs)
        for i, ob in enumerate(obs):
            if not ended[i]:
                gmaps[i].update_graph(ob)
        ended = np.logical_or(ended, np.array([x is None for x in cpu_a_t]))
        t += 1
        if flag:
            break

    return _fused_trajectory_train(
        agent, args, steps=steps, gmaps=gmaps, traj=traj,
        instructions=instructions, B=B, train_ml=train_ml, loss_den=B,
        t_pad=max_action_len)


def _fused_trajectory_train(agent, args, *, steps, gmaps, traj, instructions,
                            B, train_ml, loss_den, t_pad=None):
    """Phases 2-5 of the fused loss pass on the device-memory path."""
    runner = agent.runner
    T = len(steps)

    # ---------------- phase 2: panorama over the live rows ---------------
    # the view features are already on the device (panorama_inputs uploads
    # them); host members are concatenated and compacted here
    view_all = torch.cat([s["pano_inputs"]["view_img_fts"] for s in steps])
    row_live = np.concatenate([~s["ended"] for s in steps])       # [T*B]
    live_idx = np.nonzero(row_live)[0]
    n_live = len(live_idx)
    compact_of = np.full(T * B, -1, np.int64)
    compact_of[live_idx] = np.arange(n_live)
    pano_host = {k: np.concatenate([s["pano_inputs"][k] for s in steps])
                 [live_idx] for k in ("loc_fts", "nav_types", "view_lens")}
    chunk = int(getattr(args, "fused_rows_per_call", 0) or 0)
    if chunk <= 0:
        chunk = n_live
    bounds = list(range(0, n_live, chunk))

    def chunk_idx(c0):
        """A chunk's rows in the compact order, padded by repeating the
        last live row."""
        return np.minimum(np.arange(c0, c0 + chunk), n_live - 1)

    def chunk_feats(idx):
        feats = {k: v[idx] for k, v in pano_host.items()}
        feats["view_img_fts"] = view_all[runner.upload(live_idx[idx])]
        return feats

    V = steps[0]["pano_inputs"]["view_img_fts"].shape[1]
    seeds = {}
    pe_chunks = []
    for c0 in bounds:
        seeds[c0] = runner.next_seed()
        pe_chunks.append(runner.panorama_dev_dict(
            chunk_feats(chunk_idx(c0)), deterministic=False,
            seed=seeds[c0])["pano_embeds"])
    # masks are index data (arange < view_lens); dead rows read all-False
    pano_masks_all = np.zeros((T, B, V), bool)
    for st_idx, step in enumerate(steps):
        pano_masks_all[st_idx] = (np.arange(V)[None, :]
                                  < step["pano_inputs"]["view_lens"][:, None])
        pano_masks_all[st_idx][~row_live[st_idx * B: (st_idx + 1) * B]] = \
            False

    # ------------- phase 3: index arrays of the device replay ------------
    T_pad = max(t_pad or T, T)
    n_max = max((len(s["gmap_vpids"][i]) for s in steps for i in range(B)),
                default=1)
    G_eff = min(agent.dims.max_gmap_nodes, max(16, -(-n_max // 16) * 16))
    if T_pad > agent.dims.max_hist:
        raise ValueError(f"max_action_len {T_pad} > max_hist "
                         f"{agent.dims.max_hist}: the device history buffer "
                         f"would overwrite its last slot")
    cur_ids_g = np.full((T_pad, B), -1, np.int32)
    cand_ids_g = np.full((T_pad, B, V), -1, np.int32)
    slot_ids_g = np.full((T_pad, B, G_eff), -1, np.int32)
    for st_idx, step in enumerate(steps):
        sobs = step["obs"]
        visited = step["gmap_in"]["gmap_visited_masks"]
        for i in range(B):
            gidx = gmaps[i].graph.index
            vps = step["gmap_vpids"][i]
            if not step["ended"][i]:
                cid = gidx.get(sobs[i]["viewpoint"], -1)
                cur_ids_g[st_idx, i] = cid if cid < MEM_CAPACITY else -1
                for j, cvp in enumerate(step["pano_inputs"]["cand_vpids"][i]):
                    # visited status at this step, from the snapshot
                    if cvp in vps and visited[i][vps.index(cvp)]:
                        continue
                    nid = gidx.get(cvp, -1)
                    if 0 <= nid < MEM_CAPACITY:
                        cand_ids_g[st_idx, i, j] = nid
            for k, vp in enumerate(vps):
                if k > 0 and vp is not None:
                    nid = gidx.get(vp, -1)
                    if 0 <= nid < MEM_CAPACITY:
                        slot_ids_g[st_idx, i, k] = nid
        vp_in = agent.nav_vp_inputs(sobs, gmaps, pano_masks_all[st_idx],
                                    step["pano_inputs"]["cand_vpids"])
        # local matches against the snapshot's visited state (the graph
        # maps have moved on to the end of the trajectory)
        match = np.full((B, vp_in["pano_masks"].shape[1]), -1, np.int32)
        for i in range(B):
            index = {vp: k for k, vp in enumerate(step["gmap_vpids"][i])
                     if vp}
            for j, vp in enumerate(vp_in["vp_cand_vpids"][i]):
                if j > 0 and vp in index and not visited[i][index[vp]]:
                    match[i, j] = index[vp]
        step["vp_in"] = vp_in
        step["match"] = match

    # ------------- phase 4: device replay for gmap and history -----------
    def cat_steps(getter):
        return np.concatenate([getter(s) for s in steps], 0)

    fuse_host = {
        "gmap_step_ids": cat_steps(
            lambda s: s["gmap_in"]["gmap_step_ids"][:, :G_eff]),
        "gmap_pos_fts": cat_steps(
            lambda s: s["gmap_in"]["gmap_pos_fts"][:, :G_eff]),
        "gmap_masks": cat_steps(
            lambda s: s["gmap_in"]["gmap_masks"][:, :G_eff]),
        "gmap_visited_masks": cat_steps(
            lambda s: s["gmap_in"]["gmap_visited_masks"][:, :G_eff]),
        "vp_pos_fts": cat_steps(lambda s: s["vp_in"]["vp_pos_fts"]),
        "pano_masks": cat_steps(lambda s: s["vp_in"]["pano_masks"]),
        "local_match_slot": cat_steps(lambda s: s["match"]),
    }
    # history bookkeeping is host arithmetic; the values stay on the device
    hist_counts = np.zeros((T, B), np.int32)
    acts_g = np.full((T_pad, B), -1, np.int32)
    cnt = np.zeros(B, np.int32)
    for st_idx, step in enumerate(steps):
        hist_counts[st_idx] = cnt
        for i in range(B):
            a = int(step["targets"][i])
            if a != args.ignoreid and compact_of[st_idx * B + i] >= 0:
                acts_g[st_idx, i] = a
                cnt[i] += 1
    # full fixed-width chunks; padding rows scatter into the trash row
    rows_full = np.full(len(pe_chunks) * chunk, T_pad * B, np.int64)
    rows_full[:n_live] = live_idx

    def stack_pad(flat):
        a = flat.reshape((T, B) + flat.shape[1:])
        pad = np.zeros((T_pad - T, B) + flat.shape[1:], a.dtype)
        return np.concatenate([a, pad], 0)

    pm_grid = np.zeros((T_pad, B, V), bool)
    pm_grid[:T] = pano_masks_all
    gmap_flat, hist_flat, _ = runner.replay_fuse_scan(
        pe_chunks, rows_full, T_pad, pm_grid, cur_ids_g, cand_ids_g,
        slot_ids_g, {k: stack_pad(v) for k, v in fuse_host.items()}, acts_g)

    # ------------- phase 5: prompts and the grad calls -------------------
    prompts, orders = [], []
    C = agent.dims.max_cands
    for st_idx, step in enumerate(steps):
        visited = step["gmap_in"]["gmap_visited_masks"]
        for i in range(B):
            if compact_of[st_idx * B + i] < 0:
                continue
            slots = [k for k, vp in enumerate(step["gmap_vpids"][i])
                     if k > 0 and vp is not None and not visited[i][k]]
            perm = agent.np_rng.permutation(slots)[:C]
            row = np.full(C, -1, np.int32)
            row[: len(perm)] = perm
            orders.append(row)
            prompts.append(agent.get_prompt(
                "navigation", instruction=instructions[i],
                hist_num=int(hist_counts[st_idx, i]),
                cand_num=min(len(slots) + 1, C + 1),
                cls_token=CLS_TOKEN_TEXT))
    tok_batch, cand_pos, hist_pos, cls_pos = \
        runner.tokenize_with_positions(prompts)
    nav_batch = {k: v[live_idx] for k, v in fuse_host.items()}
    nav_batch.update({"cand_order": np.stack(orders),
                      "cand_positions": cand_pos,
                      "hist_positions": hist_pos,
                      "input_ids": tok_batch.input_ids,
                      "attention_mask": tok_batch.attention_mask,
                      "cls_pos": cls_pos})
    targets = np.concatenate([s["targets"] for s in steps], 0)[live_idx]
    coef = train_ml / loss_den / args.gradient_accumulation_step
    ml_loss = 0.0
    for c0 in bounds:
        idx = chunk_idx(c0)
        real = np.arange(c0, c0 + chunk) < n_live
        part_tgt = np.where(real, targets[idx], args.ignoreid) \
            .astype(targets.dtype)
        chunk_batch = {k: v[idx] for k, v in nav_batch.items()}
        rows = runner.upload(live_idx[idx])
        chunk_batch["gmap_img_embeds"] = gmap_flat[rows]
        chunk_batch["hist_embeds"] = hist_flat[rows]
        ml_loss = ml_loss + runner.pano_navigation_train(
            chunk_feats(idx), seeds[c0], chunk_batch, part_tgt, coef)
    return ml_loss, traj
