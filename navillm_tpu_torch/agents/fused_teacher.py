"""Fused whole-trajectory training: one grad chain per trajectory batch.

Torch twin of navillm_tpu/agents/fused_teacher.py, both halves, on the
device-memory path and, with a runner built with device_memory=False, on
the host-memory path:

TEACHER (``rollout_teacher_fused``): under teacher forcing the whole
trajectory is known before any model call, and the history embeddings fed
to the LLM are the pre-LLM graph-fusion embeddings, so phase 1 is a host
simulation of the expert trajectory.

DAGGER (``rollout_dagger_fused``): phase 1 is a no-grad sampling rollout
through the device-memory eval step (runner.eval_step, or with the
prompt-prefix cache runner.eval_step_cached), the action drawn on the
card; the batch's episodes split into slot groups driven round-robin as
generators, so one group's host work runs while another's step is on the
card, and only a_t comes back (HostCopy). On the host-memory path one
group steps through runner.navigation and draws on the host from the
agent's RandomState, as the per-step rollout does. The loss pass then
trains on the expert action at each visited state (teacher_action,
imitation_learning False), reusing the sampling pass's candidate
permutations and prompts.

The shared loss pass (``_fused_trajectory_train``):
  2. device: panorama over the live (episode, step) rows in fixed-width
     chunks, each chunk with its own dropout seed;
  3. host: the index arrays (current node, candidate nodes, gmap slots)
     that drive the replay; on the host-memory path the panorama comes
     down and the graph maps replay the node embeddings step by step;
  4. device: memory replay + fusion + history (runner.replay_fuse_scan),
     the history following the taken actions (targets or samples); on the
     host-memory path one fusion call (runner.fuse_embeds_only) and the
     history gathered on the host, the same numbers;
  5. host prompts + device grad calls in chunks of fused_rows_per_call
     rows, each recomputing its chunk's panorama with the same seed, so
     the replayed embeddings and the differentiated ones agree;
  6. the sub-task heads at the final step: on REVERIE/SOON batches with
     enable_og the object-grounding head (agent._object_grounding_step,
     under either feedback), then (agent._generation_step) with
     enable_fgr2r one generation-loss grad call per collected FGR2R step
     of an R2R batch, on EQA batches the answer head under either
     feedback, and with enable_summarize, under teacher feedback, one
     summarization call (not on CVDN batches). Neither the augmented
     REVERIE set, whose samples have no target object, nor CVDN runs the
     object-grounding head.

Rows of episodes that already ended are dropped from phases 2-5 (row
compaction): their targets are ignoreid, so they add nothing to the loss
or the gradient. One exception: under sample feedback a row keeps
appending history after its episode ended (every drawn action appends),
and the OG and EQA heads read the final history, so when one of them runs
nothing is compacted. The losses stay device scalars; train_loop reads
them one step later.

The agent's StageTimer times the stages JAX times, by the same names:
pano_assemble, nav_assemble, env_step, get_obs, pano_device,
dagger_sample, dagger_sync, phase2_host, fuse_device, phase4_host,
phase5_host and nav_device. With dagger_sample_quant the sampling rollout
runs on the runner's W8A8 policy (runner.sampling_params), prefills
included; the loss pass stays on the live weights. Not ported here: the
shape high-water marks of the JAX code (the gmap width keeps
the bucket of 16 and the sampling windows ``_window_arrays``' own
buckets; their extra columns are masked), JAX's one-dispatch concat of
phase 2 (_phase2_concat_jit: torch.cat does it, inside the same
phase2_host stage) and the thread that reads a_t (HostCopy's event
replaces it; dagger_sync times the wait).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .graph_map import GraphMap
from .mp3d_agent import CLS_TOKEN_TEXT, SUMMARIZED_TYPES
from .runner import MEM_CAPACITY, HostCopy


def rollout_teacher_fused(agent, args, name, optim_cfg, batch_dict, dataset,
                          train_ml, **kwargs):
    """Teacher-forcing rollout + fused loss pass over one batch (extra
    keyword arguments are accepted and unused, as in JAX). Returns (loss
    as a device scalar, trajectories)."""
    obs = list(batch_dict["observations"])
    envs = batch_dict["env"]
    items = batch_dict["item"]
    data_type = batch_dict["data_type"]
    B = len(obs)
    max_action_len = optim_cfg.train_max_action_len[name]
    # the host-memory path fills the gmap embeddings in phase 3
    host_mem = not agent.runner.device_memory

    agent.update_scanvp_cands(obs)
    agent.start_prefetcher(dataset)
    gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
    for i, ob in enumerate(obs):
        gmaps[i].update_graph(ob)
    traj = [{"instr_id": ob["instr_id"], "path": [[ob["viewpoint"]]],
             "details": {}} for ob in obs]
    instructions = [ob["instruction"] for ob in obs]

    # ---------------- phase 1: host trajectory simulation ----------------
    steps: List[Dict[str, Any]] = []
    fgr2r_steps: List[Dict[str, Any]] = []
    ended = np.zeros(B, bool)
    t = 0
    while t < max_action_len:
        flag = bool(ended.all() or t == max_action_len - 1)
        for i, gmap in enumerate(gmaps):
            if not ended[i]:
                gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1
        agent.prefetch(obs)
        with agent.timer.stage("pano_assemble"):
            pano_inputs = agent.panorama_inputs(obs)
        with agent.timer.stage("nav_assemble"):
            gmap_in = agent.nav_gmap_inputs(obs, gmaps, fill_embeds=host_mem)
        nav_targets = agent.teacher_action(
            obs, gmap_in["gmap_vpids"], ended,
            visited_masks=gmap_in["gmap_visited_masks"],
            imitation_learning=True, t=t)
        steps.append({"t": t, "obs": list(obs), "ended": ended.copy(),
                      "pano_inputs": pano_inputs, "gmap_in": gmap_in,
                      "targets": nav_targets,
                      "gmap_vpids": gmap_in["gmap_vpids"]})

        a_t_stop = [ob["viewpoint"] == ob["gt_path"][-1] for ob in obs]
        # FGR2R heads: every step before the last on which the batch's first
        # episode has not reached its goal (JAX's gate, row 0's alone)
        if args.enable_fgr2r and data_type[0] == "r2r" and not flag \
                and not a_t_stop[0] and "fg_instruction" in obs[0]:
            fgr2r_steps.append({"obs": list(obs), "t": t,
                                "targets": nav_targets.copy()})
        cpu_a_t: List[Optional[str]] = []
        for i in range(B):
            if a_t_stop[i] or ended[i] or gmap_in["no_vp_left"][i] \
                    or t == max_action_len - 1:
                cpu_a_t.append(None)
            else:
                cpu_a_t.append(gmap_in["gmap_vpids"][i][nav_targets[i]])
        with agent.timer.stage("env_step"):
            agent.make_equiv_action(cpu_a_t, gmaps, obs, traj, envs)
        with agent.timer.stage("get_obs"):
            obs = [dataset.get_obs(items=[items[i]], env=envs[i],
                                   data_type=data_type[i])[0]
                   for i in range(B)]
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
        instructions=instructions, data_type=data_type, B=B,
        train_ml=train_ml, loss_den=B, t_pad=max_action_len,
        fgr2r_steps=fgr2r_steps)


def rollout_dagger_fused(agent, args, name, optim_cfg, batch_dict, dataset,
                         train_ml, forced_actions=None, loss_denom=None,
                         np_rng=None, **kwargs):
    """Sample-feedback rollout + fused loss pass over one batch (twin of
    rollout_dagger_fused). forced_actions ([T][B] ints) replaces the draw
    at each step (do_sample is off then); np_rng replaces the agent's
    RandomState for the candidate permutations and, on the host-memory
    path, the draws. Returns (loss as a device scalar, trajectories).

    With args.dagger_sample_quant (on the device-memory path, where the
    runner holds a dense LLM to quantize) every sampling step and prefill
    runs on the W8A8 policy (runner.sampling_params, re-quantized after
    each optimizer step). The gradient is untouched: the loss pass
    recomputes the trajectory on the live weights."""
    obs_all = list(batch_dict["observations"])
    B = len(obs_all)
    loss_den = loss_denom if loss_denom is not None else B
    rng_local = np_rng if np_rng is not None else agent.np_rng
    max_action_len = optim_cfg.train_max_action_len[name]
    runner = agent.runner
    use_mem = runner.device_memory
    use_q = use_mem and bool(getattr(args, "dagger_sample_quant", False)) \
        and runner.sampling_quant_available()

    agent.update_scanvp_cands(obs_all)
    agent.start_prefetcher(dataset)
    # the host-memory step waits for its logits, so it has nothing to
    # overlap: one group
    n_groups = int(getattr(args, "dagger_streams", 0) or 2) if use_mem else 1
    while n_groups > 1 and (B % n_groups != 0 or B // n_groups < 2):
        n_groups -= 1

    # the cache budget at the batch level: the groups' caches coexist with
    # the params, the gradients and both AdamW moments (4 x the params
    # bytes, JAX's stand-in) under the runner's memory ceiling
    use_cache = use_mem and bool(getattr(args, "dagger_prefix_cache", True))
    if use_cache:
        use_cache = (runner.prefix_cache_bytes(B, agent.dims.max_prefix)
                     + 4 * runner.params_bytes() < runner.memory_ceiling())

    Bg = B // n_groups
    groups = []
    for g in range(n_groups):
        sl = slice(g * Bg, (g + 1) * Bg)
        obs = obs_all[sl]
        gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
        for i, ob in enumerate(obs):
            gmaps[i].update_graph(ob)
        groups.append({
            "obs": obs,
            "envs": batch_dict["env"][sl],
            "items": batch_dict["item"][sl],
            "data_type": batch_dict["data_type"][sl],
            "gmaps": gmaps,
            "traj": [{"instr_id": ob["instr_id"],
                      "path": [[ob["viewpoint"]]], "details": {}}
                     for ob in obs],
            "instructions": [ob["instruction"] for ob in obs],
            "steps": [],
            "forced": ([np.asarray(fa)[sl] for fa in forced_actions]
                       if forced_actions is not None else None),
        })

    # round robin: each generator yields between dispatching its step and
    # reading its a_t, so the others' host work overlaps the card. The
    # groups draw their permutations from rng_local in this order.
    live = [_dagger_sample_group(agent, args, grp, dataset, rng_local,
                                 max_action_len, use_cache, use_q)
            for grp in groups]
    while live:
        for gen in list(live):
            try:
                next(gen)
            except StopIteration:
                live.remove(gen)

    # the loss pass per group, over the batch's denominator: the sum over
    # groups is the one-group loss
    ml_loss = 0.0
    traj = []
    for grp in groups:
        loss_g, traj_g = _fused_trajectory_train(
            agent, args, steps=grp["steps"], gmaps=grp["gmaps"],
            traj=grp["traj"], instructions=grp["instructions"],
            data_type=grp["data_type"], B=len(grp["obs"]),
            train_ml=train_ml, loss_den=loss_den, t_pad=max_action_len,
            feedback="sample")
        ml_loss = ml_loss + loss_g
        traj.extend(traj_g)
    return ml_loss, traj


class _Row:
    """A sampling row's prefix-cache state (what _cached_prompt_windows
    reads and updates)."""
    __slots__ = ("active", "cache_ids", "needs_prefill")

    def __init__(self):
        self.active, self.cache_ids, self.needs_prefill = True, None, True


def _dagger_sample_group(agent, args, grp, dataset, rng_local,
                         max_action_len, use_cache, use_q=False):
    """Phase 1 of the DAgger half for one slot group, as a generator that
    yields once per step, between dispatching the step (sync=False) and
    reading its a_t. Fills grp["steps"] (the snapshots of the teacher's
    phase 1 plus the taken "actions", the candidate "order", the
    "prompts", and on the device-memory path the value-free "vp_in" /
    "match" of this step), and moves grp["traj"] and grp["gmaps"] along
    the sampled trajectory.

    With use_cache the step is the prefix-cached one, on a [B, P] cache
    taken from the agent's pool (re-prefilled each batch: K/V beyond a
    row's plen stays invisible behind the prefix mask) and handed back
    at the end. If a prompt outgrows the cache (_cached_prompt_windows
    raises RuntimeError), the buffer goes back to the pool at once and
    the rest of the group takes the full-prompt step: the graph memory
    does not depend on the cache.

    With use_q the steps and prefills run on the runner's W8A8 policy
    (eval_step_q, eval_step_cached_q, prefill_q).

    On the host-memory path each step's panorama comes down, the graph
    maps pool it, runner.navigation runs the step, and the action is a
    draw on the host from rng_local (forced_actions aside); the step does
    not yield."""
    from .mp3d_agent import _softmax
    runner = agent.runner
    use_mem = runner.device_memory
    obs, envs, items = grp["obs"], grp["envs"], grp["items"]
    data_type, gmaps, traj = grp["data_type"], grp["gmaps"], grp["traj"]
    instructions, forced_actions = grp["instructions"], grp["forced"]
    B = len(obs)
    C = agent.dims.max_cands
    history: List[List[str]] = [[] for _ in range(B)]
    # the policy's history embeds on the host-memory path (the loss pass
    # recomputes its own)
    hist_vis_eval: List[List[np.ndarray]] = [[] for _ in range(B)]
    mem_state = runner.memory_init(B) if use_mem else None
    temperature = max(float(args.temperature), 1e-6)

    cache = None
    cache_P = agent.dims.max_prefix
    rows_state = None
    if use_cache:
        pool = agent._dagger_cache_pool
        for pi, (bb, pp, _) in enumerate(pool):
            if bb == B and pp == cache_P:
                cache = pool.pop(pi)[2]        # this group owns it now
                break
        if cache is None:
            cache = runner.prefix_cache_init(B, cache_P)
        rows_state = [_Row() for _ in range(B)]

    steps: List[Dict[str, Any]] = grp["steps"]
    ended = np.zeros(B, bool)
    t = 0
    while t < max_action_len:
        flag = bool(ended.all() or t == max_action_len - 1)
        for i, gmap in enumerate(gmaps):
            if not ended[i]:
                gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1
        agent.prefetch(obs)
        with agent.timer.stage("pano_assemble"):
            pano_inputs = agent.panorama_inputs(obs)
        V = pano_inputs["view_img_fts"].shape[1]
        pano_embeds = None
        if use_mem:
            pano_masks = (np.arange(V)[None, :]
                          < pano_inputs["view_lens"][:, None])
            cur_ids, cand_ids = agent._memory_ids(
                gmaps, obs, pano_inputs["cand_vpids"], ended)
        else:
            # the deterministic panorama feeds the host graph memory
            with agent.timer.stage("pano_device"):
                pano_out = runner.panorama(pano_inputs, deterministic=True)
            pano_embeds = pano_out["pano_embeds"]
            pano_masks = pano_out["pano_masks"]
            agent._pool_node_embeds(gmaps, obs, pano_embeds, pano_masks,
                                    pano_inputs["cand_vpids"], ended)

        with agent.timer.stage("nav_assemble"):
            gmap_in = agent.nav_gmap_inputs(obs, gmaps,
                                            fill_embeds=not use_mem)
            vp_in = agent.nav_vp_inputs(obs, gmaps, pano_masks,
                                        pano_inputs["cand_vpids"],
                                        pano_embeds)
            match = agent.local_match_slots(
                gmap_in["gmap_vpids"], vp_in["vp_cand_vpids"], gmaps,
                width=V + 1)
            order, prompts, cand_nums = agent.cand_order_and_prompts(
                gmap_in, instructions, history, rng=rng_local)
            win = prefill_items = None
            if use_cache:
                for i in range(B):
                    rows_state[i].active = not ended[i]

                def probe_fn(i):
                    return agent.get_prompt(
                        "navigation", instruction=instructions[i],
                        hist_num=len(history[i]) + 1,
                        cand_num=min(cand_nums[i], C + 1),
                        cls_token=CLS_TOKEN_TEXT)

                try:
                    app_l, suf_l, prefill_items = \
                        agent._cached_prompt_windows(rows_state, prompts,
                                                     probe_fn, cache_P)
                except RuntimeError:
                    use_cache = False
                    agent._dagger_cache_pool.append((B, cache_P, cache))
                    cache = None
                    agent.dagger_bailouts += 1
                else:
                    tok = runner.tok
                    win = agent._window_arrays(app_l, suf_l, tok.cand_id,
                                               tok.hist_id, tok.cls_ids[0],
                                               C)
            if not use_cache:
                tok_batch, cand_pos, hist_pos, cls_pos = \
                    runner.tokenize_with_positions(prompts)
        nav_batch = {
            "gmap_step_ids": gmap_in["gmap_step_ids"],
            "gmap_pos_fts": gmap_in["gmap_pos_fts"],
            "gmap_masks": gmap_in["gmap_masks"],
            "gmap_visited_masks": gmap_in["gmap_visited_masks"],
            "vp_pos_fts": vp_in["vp_pos_fts"],
            "pano_masks": vp_in["pano_masks"],
            "local_match_slot": match,
            "cand_order": order,
        }
        if use_cache:
            nav_batch.update(win)
        else:
            nav_batch.update({"cand_positions": cand_pos,
                              "hist_positions": hist_pos,
                              "input_ids": tok_batch.input_ids,
                              "attention_mask": tok_batch.attention_mask,
                              "cls_pos": cls_pos})
        nav_targets = agent.teacher_action(
            obs, gmap_in["gmap_vpids"], ended,
            visited_masks=gmap_in["gmap_visited_masks"],
            imitation_learning=False, t=t)

        if use_mem:
            nav_batch["slot_ids"] = agent._slot_ids(gmap_in, gmaps)
            override = np.full(B, -1, np.int32)
            if forced_actions is not None:
                override = np.asarray(forced_actions[t], np.int32)
            step_args = dict(reset_mask=np.zeros(B, bool), cur_ids=cur_ids,
                             cand_ids=cand_ids, active_mask=~ended,
                             a_t_override=override,
                             do_sample=forced_actions is None,
                             temperature=temperature, sync=False)
            if use_cache and prefill_items:
                cache = agent.prefill_rows(cache, prefill_items, B,
                                           quant=use_q)
            step_cached = (runner.eval_step_cached_q if use_q
                           else runner.eval_step_cached)
            step_plain = runner.eval_step_q if use_q else runner.eval_step
            with agent.timer.stage("dagger_sample"):
                if use_cache:
                    mem_state, cache, a_t, _ = step_cached(
                        mem_state, cache, pano_inputs, nav_batch,
                        **step_args)
                else:
                    mem_state, a_t, _ = step_plain(
                        mem_state, pano_inputs, nav_batch, **step_args)
                a_t = HostCopy(a_t)
            yield
            with agent.timer.stage("dagger_sync"):
                a_t = a_t.result().astype(np.int64)
        else:
            nav_batch["gmap_img_embeds"] = gmap_in["gmap_img_embeds"]
            nav_batch["vp_img_embeds"] = vp_in["vp_img_embeds"]
            nav_batch["hist_embeds"] = agent.hist_arrays(hist_vis_eval)
            with agent.timer.stage("dagger_sample"):
                logits, fuse_embeds, _ = runner.navigation(nav_batch)
            if forced_actions is not None:
                a_t = np.asarray(forced_actions[t], np.int64)
            else:
                # the per-step rollout's draw: temperature softmax and
                # rng_local.choice on the host
                a_t = np.zeros(B, np.int64)
                probs = _softmax(logits / temperature)
                for i in range(B):
                    p = probs[i].astype(np.float64)
                    a_t[i] = rng_local.choice(len(p), p=p / p.sum())

        steps.append({
            "t": t, "flag": flag, "obs": list(obs), "ended": ended.copy(),
            "pano_inputs": pano_inputs, "gmap_in": gmap_in,
            "targets": nav_targets, "gmap_vpids": gmap_in["gmap_vpids"],
            "actions": a_t.copy(), "order": order, "prompts": prompts,
            # the host path's vp_in holds the policy's deterministic
            # embeddings: phase 3 rebuilds it from the loss pass's own
            "vp_in": vp_in if use_mem else None,
            "match": match if use_mem else None,
        })
        # history follows every row whose action is not ignoreid, ended or
        # not (the per-step path's rule; a draw never is)
        for i in range(B):
            if a_t[i] != args.ignoreid:
                history[i].append("<hist>")
                if not use_mem:
                    hist_vis_eval[i].append(fuse_embeds[i, a_t[i]])

        a_t_stop = [ob["viewpoint"] == ob["gt_path"][-1] for ob in obs]
        cpu_a_t: List[Optional[str]] = []
        for i in range(B):
            if a_t_stop[i] or ended[i] or gmap_in["no_vp_left"][i] \
                    or t == max_action_len - 1:
                cpu_a_t.append(None)
            else:
                cpu_a_t.append(gmap_in["gmap_vpids"][i][a_t[i]])
        with agent.timer.stage("env_step"):
            agent.make_equiv_action(cpu_a_t, gmaps, obs, traj, envs)
        with agent.timer.stage("get_obs"):
            obs = [dataset.get_obs(items=[items[i]], env=envs[i],
                                   data_type=data_type[i])[0]
                   for i in range(B)]
        agent.update_scanvp_cands(obs)
        for i, ob in enumerate(obs):
            if not ended[i]:
                gmaps[i].update_graph(ob)
        ended = np.logical_or(ended, np.array([x is None for x in cpu_a_t]))
        t += 1
        if flag:
            break

    if cache is not None:
        agent._dagger_cache_pool.append((B, cache_P, cache))


def _live_rows(steps, feedback, heads_on) -> np.ndarray:
    """[T*B] rows the loss pass runs: those of live episodes, or under
    sample feedback with a final-step head that reads the history (OG,
    EQA) every row (an ended row's drawn actions keep appending the
    history the head reads)."""
    if feedback == "teacher" or not heads_on:
        return np.concatenate([~s["ended"] for s in steps])
    return np.ones(len(steps) * len(steps[0]["ended"]), bool)


def _fused_trajectory_train(agent, args, *, steps, gmaps, traj, instructions,
                            data_type, B, train_ml, loss_den, t_pad=None,
                            feedback="teacher", fgr2r_steps=()):
    """Phases 2-5 of the fused loss pass, on the device memory or (a
    runner with device_memory=False) on the host's, then the sub-task heads
    (6). Under feedback="sample" each step also holds the taken "actions"
    (the history follows them), and the "order", "prompts", "vp_in" and
    "match" of the sampling pass, which are reused, not redrawn; the
    sampled half runs the OG and EQA heads only."""
    runner = agent.runner
    use_dev = runner.device_memory
    timer = agent.timer
    T = len(steps)
    is_eqa = data_type[0] == "eqa"
    run_og = data_type[0] in ("soon", "reverie") and args.enable_og
    run_gen = is_eqa or (feedback == "teacher" and args.enable_summarize
                         and data_type[0] in SUMMARIZED_TYPES)

    # ---------------- phase 2: panorama over the live rows ---------------
    # the feature arrays are already on the device (panorama_inputs uploads
    # them); host members are concatenated and compacted here. A row whose
    # episode ended is live only where its history feeds a final head
    # (sample feedback: see the module docstring)
    with timer.stage("phase2_host"):
        dev_keys = [k for k in ("view_img_fts", "obj_img_fts")
                    if k in steps[0]["pano_inputs"]]
        dev_all = {k: torch.cat([s["pano_inputs"][k] for s in steps])
                   for k in dev_keys}
        host_keys = ["loc_fts", "nav_types", "view_lens"]
        if "obj_img_fts" in dev_all:
            host_keys += ["obj_loc_fts", "obj_lens"]
        pano_cat = {k: np.concatenate([s["pano_inputs"][k] for s in steps])
                    for k in host_keys}
    row_live = _live_rows(steps, feedback, run_og or is_eqa)      # [T*B]
    live_idx = np.nonzero(row_live)[0]
    n_live = len(live_idx)
    compact_of = np.full(T * B, -1, np.int64)
    compact_of[live_idx] = np.arange(n_live)
    pano_host = {k: v[live_idx] for k, v in pano_cat.items()}
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
        rows = runner.upload(live_idx[idx])
        feats.update({k: v[rows] for k, v in dev_all.items()})
        return feats

    V = steps[0]["pano_inputs"]["view_img_fts"].shape[1]
    seeds = {}
    pe_chunks = []                  # device path: [chunk, V, H] tensors
    pe_parts, pm_parts = [], []     # host path: the live rows' downloads
    with timer.stage("pano_device"):
        for c0 in bounds:
            seeds[c0] = runner.next_seed()
            feats = chunk_feats(chunk_idx(c0))
            if use_dev:
                pe_chunks.append(runner.panorama_dev_dict(
                    feats, deterministic=False, seed=seeds[c0])[
                        "pano_embeds"])
            else:
                out = runner.panorama(feats, deterministic=False,
                                      seed=seeds[c0])
                n_real = min(chunk, n_live - c0)
                pe_parts.append(out["pano_embeds"][:n_real])
                pm_parts.append(out["pano_masks"][:n_real])
    if use_dev:
        # masks are index data (arange < view_lens); dead rows read
        # all-False
        pano_embeds_all = None
        pano_masks_all = np.zeros((T, B, V), bool)
        for st_idx, step in enumerate(steps):
            pano_masks_all[st_idx] = (
                np.arange(V)[None, :]
                < step["pano_inputs"]["view_lens"][:, None])
            pano_masks_all[st_idx][~row_live[st_idx * B:
                                             (st_idx + 1) * B]] = False
    else:
        # back onto the [T, B] grid; dead rows are zeros with all-False
        # masks (phase 3 skips them, nothing reads their fusion)
        pe_live = np.concatenate(pe_parts)
        pe_flat = np.zeros((T * B,) + pe_live.shape[1:], pe_live.dtype)
        pe_flat[live_idx] = pe_live
        pm_flat = np.zeros((T * B, V), bool)
        pm_flat[live_idx] = np.concatenate(pm_parts)
        pano_embeds_all = pe_flat.reshape(T, B, V, -1)
        pano_masks_all = pm_flat.reshape(T, B, V)

    # ------------- phase 3: index arrays of the device replay ------------
    # (host path: the graph maps replay the node embeddings step by step
    # from the loss pass's panorama)
    if not use_dev:
        for g in gmaps:
            g._embed_sum.clear()
            g._embed_cnt.clear()
    T_pad = max(t_pad or T, T) if use_dev else T
    n_max = max((len(s["gmap_vpids"][i]) for s in steps for i in range(B)),
                default=1)
    G_eff = min(agent.dims.max_gmap_nodes, max(16, -(-n_max // 16) * 16))
    if use_dev:
        if T_pad > agent.dims.max_hist:
            raise ValueError(f"max_action_len {T_pad} > max_hist "
                             f"{agent.dims.max_hist}: the device history "
                             f"buffer would overwrite its last slot")
        cur_ids_g = np.full((T_pad, B), -1, np.int32)
        cand_ids_g = np.full((T_pad, B, V), -1, np.int32)
        slot_ids_g = np.full((T_pad, B, G_eff), -1, np.int32)
    with timer.stage("nav_assemble"):
        for st_idx, step in enumerate(steps):
            sobs = step["obs"]
            visited = step["gmap_in"]["gmap_visited_masks"]
            cand_vpids = step["pano_inputs"]["cand_vpids"]
            pe = pm = None

            def updated(i):
                """(view j, node id) of row i's candidates that pool
                this step: not visited at this step, from the snapshot
                (the graph maps have moved on)."""
                gidx = gmaps[i].graph.index
                vps = step["gmap_vpids"][i]
                for j, cvp in enumerate(cand_vpids[i]):
                    if cvp in vps and visited[i][vps.index(cvp)]:
                        continue
                    yield j, cvp, gidx.get(cvp, -1)

            if use_dev:
                for i in range(B):
                    gidx = gmaps[i].graph.index
                    if not step["ended"][i]:
                        cid = gidx.get(sobs[i]["viewpoint"], -1)
                        cur_ids_g[st_idx, i] = cid if cid < MEM_CAPACITY \
                            else -1
                        for j, _, nid in updated(i):
                            if 0 <= nid < MEM_CAPACITY:
                                cand_ids_g[st_idx, i, j] = nid
                    for k, vp in enumerate(step["gmap_vpids"][i]):
                        if k > 0 and vp is not None:
                            nid = gidx.get(vp, -1)
                            if 0 <= nid < MEM_CAPACITY:
                                slot_ids_g[st_idx, i, k] = nid
            else:
                pe, pm = pano_embeds_all[st_idx], pano_masks_all[st_idx]
                avg = (pe * pm[..., None]).sum(1) \
                    / np.maximum(pm.sum(1, keepdims=True), 1)
                for i in range(B):
                    if step["ended"][i]:
                        continue
                    gmaps[i].update_node_embed(sobs[i]["viewpoint"], avg[i],
                                               rewrite=True)
                    for j, cvp, _ in updated(i):
                        gmaps[i].update_node_embed(cvp, pe[i, j])
                gin = step["gmap_in"]
                for i in range(B):
                    for k, vp in enumerate(step["gmap_vpids"][i]):
                        if k > 0 and vp is not None \
                                and gmaps[i].has_node_embed(vp):
                            gin["gmap_img_embeds"][i, k] = \
                                gmaps[i].get_node_embed(vp)
            if step.get("vp_in") is not None:
                # the sampling pass's vp_in and match, taken against this
                # step's visited state
                continue
            vp_in = agent.nav_vp_inputs(sobs, gmaps, pano_masks_all[st_idx],
                                        cand_vpids, pe)
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

    # ------------- phase 4: the replay for gmap and history --------------
    def cat_steps(getter):
        return np.concatenate([getter(s) for s in steps], 0)

    with timer.stage("phase4_host"):
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
        hist_counts = np.zeros((T, B), np.int32)
        if use_dev:
            # history bookkeeping is host arithmetic; the values stay on
            # the device
            acts_g = np.full((T_pad, B), -1, np.int32)
            cnt = np.zeros(B, np.int32)
            for st_idx, step in enumerate(steps):
                hist_counts[st_idx] = cnt
                acts = step["actions"] if feedback == "sample" \
                    else step["targets"]
                for i in range(B):
                    a = int(acts[i])
                    if a != args.ignoreid and compact_of[st_idx * B + i] >= 0:
                        acts_g[st_idx, i] = a
                        cnt[i] += 1
            # full fixed-width chunks; padding rows scatter into the trash
            # row
            rows_full = np.full(len(pe_chunks) * chunk, T_pad * B, np.int64)
            rows_full[:n_live] = live_idx

            def stack_pad(flat):
                a = flat.reshape((T, B) + flat.shape[1:])
                pad = np.zeros((T_pad - T, B) + flat.shape[1:], a.dtype)
                return np.concatenate([a, pad], 0)

            fuse_sts = {k: stack_pad(v) for k, v in fuse_host.items()}
            pm_grid = np.zeros((T_pad, B, V), bool)
            pm_grid[:T] = pano_masks_all
    if use_dev:
        with timer.stage("fuse_device"):
            gmap_flat, hist_flat, mem_final = runner.replay_fuse_scan(
                pe_chunks, rows_full, T_pad, pm_grid, cur_ids_g, cand_ids_g,
                slot_ids_g, fuse_sts, acts_g)
    else:
        fuse_batch = dict(fuse_host)
        fuse_batch["gmap_img_embeds"] = cat_steps(
            lambda s: s["gmap_in"]["gmap_img_embeds"][:, :G_eff])
        fuse_batch["vp_img_embeds"] = cat_steps(
            lambda s: s["vp_in"]["vp_img_embeds"])
        # the live rows (a history append needs a live row), padded to a
        # whole number of grad chunks by repeating the last one
        n_fuse = -(-n_live // chunk) * chunk
        fuse_sel = np.minimum(np.arange(n_fuse), n_live - 1)
        fuse_batch = {k: v[live_idx][fuse_sel] for k, v in fuse_batch.items()}
        with timer.stage("fuse_device"):
            fuse_live = runner.fuse_embeds_only(fuse_batch)[:n_live]
        # row (t, i)'s history: the fusion rows of (t', i) at their taken
        # action, for t' < t (under sample feedback the drawn action)
        Hh = agent.dims.max_hist
        hist_embeds_live = np.zeros((n_live, Hh, fuse_live.shape[-1]),
                                    np.float32)
        hist_store: List[List[np.ndarray]] = [[] for _ in range(B)]
        for st_idx, step in enumerate(steps):
            for i in range(B):
                hist_counts[st_idx, i] = len(hist_store[i])
                row = compact_of[st_idx * B + i]
                if row >= 0:
                    for k, v in enumerate(hist_store[i][-Hh:]):
                        hist_embeds_live[row, k] = v
            acts = step["actions"] if feedback == "sample" \
                else step["targets"]
            for i in range(B):
                row = compact_of[st_idx * B + i]
                if acts[i] != args.ignoreid and row >= 0:
                    hist_store[i].append(fuse_live[row, acts[i]])

    # ------------- phase 5: prompts and the grad calls -------------------
    with timer.stage("phase5_host"):
        prompts, orders = [], []
        C = agent.dims.max_cands
        for st_idx, step in enumerate(steps):
            visited = step["gmap_in"]["gmap_visited_masks"]
            for i in range(B):
                if compact_of[st_idx * B + i] < 0:
                    continue
                if feedback == "sample":
                    orders.append(np.asarray(step["order"][i], np.int32))
                    prompts.append(step["prompts"][i])
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
        if not use_dev:
            nav_batch["gmap_img_embeds"] = \
                fuse_batch["gmap_img_embeds"][:n_live]
            nav_batch["hist_embeds"] = hist_embeds_live
        targets = np.concatenate([s["targets"] for s in steps], 0)[live_idx]
    coef = train_ml / loss_den / args.gradient_accumulation_step
    ml_loss = 0.0
    with timer.stage("nav_device"):
        for c0 in bounds:
            idx = chunk_idx(c0)
            real = np.arange(c0, c0 + chunk) < n_live
            part_tgt = np.where(real, targets[idx], args.ignoreid) \
                .astype(targets.dtype)
            chunk_batch = {k: v[idx] for k, v in nav_batch.items()}
            if use_dev:
                rows = runner.upload(live_idx[idx])
                chunk_batch["gmap_img_embeds"] = gmap_flat[rows]
                chunk_batch["hist_embeds"] = hist_flat[rows]
            ml_loss = ml_loss + runner.pano_navigation_train(
                chunk_feats(idx), seeds[c0], chunk_batch, part_tgt, coef)

    # ------------- phase 6: the sub-task heads ----------------------------
    # the final-step heads read the history values: on the device path one
    # download of the final history buffer, only when one of them runs
    final_obs = steps[-1]["obs"]
    if use_dev:
        history_final = [["<hist>"] * int(cnt[i]) for i in range(B)]
        hist_vis_final = None
        if run_og or run_gen:
            hb = mem_final["hist_buf"].cpu().numpy()
            hist_vis_final = [list(hb[i, : min(int(cnt[i]), hb.shape[1])])
                              for i in range(B)]
    else:
        history_final = [["<hist>"] * len(h) for h in hist_store]
        hist_vis_final = hist_store
    if run_og:
        ml_loss = ml_loss + agent._object_grounding_step(
            args, final_obs, instructions, history_final, hist_vis_final,
            traj, training=True, loss_denom=loss_den)
    # one FGR2R head call per collected step: where is the expert going
    for fg in fgr2r_steps:
        ml_loss = ml_loss + agent._generation_step(
            args, fg["obs"], history=[[] for _ in range(B)],
            hist_vis=[[] for _ in range(B)],
            instructions=["where are we going with direction ({}) ?"
                          .format(int(idx)) for idx in fg["targets"]],
            answers=[ob["fg_instruction"][ob["fg_view"][fg["t"]]]
                     for ob in fg["obs"]],
            mode="embodied_qa", training=True, loss_denom=loss_den)
    # at the final step EQA's answer (any feedback), or the summary
    # (teacher feedback)
    if run_gen:
        ml_loss = ml_loss + agent._generation_step(
            args, final_obs, history=history_final, hist_vis=hist_vis_final,
            instructions=instructions,
            answers=[ob.get("answer", "") if is_eqa else ob["instruction"]
                     for ob in final_obs],
            mode="embodied_qa" if is_eqa else "summarization",
            training=True, loss_denom=loss_den)
    return ml_loss, traj
