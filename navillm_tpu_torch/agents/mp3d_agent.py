"""The navigation agents (R2R, CVDN, REVERIE, SOON, EQA and the augmented
R2R and REVERIE sets): evaluation and training.

Torch twin of navillm_tpu/agents/mp3d_agent.py on every path:
streaming evaluation (``validate_streaming``: device graph memory, argmax
or sampled actions, uncached or with the prompt-prefix KV cache; for
REVERIE and SOON with enable_og an object-grounding queue, for EQA and
test-mode summarization a generation queue, and for EQA the oracle pass;
with a runner built with device_memory=False the host-memory step),
batched evaluation (``validate`` over the per-step ``rollout``), and
``train``: the fused trainer (agents/fused_teacher.py) or, without
fused_teacher / fused_dagger, the per-step rollout (``_rollout_gen``,
with the interleaved DAgger streams of ``rollout_interleaved``), with the
object-grounding, summarization, FGR2R and EQA heads
(``_object_grounding_step``, ``_generation_step``). It carries the
fixed-shape input assembly of the JAX agent (``panorama_inputs``,
``nav_gmap_inputs``, ``nav_vp_inputs``, ``local_match_slots``,
``cand_order_and_prompts``, and for the cache ``_cached_prompt_windows``,
``_window_arrays`` and ``prefill_rows``), its experts (``teacher_action``,
``teacher_object``) and its sim step (``make_equiv_action``), which are
host numpy code, copied because the JAX agent module imports jax. Every
path times its stages in the agent's StageTimer (``agent.timer``) under
JAX's stage names. Where JAX prefetches (the fused teacher and DAgger,
the per-step rollout, streaming evaluation's step assembly), the agent's
FeaturePrefetcher (data/prefetch.py, ``start_prefetcher``, ``prefetch``)
reads every candidate viewpoint's features into the dataset's feature
store before the step's panorama assembly. ``args.kv_int8`` keeps the streaming prefix cache
int8 (every queue that caches: R2R, CVDN, REVERIE and SOON with the OG
queue, EQA); generate's int8 prompt K/V is the runner's own ``kv_int8``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.prefetch import FeaturePrefetcher
from ..models.decoding import decode_to_text
from ..models.trie import DenseTrie
from ..utils.config import TrainArgs
from ..utils.profiling import StageTimer
from ..utils.registry import AGENTS
from . import prompts as P
from .graph_map import GraphMap
from .runner import MEM_CAPACITY, HostCopy, NavModelRunner, RolloutDims

CLS_TOKEN_TEXT = "<cls_1>"

# the tasks whose episodes the summarization head retells (CVDN's dialogs
# and EQA's questions are not)
SUMMARIZED_TYPES = ("r2r", "soon", "reverie", "r2r_aug", "reverie_aug")

# one set of run flags (utils.config.TrainArgs, the JAX package's names and
# defaults) serves evaluation and training
EvalArgs = TrainArgs


def get_results(pred_results: Dict[str, dict],
                detailed_output: bool = False) -> List[dict]:
    """Flatten per-episode results; a generated answer (EQA, or a
    test-mode summary) comes with its oracle answer and ground truth, a
    grounded object with its direction (SOON; None for REVERIE).
    detailed_output is taken and unused, as in JAX."""
    out = []
    for k, v in pred_results.items():
        ret = {"instr_id": k, "trajectory": v["path"]}
        if "answer" in v:
            ret.update({"pred_answer": v.get("generated_sentences", ""),
                        "oracle_pred_answer": v.get("oracle_pred_answer",
                                                    ""),
                        "gt_answer": v["answer"]})
        if "pred_objid" in v:
            ret.update({"pred_objid": v["pred_objid"],
                        "pred_obj_direction": v["pred_obj_direction"]})
        out.append(ret)
    return out


@AGENTS.register("r2r")
class R2RAgent:
    name = "r2r"

    def __init__(self, args, world, runner: NavModelRunner,
                 dims: Optional[RolloutDims] = None):
        self.args = args
        self.world = world
        self.runner = runner
        self.dims = dims or runner.dims
        self.scanvp_cands: Dict[str, Dict[str, int]] = {}
        self.np_rng = np.random.RandomState(args.seed)
        # the pano encoder's first op casts features to its dtype, so
        # casting at upload is numerically the same and halves the bytes
        self._feat_dtype = runner.cfg.pano.dtype
        # the fused DAgger's prefix caches, kept across batches keyed
        # (batch rows, max_prefix), and its mid-batch fallbacks
        self._dagger_cache_pool: List[Any] = []
        self.dagger_bailouts = 0
        # host wall time per named stage of every rollout path
        self.timer = StageTimer()
        # reads the candidates' features into the store's cache while the
        # card runs a step; built at a rollout's start (start_prefetcher)
        self._prefetcher = None

    def start_prefetcher(self, dataset):
        """Build the agent's FeaturePrefetcher over ``dataset``'s feature
        store, once, where the dataset has one (JAX's rule)."""
        if self._prefetcher is None and dataset is not None \
                and getattr(dataset, "feat_db", None) is not None:
            self._prefetcher = FeaturePrefetcher(dataset.feat_db)

    def prefetch(self, obs):
        """Queue the reads of every candidate viewpoint's features of
        ``obs``, before the step's panorama assembly."""
        if self._prefetcher is not None:
            self._prefetcher.prefetch_candidates(obs)

    def get_prompt(self, task, *a, **kw):
        kind = {"navigation": P.navigation_prompt,
                "summarization": P.summarization_prompt,
                "embodied_qa": P.embodied_qa_prompt,
                "object_grounding": P.object_grounding_prompt}[task]
        return kind(self.name, *a, **kw)

    def update_scanvp_cands(self, obs):
        for ob in obs:
            key = "%s_%s" % (ob["scan"], ob["viewpoint"])
            slot = self.scanvp_cands.setdefault(key, {})
            for cand in ob["candidate"]:
                slot[cand["viewpointId"]] = cand["pointId"]

    # ---------------- fixed-shape input assembly ----------------------- #
    def panorama_inputs(self, obs, with_objects: bool = True,
                        twelve_views: bool = False) -> Dict[str, Any]:
        """Candidate views first, then non-candidate views, padded to
        max_views; with twelve_views (the generation heads) the 36 views in
        order, the first 12 (the horizon) of nav type 1. With with_objects
        and observations that carry objects, each viewpoint's objects too,
        padded to max_objects (obj_img_fts, obj_loc_fts = angle ⊕ box
        features, obj_lens, obj_ids). The feature arrays go up to the
        device here, once."""
        D = self.args.image_feat_size
        A = self.args.angle_feat_size
        V = self.dims.max_views
        b = len(obs)
        view_img = np.zeros((b, V, D), np.float32)
        loc_fts = np.zeros((b, V, A + 3), np.float32)
        nav_types = np.zeros((b, V), np.int32)
        view_lens = np.zeros((b,), np.int32)
        cand_vpids: List[List[str]] = []
        has_obj = with_objects and "obj_img_fts" in obs[0]
        if has_obj:
            O = self.dims.max_objects
            obj_img = np.zeros((b, O, self.args.obj_feat_size), np.float32)
            obj_loc = np.zeros((b, O, A + 3), np.float32)
            obj_lens = np.zeros((b,), np.int32)
            obj_ids: List[List] = []
            for i, ob in enumerate(obs):
                n_obj = min(len(ob["obj_img_fts"]), O)
                if n_obj:
                    obj_img[i, :n_obj] = ob["obj_img_fts"][:n_obj]
                    obj_loc[i, :n_obj] = np.concatenate(
                        [ob["obj_ang_fts"][:n_obj],
                         ob["obj_box_fts"][:n_obj]], 1)
                obj_lens[i] = n_obj
                obj_ids.append(list(ob["obj_ids"])[:n_obj])
        for i, ob in enumerate(obs):
            feats = ob["feature"]          # [36, D + A]
            if twelve_views:
                n = min(36, V)
                view_img[i, :n] = feats[:n, :D]
                loc_fts[i, :n, :A] = feats[:n, D:]
                loc_fts[i, :n, A:] = 1.0
                nav_types[i, : min(12, n)] = 1
                view_lens[i] = n
                cand_vpids.append([None] * 36)
                continue
            used = set()
            k = 0
            for cc in ob["candidate"]:
                if k >= V:
                    break
                view_img[i, k] = cc["feature"][:D]
                loc_fts[i, k, :A] = cc["feature"][D:]
                loc_fts[i, k, A:] = 1.0
                nav_types[i, k] = 1
                used.add(cc["pointId"])
                k += 1
            cand_vpids.append([cc["viewpointId"]
                               for cc in ob["candidate"]][:k])
            for vi in range(36):
                if vi in used or k >= V:
                    continue
                view_img[i, k] = feats[vi, :D]
                loc_fts[i, k, :A] = feats[vi, D:]
                loc_fts[i, k, A:] = 1.0
                k += 1
            view_lens[i] = k
        ret = {"view_img_fts": self.runner.upload(view_img, self._feat_dtype),
               "loc_fts": loc_fts, "nav_types": nav_types,
               "view_lens": view_lens, "cand_vpids": cand_vpids}
        if has_obj:
            ret.update({"obj_img_fts": self.runner.upload(obj_img,
                                                          self._feat_dtype),
                        "obj_loc_fts": obj_loc, "obj_lens": obj_lens,
                        "obj_ids": obj_ids})
        return ret

    def nav_gmap_inputs(self, obs, gmaps: List[GraphMap],
                        fill_embeds: bool = False) -> Dict[str, Any]:
        """Graph-node bookkeeping. The node embeddings stay on the device,
        or with fill_embeds (the host-memory path) come from the graph maps
        as gmap_img_embeds [B, G, H] f32."""
        G = self.dims.max_gmap_nodes
        b = len(obs)
        A = self.args.angle_feat_size
        img = np.zeros((b, G, self.runner.cfg.hidden_size), np.float32) \
            if fill_embeds else None
        step_ids = np.zeros((b, G), np.int32)
        pos_fts = np.zeros((b, G, A + 3), np.float32)
        masks = np.zeros((b, G), bool)
        visited = np.zeros((b, G), bool)
        gmap_vpids: List[List[Optional[str]]] = []
        no_vp_left = []
        for i, gmap in enumerate(gmaps):
            vis, unvis = [], []
            for k in gmap.node_positions:
                (vis if gmap.visited(k) else unvis).append(k)
            no_vp_left.append(len(unvis) == 0)
            if self.args.enc_full_graph:
                vpids = [None] + vis + unvis
                vmask = [False] + [True] * len(vis) + [False] * len(unvis)
            else:
                vpids = [None] + unvis
                vmask = [False] * len(vpids)
            vpids, vmask = vpids[:G], vmask[:G]
            gmap_vpids.append(vpids)
            n = len(vpids)
            masks[i, :n] = True
            visited[i, :n] = vmask
            step_ids[i, :n] = [gmap.node_step_ids.get(vp, 0) for vp in vpids]
            if fill_embeds:
                for k, vp in enumerate(vpids):
                    if k > 0 and gmap.has_node_embed(vp):
                        img[i, k] = gmap.get_node_embed(vp)
            pos_fts[i, :n] = gmap.get_pos_fts(obs[i]["viewpoint"], vpids,
                                              obs[i]["heading"],
                                              obs[i]["elevation"], A)
        ret = {"gmap_step_ids": step_ids, "gmap_pos_fts": pos_fts,
               "gmap_masks": masks, "gmap_visited_masks": visited,
               "gmap_vpids": gmap_vpids, "no_vp_left": no_vp_left}
        if fill_embeds:
            ret["gmap_img_embeds"] = img
        return ret

    def nav_vp_inputs(self, obs, gmaps, pano_masks, cand_vpids,
                      pano_embeds=None) -> Dict[str, Any]:
        """[stop] + panorama views, with 14-dim pos features. The stop row's
        embedding is prepended on the device, or with pano_embeds [B, V, H]
        (the host-memory path) here, as vp_img_embeds [B, V+1, H] f32."""
        b, V = pano_masks.shape
        A = self.args.angle_feat_size
        masks = np.zeros((b, V + 1), bool)
        masks[:, 0] = True
        masks[:, 1:] = pano_masks
        pos = np.zeros((b, V + 1, 2 * A + 6), np.float32)
        for i, gmap in enumerate(gmaps):
            start = gmap.get_pos_fts(obs[i]["viewpoint"], [gmap.start_vp],
                                     obs[i]["heading"], obs[i]["elevation"], A)
            pos[i, :, : A + 3] = start[0]
            cand = gmap.get_pos_fts(obs[i]["viewpoint"], cand_vpids[i],
                                    obs[i]["heading"], obs[i]["elevation"], A)
            pos[i, 1: len(cand_vpids[i]) + 1, A + 3:] = cand
        ret = {"vp_pos_fts": pos, "pano_masks": masks,
               "vp_cand_vpids": [[None] + list(x) for x in cand_vpids]}
        if pano_embeds is not None:
            vp_img = np.zeros((b, V + 1, pano_embeds.shape[-1]), np.float32)
            vp_img[:, 1:] = pano_embeds
            ret["vp_img_embeds"] = vp_img
        return ret

    def local_match_slots(self, gmap_vpids, vp_cand_vpids, gmaps,
                          width: int) -> np.ndarray:
        """[B, width]: gmap slot of local candidate j's vpid if unvisited,
        else -1."""
        b = len(gmap_vpids)
        out = np.full((b, width), -1, np.int32)
        for i in range(b):
            index = {vp: k for k, vp in enumerate(gmap_vpids[i]) if vp}
            for j, vp in enumerate(vp_cand_vpids[i]):
                if j == 0 or vp is None:
                    continue
                if not gmaps[i].visited(vp) and vp in index:
                    out[i, j] = index[vp]
        return out

    def cand_order_and_prompts(self, gmap_inputs, instructions, history,
                               rng=None):
        """Random candidate permutation + schema prompts. Returns
        (cand_order [B,C], prompts, cand_nums)."""
        C = self.dims.max_cands
        b = len(instructions)
        rng = rng if rng is not None else self.np_rng
        order = np.full((b, C), -1, np.int32)
        prompts = []
        cand_nums = []
        for i in range(b):
            slots = [k for k, vp in enumerate(gmap_inputs["gmap_vpids"][i])
                     if k > 0 and vp is not None
                     and not gmap_inputs["gmap_visited_masks"][i][k]]
            perm = rng.permutation(slots)[:C]
            order[i, : len(perm)] = perm
            cand_num = len(slots) + 1          # + stop
            cand_nums.append(cand_num)
            prompts.append(self.get_prompt(
                "navigation", instruction=instructions[i],
                hist_num=len(history[i]), cand_num=min(cand_num, C + 1),
                cls_token=CLS_TOKEN_TEXT))
        return order, prompts, cand_nums

    def _cached_prompt_windows(self, slots, prompts, probe_fn, max_prefix):
        """Split each slot's navigation prompt into (append window, suffix
        window) relative to its cached prefix.

        The cacheable boundary: history items insert right after the last
        `<hist>` token (an atomic special token), so with history it is
        last-<hist>+1. At refill (no history yet) it is the longest common
        prefix of the prompt's ids and a PROBE prompt's (the same prompt
        with one more history item): the insertion point, with no
        assumption about how the tokenizer splices. Rows needing a
        (re)prefill get their prefix queued; inactive rows emit empty
        windows and keep their cache untouched. Returns (app_list,
        suf_list, prefill items [(row, prefix ids)])."""
        tok = self.runner.tok
        hist_id = tok.hist_id
        app_list, suf_list, prefill = [], [], []
        empty = np.zeros(0, np.int32)
        for i, sl in enumerate(slots):
            if not sl.active:
                app_list.append(empty)
                suf_list.append(empty)
                continue
            ids = np.asarray(tok.encode(prompts[i], add_bos=True), np.int32)
            if len(ids) > tok.max_length:
                # the uncached path would LEFT-truncate here, which an
                # append-only prefix cache cannot reproduce
                raise RuntimeError(
                    f"navigation prompt ({len(ids)} tokens) exceeds "
                    f"max_length={tok.max_length}; prefix caching cannot "
                    f"reproduce left truncation — disable "
                    f"args.prefix_cache for this dataset")
            hp = np.nonzero(ids == hist_id)[0]
            if len(hp):
                lcp = int(hp[-1]) + 1
            else:
                pids = np.asarray(tok.encode(probe_fn(i), add_bos=True),
                                  np.int32)
                m = min(len(ids), len(pids))
                ne = ids[:m] != pids[:m]
                lcp = int(np.argmax(ne)) if ne.any() else m
            if sl.needs_prefill or sl.cache_ids is None:
                sl.cache_ids = ids[:lcp]
                sl.needs_prefill = False
                prefill.append((i, sl.cache_ids))
                app_list.append(empty)
            else:
                n = len(sl.cache_ids)
                if n > lcp or not np.array_equal(ids[:n], sl.cache_ids):
                    raise RuntimeError(
                        "prefix-cache token mismatch: this step's prompt "
                        "does not extend the cached prefix (tokenizer "
                        "splice instability?) — disable with "
                        "args.prefix_cache=False")
                app_list.append(ids[n:lcp])
                sl.cache_ids = ids[:lcp]
            if len(sl.cache_ids) > max_prefix:
                raise RuntimeError(
                    f"prompt prefix ({len(sl.cache_ids)} tokens) exceeds "
                    f"RolloutDims.max_prefix={max_prefix}; raise it or "
                    f"disable args.prefix_cache")
            suf_list.append(ids[lcp:])
        return app_list, suf_list, prefill

    @staticmethod
    def _window_arrays(app_list, suf_list, cand_id, hist_id, cls_id, C,
                       min_a_w=8, min_s_w=64):
        """Pack ragged windows into bucketed arrays (append width a multiple
        of 8, suffix width of 64) and suffix-relative injection positions
        (the k-th <cand> token <-> cand_order[:, k], the pairing of
        tokenize_with_positions)."""
        n = len(app_list)
        a_w = max(min_a_w,
                  -(-max((len(a) for a in app_list), default=1) // 8) * 8)
        s_w = max(min_s_w,
                  -(-max((len(s) for s in suf_list), default=1) // 64) * 64)
        app_ids = np.zeros((n, a_w), np.int32)
        app_mask = np.zeros((n, a_w), bool)
        app_hist_pos = np.full(n, -1, np.int32)
        suf_ids = np.zeros((n, s_w), np.int32)
        suf_mask = np.zeros((n, s_w), bool)
        cand_pos = np.full((n, C), -1, np.int32)
        cls_pos = np.zeros(n, np.int32)
        for i, (a, s) in enumerate(zip(app_list, suf_list)):
            app_ids[i, : len(a)] = a
            app_mask[i, : len(a)] = True
            hp = np.nonzero(a == hist_id)[0]
            if len(hp):
                app_hist_pos[i] = hp[-1]
            suf_ids[i, : len(s)] = s
            suf_mask[i, : len(s)] = True
            cp = np.nonzero(s == cand_id)[0][:C]
            cand_pos[i, : len(cp)] = cp
            cl = np.nonzero(s == cls_id)[0]
            if len(cl):
                cls_pos[i] = cl[0]
        return {"app_ids": app_ids, "app_mask": app_mask,
                "app_hist_pos": app_hist_pos, "suf_ids": suf_ids,
                "suf_mask": suf_mask, "cand_positions": cand_pos,
                "cls_pos": cls_pos}

    def prefill_rows(self, cache, items, width, quant: bool = False):
        """Dispatch bucketed prompt-prefix prefills into ``cache``.

        items: [(row, prefix ids)]; width: the cache's batch rows. Calls
        run in fixed-width chunks (bp <= 8) at 64-bucketed prefix widths;
        padding entries point at distinct rows NOT being prefilled, with
        valid False (they write that row's old content back). quant:
        through the runner's W8A8 sampling policy (prefill_q), so the
        cached K/V comes from the policy that steps on it. Returns the
        cache."""
        bp = min(8, width)
        for c0 in range(0, len(items), bp):
            chunk = items[c0: c0 + bp]
            taken = {i for i, _ in chunk}
            spare = [r for r in range(width) if r not in taken]
            p_w = max(64, -(-max(len(p) for _, p in chunk) // 64) * 64)
            ids = np.zeros((bp, p_w), np.int32)
            mask = np.zeros((bp, p_w), bool)
            rows = np.zeros(bp, np.int32)
            valid = np.zeros(bp, bool)
            for j, (r, pref) in enumerate(chunk):
                ids[j, : len(pref)] = pref
                mask[j, : len(pref)] = True
                rows[j] = r
                valid[j] = True
            for j in range(len(chunk), bp):
                rows[j] = spare[j - len(chunk)]
            with self.timer.stage("prefill_dispatch"):
                cache = self.runner.prefill(cache, ids, mask, rows, valid,
                                            quant=quant)
        return cache

    def _memory_ids(self, gmaps, obs, cand_vpids, skip):
        """The ids of a device memory update: cur_ids [B], the current
        viewpoint's node, and cand_ids [B, V], the node each unvisited
        candidate view pools into (-1: none; rows in ``skip`` and nodes past
        the memory's capacity take none)."""
        b = len(gmaps)
        cur_ids = np.full(b, -1, np.int32)
        cand_ids = np.full((b, self.dims.max_views), -1, np.int32)
        for i, gmap in enumerate(gmaps):
            if skip[i]:
                continue
            gidx = gmap.graph.index
            cid = gidx.get(obs[i]["viewpoint"], -1)
            cur_ids[i] = cid if cid < MEM_CAPACITY else -1
            for j, cvp in enumerate(cand_vpids[i]):
                if not gmap.visited(cvp):
                    nid = gidx.get(cvp, -1)
                    if 0 <= nid < MEM_CAPACITY:
                        cand_ids[i, j] = nid
        return cur_ids, cand_ids

    @staticmethod
    def _slot_ids(gmap_in, gmaps) -> np.ndarray:
        """[B, G]: the memory node of each gmap slot (-1: the stop slot,
        padding, nodes past the memory's capacity)."""
        slot_ids = np.full(gmap_in["gmap_masks"].shape, -1, np.int32)
        for i, gmap in enumerate(gmaps):
            gidx = gmap.graph.index
            for k, vp in enumerate(gmap_in["gmap_vpids"][i]):
                if k > 0 and vp is not None:
                    nid = gidx.get(vp, -1)
                    if 0 <= nid < MEM_CAPACITY:
                        slot_ids[i, k] = nid
        return slot_ids

    @staticmethod
    def _pool_node_embeds(gmaps, obs, pano_embeds, pano_masks, cand_vpids,
                          skip):
        """The host graph memory's update (the host-memory path): the
        current node's embedding becomes the mean of its views, each
        unvisited candidate node pools its view; rows in ``skip`` are
        left alone."""
        denom = np.maximum(pano_masks.sum(1, keepdims=True), 1)
        avg = (pano_embeds * pano_masks[..., None]).sum(1) / denom
        for i, gmap in enumerate(gmaps):
            if skip[i]:
                continue
            gmap.update_node_embed(obs[i]["viewpoint"], avg[i], rewrite=True)
            for j, cvp in enumerate(cand_vpids[i]):
                if not gmap.visited(cvp):
                    gmap.update_node_embed(cvp, pano_embeds[i, j])

    def hist_arrays(self, hist_vis) -> np.ndarray:
        """[B, max_hist, H] f32: each row's last max_hist history embeds."""
        Hh = self.dims.max_hist
        out = np.zeros((len(hist_vis), Hh, self.runner.cfg.hidden_size),
                       np.float32)
        for i, vis in enumerate(hist_vis):
            for k, v in enumerate(vis[-Hh:]):
                out[i, k] = v
        return out

    def _generation_inputs(self, obs, history, instructions, mode,
                           answers=None):
        """The generation heads' host inputs: the 12 horizon views as the
        candidates of a summarization / EQA prompt (with answers, the
        [prompt, answer + eos] pairs). Returns (pano_inputs, nav_mask,
        TokenBatch, cand_positions, hist_positions)."""
        pano_in = self.panorama_inputs(obs, with_objects=False,
                                       twelve_views=True)
        V = self.dims.max_views
        host_masks = np.arange(V)[None, :] < pano_in["view_lens"][:, None]
        # the nav-type 1 views are a contiguous prefix: the 12 horizon ones
        nav_mask = (pano_in["nav_types"] == 1) & host_masks
        cand_counts = nav_mask.sum(1)
        prompts = [self.get_prompt(mode, instruction=instructions[i],
                                   hist_num=len(history[i]),
                                   cand_num=int(cand_counts[i]))
                   for i in range(len(obs))]
        if answers is not None:
            eos = self.runner.tok.eos_token
            prompts = [[p, a + eos] for p, a in zip(prompts, answers)]
        tok_batch, cand_pos, hist_pos, _ = self.runner.tokenize_with_positions(
            prompts, max_cands=max(int(cand_counts.max()), 1))
        return pano_in, nav_mask, tok_batch, cand_pos, hist_pos

    def _generate_answers(self, obs, history, hist_vis, instructions, mode,
                          trie) -> List[str]:
        """Greedy decode of up to 50 tokens after the generation prompt,
        the panorama's fused views and the history injected at its <cand>
        and <hist> tokens (the eval side of the generation heads)."""
        runner = self.runner
        pano_in, nav_mask, tok_batch, cand_pos, hist_pos = \
            self._generation_inputs(obs, history, instructions, mode)
        pe = runner.panorama_dev_dict(pano_in, deterministic=True)[
            "pano_embeds"]
        emb = runner.gen_embeds(pe, nav_mask)[:, : cand_pos.shape[1]]
        inj_emb = torch.cat([emb.float(),
                             runner.upload(self.hist_arrays(hist_vis))], 1)
        gen_ids = runner.generate(
            tok_batch.input_ids, tok_batch.attention_mask,
            np.concatenate([cand_pos, hist_pos], 1), inj_emb,
            max_new_tokens=50, do_sample=False, trie=trie)
        return decode_to_text(runner.tok, gen_ids)

    def _generation_step(self, args, obs, history, hist_vis, instructions,
                         answers, mode, training, traj=None, trie=None,
                         loss_denom=None):
        """Summarization / EQA / FGR2R generation head over the 12-view
        panorama: training, the teacher-forced LM loss times gen_loss_coef
        / loss_denom / gradient_accumulation_step (a device scalar);
        evaluation, the decoded answers written onto traj."""
        if training:
            pano_in, nav_mask, tok_batch, cand_pos, hist_pos = \
                self._generation_inputs(obs, history, instructions, mode,
                                        answers)
            labels = tok_batch.input_ids.astype(np.int64)
            labels[tok_batch.token_type_ids == 0] = self.args.ignoreid
            batch = {"input_ids": tok_batch.input_ids,
                     "attention_mask": tok_batch.attention_mask,
                     "labels": labels, "vp_masks": nav_mask,
                     "cand_positions": cand_pos, "hist_positions": hist_pos,
                     "hist_embeds": self.hist_arrays(hist_vis)}
            coef = args.gen_loss_coef / (loss_denom or len(obs)) \
                / args.gradient_accumulation_step
            return self.runner.pano_generation_train(
                pano_in, self.runner.next_seed(), batch, coef)
        sentences = self._generate_answers(obs, history, hist_vis,
                                           instructions, mode, trie)
        for i in range(len(obs)):
            traj[i]["generated_sentences"] = sentences[i]
            traj[i]["answer"] = answers[i]
        return 0.0

    def _streaming_generation(self, snaps, n_real, trie, results):
        """Batched generation (EQA answers, test-mode summaries) for the
        snapshots of finished streaming slots, padded to the flush width
        with copies of the last one; only the first n_real are real. An
        oracle snapshot writes oracle_pred_answer into its episode's
        results entry."""
        is_eqa = snaps[0]["data_type"] == "eqa"
        sentences = self._generate_answers(
            [sn["ob"] for sn in snaps], [sn["history"] for sn in snaps],
            [sn["hist_vis"] for sn in snaps],
            [sn["instruction"] for sn in snaps],
            "embodied_qa" if is_eqa else "summarization",
            trie if is_eqa else None)
        for sn, sentence in zip(snaps[:n_real], sentences):
            if sn["oracle"]:
                entry = results.get(sn["traj"]["instr_id"])
                if entry is not None:
                    entry["oracle_pred_answer"] = sentence
            else:
                sn["traj"]["generated_sentences"] = sentence
                sn["traj"]["answer"] = sn["ob"].get("answer", "") \
                    if is_eqa else sn["instruction"]

    def _og_inputs(self, pano_in, has_obj, instructions, history,
                   hist_vis):
        """The object-grounding prompt and its host arrays for a batch:
        with has_obj obj_masks from obj_lens, else all False and zero
        objects (the model has no object branch or the observations no
        objects); one <cand> per object after "(0) not exist", the history
        at <hist>. Returns the batch without obj_embeds."""
        b = len(instructions)
        O = self.dims.max_objects
        if has_obj:
            obj_masks = np.arange(O)[None, :] < pano_in["obj_lens"][:, None]
            obj_loc = pano_in["obj_loc_fts"]
        else:
            obj_masks = np.zeros((b, O), bool)
            obj_loc = np.zeros((b, O, self.args.angle_feat_size + 3),
                               np.float32)
        prompts = [self.get_prompt(
            "object_grounding", instruction=instructions[i],
            hist_num=len(history[i]), cand_num=int(obj_masks[i].sum()) + 1,
            cls_token=CLS_TOKEN_TEXT) for i in range(b)]
        tok_batch, cand_pos, hist_pos, cls_pos = \
            self.runner.tokenize_with_positions(prompts, max_cands=O)
        return {"obj_loc_fts": obj_loc, "obj_masks": obj_masks,
                "input_ids": tok_batch.input_ids,
                "attention_mask": tok_batch.attention_mask,
                "cand_positions": cand_pos, "hist_positions": hist_pos,
                "hist_embeds": self.hist_arrays(hist_vis),
                "cls_pos": cls_pos}

    @staticmethod
    def _write_objects(obs, obj_logits, trajs):
        """pred_objid (the best of the viewpoint's objects, option 0 aside)
        and, for SOON, its direction onto each traj; None without
        objects."""
        for ob, logits, traj in zip(obs, obj_logits, trajs):
            objids = ob["obj_ids"]
            if len(objids):
                best = int(logits[1: len(objids) + 1].argmax())
                traj["pred_objid"] = objids[best]
                dirs = ob.get("obj_directions")
                traj["pred_obj_direction"] = dirs[best] if dirs else None
            else:
                traj["pred_objid"] = None
                traj["pred_obj_direction"] = None

    def _object_grounding_step(self, args, obs, instructions, history,
                               hist_vis, traj, training, loss_denom=None):
        """The object-grounding head at the final step (twin of
        _object_grounding_step): training, the OG loss times obj_loss_coef /
        loss_denom / gradient_accumulation_step through the panorama's
        object branch (runner.pano_og_train; a device scalar); evaluation,
        the objects' logits. Either way pred_objid (and for SOON its
        direction) lands on traj."""
        runner = self.runner
        b = len(obs)
        pano_in = self.panorama_inputs(obs)
        seed = runner.next_seed()
        has_obj = "obj_img_fts" in pano_in and runner.cfg.pano.use_obj
        og_batch = self._og_inputs(pano_in, has_obj, instructions, history,
                                   hist_vis)
        if not has_obj:
            og_batch["obj_embeds"] = np.zeros(
                (b, self.dims.max_objects, runner.cfg.hidden_size),
                np.float32)
        loss = 0.0
        if training:
            targets = self.teacher_object(obs)
            coef = args.obj_loss_coef / (loss_denom or b) \
                / args.gradient_accumulation_step
            if has_obj:
                obj_logits, loss = runner.pano_og_train(
                    pano_in, seed, og_batch, targets, coef)
            else:
                obj_logits, loss = runner.object_grounding(
                    og_batch, targets=targets, coef=coef, train=True)
        else:
            if has_obj:
                og_batch["obj_embeds"] = runner.panorama_dev_dict(
                    pano_in, deterministic=True, seed=seed)["obj_embeds"]
            obj_logits, _ = runner.object_grounding(og_batch)
        self._write_objects(obs, obj_logits, traj)
        return loss

    def _streaming_og(self, snaps, n_real):
        """Object grounding (_object_grounding_step's evaluation branch) for
        the snapshots of finished streaming slots, padded to the flush width
        with copies of the last one; only the first n_real write their
        episode's pred_objid."""
        trajs = [sn["traj"] for sn in snaps[:n_real]] \
            + [{} for _ in snaps[n_real:]]
        self._object_grounding_step(
            self.args, [sn["ob"] for sn in snaps],
            [sn["instruction"] for sn in snaps],
            [sn["history"] for sn in snaps],
            [sn["hist_vis"] for sn in snaps], trajs, training=False)

    def teacher_action(self, obs, vpids, ended, visited_masks=None,
                       imitation_learning=False, t=None) -> np.ndarray:
        """Expert action per row (twin of teacher_action): under imitation
        learning on R2R the next ground-truth node, else the unvisited
        node minimising d(cur, v) + d(v, goal); ignoreid for ended rows."""
        a = np.zeros(len(obs), np.int64)
        for i, ob in enumerate(obs):
            if ended[i]:
                a[i] = self.args.ignoreid
                continue
            if imitation_learning and "r2r" in ob["instr_id"]:
                if ob["viewpoint"] != ob["gt_path"][t]:
                    raise ValueError(f"{ob['instr_id']} left its ground-truth "
                                     f"path at step {t}")
                if t == len(ob["gt_path"]) - 1:
                    a[i] = 0
                else:
                    goal = ob["gt_path"][t + 1]
                    for j, vpid in enumerate(vpids[i]):
                        if vpid == goal:
                            a[i] = j
                            break
            elif ob["viewpoint"] == ob["gt_path"][-1]:
                a[i] = 0
            else:
                dist = self.world.graph(ob["scan"]).distance
                cur, goal = ob["viewpoint"], ob["gt_path"][-1]
                min_idx, min_dist = self.args.ignoreid, float("inf")
                for j, vpid in enumerate(vpids[i]):
                    if j == 0 or vpid is None:
                        continue
                    if visited_masks is not None and visited_masks[i][j]:
                        continue
                    d = dist(vpid, goal) + dist(cur, vpid)
                    if d < min_dist:
                        min_dist, min_idx = d, j
                a[i] = min_idx
        return a

    def teacher_object(self, obs) -> np.ndarray:
        """Target option of the object-grounding head: the ground-truth
        object's index + 1 (option 0 is "not exist") where this viewpoint
        sees it, else ignoreid."""
        targets = np.zeros(len(obs), np.int64)
        for i, ob in enumerate(obs):
            targets[i] = self.args.ignoreid
            if len(ob["obj_ids"]) and ob["viewpoint"] in ob["gt_end_vps"]:
                for j, obj_id in enumerate(ob["obj_ids"]):
                    if str(obj_id) == str(ob["gt_obj_id"]):
                        targets[i] = j + 1
                        break
        return targets

    def make_equiv_action(self, a_t_vpids, gmaps, obs, traj, envs):
        """Append the graph path and teleport the sim."""
        for i, ob in enumerate(obs):
            action = a_t_vpids[i]
            if action is None:
                continue
            traj[i]["path"].append(gmaps[i].graph.path(ob["viewpoint"],
                                                       action))
            if len(traj[i]["path"][-1]) == 1:
                prev_vp = traj[i]["path"][-2][-1]
            else:
                prev_vp = traj[i]["path"][-1][-2]
            viewidx = self.scanvp_cands["%s_%s" % (ob["scan"], prev_vp)][action]
            heading = (viewidx % 12) * math.radians(30)
            elevation = (viewidx // 12 - 1) * math.radians(30)
            envs[i].new_episode(0, ob["scan"], action, heading, elevation)

    # ---------------- training ------------------------------------------ #
    def train(self, name, batch, args, config, dataset, step=0, **kwargs):
        """One training batch (twin of MP3DAgent.train). At stage pretrain
        and on even steps teacher forcing: the fused teacher
        (fused_teacher), else the per-step rollout. On odd steps of stage
        multi the DAgger half: the fused DAgger (fused_dagger), else the
        per-step sampled rollout, split into dagger_streams streams driven
        by rollout_interleaved when dagger_pipeline is on, the runner keeps
        its memory on the device, dagger_streams >= 2 and the batch has at
        least 4 episodes (dagger_streams 1 is the serial baseline).
        ``kwargs`` (forced_actions and np_rng of the fused DAgger, np_rng of
        the per-step rollouts) go to the rollout. Returns the loss (a
        device scalar or a float) times gradient_accumulation_step, as the
        JAX agent does."""
        stage_cfg = config.Pretrain if args.stage == "pretrain" \
            else config.Multi
        loss_coef = (getattr(stage_cfg, "LOSS_COEF", None) or {}) \
            .get(name, 1.0)
        from . import fused_teacher as FT
        if args.stage == "pretrain" or step % 2 == 0:
            train_ml = loss_coef * args.teacher_forcing_coef
            if args.fused_teacher:
                loss, _ = FT.rollout_teacher_fused(
                    self, args, name, config.Optim, batch, dataset=dataset,
                    train_ml=train_ml, **kwargs)
            else:
                loss, _ = self.rollout(args, name, config.Optim, batch,
                                       dataset=dataset, feedback="teacher",
                                       train_ml=train_ml, **kwargs)
        elif args.fused_dagger:
            # the DAgger half's coefficient is LOSS_COEF alone, as in JAX
            loss, _ = FT.rollout_dagger_fused(
                self, args, name, config.Optim, batch, dataset=dataset,
                train_ml=loss_coef, **kwargs)
        else:
            n_streams = max(1, int(args.dagger_streams))
            if args.dagger_pipeline and self.runner.device_memory \
                    and n_streams >= 2 and len(batch["observations"]) >= 4:
                loss, _ = self.rollout_interleaved(
                    args, name, config.Optim,
                    _split_batch_dict(batch, n_streams), dataset=dataset,
                    feedback="sample", train_ml=loss_coef, **kwargs)
            else:
                loss, _ = self.rollout(args, name, config.Optim, batch,
                                       dataset=dataset, feedback="sample",
                                       train_ml=loss_coef, **kwargs)
        return loss * args.gradient_accumulation_step

    def _eqa_trie(self, name, dataset) -> Optional[DenseTrie]:
        """EQA's answer vocabulary as a trie (the constraint of its
        generated answers); None for the other tasks."""
        if name != "EQA":
            return None
        return DenseTrie([self.runner.tok.encode(w, add_bos=True)
                          for w in dataset.answer_vocab],
                         eos_id=self.runner.tok.eos_id,
                         device=self.runner.device)

    # ---------------- batched evaluation -------------------------------- #
    def validate(self, name, args, config, loader, dataset=None, **kwargs):
        """Batched evaluation (twin of MP3DAgent.validate): each loader
        batch rolls out together (rollout, argmax or with do_sample sampled
        on the host) until its last episode ends. On EQA the answers come
        from trie-constrained generation at the final step, and the batch
        rolls out again under the expert's actions (the oracle pass) for
        oracle_pred_answer. Stops after the first batch that repeats an
        episode. Returns get_results."""
        results: Dict[str, dict] = {}
        trie = self._eqa_trie(name, dataset)
        looped = False
        for batch in loader:
            _, traj = self.rollout(
                args, name, config.Optim, batch, dataset=dataset,
                feedback="sample" if args.do_sample else "argmax",
                train_ml=None, validate=True, trie=trie, **kwargs)
            for s in traj:
                if s["instr_id"] in results:
                    looped = True
                else:
                    results[s["instr_id"]] = s
            if name == "EQA":
                _, oracle_traj = self.rollout(
                    args, name, config.Optim, batch, dataset=dataset,
                    feedback="teacher", train_ml=1, validate=True,
                    trie=trie, **kwargs)
                for s in oracle_traj:
                    results[s["instr_id"]]["oracle_pred_answer"] = \
                        s.get("generated_sentences", "")
            if looped:
                break
        return get_results(results)

    # ---------------- continuous-refill streaming evaluation ----------- #
    def validate_streaming(self, name, args, config, loader, dataset=None):
        """Slot-refill greedy evaluation: N episode slots step together and
        a slot whose episode ends is refilled with the next sample at once.
        Slot groups pipeline the work: while the card runs group A's fused
        step, the host retires group B's previous actions (env step,
        get_obs, refill) and assembles and dispatches B's next step; only
        a_t ([B] int32) comes back, through a pinned non-blocking copy.

        With args.prefix_cache (and the runner's memory policy agreeing),
        each slot group owns a prompt-prefix KV cache: a refilled slot's
        instruction prefix is prefilled once, and each step forwards only
        the new history tokens and the candidates section
        (runner.eval_step_cached); queued prefills are flushed before the
        group's step is dispatched.

        EQA streams too: a finishing slot's snapshot (its final observation
        and the history embeds of the device memory) joins a generation
        queue, answered by trie-constrained generation in batches of the
        slot-group width (_streaming_generation), and the slot re-runs the
        same sample with the expert's actions forced through a_t_override
        (the oracle pass), whose answer is oracle_pred_answer. Test-mode
        summarization (enable_summarize, mode "test", not do_sample) rides
        the same queue.

        REVERIE and SOON with args.enable_og: a finishing slot's snapshot
        joins an object-grounding queue, grounded in batches of the
        slot-group width (_streaming_og), which writes pred_objid (and for
        SOON pred_obj_direction) onto the episode's result.

        With args.do_sample each step draws its action on the card at
        args.temperature (device_memory.sample_actions, a generator seeded
        from the runner's), uncached or cached; oracle rows stay forced.

        A runner without device memory (device_memory=False) runs one slot
        group on the host path: each step the panorama comes down
        (runner.panorama), the graph maps pool the node embeddings, the
        step uploads them with the history (runner.navigation, whose
        logits come down), and the action is the argmax or a draw on the
        host from the agent's RandomState, as the per-step rollout's."""
        trie = self._eqa_trie(name, dataset)
        use_mem = self.runner.device_memory

        def needs_generation(sl):
            # summarization only under argmax, never under sampling (the
            # batched rollout's feedback gate)
            return sl.data_type == "eqa" or (
                sl.data_type in SUMMARIZED_TYPES
                and args.enable_summarize and args.mode == "test"
                and not args.do_sample)

        do_sample = bool(args.do_sample)

        eqa_oracle = name == "EQA"
        kv_int8 = getattr(args, "kv_int8", False)
        max_action_len = config.Optim.val_max_action_len[name]
        assert max_action_len <= self.dims.max_hist, (
            f"max_action_len {max_action_len} exceeds history capacity "
            f"{self.dims.max_hist}: raise RolloutDims.max_hist")
        num_slots = max(args.val_batch_size, 1)

        def sample_iter():
            for batch in loader:
                for i in range(batch["batch_size"]):
                    yield {k: batch[k][i] for k in
                           ("observations", "env", "item", "data_type",
                            "instr_id")}

        samples = sample_iter()
        results: Dict[str, dict] = {}
        og_queue: List[dict] = []
        gen_queue: List[dict] = []

        class Slot:
            __slots__ = ("ob", "env", "item", "data_type", "gmap", "traj",
                         "history", "hist_vis", "t", "active", "instruction",
                         "oracle", "cache_ids", "needs_prefill")

        def init_episode(slot):
            slot.gmap = GraphMap(slot.ob["viewpoint"])
            slot.gmap.update_graph(slot.ob)
            slot.history = []
            slot.hist_vis = []
            slot.t = 0
            slot.active = True
            slot.instruction = slot.ob["instruction"]
            slot.cache_ids = None
            slot.needs_prefill = True
            self.update_scanvp_cands([slot.ob])

        def fill(slot) -> bool:
            try:
                s = next(samples)
            except StopIteration:
                slot.active = False
                return False
            slot.ob = s["observations"]
            slot.env = s["env"]
            slot.item = s["item"]
            slot.data_type = s["data_type"]
            slot.traj = {"instr_id": s["instr_id"],
                         "path": [[slot.ob["viewpoint"]]], "details": {}}
            slot.oracle = False
            init_episode(slot)
            return True

        def restart_as_oracle(slot):
            """The EQA oracle pass: the same sample from its start, with
            fresh graph memory, stepping by the expert's actions."""
            item = slot.item
            slot.env.new_episodes([item["scan"]], [item["path"][0]],
                                  [item.get("heading") or 0.0])
            slot.ob = dataset.get_obs(items=[item], env=slot.env,
                                      data_type=slot.data_type)[0]
            slot.traj = {"instr_id": slot.traj["instr_id"],
                         "path": [[slot.ob["viewpoint"]]], "details": {}}
            slot.oracle = True
            init_episode(slot)

        n_streams = max(1, int(getattr(args, "eval_streams", 0) or 2))
        use_cache = args.prefix_cache and self.runner.prefix_cache_enabled(
            num_slots, self.dims.max_prefix, n_caches=n_streams,
            kv_int8=kv_int8)
        # the host path waits for the whole logits in its step, so it has
        # nothing to overlap: one slot group
        if not use_mem:
            n_streams = 1

        class Stream:
            __slots__ = ("slots", "mem_state", "reset_rows", "pending",
                         "pano_inputs", "gmap_in", "nav_batch", "cur_ids",
                         "cand_ids", "real_mask", "a_t_override", "a_t",
                         "fuse_embeds", "cache", "prefill_items")

        streams: List[Stream] = []
        for _ in range(n_streams):
            st = Stream()
            st.slots = []
            for _ in range(num_slots):
                sl = Slot()
                if fill(sl):
                    st.slots.append(sl)
            if not st.slots:
                break
            st.mem_state = (self.runner.memory_init(len(st.slots))
                            if use_mem else None)
            st.cache = (self.runner.prefix_cache_init(
                len(st.slots), self.dims.max_prefix, kv_int8=kv_int8)
                if use_cache else None)
            st.prefill_items = []
            st.reset_rows = np.zeros(len(st.slots), bool)
            st.pending = False
            streams.append(st)
        if not streams:
            return []
        flush_width = len(streams[0].slots)
        self.start_prefetcher(dataset)

        def flush_og(force=False):
            # two streams can queue up to 2 x flush_width snapshots in one
            # iteration, so a forced flush loops until the queue is empty
            while og_queue and (force or len(og_queue) >= flush_width):
                batch = og_queue[: flush_width]
                del og_queue[: len(batch)]
                pad = batch + [batch[-1]] * (flush_width - len(batch))
                self._streaming_og(pad, len(batch))

        def flush_gen(force=False):
            while gen_queue and (force or len(gen_queue) >= flush_width):
                batch = gen_queue[: flush_width]
                del gen_queue[: len(batch)]
                pad = batch + [batch[-1]] * (flush_width - len(batch))
                self._streaming_generation(pad, len(batch), trie, results)

        def _pre(st: Stream) -> bool:
            """Host assembly of st's next step inputs. False once the
            stream has no active slot (dataset drained)."""
            if not any(sl.active for sl in st.slots):
                return False
            # fixed slot->row binding: inactive rows are stale and ignored
            active = st.slots
            n = len(active)
            st.real_mask = np.array([sl.active for sl in active])
            obs = [sl.ob for sl in active]
            gmaps = [sl.gmap for sl in active]
            self.prefetch([sl.ob for sl in active if sl.active])
            for sl in active:
                if sl.active:
                    sl.gmap.node_step_ids[sl.ob["viewpoint"]] = sl.t + 1

            with self.timer.stage("pano_assemble"):
                pano_inputs = self.panorama_inputs(obs)
                host_pano_masks = (np.arange(self.dims.max_views)[None, :]
                                   < pano_inputs["view_lens"][:, None])
            pano_embeds = None
            if use_mem:
                # ids of the on-card memory update (which runs inside the
                # fused eval step)
                st.cur_ids, st.cand_ids = self._memory_ids(
                    gmaps, obs, pano_inputs["cand_vpids"],
                    ~st.real_mask)
            else:
                with self.timer.stage("pano_device"):
                    pano_out = self.runner.panorama(pano_inputs,
                                                    deterministic=True)
                pano_embeds = pano_out["pano_embeds"]
                host_pano_masks = pano_out["pano_masks"]
                self._pool_node_embeds(gmaps, obs, pano_embeds,
                                       host_pano_masks,
                                       pano_inputs["cand_vpids"],
                                       ~st.real_mask)

            with self.timer.stage("nav_assemble"):
                with self.timer.stage("na_gmap"):
                    gmap_in = self.nav_gmap_inputs(obs, gmaps,
                                                   fill_embeds=not use_mem)
                with self.timer.stage("na_vp"):
                    vp_in = self.nav_vp_inputs(obs, gmaps, host_pano_masks,
                                               pano_inputs["cand_vpids"],
                                               pano_embeds)
                    match = self.local_match_slots(
                        gmap_in["gmap_vpids"], vp_in["vp_cand_vpids"], gmaps,
                        width=host_pano_masks.shape[1] + 1)
                with self.timer.stage("na_prompts"):
                    order, prompts, cand_nums = self.cand_order_and_prompts(
                        gmap_in, [sl.instruction for sl in active],
                        [sl.history for sl in active])
                with self.timer.stage("na_tok"):
                    if use_cache:
                        C = self.dims.max_cands

                        def probe_fn(i):
                            return self.get_prompt(
                                "navigation",
                                instruction=active[i].instruction,
                                hist_num=len(active[i].history) + 1,
                                cand_num=min(cand_nums[i], C + 1),
                                cls_token=CLS_TOKEN_TEXT)

                        app_l, suf_l, st.prefill_items = \
                            self._cached_prompt_windows(
                                active, prompts, probe_fn,
                                self.dims.max_prefix)
                        tok = self.runner.tok
                        text = self._window_arrays(
                            app_l, suf_l, tok.cand_id, tok.hist_id,
                            tok.cls_ids[0], C)
                    else:
                        tok_batch, cand_pos, hist_pos, cls_pos = \
                            self.runner.tokenize_with_positions(prompts)
                        text = {"cand_positions": cand_pos,
                                "hist_positions": hist_pos,
                                "input_ids": tok_batch.input_ids,
                                "attention_mask": tok_batch.attention_mask,
                                "cls_pos": cls_pos}
            st.nav_batch = {
                "gmap_step_ids": gmap_in["gmap_step_ids"],
                "gmap_pos_fts": gmap_in["gmap_pos_fts"],
                "gmap_masks": gmap_in["gmap_masks"],
                "gmap_visited_masks": gmap_in["gmap_visited_masks"],
                "vp_pos_fts": vp_in["vp_pos_fts"],
                "pano_masks": vp_in["pano_masks"],
                "local_match_slot": match,
                "cand_order": order,
                **text,
            }
            if use_mem:
                st.nav_batch["slot_ids"] = self._slot_ids(gmap_in, gmaps)
            else:
                st.nav_batch.update({
                    "gmap_img_embeds": gmap_in["gmap_img_embeds"],
                    "vp_img_embeds": vp_in["vp_img_embeds"],
                    "hist_embeds": self.hist_arrays(
                        [sl.hist_vis for sl in active])})
            # oracle slots follow the expert (a host shortest-path argmin)
            st.a_t_override = np.full(n, -1, np.int32)
            for i, sl in enumerate(active):
                if sl.active and sl.oracle:
                    tgt = self.teacher_action(
                        [sl.ob], [gmap_in["gmap_vpids"][i]],
                        np.zeros(1, bool),
                        visited_masks=gmap_in["gmap_visited_masks"][i:i + 1],
                        imitation_learning=True, t=sl.t)[0]
                    st.a_t_override[i] = max(int(tgt), 0)
            st.pano_inputs = pano_inputs
            st.gmap_in = gmap_in
            return True

        def _dispatch(st: Stream):
            # ONE device call: reset refills -> pano -> mem update -> nav
            # forward -> argmax -> hist append; a_t's download starts now.
            # On the cached path the queued prefills go first (the card
            # runs them in dispatch order, so the step sees fresh K/V).
            if use_cache:
                items, st.prefill_items = st.prefill_items, []
                if items:
                    st.cache = self.prefill_rows(st.cache, items,
                                                 len(st.slots))
                with self.timer.stage("nav_dispatch"):
                    st.mem_state, st.cache, a_t, _ = \
                        self.runner.eval_step_cached(
                            st.mem_state, st.cache, st.pano_inputs,
                            st.nav_batch, st.reset_rows, st.cur_ids,
                            st.cand_ids, st.real_mask, st.a_t_override,
                            do_sample=do_sample,
                            temperature=args.temperature, sync=False)
                    st.a_t = HostCopy(a_t)
            elif use_mem:
                with self.timer.stage("nav_dispatch"):
                    st.mem_state, a_t, _ = self.runner.eval_step(
                        st.mem_state, st.pano_inputs, st.nav_batch,
                        st.reset_rows, st.cur_ids, st.cand_ids,
                        st.real_mask, st.a_t_override, do_sample=do_sample,
                        temperature=args.temperature, sync=False)
                    st.a_t = HostCopy(a_t)
            else:
                with self.timer.stage("nav_device"):
                    logits, st.fuse_embeds, _ = \
                        self.runner.navigation(st.nav_batch)
                if do_sample:
                    probs = _softmax(logits / max(args.temperature, 1e-6))
                    a_t = np.array([self.np_rng.choice(
                        len(p), p=(p / p.sum()).astype(np.float64))
                        for p in probs.astype(np.float64)])
                else:
                    a_t = logits.argmax(1)
                st.a_t = np.where(st.a_t_override >= 0, st.a_t_override,
                                  a_t)
            st.pending = True

        def _post(st: Stream):
            """Retire st's in-flight step: wait for a_t only, then run the
            per-slot host work (stop handling, refill, env step)."""
            st.pending = False
            with self.timer.stage("nav_sync"):
                a_t = st.a_t.result() if use_mem else st.a_t
            st.a_t = None
            nav_vpids = st.gmap_in["gmap_vpids"]
            st.reset_rows = np.zeros(len(st.slots), bool)
            for i, sl in enumerate(st.slots):
                if not sl.active:
                    continue
                sl.history.append("<hist>")
                if not use_mem:
                    sl.hist_vis.append(st.fuse_embeds[i, a_t[i]])
                sl.t += 1
                stop = (a_t[i] == 0) or st.gmap_in["no_vp_left"][i] \
                    or sl.t >= max_action_len
                if stop:
                    need_og = sl.data_type in ("soon", "reverie") \
                        and args.enable_og and not sl.oracle
                    need_gen = needs_generation(sl)
                    if need_og or need_gen:
                        if use_mem:
                            # the heads read the history values: one
                            # download of this row of the history buffer
                            buf = st.mem_state["hist_buf"][i].cpu().numpy()
                            cnt = int(st.mem_state["hist_cnt"][i])
                            hist_vis = list(buf[: min(cnt, len(buf))])
                        else:
                            hist_vis = list(sl.hist_vis)
                        snap = {
                            "ob": sl.ob, "history": list(sl.history),
                            "hist_vis": hist_vis,
                            "instruction": sl.instruction, "traj": sl.traj,
                            "oracle": sl.oracle,
                            "data_type": sl.data_type}
                        if need_og:
                            og_queue.append(snap)
                        if need_gen:
                            gen_queue.append(snap)
                    if sl.oracle:
                        fill(sl)
                    else:
                        results[sl.traj["instr_id"]] = sl.traj
                        if eqa_oracle:
                            restart_as_oracle(sl)
                        else:
                            fill(sl)
                    st.reset_rows[i] = True
                else:
                    action = nav_vpids[i][a_t[i]]
                    with self.timer.stage("env_step"):
                        self.make_equiv_action([action], [sl.gmap], [sl.ob],
                                               [sl.traj], [sl.env])
                    with self.timer.stage("get_obs"):
                        sl.ob = dataset.get_obs(items=[sl.item], env=sl.env,
                                                data_type=sl.data_type)[0]
                    self.update_scanvp_cands([sl.ob])
                    sl.gmap.update_graph(sl.ob)

        # prime the pipeline: each stream's first step is dispatched
        # before any result is awaited
        for st in streams:
            if _pre(st):
                _dispatch(st)
        while True:
            progressed = False
            for st in streams:
                if not st.pending:
                    continue
                progressed = True
                _post(st)
                if _pre(st):
                    _dispatch(st)
            if not progressed:
                break
            flush_og()
            flush_gen()
        flush_og(force=True)
        flush_gen(force=True)
        return get_results(results)

    # ---------------- the per-step rollout ------------------------------ #
    def rollout(self, args, name, optim_cfg, batch_dict, dataset, feedback,
                train_ml, validate=False, trie=None, **kwargs):
        """The per-step rollout of one batch (twin of MP3DAgent.rollout):
        _rollout_gen drained in one stream. Returns (loss, trajectories)."""
        gen = self._rollout_gen(args, name, optim_cfg, batch_dict, dataset,
                                feedback, train_ml, validate=validate,
                                trie=trie, **kwargs)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def rollout_interleaved(self, args, name, optim_cfg, halves, dataset,
                            feedback, train_ml, **kwargs):
        """The per-step DAgger rollout over the streams of one batch
        (_split_batch_dict), advanced in lockstep: while one stream's step
        (forward, backward and the panorama's backward) runs on the card,
        the others do their host work (action draw, env step, observations,
        prompts). Every loss term divides by the whole batch's size, so
        the gradients are those of draining the same streams in sequence,
        up to the order of accumulation. Each stream draws its candidate
        permutations and actions from its own RandomState (stream_rngs, or
        seeded from the agent's), so the interleaving order moves no draw.
        Returns (loss, trajectories in stream order)."""
        denom = sum(len(h["observations"]) for h in halves)
        stream_rngs = kwargs.pop("stream_rngs", None)
        if stream_rngs is None:
            stream_rngs = [np.random.RandomState(
                int(self.np_rng.randint(0, 2 ** 31 - 1))) for _ in halves]
        gens = [self._rollout_gen(args, name, optim_cfg, h, dataset,
                                  feedback, train_ml, loss_denom=denom,
                                  np_rng=srng, **kwargs)
                for h, srng in zip(halves, stream_rngs)]
        results: List[Optional[tuple]] = [None] * len(gens)
        live = list(range(len(gens)))
        while live:
            for gi in list(live):
                try:
                    next(gens[gi])
                except StopIteration as e:
                    results[gi] = e.value
                    live.remove(gi)
        loss = sum(r[0] for r in results)
        traj = [t for r in results for t in r[1]]
        return loss, traj

    def _rollout_gen(self, args, name, optim_cfg, batch_dict, dataset,
                     feedback, train_ml, validate=False, trie=None,
                     loss_denom=None, np_rng=None, **kwargs):
        """The per-step rollout as a generator (twin of _rollout_gen): per
        step the panorama, the graph memory's update, the navigation step
        (with its loss and gradient when training), the action (the
        expert's under teacher feedback, a draw on the host under sample,
        the argmax under argmax), the history, and on the final step the
        sub-task heads, then the env step.

        Training with device memory runs each step as one grad call on the
        card's memory (runner.pano_mem_navigation_train) and yields between
        dispatching it and downloading its logits: rollout_interleaved
        runs the other streams' host work there. Otherwise the panorama
        comes down (runner.panorama) and the graph maps pool the node
        embeddings; training then recomputes the panorama in its grad call
        with the same seed (runner.pano_navigation_train), so the memory's
        copy and the differentiated one draw the same dropout, and
        evaluation runs runner.navigation. Memory and history leave the
        graph: no step's gradient reaches an earlier one.

        loss_denom divides every loss term (the whole batch's size under
        rollout_interleaved); np_rng replaces the agent's RandomState for
        the candidate permutations and the draws. Returns (loss, a device
        scalar or a float, and the trajectories) as StopIteration's
        value."""
        runner = self.runner
        obs = list(batch_dict["observations"])
        envs = batch_dict["env"]
        items = batch_dict["item"]
        data_type = batch_dict["data_type"]
        batch_size = len(obs)
        training = train_ml is not None and not validate
        loss_den = loss_denom if loss_denom is not None else batch_size
        rng_local = np_rng if np_rng is not None else self.np_rng
        max_action_len = optim_cfg.val_max_action_len[name] if validate \
            else optim_cfg.train_max_action_len[name]
        assert max_action_len <= self.dims.max_hist, (
            f"max_action_len {max_action_len} exceeds history capacity "
            f"{self.dims.max_hist}: hist_append would overwrite the last "
            f"slot; raise RolloutDims.max_hist")

        self.update_scanvp_cands(obs)
        self.start_prefetcher(dataset)
        gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
        for i, ob in enumerate(obs):
            gmaps[i].update_graph(ob)
        traj = [{"instr_id": ob["instr_id"], "path": [[ob["viewpoint"]]],
                 "details": {}} for ob in obs]
        ended = np.zeros(batch_size, bool)
        instructions = [ob["instruction"] for ob in obs]
        history: List[List[str]] = [[] for _ in range(batch_size)]
        hist_vis: List[List[np.ndarray]] = [[] for _ in range(batch_size)]
        ml_loss = 0.0
        flag = False
        use_mem_train = training and runner.device_memory
        mem_state = runner.memory_init(batch_size) if use_mem_train \
            else None

        for t in range(max_action_len):
            if ended.all() or t == max_action_len - 1:
                flag = True
            for i, gmap in enumerate(gmaps):
                if not ended[i]:
                    gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1
            self.prefetch(obs)

            # one seed for the step's panorama: the host copy of the
            # memory path and the grad call's recompute draw the same
            # dropout
            step_seed = runner.next_seed()
            with self.timer.stage("pano_assemble"):
                pano_inputs = self.panorama_inputs(obs)
            if use_mem_train:
                # the memory update runs inside the grad call; here only
                # its ids
                pano_embeds = None
                pano_masks = (np.arange(self.dims.max_views)[None, :]
                              < pano_inputs["view_lens"][:, None])
                cur_ids, cand_ids = self._memory_ids(
                    gmaps, obs, pano_inputs["cand_vpids"], ended)
            else:
                with self.timer.stage("pano_device"):
                    pano_out = runner.panorama(
                        pano_inputs, deterministic=not training,
                        seed=step_seed)
                pano_embeds = pano_out["pano_embeds"]
                pano_masks = pano_out["pano_masks"]
                self._pool_node_embeds(gmaps, obs, pano_embeds, pano_masks,
                                       pano_inputs["cand_vpids"], ended)

            with self.timer.stage("nav_assemble"):
                gmap_in = self.nav_gmap_inputs(obs, gmaps,
                                               fill_embeds=not use_mem_train)
            with self.timer.stage("nav_assemble"):
                vp_in = self.nav_vp_inputs(obs, gmaps, pano_masks,
                                           pano_inputs["cand_vpids"],
                                           pano_embeds)
                match = self.local_match_slots(
                    gmap_in["gmap_vpids"], vp_in["vp_cand_vpids"], gmaps,
                    width=pano_masks.shape[1] + 1)
                order, prompts, cand_nums = self.cand_order_and_prompts(
                    gmap_in, instructions, history, rng=rng_local)
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
                "cand_positions": cand_pos,
                "hist_positions": hist_pos,
                "input_ids": tok_batch.input_ids,
                "attention_mask": tok_batch.attention_mask,
                "cls_pos": cls_pos,
            }
            if not use_mem_train:
                nav_batch["gmap_img_embeds"] = gmap_in["gmap_img_embeds"]
                nav_batch["vp_img_embeds"] = vp_in["vp_img_embeds"]
                nav_batch["hist_embeds"] = self.hist_arrays(hist_vis)

            nav_vpids = gmap_in["gmap_vpids"]
            nav_targets = None
            if train_ml is not None:
                nav_targets = self.teacher_action(
                    obs, nav_vpids, ended,
                    visited_masks=gmap_in["gmap_visited_masks"],
                    imitation_learning=(feedback == "teacher"), t=t)
            coef = (train_ml or 0.0) / loss_den / \
                args.gradient_accumulation_step
            if use_mem_train:
                nav_batch["cur_ids"] = cur_ids
                nav_batch["cand_ids"] = cand_ids
                nav_batch["slot_ids"] = self._slot_ids(gmap_in, gmaps)
                with self.timer.stage("nav_dispatch"):
                    mem_state, logits, fuse_dev, step_loss = \
                        runner.pano_mem_navigation_train(
                            mem_state, step_seed, pano_inputs, nav_batch,
                            nav_targets, coef, sync=False)
                    # the download starts now and is waited for after the
                    # yield: nothing here waits for the card
                    logits = HostCopy(logits)
                fuse_embeds = None
                # a peer stream's host work runs here while the card runs
                # this step (rollout_interleaved)
                yield
                with self.timer.stage("nav_sync"):
                    logits = logits.result()
            elif training:
                with self.timer.stage("nav_device"):
                    del nav_batch["vp_img_embeds"]
                    logits, fuse_embeds, _, _, step_loss = \
                        runner.pano_navigation_train(
                            pano_inputs, step_seed, nav_batch, nav_targets,
                            coef, need_outputs=True)
            else:
                with self.timer.stage("nav_device"):
                    logits, fuse_embeds, step_loss = runner.navigation(
                        nav_batch, targets=nav_targets, coef=coef,
                        train=training)
            ml_loss = ml_loss + step_loss

            # -- action selection --
            if feedback == "teacher":
                a_t = nav_targets.copy()
            elif feedback == "sample":
                a_t = np.zeros(batch_size, np.int64)
                probs = _softmax(logits / max(args.temperature, 1e-6))
                for i in range(batch_size):
                    p = probs[i].astype(np.float64)
                    a_t[i] = rng_local.choice(len(p), p=p / p.sum())
            elif feedback == "argmax":
                a_t = logits.argmax(1)
            else:
                raise NotImplementedError(feedback)

            # the history follows every row whose action is not ignoreid
            if use_mem_train:
                mem_state = runner.history_append(mem_state, fuse_dev,
                                                  a_t.astype(np.int64))
                for i in range(batch_size):
                    if a_t[i] != self.args.ignoreid:
                        history[i].append("<hist>")
            else:
                for i in range(batch_size):
                    if a_t[i] == self.args.ignoreid:
                        continue
                    history[i].append("<hist>")
                    hist_vis[i].append(fuse_embeds[i, a_t[i]])

            if not validate:
                a_t_stop = [ob["viewpoint"] == ob["gt_path"][-1]
                            for ob in obs]
            else:
                a_t_stop = (a_t == 0)

            # -- the sub-task heads on the final step --
            if use_mem_train and flag:
                # the heads read the history values: one download
                buf = mem_state["hist_buf"].cpu().numpy()
                cnt = mem_state["hist_cnt"].cpu().numpy()
                hist_vis = [list(buf[i, : min(int(cnt[i]), buf.shape[1])])
                            for i in range(batch_size)]
            if data_type[0] in ("soon", "reverie") and args.enable_og \
                    and flag:
                ml_loss = ml_loss + self._object_grounding_step(
                    args, obs, instructions, history, hist_vis, traj,
                    training=training, loss_denom=loss_den)

            if (feedback == "teacher" and not flag and not a_t_stop[0]
                    and data_type[0] == "r2r" and not validate
                    and "fg_instruction" in obs[0] and args.enable_fgr2r):
                ml_loss = ml_loss + self._generation_step(
                    args, obs, history=[[] for _ in obs],
                    hist_vis=[[] for _ in obs],
                    instructions=["where are we going with direction ({}) ?"
                                  .format(int(idx)) for idx in nav_targets],
                    answers=[ob["fg_instruction"][ob["fg_view"][t]]
                             for ob in obs],
                    mode="embodied_qa", training=training, traj=traj,
                    loss_denom=loss_den)

            # EQA answers at the final step under any feedback; the
            # summaries under teacher or argmax, in evaluation only in
            # test mode
            if data_type[0] == "eqa":
                enable_summarize = flag
            elif data_type[0] in SUMMARIZED_TYPES:
                enable_summarize = (feedback in ("teacher", "argmax")
                                    and flag and args.enable_summarize
                                    and (not validate or args.mode == "test"))
            else:
                enable_summarize = False
            if enable_summarize:
                is_eqa = data_type[0] == "eqa"
                ml_loss = ml_loss + self._generation_step(
                    args, obs, history=history, hist_vis=hist_vis,
                    instructions=instructions,
                    answers=[ob.get("answer", "") if is_eqa
                             else ob["instruction"] for ob in obs],
                    mode="embodied_qa" if is_eqa else "summarization",
                    training=training, traj=traj, trie=trie,
                    loss_denom=loss_den)

            # -- the environment's step --
            cpu_a_t: List[Optional[str]] = []
            for i in range(batch_size):
                if a_t_stop[i] or ended[i] or gmap_in["no_vp_left"][i] \
                        or t == max_action_len - 1:
                    cpu_a_t.append(None)
                else:
                    cpu_a_t.append(nav_vpids[i][a_t[i]])
            with self.timer.stage("env_step"):
                self.make_equiv_action(cpu_a_t, gmaps, obs, traj, envs)
            with self.timer.stage("get_obs"):
                obs = [dataset.get_obs(items=[items[i]], env=envs[i],
                                       data_type=data_type[i])[0]
                       for i in range(batch_size)]
            self.update_scanvp_cands(obs)
            for i, ob in enumerate(obs):
                if not ended[i]:
                    gmaps[i].update_graph(ob)
            ended = np.logical_or(ended,
                                  np.array([x is None for x in cpu_a_t]))
            if flag:
                break

        return ml_loss, traj


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _split_batch_dict(batch_dict: dict, n_streams: int = 2) -> List[dict]:
    """Split a loader batch into ``n_streams`` contiguous sub-batches (the
    streams of rollout_interleaved): per-episode lists and arrays are
    sliced, other entries shared, batch_size recomputed; never an empty
    stream."""
    n = len(batch_dict["observations"])
    n_streams = max(1, min(n_streams, n))

    def cut(sl: slice) -> dict:
        out = {}
        for k, v in batch_dict.items():
            if k == "batch_size":
                continue
            if isinstance(v, (list, tuple, np.ndarray)) and len(v) == n:
                out[k] = v[sl]
            else:
                out[k] = v
        out["batch_size"] = len(out["observations"])
        return out

    bounds = [round(i * n / n_streams) for i in range(n_streams + 1)]
    return [cut(slice(bounds[i], bounds[i + 1])) for i in range(n_streams)
            if bounds[i] < bounds[i + 1]]


@AGENTS.register("r2r_aug")
class R2RAugAgent(R2RAgent):
    """The augmented R2R set's agent: R2R's navigation under the r2r_aug
    prompts (R2R's text)."""


@AGENTS.register("cvdn")
class CVDNAgent(R2RAgent):
    """The CVDN agent: R2R's navigation under the CVDN prompts (name
    "cvdn"), which read the dialog history as the instruction."""


@AGENTS.register("reverie")
class REVERIEAgent(R2RAgent):
    """The REVERIE agent: R2R's navigation under the REVERIE prompts (name
    "reverie"), with the object-grounding head."""


@AGENTS.register("reverie_aug")
class REVERIEAgent_Aug(R2RAgent):
    """The augmented REVERIE set's agent: REVERIE's prompts, no object to
    ground (its samples carry objId None)."""


@AGENTS.register("soon")
class SOONAgent(R2RAgent):
    """The SOON agent: R2R's navigation under the SOON prompts (name
    "soon"), with the object-grounding head."""


@AGENTS.register("eqa")
class EQAAgent(R2RAgent):
    """The EQA agent: R2R's navigation under the EQA prompts (name "eqa"),
    its answers generated over the answer vocabulary's trie."""
