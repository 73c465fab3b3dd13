"""R2R agent: greedy streaming evaluation and teacher-forcing training.

Torch twin of navillm_tpu/agents/mp3d_agent.py on two paths: greedy R2R
streaming evaluation (device graph memory, argmax actions, uncached or
with the prompt-prefix KV cache) and ``train`` through the fused teacher
(agents/fused_teacher.py). It carries the fixed-shape input assembly of
the JAX agent (``panorama_inputs``, ``nav_gmap_inputs``,
``nav_vp_inputs``, ``local_match_slots``, ``cand_order_and_prompts``,
and for the cache ``_cached_prompt_windows``, ``_window_arrays`` and
``prefill_rows``), its expert (``teacher_action``) and its sim step
(``make_equiv_action``), which are host numpy code, copied because the JAX
agent module imports jax. The rest of the JAX agent (DAgger training, the
per-step and batched rollouts, OG, generation, EQA, sampling, the int8
prefix cache) is not ported: asking for it raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from . import prompts as P
from .graph_map import GraphMap
from .runner import HostCopy, NavModelRunner, RolloutDims

CLS_TOKEN_TEXT = "<cls_1>"


@dataclasses.dataclass
class EvalArgs:
    """The run flags greedy R2R evaluation reads (their names and defaults
    are navillm_tpu.utils.config.TrainArgs', which needs pyyaml)."""
    seed: int = 0
    val_batch_size: int = 2
    image_feat_size: int = 1024
    angle_feat_size: int = 4
    enc_full_graph: bool = True
    eval_streams: int = 2
    do_sample: bool = False
    prefix_cache: bool = False
    kv_int8: bool = False
    enable_og: bool = False
    enable_summarize: bool = False
    mode: str = "train"


@dataclasses.dataclass
class TrainArgs(EvalArgs):
    """The run flags teacher-forcing training reads, with the names and
    defaults of navillm_tpu.utils.config.TrainArgs."""
    stage: str = "multi"              # pretrain | multi
    lr: float = 1e-5
    feat_dropout: float = 0.4
    num_warmup_steps: int = 0
    gradient_accumulation_step: int = 2
    grad_clip_norm: float = 40.0
    ignoreid: int = -100
    teacher_forcing_coef: float = 1.0
    enable_fgr2r: bool = False
    fused_teacher: bool = True
    fused_rows_per_call: int = 48
    rank: int = 0


def get_results(pred_results: Dict[str, dict]) -> List[dict]:
    return [{"instr_id": k, "trajectory": v["path"]}
            for k, v in pred_results.items()]


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

    def get_prompt(self, task, *a, **kw):
        if task != "navigation":
            raise NotImplementedError(f"{task} prompts are not ported")
        return P.navigation_prompt(self.name, *a, **kw)

    def update_scanvp_cands(self, obs):
        for ob in obs:
            key = "%s_%s" % (ob["scan"], ob["viewpoint"])
            slot = self.scanvp_cands.setdefault(key, {})
            for cand in ob["candidate"]:
                slot[cand["viewpointId"]] = cand["pointId"]

    # ---------------- fixed-shape input assembly ----------------------- #
    def panorama_inputs(self, obs) -> Dict[str, Any]:
        """Candidate views first, then non-candidate views, padded to
        max_views. view_img_fts goes up to the device here, once."""
        D = self.args.image_feat_size
        A = self.args.angle_feat_size
        V = self.dims.max_views
        b = len(obs)
        view_img = np.zeros((b, V, D), np.float32)
        loc_fts = np.zeros((b, V, A + 3), np.float32)
        nav_types = np.zeros((b, V), np.int32)
        view_lens = np.zeros((b,), np.int32)
        cand_vpids: List[List[str]] = []
        for i, ob in enumerate(obs):
            feats = ob["feature"]          # [36, D + A]
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
        return {"view_img_fts": self.runner.upload(view_img, self._feat_dtype),
                "loc_fts": loc_fts, "nav_types": nav_types,
                "view_lens": view_lens, "cand_vpids": cand_vpids}

    def nav_gmap_inputs(self, obs, gmaps: List[GraphMap]) -> Dict[str, Any]:
        """Graph-node bookkeeping; the node embeddings stay on the device."""
        G = self.dims.max_gmap_nodes
        b = len(obs)
        A = self.args.angle_feat_size
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
            pos_fts[i, :n] = gmap.get_pos_fts(obs[i]["viewpoint"], vpids,
                                              obs[i]["heading"],
                                              obs[i]["elevation"], A)
        return {"gmap_step_ids": step_ids, "gmap_pos_fts": pos_fts,
                "gmap_masks": masks, "gmap_visited_masks": visited,
                "gmap_vpids": gmap_vpids, "no_vp_left": no_vp_left}

    def nav_vp_inputs(self, obs, gmaps, pano_masks, cand_vpids
                      ) -> Dict[str, Any]:
        """[stop] + panorama views, with 14-dim pos features (the stop
        row's embedding is prepended on the device)."""
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
        return {"vp_pos_fts": pos, "pano_masks": masks,
                "vp_cand_vpids": [[None] + list(x) for x in cand_vpids]}

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

    def prefill_rows(self, cache, items, width):
        """Dispatch bucketed prompt-prefix prefills into ``cache``.

        items: [(row, prefix ids)]; width: the cache's batch rows. Calls
        run in fixed-width chunks (bp <= 8) at 64-bucketed prefix widths;
        padding entries point at distinct rows NOT being prefilled, with
        valid False (they write that row's old content back). Returns the
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
            cache = self.runner.prefill(cache, ids, mask, rows, valid)
        return cache

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
    def train(self, name, batch, args, config, dataset, step=0):
        """One training batch (twin of MP3DAgent.train). The teacher half
        runs the fused teacher; returns its loss (a device scalar) times
        gradient_accumulation_step, as the JAX agent does."""
        stage_cfg = config.Pretrain if args.stage == "pretrain" \
            else config.Multi
        loss_coef = (getattr(stage_cfg, "LOSS_COEF", None) or {}) \
            .get(name, 1.0)
        if not (args.stage == "pretrain" or step % 2 == 0):
            raise NotImplementedError(
                "DAgger (sample-feedback) training is not ported yet: run "
                "stage='pretrain', where every step is teacher forcing")
        if not args.fused_teacher:
            raise NotImplementedError("only the fused teacher is ported")
        from .fused_teacher import rollout_teacher_fused
        loss, _ = rollout_teacher_fused(
            self, args, name, config.Optim, batch, dataset=dataset,
            train_ml=loss_coef * args.teacher_forcing_coef)
        return loss * args.gradient_accumulation_step

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
        group's step is dispatched."""
        if name == "EQA" or args.do_sample or args.enable_og \
                or (args.enable_summarize and args.mode == "test"):
            raise NotImplementedError(
                "only greedy R2R navigation is ported")
        kv_int8 = getattr(args, "kv_int8", False)
        if args.prefix_cache and kv_int8:
            raise NotImplementedError("the int8 prefix cache (kv_int8) is "
                                      "not ported yet (ROADMAP A9)")
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

        class Slot:
            __slots__ = ("ob", "env", "item", "data_type", "gmap", "traj",
                         "history", "t", "active", "instruction",
                         "cache_ids", "needs_prefill")

        def fill(slot) -> bool:
            try:
                s = next(samples)
            except StopIteration:
                slot.active = False
                return False
            if s["data_type"] != "r2r":
                raise NotImplementedError(f"{s['data_type']} episodes are "
                                          f"not ported")
            slot.ob = s["observations"]
            slot.env = s["env"]
            slot.item = s["item"]
            slot.data_type = s["data_type"]
            slot.traj = {"instr_id": s["instr_id"],
                         "path": [[slot.ob["viewpoint"]]], "details": {}}
            slot.gmap = GraphMap(slot.ob["viewpoint"])
            slot.gmap.update_graph(slot.ob)
            slot.history = []
            slot.t = 0
            slot.active = True
            slot.instruction = slot.ob["instruction"]
            slot.cache_ids = None
            slot.needs_prefill = True
            self.update_scanvp_cands([slot.ob])
            return True

        n_streams = max(1, int(getattr(args, "eval_streams", 0) or 2))
        use_cache = args.prefix_cache and self.runner.prefix_cache_enabled(
            num_slots, self.dims.max_prefix, n_caches=n_streams)

        class Stream:
            __slots__ = ("slots", "mem_state", "reset_rows", "pending",
                         "pano_inputs", "gmap_in", "nav_batch", "cur_ids",
                         "cand_ids", "real_mask", "a_t", "cache",
                         "prefill_items")

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
            st.mem_state = self.runner.memory_init(len(st.slots))
            st.cache = (self.runner.prefix_cache_init(len(st.slots),
                                                      self.dims.max_prefix)
                        if use_cache else None)
            st.prefill_items = []
            st.reset_rows = np.zeros(len(st.slots), bool)
            st.pending = False
            streams.append(st)
        if not streams:
            return []

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
            for sl in active:
                if sl.active:
                    sl.gmap.node_step_ids[sl.ob["viewpoint"]] = sl.t + 1

            pano_inputs = self.panorama_inputs(obs)
            host_pano_masks = (np.arange(self.dims.max_views)[None, :]
                               < pano_inputs["view_lens"][:, None])
            M = st.mem_state["mem_sum"].shape[1]
            st.cur_ids = np.full(n, -1, np.int32)
            st.cand_ids = np.full((n, self.dims.max_views), -1, np.int32)
            for i, sl in enumerate(active):
                if not sl.active:
                    continue
                gidx = sl.gmap.graph.index
                cid = gidx.get(sl.ob["viewpoint"], -1)
                st.cur_ids[i] = cid if cid < M else -1
                for j, cvp in enumerate(pano_inputs["cand_vpids"][i]):
                    if not sl.gmap.visited(cvp):
                        nid = gidx.get(cvp, -1)
                        if 0 <= nid < M:
                            st.cand_ids[i, j] = nid

            gmap_in = self.nav_gmap_inputs(obs, gmaps)
            vp_in = self.nav_vp_inputs(obs, gmaps, host_pano_masks,
                                       pano_inputs["cand_vpids"])
            match = self.local_match_slots(
                gmap_in["gmap_vpids"], vp_in["vp_cand_vpids"], gmaps,
                width=host_pano_masks.shape[1] + 1)
            order, prompts, cand_nums = self.cand_order_and_prompts(
                gmap_in, [sl.instruction for sl in active],
                [sl.history for sl in active])
            if use_cache:
                C = self.dims.max_cands

                def probe_fn(i):
                    return self.get_prompt(
                        "navigation", instruction=active[i].instruction,
                        hist_num=len(active[i].history) + 1,
                        cand_num=min(cand_nums[i], C + 1),
                        cls_token=CLS_TOKEN_TEXT)

                app_l, suf_l, st.prefill_items = self._cached_prompt_windows(
                    active, prompts, probe_fn, self.dims.max_prefix)
                tok = self.runner.tok
                text = self._window_arrays(app_l, suf_l, tok.cand_id,
                                           tok.hist_id, tok.cls_ids[0], C)
            else:
                tok_batch, cand_pos, hist_pos, cls_pos = \
                    self.runner.tokenize_with_positions(prompts)
                text = {"cand_positions": cand_pos,
                        "hist_positions": hist_pos,
                        "input_ids": tok_batch.input_ids,
                        "attention_mask": tok_batch.attention_mask,
                        "cls_pos": cls_pos}
            slot_ids = np.full(gmap_in["gmap_masks"].shape, -1, np.int32)
            for i, sl in enumerate(active):
                gidx = sl.gmap.graph.index
                for k, vp in enumerate(gmap_in["gmap_vpids"][i]):
                    if k > 0 and vp is not None:
                        nid = gidx.get(vp, -1)
                        if 0 <= nid < M:
                            slot_ids[i, k] = nid
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
                "slot_ids": slot_ids,
            }
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
                st.mem_state, st.cache, a_t, _ = self.runner.eval_step_cached(
                    st.mem_state, st.cache, st.pano_inputs, st.nav_batch,
                    st.reset_rows, st.cur_ids, st.cand_ids, st.real_mask,
                    sync=False)
            else:
                st.mem_state, a_t, _ = self.runner.eval_step(
                    st.mem_state, st.pano_inputs, st.nav_batch,
                    st.reset_rows, st.cur_ids, st.cand_ids, st.real_mask,
                    sync=False)
            st.a_t = HostCopy(a_t)
            st.pending = True

        def _post(st: Stream):
            """Retire st's in-flight step: wait for a_t only, then run the
            per-slot host work (stop handling, refill, env step)."""
            st.pending = False
            a_t = st.a_t.result()
            st.a_t = None
            nav_vpids = st.gmap_in["gmap_vpids"]
            st.reset_rows = np.zeros(len(st.slots), bool)
            for i, sl in enumerate(st.slots):
                if not sl.active:
                    continue
                sl.history.append("<hist>")
                sl.t += 1
                stop = (a_t[i] == 0) or st.gmap_in["no_vp_left"][i] \
                    or sl.t >= max_action_len
                if stop:
                    results[sl.traj["instr_id"]] = sl.traj
                    fill(sl)
                    st.reset_rows[i] = True
                else:
                    action = nav_vpids[i][a_t[i]]
                    self.make_equiv_action([action], [sl.gmap], [sl.ob],
                                           [sl.traj], [sl.env])
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
        return get_results(results)
