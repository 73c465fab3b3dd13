"""Greedy streaming R2R evaluation of the port, timed at its runner.

One run: the world, its episodes and its HDF5 view features are made from
the seed (``world``), the weights are drawn on the card (``weights``), the
port's ``R2RAgent.validate_streaming`` evaluates a warm-up set of episodes
on its own world, then the measured set, with ``groups`` slot groups of
``slots_per_group`` episodes in flight (a finished slot is refilled at
once), uncached or on the prefix-cached path as the traffic file says.
The window opens once ``ramp_steps`` slot-group steps have completed (the
slots' start in step is over) and closes ``seconds`` later; the loader
then stops handing out episodes and the episodes in flight finish outside
the window.

The benchmark's own spans wrap the calls into the program's runner
(``agents/runner.py``): each slot-group step runs from the agent's
prefetch call, which opens the host's assembly of the step, to the moment
its actions are back on the host (``HostCopy.result``). For the rows of
a few slots drawn from the seed, the step's host inputs and its logits
are kept, so that the plain reference can recompute those episodes once
the window has closed (``reference.compare``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import flops as FL
from .. import trace as TR
from .. import weights as W
from .. import world as WD
from ..reference import check as RC

# the numbers that decide correct (reference/check.py)
COMPARED = RC.COMPARED

UNCACHED_TEXT = ("input_ids", "attention_mask", "cand_positions",
                 "hist_positions", "cls_pos")
CACHED_TEXT = ("app_ids", "app_mask", "app_hist_pos", "suf_ids", "suf_mask",
               "cand_positions", "cls_pos")
FUSION = ("gmap_step_ids", "gmap_pos_fts", "gmap_masks",
          "gmap_visited_masks", "vp_pos_fts", "pano_masks",
          "local_match_slot", "cand_order", "slot_ids")


def program_config(cfg: Dict, traffic: Dict):
    """The port's NavModelConfig for a configuration file."""
    from navillm_tpu_torch.models.llama import LlamaConfig
    from navillm_tpu_torch.models.nav_model import NavModelConfig
    from navillm_tpu_torch.models.pano_encoder import PanoConfig
    dtype = getattr(torch, cfg["torch_dtype"])
    llm = LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]),
        max_seq_len=traffic["max_length"], dtype=dtype)
    p = cfg["panorama"]
    pano = PanoConfig(image_feat_size=p["image_feat_size"],
                      obj_feat_size=p["obj_feat_size"],
                      angle_feat_size=p["angle_feat_size"],
                      hidden_size=p["hidden_size"],
                      num_attention_heads=p["num_attention_heads"],
                      intermediate_size=p["intermediate_size"],
                      num_pano_layers=p["num_pano_layers"],
                      hidden_dropout_prob=p["hidden_dropout_prob"],
                      output_size=cfg["hidden_size"], use_obj=p["use_obj"],
                      dtype=dtype)
    return NavModelConfig(llm=llm, pano=pano)


@dataclasses.dataclass
class Step:
    group: int
    t_start: float
    t_call: float = 0.0
    t_end: float = 0.0
    call_s: float = 0.0
    wait_s: float = 0.0
    n_active: int = 0
    rows: list = None          # (tokens, keys before, views, nodes, k1)
    logits: object = None
    a_t: object = None
    captures: list = None      # [(slot, capture dict)]


class Recorder:
    """The wrappers around the runner's calls, and what they record."""

    def __init__(self, runner, agent, agent_mod, check_slots, cached: bool,
                 profile, ramp_steps: int, seconds: float):
        self.runner, self.agent, self.mod = runner, agent, agent_mod
        self.cached, self.seconds = cached, seconds
        self.check = set(check_slots)
        self.steps: List[Step] = []
        self.prefills: List[tuple] = []    # (t, seconds, rows work)
        self.group_of: Dict[int, int] = {}
        self.n_groups = 0
        self.pending_start = None
        self.by_tensor: Dict[int, Step] = {}
        self.view_host: Dict[int, np.ndarray] = {}
        self.stash = None
        self.capture_views = False
        self.plen: Dict[tuple, int] = {}
        self.prefix: Dict[tuple, np.ndarray] = {}
        self.episodes: Dict[tuple, list] = {}     # slot -> [episode steps]
        self.profile = profile
        self.t0 = self.t1 = None
        self.ramp_steps = ramp_steps
        self.completed = 0
        self.orig = {}

    # ------------------------------------------------------------ hooks
    def install(self):
        r, a = self.runner, self.agent
        self.orig = {"memory_init": r.memory_init,
                     "prefix_cache_init": r.prefix_cache_init,
                     "eval_step": r.eval_step,
                     "eval_step_cached": r.eval_step_cached,
                     "prefill": r.prefill, "upload": r.upload,
                     "prefetch": a.prefetch,
                     "panorama_inputs": a.panorama_inputs,
                     "HostCopy": self.mod.HostCopy}
        r.memory_init = self._memory_init
        r.prefix_cache_init = self._prefix_cache_init
        r.eval_step = self._eval_step
        r.eval_step_cached = self._eval_step_cached
        r.prefill = self._prefill
        r.upload = self._upload
        a.prefetch = self._prefetch
        a.panorama_inputs = self._panorama_inputs
        rec = self
        base = self.orig["HostCopy"]

        class TimedCopy(base):
            def __init__(self, t):
                super().__init__(t)
                self._step = rec.by_tensor.pop(id(t), None)

            def result(self):
                if self._step is None:
                    return super().result()
                t0 = time.perf_counter()
                with rec.span("wait_actions"):
                    out = super().result()
                t1 = time.perf_counter()
                rec.finish(self._step, out, t1, t1 - t0)
                return out

        self.mod.HostCopy = TimedCopy

    def uninstall(self):
        r, a = self.runner, self.agent
        for k in ("memory_init", "prefix_cache_init", "eval_step",
                  "eval_step_cached", "prefill", "upload"):
            setattr(r, k, self.orig[k])
        a.prefetch = self.orig["prefetch"]
        a.panorama_inputs = self.orig["panorama_inputs"]
        self.mod.HostCopy = self.orig["HostCopy"]

    def span(self, name):
        if self.profile.active:
            return torch.profiler.record_function(TR.SPAN_PREFIX + name)
        return contextlib.nullcontext()

    def _new_group(self, obj):
        g = self.n_groups
        self.n_groups += 1
        self.group_of[id(obj)] = g
        return obj

    def _memory_init(self, *a, **kw):
        return self._new_group(self.orig["memory_init"](*a, **kw))

    def _prefix_cache_init(self, *a, **kw):
        cache = self.orig["prefix_cache_init"](*a, **kw)
        self.group_of[id(cache)] = self.n_groups - 1
        return cache

    def _upload(self, x, dtype=None):
        out = self.orig["upload"](x, dtype)
        if self.capture_views:
            self.stash = x
        return out

    def _panorama_inputs(self, obs, *a, **kw):
        self.capture_views = True
        try:
            ret = self.orig["panorama_inputs"](obs, *a, **kw)
        finally:
            self.capture_views = False
        self.view_host[id(ret["view_img_fts"])] = self.stash
        self.stash = None
        return ret

    def _prefetch(self, obs):
        now = time.perf_counter()
        self.profile.tick(now)
        self.pending_start = now
        return self.orig["prefetch"](obs)

    # ------------------------------------------------------------- calls
    def _prefill(self, cache, ids, mask, rows, valid, **kw):
        g = self.group_of[id(cache)]
        t0 = time.perf_counter()
        with self.span("prefill"):
            out = self.orig["prefill"](cache, ids, mask, rows, valid, **kw)
        dt = time.perf_counter() - t0
        self.group_of[id(out)] = g
        work = []
        for j in range(len(rows)):
            if not valid[j]:
                continue
            n = int(np.asarray(mask[j]).sum())
            slot = (g, int(rows[j]))
            self.plen[slot] = n
            work.append((n, 0, 0, 0, True))
            if slot in self.check:
                self.prefix[slot] = np.asarray(ids[j])[np.asarray(mask[j])
                                                       .astype(bool)].copy()
        self.prefills.append((t0, dt, work))
        return out

    def _begin(self, state, pano, batch, reset, active, cached_rows):
        g = self.group_of.pop(id(state))
        st = Step(group=g, t_start=self.pending_start or time.perf_counter())
        self.pending_start = None
        act = np.asarray(active).astype(bool)
        st.n_active = int(act.sum())
        views = np.asarray(pano["view_lens"])
        nodes = np.asarray(batch["gmap_masks"]).sum(1)
        rows = []
        for i in np.nonzero(act)[0]:
            tokens, before = cached_rows(i)
            rows.append((tokens, before, int(views[i]), int(nodes[i]),
                         not self.cached))
        st.rows = rows
        host_views = self.view_host.pop(id(pano["view_img_fts"]), None)
        st.captures = []
        text = CACHED_TEXT if self.cached else UNCACHED_TEXT
        for i in range(len(act)):
            slot = (g, i)
            if slot not in self.check:
                continue
            eps = self.episodes.setdefault(slot, [])
            if reset[i] or not eps:
                eps.append({"steps": [], "prefix": None})
            ep = eps[-1]
            if not act[i]:
                continue
            if self.cached and ep["prefix"] is None:
                ep["prefix"] = self.prefix.get(slot)
            cap = {"view_img_fts": None if host_views is None
                   else np.array(host_views[i], np.float32),
                   **{k: np.array(np.asarray(pano[k])[i])
                      for k in ("loc_fts", "nav_types", "view_lens")},
                   **{k: np.array(np.asarray(batch[k])[i])
                      for k in FUSION + text}}
            ep["steps"].append(cap)
            st.captures.append((i, cap))
        return st

    def _finish_call(self, st, state_out, a_t, logits, t_call, dt):
        st.t_call, st.call_s, st.logits = t_call, dt, logits
        self.group_of[id(state_out)] = st.group
        self.by_tensor[id(a_t)] = st
        self.steps.append(st)

    def _eval_step(self, state, pano, batch, reset, cur_ids, cand_ids,
                   active, *a, **kw):
        mask = np.asarray(batch["attention_mask"])
        st = self._begin(state, pano, batch, np.asarray(reset), active,
                         lambda i: (int(mask[i].sum()), 0))
        t0 = time.perf_counter()
        with self.span("eval_step"):
            state_out, a_t, logits = self.orig["eval_step"](
                state, pano, batch, reset, cur_ids, cand_ids, active, *a,
                **kw)
        self._finish_call(st, state_out, a_t, logits, t0,
                          time.perf_counter() - t0)
        self._ids(st, cur_ids, cand_ids)
        return state_out, a_t, logits

    def _eval_step_cached(self, state, cache, pano, batch, reset, cur_ids,
                          cand_ids, active, *a, **kw):
        g = self.group_of.get(id(state))
        app = np.asarray(batch["app_mask"]).sum(1)
        suf = np.asarray(batch["suf_mask"]).sum(1)
        act = np.asarray(active).astype(bool)

        def rows(i):
            before = self.plen.get((g, int(i)), 0)
            return int(app[i] + suf[i]), before

        st = self._begin(state, pano, batch, np.asarray(reset), active, rows)
        for i in np.nonzero(act)[0]:
            slot = (g, int(i))
            self.plen[slot] = self.plen.get(slot, 0) + int(app[i])
        t0 = time.perf_counter()
        with self.span("eval_step"):
            state_out, cache_out, a_t, logits = \
                self.orig["eval_step_cached"](state, cache, pano, batch,
                                              reset, cur_ids, cand_ids,
                                              active, *a, **kw)
        self._finish_call(st, state_out, a_t, logits, t0,
                          time.perf_counter() - t0)
        self.group_of[id(cache_out)] = st.group
        self._ids(st, cur_ids, cand_ids)
        return state_out, cache_out, a_t, logits

    @staticmethod
    def _ids(st, cur_ids, cand_ids):
        for i, cap in st.captures:
            cap["cur_ids"] = int(np.asarray(cur_ids)[i])
            cap["cand_ids"] = np.array(np.asarray(cand_ids)[i])

    def finish(self, st, a_t, t_end, wait_s):
        st.t_end, st.wait_s = t_end, wait_s
        st.a_t = np.array(a_t)
        for i, cap in st.captures:
            cap["a_t"] = int(st.a_t[i])
            cap["logits"] = st.logits[i]
        st.logits = None
        self.completed += 1
        if self.t0 is None and self.completed >= self.ramp_steps:
            self.t0 = t_end
            self.t1 = t_end + self.seconds
            self.profile.open(t_end)
        self.profile.tick(t_end)


class Profile:
    """The traced sub-window: the profiler runs from the window's start
    for ``trace_seconds`` (at most the window), with the card synchronized
    at both ends."""

    def __init__(self, enabled: bool, seconds: float, device):
        self.enabled, self.seconds, self.device = enabled, seconds, device
        self.prof = None
        self.active = False
        self.start = self.end = None
        self.digest = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self, now):
        if not self.enabled:
            return
        self._sync()
        self.prof = TR.profiler()
        self.prof.start()
        self.active = True
        self.start = time.perf_counter()

    def tick(self, now):
        if self.active and now - self.start >= self.seconds:
            self.close()

    def close(self):
        if not self.active:
            return
        self._sync()
        self.end = time.perf_counter()
        self.prof.stop()
        self.active = False


class TimedLoader:
    """The program's loader, cut at the window's end: no episode is handed
    out once the recorder's window has closed."""

    def __init__(self, loader, rec):
        self.loader, self.rec = loader, rec

    def __iter__(self):
        for batch in self.loader:
            if self.rec.t1 is not None and time.perf_counter() > self.rec.t1:
                return
            yield batch


def run(ctx) -> Dict:
    """Set up, warm up, measure; returns the raw record for the harness:
    the steps and the window, the kept captures, the peak memory."""
    from navillm_tpu_torch.agents import mp3d_agent as MA
    from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
    from navillm_tpu_torch.data.feature_db import ImageFeaturesDB
    from navillm_tpu_torch.data.loaders import Dataloader
    from navillm_tpu_torch.data.r2r import R2RDataset
    from navillm_tpu_torch.models.nav_model import NavModel
    from navillm_tpu_torch.models.tokenization import NavTokenizer
    from navillm_tpu_torch.sim import WorldModel

    cfg, tr, seed, device = ctx.config, ctx.traffic, ctx.seed, ctx.device
    work = Path(ctx.workdir)
    feat = cfg["panorama"]["image_feat_size"]
    marks = {"start": time.perf_counter()}
    anno = WD.make_world(work / "main", tr, seed)
    warm_tr = dict(tr, paths=tr["warm_paths"])
    warm_anno = WD.make_world(work / "warm", warm_tr, seed,
                              paths_seed=seed + 1)
    h5 = WD.write_features(work / "features.hdf5",
                           WD.features(tr, feat, seed))
    marks["world"] = time.perf_counter()
    ncfg = program_config(cfg, tr)
    model = NavModel(ncfg, W.draw(cfg, seed, device,
                                  getattr(torch, cfg["torch_dtype"])))
    tok = NavTokenizer.bpe(max_length=tr["max_length"],
                           pad_to_multiple=tr["pad_to_multiple"])
    d = tr["dims"]
    dims = RolloutDims(max_gmap_nodes=d["max_gmap_nodes"],
                       max_views=d["max_views"], max_cands=d["max_cands"],
                       max_hist=d["max_hist"], max_prefix=d["max_prefix"])
    runner = NavModelRunner(ncfg, model, tok, dims=dims, device=device,
                            seed=seed % 2 ** 32)
    config = SimpleNamespace(Optim=SimpleNamespace(
        val_max_action_len={"R2R": tr["max_action_len"]}))
    slots = tr["slots_per_group"]

    def evaluation(anno_file):
        world = WorldModel(str(Path(anno_file).parents[2] / "connectivity"))
        ds = R2RDataset(anno_file, world)
        ds.init_feat_db(ImageFeaturesDB(str(h5), feat))
        args = MA.EvalArgs(seed=seed % 2 ** 32, val_batch_size=slots,
                           image_feat_size=feat,
                           prefix_cache=tr["prefix_cache"],
                           eval_streams=tr["groups"])
        return MA.R2RAgent(args, world, runner), ds, args

    cached = bool(tr["prefix_cache"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["weights"] = time.perf_counter()
    with torch.inference_mode():
        agent, ds, args = evaluation(warm_anno)
        agent.validate_streaming("R2R", args, config,
                                 Dataloader(ds, slots, shuffle=False),
                                 dataset=ds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks["warm_up"] = time.perf_counter()
        agent, ds, args = evaluation(anno)
        rng = np.random.default_rng([seed, 2])
        all_slots = [(g, i) for g in range(tr["groups"])
                     for i in range(slots)]
        pick = rng.choice(len(all_slots), tr["check_slots"], replace=False)
        profile = Profile(ctx.trace, min(tr["trace_seconds"], ctx.seconds),
                          device)
        rec = Recorder(runner, agent, MA, [all_slots[k] for k in pick],
                       cached, profile, tr["ramp_steps"], ctx.seconds)
        counts0 = (runner.eval_steps, runner.cached_steps,
                   runner.prefill_calls)
        peak_before = ctx.peak_bytes()
        rec.install()
        try:
            ctx.reset_peak()
            preds = agent.validate_streaming(
                "R2R", args, config,
                TimedLoader(Dataloader(ds, slots, shuffle=False), rec),
                dataset=ds)
        finally:
            rec.uninstall()
            profile.close()
        peak_window = ctx.peak_bytes()
    marks["window_open"], marks["window_close"] = rec.t0, rec.t1
    marks["drained"] = time.perf_counter()
    if rec.t0 is None or rec.t1 is None:
        raise RuntimeError(f"the window never opened: {rec.completed} steps "
                           f"for a ramp of {rec.ramp_steps}")
    n_uncached = runner.eval_steps - counts0[0]
    n_cached = runner.cached_steps - counts0[1]
    if cached and (n_uncached or not n_cached):
        raise RuntimeError(f"the cached cell did not take the cached step "
                           f"throughout: {n_uncached} uncached, {n_cached} "
                           f"cached steps")
    if not cached and n_cached:
        raise RuntimeError("the uncached cell took a cached step")
    if profile.enabled:
        profile.digest = TR.digest(profile.prof)
        profile.prof = None
    return {"rec": rec, "window": (rec.t0, rec.t1), "profile": profile,
            "preds": preds, "dataset": ds,
            "peak_window": peak_window,
            "peak_process": max(peak_before, peak_window),
            "features": h5, "model": model, "runner": runner,
            "agent": agent, "tokenizer": tok,
            "marks": {k: v - marks["start"] for k, v in marks.items()
                      if v is not None}}


def window_steps(rec, t0, t1) -> List[Step]:
    return [s for s in rec.steps if s.t_end and t0 <= s.t_end <= t1]


def end_to_end(out, seconds):
    """(the end-to-end metrics, the window's steps and actions)."""
    rec = out["rec"]
    steps = window_steps(rec, rec.t0, rec.t1)
    if not steps:
        raise RuntimeError("no step completed in the window")
    actions = sum(s.n_active for s in steps)
    return {"actions_per_s": actions / (rec.t1 - rec.t0),
            "peak_mem_gib": out["peak_window"] / 2 ** 30}, \
        {"steps": len(steps), "actions": actions}


def traced(out, cfg) -> Dict:
    """What the per-layer readers read, over the traced sub-window; the
    decision times are those of the window's steps after it, which the
    profiler does not slow."""
    rec, prof = out["rec"], out["profile"]
    t0 = prof.start
    t1 = prof.end
    steps = window_steps(rec, t0, t1)
    fl = bound_s = 0.0
    for s in steps:
        f, b = FL.step_work(cfg, s.rows)
        fl += f
        bound_s += b
    prefill_s = 0.0
    for t, dt, work in rec.prefills:
        if t0 <= t <= t1:
            f, b = FL.step_work(cfg, work)
            fl += f
            bound_s += b
            prefill_s += dt

    def clip(a, b):
        return max(0.0, min(b, t1) - max(a, t0))

    runner_s = sum(clip(s.t_call, s.t_call + s.call_s)
                   + clip(s.t_end - s.wait_s, s.t_end) for s in rec.steps)
    runner_s += sum(clip(t, t + dt) for t, dt, _ in rec.prefills)
    dg = prof.digest
    return {"window_s": t1 - t0, "busy_s": dg["busy_s"], "steps": len(steps),
            "flops": fl, "attn_bound_s": bound_s if not out["rec"].cached
            else 0.0,
            "k1_s": dg["groups"].get(TR.K1_GROUP, 0.0),
            "runner_s": runner_s, "groups": dg["groups"], "gaps": dg["gaps"],
            "decision_ms": [1e3 * (s.t_end - s.t_start) for s in
                            window_steps(rec, t1, rec.t1)],
            "actions": sum(s.n_active for s in steps)}


def take(out) -> Dict:
    """What the comparison reads, as plain data on the host: the kept
    episodes (each step's host inputs, its logits and action), the
    returned trajectories and each episode's start, the prompt's special
    token ids. The prefetcher's threads are stopped here."""
    rec, tok, agent = out["rec"], out["tokenizer"], out["agent"]
    pre = getattr(agent, "_prefetcher", None)
    if pre is not None and hasattr(pre, "pool"):
        pre.pool.shutdown(wait=True)
    episodes = []
    for slot in sorted(rec.episodes):
        for ep in rec.episodes[slot]:
            steps = []
            for cap in ep["steps"]:
                if "logits" not in cap:
                    continue
                c = dict(cap)
                c["logits"] = cap["logits"].detach().float().cpu()
                steps.append(c)
            episodes.append({"steps": steps, "prefix": ep["prefix"]})
    starts = {item["instr_id"]: item["path"][0]
              for item in out["dataset"].alldata}
    return {"episodes": episodes, "preds": out["preds"], "starts": starts,
            "special": {"cand": tok.cand_id, "hist": tok.hist_id,
                        "cls": tok.cls_ids[0]},
            "cached": rec.cached, "attempted": len(out["preds"])}


def check(held, cfg, traffic, seed, device, control=False) -> Dict:
    """The plain reference's verdict on the kept episodes
    (``reference.check``); a run fails the trajectories it returned
    malformed."""
    nums = RC.numbers(held, cfg, traffic, seed, device, control=control)
    return {"compared": {k: nums[k] for k in COMPARED},
            "numbers": {k: v for k, v in nums.items() if k not in COMPARED},
            "attempted": held["attempted"], "failed": nums["paths_wrong"]}
