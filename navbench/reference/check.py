"""The numbers behind ``correct``, from what a run kept of its timed path.

Imports nothing of the program: ``held`` is plain data (numpy arrays,
CPU tensors, strings) that the cell's driver took from the run
(``take``), and the weights are drawn again from the seed by the
benchmark's own ``weights``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import weights as W
from .. import world as WD
from . import compare as C
from . import nav_ref as R

# the numbers compared with the cell's limits (navbench/limits/<cell>.json;
# the exact ones have the limit 0)
COMPARED = ("logit_err", "action_gap", "masks_differ", "views_wrong",
            "prompts_wrong", "paths_wrong")


def sample(episodes: List[Dict], n: int, seed: int) -> List[Dict]:
    """Up to ``n`` episodes drawn from the seed, the longest first."""
    eps = [e for e in episodes if e["steps"]]
    if not eps:
        return []
    longest = max(range(len(eps)), key=lambda k: len(eps[k]["steps"]))
    rest = [k for k in range(len(eps)) if k != longest]
    rng = np.random.default_rng([int(seed), 3])
    rng.shuffle(rest)
    return [eps[k] for k in [longest] + rest[: max(0, n - 1)]]


def reference_tree(cfg: Dict, seed: int, device) -> Dict:
    """The weights drawn again from the seed: the LLM kept in the served
    dtype (cast to f32 a layer at a time by the reference), the rest in
    f32."""
    tree = W.draw(cfg, seed, device, getattr(torch, cfg["torch_dtype"]))
    return {k: (v if k == "llm" else R.f32(v)) for k, v in tree.items()}


def numbers(held: Dict, cfg: Dict, traffic: Dict, seed: int, device,
            control: bool = False) -> Dict:
    """The compared numbers (COMPARED) and a few counts beside them. With
    ``control``, the control takes the program's place: the reference
    computed in fp8, with its own greedy actions, is compared against the
    reference in f32 on the same steps; the program's own readings are
    kept beside them as ``program_logit_err`` and ``program_action_gap``."""
    eps = sample(held["episodes"], traffic["check_episodes"], seed)
    feats = WD.features(traffic, cfg["panorama"]["image_feat_size"], seed)
    index = C.view_index(feats)
    steps = [cap for e in eps for cap in e["steps"]]
    views_wrong = sum(not C.views_ok(cap, index) for cap in steps)
    del index, feats
    tree = reference_tree(cfg, seed, device)
    with torch.no_grad():
        refs, gots, prompts_wrong, acts = C.reference_logits(
            tree, cfg, eps, held["special"], held["cached"], device)
        extra = {}
        if control:
            prog = C.logit_gap(refs, gots, acts)
            extra = {"program_logit_err": prog["logit_err"],
                     "program_action_gap": prog["action_gap"]}
            gots, _, _, _ = C.reference_logits(
                tree, cfg, eps, held["special"], held["cached"], device,
                "fp8")
            acts = [int(torch.argmax(c)) for c in gots]
        gap = C.logit_gap(refs, gots, acts)
    return {"logit_err": gap["logit_err"], "action_gap": gap["action_gap"],
            "masks_differ": gap["masks_differ"],
            "views_wrong": views_wrong, "prompts_wrong": prompts_wrong,
            "paths_wrong": C.paths_wrong(held["preds"], held["starts"]),
            "checked_episodes": len(eps), "checked_steps": len(steps),
            "checked_logits": gap["compared"], **extra}
