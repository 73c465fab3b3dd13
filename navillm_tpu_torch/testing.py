"""Synthetic worlds and batches for the port's tests and chip_smoke.py.

``make_grid_connectivity`` and ``synthetic_nav_batch`` follow
navillm_tpu/testing.py (which the port cannot import: it imports the JAX
nav model). ``make_r2r_world`` writes a grid world with R2R annotations,
as bench.py's rollout world does, and ``r2r_eval`` wires the port's
greedy streaming evaluation over it.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import numpy as np

_VERBS = "walk turn go continue head move proceed pass".split()
_DIRS = "left right straight forward around back".split()
_ROOMS = "kitchen bedroom bathroom hallway lounge office foyer".split()
_OBJECTS = ("sofa table chair lamp bed door window mirror sink stairs "
            "counter cabinet rug plant").split()


def make_grid_connectivity(tmpdir, scan: str = "scan0", rows: int = 4,
                           cols: int = 4, spacing: float = 2.0) -> Path:
    """Matterport-style connectivity JSON for a 4-connected grid world:
    node (r, c) sits at (c*spacing, r*spacing, 0) with id 'vp_r_c'."""
    n = rows * cols
    unob = [[False] * n for _ in range(n)]
    for r in range(rows):
        for c in range(cols):
            for r2, c2 in ((r, c + 1), (r + 1, c)):
                if r2 < rows and c2 < cols:
                    unob[r * cols + c][r2 * cols + c2] = True
                    unob[r2 * cols + c2][r * cols + c] = True
    data = []
    for r in range(rows):
        for c in range(cols):
            pose = [0.0] * 16
            pose[3], pose[7] = c * spacing, r * spacing
            data.append({"image_id": f"vp_{r}_{c}", "pose": pose,
                         "included": True,
                         "unobstructed": unob[r * cols + c], "height": 1.5})
    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    out = tmpdir / f"{scan}_connectivity.json"
    out.write_text(json.dumps(data))
    return out


def _instruction(rng: random.Random) -> str:
    """1-5 navigation sentences, ~30 words on average (R2R's length)."""
    def sentence():
        return (f"{rng.choice(_VERBS).capitalize()} {rng.choice(_DIRS)} "
                f"into the {rng.choice(_ROOMS)} and stop next to the "
                f"{rng.choice(_OBJECTS)} near the {rng.choice(_OBJECTS)}.")
    return " ".join(sentence() for _ in range(rng.randint(1, 5)))


def make_r2r_world(root, n_episodes: int = 32, rows: int = 8, cols: int = 8,
                   scan: str = "grid0", seed: int = 0) -> Path:
    """Write ``root/connectivity`` and R2R annotations for shortest-path
    episodes between random distinct grid nodes; returns the annotation
    file."""
    from navillm_tpu.sim.graph import ScanGraph

    root = Path(root)
    make_grid_connectivity(root / "connectivity", scan=scan, rows=rows,
                           cols=cols)
    graph = ScanGraph.from_connectivity(str(root / "connectivity"), scan)
    rng = np.random.RandomState(seed)
    irng = random.Random(seed)
    items = []
    for pid in range(n_episodes):
        start = end = (0, 0)
        while start == end:
            start, end = tuple(rng.randint(0, rows, 2)), \
                tuple(rng.randint(0, cols, 2))
        path = graph.path(f"vp_{start[0]}_{start[1]}",
                          f"vp_{end[0]}_{end[1]}")
        items.append({"distance": 1.0, "scan": scan, "path_id": pid,
                      "heading": 0.0, "instructions": [_instruction(irng)],
                      "path": path})
    anno = root / "R2R" / "annotations" / "val.json"
    anno.parent.mkdir(parents=True, exist_ok=True)
    anno.write_text(json.dumps(items))
    return anno


def eval_config(max_action_len: int, name: str = "R2R"):
    """The slice of the experiment config validate_streaming reads."""
    return SimpleNamespace(
        Optim=SimpleNamespace(val_max_action_len={name: max_action_len}))


def r2r_eval(anno_file, runner, n_slots: int, image_feat_size: int,
             seed: int = 0):
    """(agent, dataset, args) for greedy R2R streaming evaluation over a
    world written by make_r2r_world, with synthetic image features."""
    from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB
    from navillm_tpu.sim import WorldModel

    from .agents.mp3d_agent import EvalArgs, R2RAgent
    from .data.r2r import R2RDataset

    world = WorldModel(str(Path(anno_file).parents[2] / "connectivity"))
    ds = R2RDataset(anno_file, world)
    ds.init_feat_db(SyntheticImageFeaturesDB(image_feat_size))
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size)
    return R2RAgent(args, world, runner), ds, args


def synthetic_nav_batch(cfg, b: int = 2, g: int = 12, v: int = 8, c: int = 8,
                        hh: int = 4, tlen: int = 64, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """Random but structurally consistent navigation batch (the layout of
    navillm_tpu.testing.synthetic_nav_batch): slots 0..5 valid, slot 1
    visited, local views 1..3 map to slots 2..4."""
    r = np.random.RandomState(seed)
    h = cfg.hidden_size
    n_nodes = min(6, g)
    gmask = np.zeros((b, g), bool)
    gmask[:, :n_nodes] = True
    visited = np.zeros((b, g), bool)
    visited[:, 1] = True
    match = np.full((b, v), -1, np.int32)
    for j, s in ((1, 2), (2, 3), (3, 4)):
        if j < v and s < n_nodes:
            match[:, j] = s
    pano_m = np.zeros((b, v), bool)
    pano_m[:, : min(5, v)] = True
    cand_slots = [s for s in range(2, n_nodes) if not visited[0, s]][:c]
    order = np.full((b, c), -1, np.int32)
    cand_pos = np.full((b, c), -1, np.int32)
    for bi in range(b):
        perm = r.permutation(cand_slots)
        order[bi, : len(perm)] = perm
        cand_pos[bi, : len(perm)] = 8 + 2 * np.arange(len(perm))
    hist_pos = np.full((b, hh), -1, np.int32)
    hist_pos[:, 0] = 4
    return {
        "gmap_img_embeds": r.randn(b, g, h).astype(np.float32),
        "gmap_step_ids": r.randint(0, 5, (b, g)).astype(np.int32),
        "gmap_pos_fts": r.randn(b, g, cfg.angle_feat_size + 3)
        .astype(np.float32),
        "gmap_masks": gmask,
        "gmap_visited_masks": visited,
        "vp_img_embeds": r.randn(b, v, h).astype(np.float32),
        "vp_pos_fts": r.randn(b, v, 2 * cfg.angle_feat_size + 6)
        .astype(np.float32),
        "pano_masks": pano_m,
        "local_match_slot": match,
        "cand_order": order,
        "cand_positions": cand_pos,
        "hist_positions": hist_pos,
        "hist_embeds": r.randn(b, hh, h).astype(np.float32),
        "input_ids": r.randint(3, cfg.llm.vocab_size - 1, (b, tlen))
        .astype(np.int32),
        "attention_mask": np.ones((b, tlen), bool),
        "cls_pos": np.full((b,), tlen - 1, np.int32),
    }
