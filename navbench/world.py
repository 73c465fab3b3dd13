"""Synthetic R2R worlds, episodes and view features, made from the seed.

Frozen copy of the world generator of ``navillm_tpu_torch/testing.py``
(commit 20b2d57: ``make_grid_connectivity``, ``_instruction`` and the R2R
part of ``make_r2r_world``), so that a later change to the program's
test helpers cannot move the benchmark's traffic. Changes from it: many
scans in one world, each a connected set of grid cells whose size is an
episode's length (R2R's paths have 4-6 edges, so a trained agent decides
5-7 times: 4-6 moves and the stop); shortest paths inside a scan with
three instructions each (R2R's count); every size drawn from a generator
seeded by the benchmark's ``--seed``; and view features drawn from the
seed and written as the paper's HDF5 feature file (``h5write``, the
extractors' layout: one [36, D] f32 gzip'd dataset per
``<scan>_<viewpoint>``).
"""
from __future__ import annotations

import json
import random
from collections import deque
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from . import h5write

_VERBS = "walk turn go continue head move proceed pass".split()
_DIRS = "left right straight forward around back".split()
_ROOMS = "kitchen bedroom bathroom hallway lounge office foyer".split()
_OBJECTS = ("sofa table chair lamp bed door window mirror sink stairs "
            "counter cabinet rug plant").split()
NUM_VIEWS = 36


def neighbours_8(r: int, c: int):
    return [(r + dr, c + dc) for dr in (0, 1, -1) for dc in (0, 1, -1)
            if dr or dc]


def make_connectivity(root, scan: str, cells: List[Tuple[int, int]],
                      spacing: float = 2.0) -> Path:
    """Matterport-style connectivity JSON for the cells of a grid, each
    joined to its 8 neighbours among them (as a viewpoint sees ~4 of them
    on average): cell (r, c) sits at (c*spacing, r*spacing, 0) with id
    'vp_r_c'. (testing.py's make_grid_connectivity joins 4-neighbours of
    a whole rows x cols block.)"""
    index = {cell: k for k, cell in enumerate(cells)}
    n = len(cells)
    unob = [[False] * n for _ in range(n)]
    for (r, c), k in index.items():
        for other in ((r, c + 1), (r + 1, c), (r + 1, c + 1),
                      (r + 1, c - 1)):
            if other in index:
                unob[k][index[other]] = unob[index[other]][k] = True
    data = []
    for (r, c), k in index.items():
        pose = [0.0] * 16
        pose[3], pose[7] = c * spacing, r * spacing
        data.append({"image_id": f"vp_{r}_{c}", "pose": pose,
                     "included": True, "unobstructed": unob[k],
                     "height": 1.5})
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    out = root / f"{scan}_connectivity.json"
    out.write_text(json.dumps(data))
    return out


def instruction(rng: random.Random, n_sentences: int) -> str:
    """``n_sentences`` navigation sentences of 14 words each."""
    def sentence():
        return (f"{rng.choice(_VERBS).capitalize()} {rng.choice(_DIRS)} "
                f"into the {rng.choice(_ROOMS)} and stop next to the "
                f"{rng.choice(_OBJECTS)} near the {rng.choice(_OBJECTS)}.")
    return " ".join(sentence() for _ in range(n_sentences))


def shortest_path(cells, start: Tuple[int, int], end: Tuple[int, int]
                  ) -> List[str]:
    """A shortest path between two cells over 8-neighbours among
    ``cells``, by breadth-first search in a fixed neighbour order."""
    inside = set(cells)
    prev = {start: None}
    todo = deque([start])
    while todo:
        r, c = todo.popleft()
        if (r, c) == end:
            break
        for nxt in neighbours_8(r, c):
            if nxt in inside and nxt not in prev:
                prev[nxt] = (r, c)
                todo.append(nxt)
    path, node = [], end
    while node is not None:
        path.append(f"vp_{node[0]}_{node[1]}")
        node = prev[node]
    return path[::-1]


def _blocks(rng, counts: Dict[str, int], n: int) -> List[int]:
    """``n`` sizes, block by block: each block holds every size of
    ``counts`` as often as it says, shuffled."""
    block = [int(k) for k, count in counts.items() for _ in range(count)]
    return [int(x) for x in np.concatenate(
        [rng.permutation(block) for _ in range(-(-n // len(block)))])[:n]]


def scans(traffic: Dict, seed: int) -> Dict[str, List[Tuple[int, int]]]:
    """The world's scans: ``traffic["scans"]`` connected sets of cells of a
    ``box_rows`` x ``box_cols`` grid, grown cell by cell from a random
    cell through random 4-neighbours, with as many viewpoints as
    ``scan_sizes`` mixes (every seed the same sizes)."""
    rng = np.random.default_rng([int(seed), 4])
    rows, cols = traffic["box_rows"], traffic["box_cols"]
    out = {}
    for k, size in enumerate(_blocks(rng, traffic["scan_sizes"],
                                     traffic["scans"])):
        cells = [(int(rng.integers(rows)), int(rng.integers(cols)))]
        while len(cells) < size:
            r, c = cells[int(rng.integers(len(cells)))]
            nxt = [(r + dr, c + dc) for dr, dc in
                   ((0, 1), (1, 0), (0, -1), (-1, 0))]
            nxt = [x for x in nxt if 0 <= x[0] < rows and 0 <= x[1] < cols
                   and x not in cells]
            if nxt:
                cells.append(nxt[int(rng.integers(len(nxt)))])
        out[f"scan{k}"] = sorted(cells)
    return out


def make_world(root, traffic: Dict, seed: int, paths_seed=None) -> Path:
    """Write ``root/connectivity`` (the scans of ``scans(traffic, seed)``)
    and ``root/R2R/annotations/val.json``: ``paths`` shortest paths between
    two random viewpoints of a scan, three instructions each, drawn from
    ``paths_seed`` (``seed`` where None). Every seed draws the same sizes
    in its own order, block by block: each run of paths holds every scan
    size of ``scan_sizes`` as often as it says, and each run of
    instructions as long as ``sentences`` (how many instructions of each
    sentence count) holds that mix, shuffled, so any stretch of the
    episode stream holds nearly the same mix on every seed. A greedy agent
    that stops only when it has seen every viewpoint of its scan takes as
    many decisions as the scan has viewpoints. Returns the annotation
    file."""
    root = Path(root)
    world = scans(traffic, seed)
    for scan, cells in world.items():
        make_connectivity(root / "connectivity", scan, cells)
    by_size: Dict[int, List[str]] = {}
    for scan, cells in world.items():
        by_size.setdefault(len(cells), []).append(scan)
    pseed = seed if paths_seed is None else paths_seed
    rng = np.random.default_rng(pseed)
    irng = random.Random(pseed)
    n_paths = traffic["paths"]
    sizes = _blocks(rng, traffic["scan_sizes"], n_paths)
    sent = _blocks(rng, traffic["sentences"], 3 * n_paths)
    items = []
    for pid in range(n_paths):
        pool = by_size[sizes[pid]]
        scan = pool[int(rng.integers(len(pool)))]
        cells = world[scan]
        i, j = rng.choice(len(cells), 2, replace=False)
        path = shortest_path(cells, cells[int(i)], cells[int(j)])
        texts = [instruction(irng, sent[3 * pid + k]) for k in range(3)]
        items.append({"distance": 2.0 * (len(path) - 1), "scan": scan,
                      "path_id": pid, "heading": 0.0,
                      "instructions": texts, "path": path})
    anno = root / "R2R" / "annotations" / "val.json"
    anno.parent.mkdir(parents=True, exist_ok=True)
    anno.write_text(json.dumps(items))
    return anno


def features(traffic: Dict, image_feat_size: int, seed: int
             ) -> Dict[str, np.ndarray]:
    """{"<scan>_<viewpoint>": [36, D] f32} for every viewpoint of the
    seed's scans, drawn from the seed (standard normal)."""
    rng = np.random.default_rng([int(seed), 1])
    keys = [f"{scan}_vp_{r}_{c}"
            for scan, cells in scans(traffic, seed).items()
            for r, c in cells]
    block = rng.standard_normal((len(keys), NUM_VIEWS, image_feat_size),
                                dtype=np.float32)
    return {k: block[j] for j, k in enumerate(keys)}


def write_features(path, feats: Dict[str, np.ndarray]) -> Path:
    """The paper's HDF5 feature file: one gzip'd dataset per key."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5write.File(path) as f:
        for key in sorted(feats):
            f.create_dataset(key, data=feats[key], compression="gzip")
    return path
