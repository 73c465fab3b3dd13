"""Scan navigation graphs and per-episode topological memory.

ScanGraph: static per-scan connectivity graph with all-pairs shortest
paths (replaces the reference's networkx Dijkstra at dataset init,
tasks/datasets/mp3d_dataset.py:122-138, and MatterSim's nav-graph role).

EpisodeGraph: incremental shortest-path memory over the *discovered*
subgraph during a rollout, with exact reference FloydGraph semantics
(models/graph_utils.py:47-96): distances improve only when a node is
visited via update(); path() excludes the start node.

Both prefer the native C++ backend (navsim.cpp) and fall back to NumPy.

The port's copy of navillm_tpu/sim/graph.py, with the same names and
numerics; its native library is the port's own build of navsim.cpp
(native.py).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .native import load_library

INF = float("inf")


def load_connectivity(connectivity_dir: str | Path, scan: str):
    """Parse a Matterport-style connectivity JSON into (ids, pos, edges, w).

    Matches reference mp3d_envs.py:69-94: only `included` nodes, only
    `unobstructed` symmetric links, Euclidean edge weights from pose
    translation (pose[3], pose[7], pose[11]).
    """
    path = Path(connectivity_dir) / f"{scan}_connectivity.json"
    with open(path) as f:
        data = json.load(f)
    ids, pos = [], []
    idx_of_entry = {}
    for i, item in enumerate(data):
        if item["included"]:
            idx_of_entry[i] = len(ids)
            ids.append(item["image_id"])
            pose = item["pose"]
            pos.append([pose[3], pose[7], pose[11]])
    pos = np.asarray(pos, dtype=np.float64)
    edges, weights = [], []
    for i, item in enumerate(data):
        if not item["included"]:
            continue
        for j, conn in enumerate(item["unobstructed"]):
            if conn and j > i and data[j]["included"]:
                assert data[j]["unobstructed"][i], "Graph should be undirected"
                a, b = idx_of_entry[i], idx_of_entry[j]
                edges.append((a, b))
                weights.append(float(np.linalg.norm(pos[a] - pos[b])))
    return ids, pos, np.asarray(edges, dtype=np.int32).reshape(-1, 2), \
        np.asarray(weights, dtype=np.float64)


class ScanGraph:
    """Static scan graph: ids, positions, all-pairs distances and paths."""

    def __init__(self, ids: Sequence[str], positions: np.ndarray,
                 edges: np.ndarray, weights: np.ndarray):
        self.ids = list(ids)
        self.index = {vp: i for i, vp in enumerate(self.ids)}
        self.positions = np.asarray(positions, dtype=np.float64)
        self.n = len(self.ids)
        edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        self._adjacency = [[] for _ in range(self.n)]
        for (a, b), w in zip(edges, weights):
            self._adjacency[a].append((int(b), float(w)))
            self._adjacency[b].append((int(a), float(w)))
        self._lib = load_library()
        if self._lib is not None:
            self._h = self._lib.ns_scan_create(self.n, len(weights), edges, weights)
            self._dist = np.empty((self.n, self.n), dtype=np.float64)
            self._lib.ns_scan_dist_matrix(self._h, self._dist)
        else:
            self._h = None
            self._dist, self._next = self._all_pairs_numpy(edges, weights)

    @classmethod
    def from_connectivity(cls, connectivity_dir: str | Path, scan: str) -> "ScanGraph":
        return cls(*load_connectivity(connectivity_dir, scan))

    def _all_pairs_numpy(self, edges, weights):
        import heapq
        n = self.n
        dist = np.full((n, n), INF)
        nxt = np.full((n, n), -1, dtype=np.int32)
        for s in range(n):
            d = np.full(n, INF)
            par = np.full(n, -1, dtype=np.int32)
            d[s] = 0.0
            pq = [(0.0, s)]
            done = np.zeros(n, dtype=bool)
            while pq:
                du, u = heapq.heappop(pq)
                if done[u]:
                    continue
                done[u] = True
                for v, w in self._adjacency[u]:
                    if du + w < d[v]:
                        d[v] = du + w
                        par[v] = u
                        heapq.heappush(pq, (d[v], v))
            dist[s] = d
            for t in range(n):
                if t == s or par[t] < 0:
                    continue
                cur = t
                while par[cur] != s:
                    cur = par[cur]
                nxt[s, t] = cur
        return dist, nxt

    # --- queries (string viewpoint ids) ---
    def distance(self, a: str, b: str) -> float:
        return float(self._dist[self.index[a], self.index[b]])

    def distance_matrix(self) -> np.ndarray:
        return self._dist

    def path(self, a: str, b: str) -> List[str]:
        """Shortest path a..b inclusive."""
        ia, ib = self.index[a], self.index[b]
        if self._h is not None:
            out = np.empty(self.n + 1, dtype=np.int32)
            k = self._lib.ns_scan_path(self._h, ia, ib, out, out.shape[0])
            return [self.ids[i] for i in out[:k]]
        if ia == ib:
            return [a]
        seq = [ia]
        cur = ia
        while cur != ib:
            cur = int(self._next[cur, ib])
            if cur < 0:
                return []
            seq.append(cur)
        return [self.ids[i] for i in seq]

    def position(self, vp: str) -> np.ndarray:
        return self.positions[self.index[vp]]

    def neighbors(self, vp: str) -> List[str]:
        return [self.ids[j] for j, _ in self._adjacency[self.index[vp]]]

    # dict-like views matching the reference's shortest_distances /
    # shortest_paths nested-dict access patterns (r2r.py:111 etc.)
    def distances_view(self) -> "._DistView":
        return _DistView(self)

    def paths_view(self) -> "._PathView":
        return _PathView(self)


class _DistView:
    def __init__(self, g: ScanGraph):
        self._g = g

    def __getitem__(self, a):
        g = self._g
        row = g._dist[g.index[a]]
        return {vp: float(row[i]) for vp, i in g.index.items()}


class _PathView:
    def __init__(self, g: ScanGraph):
        self._g = g

    def __getitem__(self, a):
        g = self._g
        return {vp: g.path(a, vp) for vp in g.ids}


class EpisodeGraph:
    """Reference-FloydGraph-equivalent episode memory (string node ids)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.index: Dict[str, int] = {}
        self.ids: List[str] = []
        self._lib = load_library()
        if self._lib is not None:
            self._h = self._lib.ep_create(capacity)
        else:
            self._h = None
            self._dist = np.full((capacity, capacity), INF)
            np.fill_diagonal(self._dist, 0.0)
            self._mid = np.full((capacity, capacity), -1, dtype=np.int32)
            self._visited = np.zeros(capacity, dtype=bool)

    def __del__(self):
        # return the native handle to the reuse pool (episode graphs are
        # per-episode; without recycling, long runs leak cap^2 buffers)
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h is not None:
            try:
                lib.ep_free(h)
            except Exception:
                pass

    def _idx(self, vp: str) -> int:
        if vp not in self.index:
            if len(self.ids) >= self.capacity:
                raise RuntimeError("EpisodeGraph capacity exceeded")
            self.index[vp] = len(self.ids)
            self.ids.append(vp)
        return self.index[vp]

    def add_edge(self, a: str, b: str, w: float):
        ia, ib = self._idx(a), self._idx(b)
        if self._h is not None:
            self._lib.ep_add_edge(self._h, ia, ib, float(w))
        else:
            if w < self._dist[ia, ib]:
                self._dist[ia, ib] = self._dist[ib, ia] = w
                self._mid[ia, ib] = self._mid[ib, ia] = -1

    def update(self, k: str):
        ik = self._idx(k)
        if self._h is not None:
            self._lib.ep_update(self._h, ik)
        else:
            n = len(self.ids)
            d = self._dist
            for x in range(n):
                if x == ik or d[x, ik] == INF:
                    continue
                cand = d[x, ik] + d[ik, :n]
                better = cand < d[x, :n]
                better[x] = False
                d[x, :n][better] = cand[better]
                d[:n, x][better] = cand[better]
                self._mid[x, :n][better] = ik
                self._mid[:n, x][better] = ik
            self._visited[ik] = True

    def visited(self, vp: str) -> bool:
        if vp not in self.index:
            return False
        i = self.index[vp]
        if self._h is not None:
            return bool(self._lib.ep_visited(self._h, i))
        return bool(self._visited[i])

    def distance(self, a: str, b: str) -> float:
        if a == b:
            return 0.0
        ia, ib = self._idx(a), self._idx(b)
        if self._h is not None:
            return self._lib.ep_distance(self._h, ia, ib)
        return float(self._dist[ia, ib])

    def path(self, a: str, b: str) -> List[str]:
        """Path from a to b, excluding a (reference graph_utils.py:80-96)."""
        if a == b:
            return []
        ia, ib = self._idx(a), self._idx(b)
        if self._h is not None:
            out = np.empty(4 * self.capacity, dtype=np.int32)
            k = self._lib.ep_path(self._h, ia, ib, out, out.shape[0])
            return [self.ids[i] for i in out[:k]]
        return self._path_numpy(ia, ib)

    def _path_numpy(self, x: int, y: int) -> List[str]:
        if x == y:
            return []
        k = int(self._mid[x, y])
        if k < 0:
            return [self.ids[y]]
        return self._path_numpy(x, k) + self._path_numpy(k, y)

    def dist_steps(self, src: str, vps: Sequence[str]):
        """Batched (distance, path-step-count) from src to each vp —
        one native call instead of per-node distance()+path() pairs."""
        isrc = self._idx(src)
        ids = np.asarray([self._idx(v) for v in vps], dtype=np.int32)
        k = len(ids)
        dist = np.empty(k, np.float64)
        steps = np.empty(k, np.int32)
        if self._h is not None:
            self._lib.ep_dist_steps(self._h, isrc, k, ids, dist, steps)
        else:
            for i, v in enumerate(vps):
                dist[i] = self.distance(src, v)
                steps[i] = len(self.path(src, v))
        return dist, steps

    def pair_distances(self, vps: Sequence[str]) -> np.ndarray:
        """Pairwise distance matrix over an ordered node list (one native
        call instead of the reference's O(N^2) Python loop,
        mp3d_agent.py:337-341)."""
        ids = np.asarray([self._idx(v) for v in vps], dtype=np.int32)
        k = len(ids)
        out = np.empty((k, k), dtype=np.float64)
        if self._h is not None:
            self._lib.ep_pair_dists(self._h, k, ids, out)
        else:
            for i in range(k):
                for j in range(k):
                    out[i, j] = 0.0 if ids[i] == ids[j] else self._dist[ids[i], ids[j]]
        return out
