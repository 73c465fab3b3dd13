"""Per-episode topological memory (reference models/graph_utils.py:99-185).

GraphMap tracks discovered nodes, their positions, pooled embeddings,
step ids, and incremental shortest paths. Differences from the
reference, chosen for the TPU pipeline:
  - shortest paths come from the C++ EpisodeGraph (exact FloydGraph
    semantics, the port's sim/graph.py) instead of O(V^2) Python;
  - node embeddings are host numpy [H] accumulators (sum, count) —
    they are graph *memory*, detached from autodiff by design
    (reference detaches too, mp3d_agent.py:692-698).

Copy of navillm_tpu/agents/graph_map.py (the port imports nothing of the
JAX package). Keep the code in step with that file.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..sim.geometry import (MAX_DIST, MAX_STEP, angle_feature,
                            position_distance, rel_heading_elevation_dist)
from ..sim.graph import EpisodeGraph


class GraphMap:
    def __init__(self, start_vp: str, capacity: int = 512):
        self.start_vp = start_vp
        self.node_positions: Dict[str, np.ndarray] = {}
        self.graph = EpisodeGraph(capacity=capacity)
        self._embed_sum: Dict[str, np.ndarray] = {}
        self._embed_cnt: Dict[str, int] = {}
        self.node_step_ids: Dict[str, int] = {}
        self.node_stop_scores: Dict[str, dict] = {}

    def update_graph(self, ob: dict):
        """Register the current viewpoint + its candidates
        (graph_utils.py:111-117)."""
        vp = ob["viewpoint"]
        self.node_positions[vp] = np.asarray(ob["position"], np.float64)
        for cc in ob["candidate"]:
            cvp = cc["viewpointId"]
            self.node_positions[cvp] = np.asarray(cc["position"], np.float64)
            dist = position_distance(ob["position"], cc["position"])
            self.graph.add_edge(vp, cvp, dist)
        self.graph.update(vp)

    def update_node_embed(self, vp: str, embed: np.ndarray,
                          rewrite: bool = False):
        """Mean-pooled accumulation (graph_utils.py:119-133)."""
        embed = np.asarray(embed, np.float32)
        if rewrite or vp not in self._embed_sum:
            self._embed_sum[vp] = embed.copy()
            self._embed_cnt[vp] = 1
        else:
            self._embed_sum[vp] += embed
            self._embed_cnt[vp] += 1

    def get_node_embed(self, vp: str) -> np.ndarray:
        return self._embed_sum[vp] / self._embed_cnt[vp]

    def has_node_embed(self, vp: str) -> bool:
        return vp in self._embed_sum

    def visited(self, vp: str) -> bool:
        return self.graph.visited(vp)

    def nodes(self) -> List[str]:
        return list(self.node_positions.keys())

    def save_to_json(self) -> dict:
        """Debug dump of the topological memory (graph_utils.py:167-185)."""
        nodes = {}
        for vp, pos in self.node_positions.items():
            nodes[vp] = {"location": list(map(float, pos)),
                         "visited": self.visited(vp)}
            if nodes[vp]["visited"] and vp in self.node_stop_scores:
                nodes[vp]["stop_prob"] = self.node_stop_scores[vp].get("stop")
                nodes[vp]["og_objid"] = self.node_stop_scores[vp].get("og")
        edges = []
        for a in self.node_positions:
            for b in self.node_positions:
                if a < b and self.graph.distance(a, b) < float("inf"):
                    edges.append((a, b))
        return {"nodes": nodes, "edges": edges}

    def get_pos_fts(self, cur_vp: str, vpids: List[Optional[str]],
                    cur_heading: float, cur_elevation: float,
                    angle_feat_size: int = 4) -> np.ndarray:
        """7-dim rel-pos features per node; None rows get the zero-angle
        feature (graph_utils.py:144-165). Vectorized: geometry in one
        numpy pass, graph distances + step counts in one native call."""
        n = len(vpids)
        out = np.zeros((n, angle_feat_size + 3), np.float32)
        out[:, :angle_feat_size] = angle_feature(0.0, 0.0, angle_feat_size)
        real = [(k, vp) for k, vp in enumerate(vpids) if vp is not None]
        if not real:
            return out
        idx = np.asarray([k for k, _ in real])
        vps = [vp for _, vp in real]
        cur_pos = self.node_positions[cur_vp]
        pos = np.stack([self.node_positions[vp] for vp in vps])
        h, e, line = rel_heading_elevation_dist(cur_pos, pos, cur_heading,
                                                cur_elevation)
        out[idx, :angle_feat_size] = angle_feature(h, e, angle_feat_size)
        out[idx, angle_feat_size] = line / MAX_DIST
        dist, steps = self.graph.dist_steps(cur_vp, vps)
        out[idx, angle_feat_size + 1] = dist / MAX_DIST
        out[idx, angle_feat_size + 2] = steps / MAX_STEP
        return out
