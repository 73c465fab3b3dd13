"""Render-free batched navigation environment.

The port's copy of navillm_tpu/sim/env.py, with the same names and
numerics.

The reference drives the MatterSim C++ simulator with rendering disabled
everywhere (mp3d_envs.py:25), so the needed behavior is a pure nav-graph
state machine: discretized 36-view camera, navigable-neighbor enumeration,
and episode stepping. This module reimplements that on the host:

  - WorldModel: per-scan ScanGraph + precomputed candidate tables. The
    reference re-derives candidates per (scan, viewpoint) by sweeping all
    36 views through the simulator and caching (mp3d_dataset.py:247-324);
    here the sweep result is closed-form geometry computed once per scan.
  - EpisodeBatch: N episode states stepped together (replaces per-sample
    1-sim EnvBatch objects, mp3d_envs.py:114-158).

Candidate semantics match the reference cache: one candidate per graph
neighbor, represented by the discretized view (pointId) with minimal
angular distance to the neighbor's direction, carrying normalized
(absolute) heading/elevation so per-step relative angles are a subtract.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .geometry import (RAD30, NUM_VIEWS, angle_feature, view_heading,
                       view_elevation, rel_heading_elevation_dist)
from .graph import ScanGraph


def discretize(heading: float, elevation: float):
    """Snap angles to the 36-view grid; returns (view_index, heading, elevation)."""
    h_idx = int(round(heading / RAD30)) % 12
    e_idx = int(np.clip(round(elevation / RAD30), -1, 1))
    return (e_idx + 1) * 12 + h_idx, h_idx * RAD30, e_idx * RAD30


@dataclasses.dataclass
class Candidate:
    """A navigable neighbor viewed from its best-aligned discrete view."""
    viewpoint_id: str
    point_id: int                  # discrete view index that best sees it
    normalized_heading: float      # absolute heading toward the neighbor
    normalized_elevation: float    # absolute elevation toward the neighbor
    position: np.ndarray           # xyz of the neighbor
    distance: float                # angular distance to the view center
    index: int                     # stable per-viewpoint candidate index


class WorldModel:
    """All static per-scan knowledge: graphs, positions, candidate tables."""

    def __init__(self, connectivity_dir: str | Path,
                 scans: Optional[Sequence[str]] = None,
                 graphs: Optional[Dict[str, ScanGraph]] = None):
        self.connectivity_dir = str(connectivity_dir)
        self.graphs: Dict[str, ScanGraph] = dict(graphs or {})
        if scans:
            for scan in scans:
                self.load_scan(scan)
        self._cand_tables: Dict[str, Dict[str, List[Candidate]]] = {}

    def load_scan(self, scan: str) -> ScanGraph:
        if scan not in self.graphs:
            self.graphs[scan] = ScanGraph.from_connectivity(self.connectivity_dir, scan)
        return self.graphs[scan]

    def graph(self, scan: str) -> ScanGraph:
        return self.load_scan(scan)

    def candidates(self, scan: str, viewpoint: str) -> List[Candidate]:
        table = self._cand_tables.get(scan)
        if table is None:
            table = self._build_candidate_table(scan)
            self._cand_tables[scan] = table
        return table[viewpoint]

    def _build_candidate_table(self, scan: str) -> Dict[str, List[Candidate]]:
        g = self.graph(scan)
        view_h = view_heading(np.arange(NUM_VIEWS))
        view_e = view_elevation(np.arange(NUM_VIEWS))
        table: Dict[str, List[Candidate]] = {}
        for vp in g.ids:
            neighbors = g.neighbors(vp)
            cands: List[Candidate] = []
            if neighbors:
                cur = g.position(vp)
                npos = np.stack([g.position(n) for n in neighbors])
                abs_h, abs_e, _ = rel_heading_elevation_dist(cur, npos)
                # angular distance to each view center, headings wrapped
                dh = (abs_h[:, None] - view_h[None, :] + math.pi) % (2 * math.pi) - math.pi
                de = abs_e[:, None] - view_e[None, :]
                ang = np.sqrt(dh ** 2 + de ** 2)
                point_ids = np.argmin(ang, axis=1)
                min_ang = ang[np.arange(len(neighbors)), point_ids]
                order = np.lexsort((min_ang, point_ids))
                for rank, k in enumerate(order):
                    cands.append(Candidate(
                        viewpoint_id=neighbors[k],
                        point_id=int(point_ids[k]),
                        normalized_heading=float(abs_h[k]),
                        normalized_elevation=float(abs_e[k]),
                        position=npos[k],
                        distance=float(min_ang[k]),
                        index=rank + 1,
                    ))
            table[vp] = cands
        return table


@dataclasses.dataclass
class SimState:
    """Mirror of the MatterSim state consumed by get_obs (mp3d_dataset.py:196-245)."""
    scan: str
    viewpoint: str
    view_index: int
    heading: float
    elevation: float
    position: np.ndarray


class EpisodeBatch:
    """N episodes stepped together over a shared WorldModel."""

    def __init__(self, world: WorldModel, batch_size: int):
        self.world = world
        self.batch_size = batch_size
        self.states: List[Optional[SimState]] = [None] * batch_size

    def new_episodes(self, scans: Sequence[str], viewpoints: Sequence[str],
                     headings: Sequence[float],
                     elevations: Optional[Sequence[float]] = None):
        if elevations is None:
            elevations = [0.0] * len(scans)
        for i, (scan, vp, h, e) in enumerate(zip(scans, viewpoints, headings, elevations)):
            g = self.world.graph(scan)
            view_index, dh, de = discretize(h, e)
            self.states[i] = SimState(scan=scan, viewpoint=vp,
                                      view_index=view_index, heading=dh,
                                      elevation=de, position=g.position(vp))

    def new_episode(self, i: int, scan: str, viewpoint: str, heading: float,
                    elevation: float = 0.0):
        g = self.world.graph(scan)
        view_index, dh, de = discretize(heading, elevation)
        self.states[i] = SimState(scan=scan, viewpoint=viewpoint,
                                  view_index=view_index, heading=dh,
                                  elevation=de, position=g.position(viewpoint))

    def teleport(self, i: int, viewpoint: str, point_id: int):
        """Move episode i to `viewpoint`, facing the view that saw it
        (reference make_equiv_action, mp3d_agent.py:475-491)."""
        s = self.states[i]
        heading = (point_id % 12) * RAD30
        elevation = (point_id // 12 - 1) * RAD30
        self.new_episode(i, s.scan, viewpoint, heading, elevation)

    def get_states(self) -> List[SimState]:
        return list(self.states)

    def candidates(self, i: int) -> List[Candidate]:
        s = self.states[i]
        return self.world.candidates(s.scan, s.viewpoint)
