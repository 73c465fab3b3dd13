"""Viewpoint geometry: discretized-view angles and relative-position features.

The port's copy of navillm_tpu/sim/geometry.py, with the same names and
numerics (the port imports nothing of the JAX package).

Behavioral parity with the reference's angle math
(reference: tasks/datasets/mp3d_envs.py:35-66,97-111, models/graph_utils.py:9-44),
but vectorized over candidates/nodes instead of per-item Python loops.

The MP3D camera is discretized into 36 views: 12 headings x 3 elevations
(30-degree increments); view index ix has heading (ix % 12) * 30deg and
elevation ((ix // 12) - 1) * 30deg.
"""
from __future__ import annotations

import math

import numpy as np

RAD30 = math.radians(30)
NUM_VIEWS = 36
MAX_DIST = 30.0   # rel-dist normalizers (reference graph_utils.py:5-6)
MAX_STEP = 10.0


def view_heading(view_index) -> np.ndarray:
    return (np.asarray(view_index) % 12) * RAD30


def view_elevation(view_index) -> np.ndarray:
    return (np.asarray(view_index) // 12 - 1) * RAD30


def angle_feature(heading, elevation, angle_feat_size: int = 4) -> np.ndarray:
    """[sin(h), cos(h), sin(e), cos(e)] tiled to angle_feat_size.

    Accepts scalars or arrays; returns (..., angle_feat_size) float32.
    """
    h = np.asarray(heading, dtype=np.float32)
    e = np.asarray(elevation, dtype=np.float32)
    base = np.stack([np.sin(h), np.cos(h), np.sin(e), np.cos(e)], axis=-1)
    reps = angle_feat_size // 4
    if reps > 1:
        base = np.concatenate([base] * reps, axis=-1)
    return base.astype(np.float32)


def all_point_angle_features(angle_feat_size: int = 4) -> np.ndarray:
    """Angle features of all 36 views relative to each base view.

    Returns (36, 36, angle_feat_size): entry [b, ix] encodes view ix's
    heading/elevation minus base view b's (reference mp3d_envs.py:42-66,
    computed there by stepping the C++ sim; here it is closed-form).
    """
    ix = np.arange(NUM_VIEWS)
    headings = view_heading(ix)
    elevations = view_elevation(ix)
    rel_h = headings[None, :] - headings[:, None]
    rel_e = elevations[None, :] - elevations[:, None]
    return angle_feature(rel_h, rel_e, angle_feat_size)


def rel_heading_elevation_dist(a: np.ndarray, b: np.ndarray,
                               base_heading: float = 0.0,
                               base_elevation: float = 0.0):
    """Relative heading/elevation/distance from position a to b (xyz).

    Matches reference graph_utils.py:18-35, including the transposed-axis
    quirk (heading from arcsin(dx / xy_dist), flipped when dy < 0).
    Vectorized: b may be (N, 3).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = b - a
    xy = np.maximum(np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2), 1e-8)
    xyz = np.maximum(np.sqrt((d ** 2).sum(-1)), 1e-8)
    heading = np.arcsin(np.clip(d[..., 0] / xy, -1.0, 1.0))
    heading = np.where(d[..., 1] < 0, np.pi - heading, heading) - base_heading
    elevation = np.arcsin(np.clip(d[..., 2] / xyz, -1.0, 1.0)) - base_elevation
    return heading, elevation, xyz


def rel_pos_features(cur_pos: np.ndarray, node_pos: np.ndarray,
                     graph_dist: np.ndarray, graph_steps: np.ndarray,
                     base_heading: float, base_elevation: float,
                     angle_feat_size: int = 4) -> np.ndarray:
    """7-dim rel-pos features: angle_feature(4) ++ [line/MAX_DIST,
    graph_dist/MAX_DIST, steps/MAX_STEP] (reference graph_utils.py:144-165).

    node_pos: (N, 3); graph_dist/graph_steps: (N,). Returns (N, 4+3) f32.
    """
    h, e, line = rel_heading_elevation_dist(cur_pos, node_pos, base_heading, base_elevation)
    ang = angle_feature(h, e, angle_feat_size)
    dists = np.stack([
        line / MAX_DIST,
        np.asarray(graph_dist, dtype=np.float64) / MAX_DIST,
        np.asarray(graph_steps, dtype=np.float64) / MAX_STEP,
    ], axis=-1).astype(np.float32)
    return np.concatenate([ang, dists], axis=-1)


def normalize_angle(x: float) -> float:
    """Radians -> (-pi, pi] (reference mp3d_envs.py:97-103)."""
    x = x % (2 * math.pi)
    if x > math.pi:
        x -= 2 * math.pi
    return x


def convert_heading(x: float) -> float:
    """Radians -> [0, 1) (reference mp3d_envs.py:106-107)."""
    return x % (2 * math.pi) / (2 * math.pi)


def convert_elevation(x: float) -> float:
    """Radians -> [0, 1) centered at 0.5 (reference mp3d_envs.py:110-111)."""
    return (normalize_angle(x) + math.pi) / (2 * math.pi)


def position_distance(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(((b - a) ** 2).sum()))
