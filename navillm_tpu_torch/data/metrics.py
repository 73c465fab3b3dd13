"""Navigation evaluation metrics as pure functions.

The port's copy of the scorers of navillm_tpu/data/metrics.py, with the
same names and numerics:
  - eval_r2r_item      <- R2RDataset.eval_dis_item (reference r2r.py:108-131)
  - eval_reverie_item  <- REVERIEDataset.eval_dis_item (reverie.py:138-168)
  - eval_cvdn_item     <- CVDNDataset.eval_cvdn (cvdn.py:165-207), over the
                          flattened path
  - eval_soon_item     <- SOONDataset.eval_soon_item (soon.py:163-223), with
                          shapely's point-in-polygon replaced by a ray-casting
                          test (point_in_polygon)
and their aggregates.

All scorers take `dist`: a callable (vp_a, vp_b) -> float over the
scan's all-pairs shortest distances (ScanGraph.distance).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

ERROR_MARGIN = 3.0

Dist = Callable[[str, str], float]


def flatten_trajectory(traj: Sequence[Sequence[str]]) -> List[str]:
    """Per-action viewpoint lists -> flat path (reference `sum(traj, [])`)."""
    return [vp for seg in traj for vp in seg]


def get_nearest(dist: Dist, goal: str, path: Sequence[str]) -> str:
    """Closest visited viewpoint to the goal (mp3d_dataset.py:326-334)."""
    near_id = path[0]
    near_d = dist(near_id, goal)
    for vp in path:
        d = dist(vp, goal)
        if d < near_d:
            near_id, near_d = vp, d
    return near_id


def path_length(dist: Dist, path: Sequence[str]) -> float:
    return float(np.sum([dist(a, b) for a, b in zip(path[:-1], path[1:])])) \
        if len(path) > 1 else 0.0


def eval_r2r_item(dist: Dist, pred_traj: Sequence[Sequence[str]],
                  gt_path: Sequence[str]) -> Dict[str, float]:
    path = flatten_trajectory(pred_traj)
    assert gt_path[0] == path[0], "trajectories must include the start"
    nearest = get_nearest(dist, gt_path[-1], path)
    s: Dict[str, float] = {}
    s["nav_error"] = dist(path[-1], gt_path[-1])
    s["oracle_error"] = dist(nearest, gt_path[-1])
    s["action_steps"] = len(pred_traj) - 1
    s["trajectory_steps"] = len(path) - 1
    s["trajectory_lengths"] = path_length(dist, path)
    gt_lengths = path_length(dist, gt_path)
    s["success"] = float(s["nav_error"] < ERROR_MARGIN)
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    s["oracle_success"] = float(s["oracle_error"] < ERROR_MARGIN)
    return s


def aggregate_r2r(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    m = lambda k: float(np.mean([x[k] for x in per_item]))
    return {
        "action_steps": m("action_steps"),
        "steps": m("trajectory_steps"),
        "lengths": m("trajectory_lengths"),
        "nav_error": m("nav_error"),
        "oracle_error": m("oracle_error"),
        "sr": m("success") * 100,
        "oracle_sr": m("oracle_success") * 100,
        "spl": m("spl") * 100,
    }


def eval_reverie_item(dist: Dist, pred_traj: Sequence[Sequence[str]],
                      pred_objid: Optional[str], gt_path: Sequence[str],
                      gt_objid: Optional[str],
                      goal_viewpoints: Sequence[str]) -> Dict[str, float]:
    """REVERIE success = final vp sees the gt object (reverie.py:156-165)."""
    path = flatten_trajectory(pred_traj)
    assert gt_path[0] == path[0], "trajectories must include the start"
    nearest = get_nearest(dist, gt_path[-1], path)
    s: Dict[str, float] = {}
    s["nav_error"] = dist(path[-1], gt_path[-1])
    s["oracle_error"] = dist(nearest, gt_path[-1])
    s["action_steps"] = len(pred_traj) - 1
    s["trajectory_steps"] = len(path) - 1
    s["trajectory_lengths"] = path_length(dist, path)
    gt_lengths = path_length(dist, gt_path)
    goal_set = set(goal_viewpoints)
    assert goal_set, "gt object must be visible somewhere"
    s["success"] = float(path[-1] in goal_set)
    s["oracle_success"] = float(any(vp in goal_set for vp in path))
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    s["rgs"] = float(str(pred_objid) == str(gt_objid))
    s["rgspl"] = s["rgs"] * gt_lengths / max(s["trajectory_lengths"],
                                             gt_lengths, 0.01)
    return s


def aggregate_reverie(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    out = aggregate_r2r(per_item)
    m = lambda k: float(np.mean([x[k] for x in per_item]))
    out["rgs"] = m("rgs") * 100
    out["rgspl"] = m("rgspl") * 100
    return out


def eval_cvdn_item(dist: Dist, path: Sequence[str], gt_path: Sequence[str],
                   planner_path: Sequence[str],
                   end_panos: Sequence[str]) -> Dict[str, float]:
    """CVDN scorer over the FLAT path (caller flattens; cvdn.py:152,165-207)."""
    start, goal = gt_path[0], gt_path[-1]
    assert start == path[0], "trajectories must include the start"
    planner_goal = planner_path[-1]
    final = path[-1]
    nearest = get_nearest(dist, goal, path)
    nearest_planner = get_nearest(dist, planner_goal, path)
    dist_to_end_start = min(dist(start, p) for p in end_panos)
    dist_to_end_end = min(dist(final, p) for p in end_panos)

    s: Dict[str, float] = {}
    s["nav_errors"] = dist(final, goal)
    s["oracle_errors"] = dist(nearest, goal)
    s["oracle_plan_errors"] = dist(nearest_planner, planner_goal)
    s["dist_to_end_reductions"] = dist_to_end_start - dist_to_end_end
    s["trajectory_lengths"] = path_length(dist, path)
    s["success"] = float(s["nav_errors"] < ERROR_MARGIN)
    gt_lengths = path_length(dist, gt_path)
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    s["shortest_path_lengths"] = dist(start, goal)
    return s


def aggregate_cvdn(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    n = len(per_item)
    num_s = sum(1 for x in per_item if x["nav_errors"] < ERROR_MARGIN)
    num_os = sum(1 for x in per_item if x["oracle_errors"] < ERROR_MARGIN)
    num_ops = sum(1 for x in per_item if x["oracle_plan_errors"] < ERROR_MARGIN)
    m = lambda k: float(np.mean([x[k] for x in per_item]))
    return {
        "lengths": m("trajectory_lengths"),
        "nav_error": m("nav_errors"),
        "oracle_sr": num_os / n * 100,
        "sr": num_s / n * 100,
        "spl": m("spl") * 100,
        "oracle path_success_rate": num_ops / n * 100,
        "dist_to_end_reduction": float(
            sum(x["dist_to_end_reductions"] for x in per_item) / n),
    }


def point_in_polygon(x: float, y: float,
                     poly: Sequence[Sequence[float]]) -> bool:
    """Ray-casting point-in-polygon (replaces shapely, soon.py:189-198).

    Matches shapely `contains` semantics for simple polygons: boundary
    points are NOT contained (even-odd rule; ties on edges are
    don't-care for this metric, angle floats never land exactly)."""
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
            if x < xin:
                inside = not inside
    return inside


def eval_soon_item(dist: Dist, pred_traj: Sequence[Sequence[str]],
                   gt_path: Sequence[str], gt_bboxes: Dict[str, dict],
                   obj_heading: Optional[float],
                   obj_elevation: Optional[float]) -> Dict[str, float]:
    """SOON scorer (soon.py:163-223). gt_bboxes: vp -> normalized bbox
    dict with 'heading'/'elevation' and 'target' corner dict."""
    start_vp, goal_vp = gt_path[0], gt_path[-1]
    path = flatten_trajectory(pred_traj)
    assert gt_path[0] == path[0], "trajectories must include the start"
    nearest = get_nearest(dist, goal_vp, path)

    s: Dict[str, float] = {}
    if path[-1] in gt_bboxes and obj_heading is not None \
            and obj_elevation is not None:
        bb = gt_bboxes[path[-1]]
        s["heading_error"] = math.fabs(bb["heading"] - obj_heading)
        s["elevation_error"] = math.fabs(bb["elevation"] - obj_elevation)
        s["point_det_error"] = math.hypot(bb["heading"] - obj_heading,
                                          bb["elevation"] - obj_elevation)
        t = bb["target"]
        poly = [(t["left_top"]["heading"], t["left_top"]["elevation"]),
                (t["right_top"]["heading"], t["right_top"]["elevation"]),
                (t["right_bottom"]["heading"], t["right_bottom"]["elevation"]),
                (t["left_bottom"]["heading"], t["left_bottom"]["elevation"])]
        s["det_success"] = point_in_polygon(obj_heading, obj_elevation, poly)
    else:
        s["det_success"] = False

    s["action_steps"] = len(pred_traj) - 1
    s["trajectory_steps"] = len(path) - 1
    s["trajectory_lengths"] = path_length(dist, path)
    s["nav_error"] = dist(path[-1], goal_vp)
    s["oracle_error"] = dist(nearest, goal_vp)
    s["success"] = s["nav_error"] < ERROR_MARGIN
    s["oracle_success"] = s["oracle_error"] < ERROR_MARGIN
    s["goal_progress"] = dist(start_vp, goal_vp) - dist(path[-1], goal_vp)
    gt_lengths = dist(gt_path[0], goal_vp)   # NOTE: shortest, not path sum
    s["spl"] = s["success"] * gt_lengths / max(s["trajectory_lengths"],
                                               gt_lengths, 0.01)
    s["det_spl"] = s["det_success"] * gt_lengths / max(s["trajectory_lengths"],
                                                       gt_lengths, 0.01)
    return s


def aggregate_soon(per_item: List[Dict[str, float]]) -> Dict[str, float]:
    out = aggregate_r2r(per_item)
    m = lambda k: float(np.mean([float(x[k]) for x in per_item]))
    out["det_sr"] = m("det_success") * 100
    out["det_spl"] = m("det_spl") * 100
    return out
