"""Navigation evaluation metrics as pure functions.

The port's copy of the R2R scorer of navillm_tpu/data/metrics.py, with
the same names and numerics: ``eval_r2r_item`` <- R2RDataset.eval_dis_item
(reference r2r.py:108-131) and ``aggregate_r2r``. The other tasks'
scorers (REVERIE, CVDN, SOON) come with those tasks.

All scorers take `dist`: a callable (vp_a, vp_b) -> float over the
scan's all-pairs shortest distances (ScanGraph.distance).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

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
