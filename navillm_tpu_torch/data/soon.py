"""SOON dataset for the port (twin of navillm_tpu/data/datasets/soon.py;
reference tasks/datasets/soon.py).

jsonlines annotations, parsed with the stdlib: one sample per instruction
(its "full" text), ids soon_<i>_<path_id>_<j>, the bboxes keyed by the
viewpoint that sees the target. In training every sample starts at a random
heading and, with ``multi_endpoints``, walks to a random one of its end
viewpoints, both drawn from numpy's global RNG in JAX's order; evaluation
starts at heading 1.52. ``get_object_info`` adds the viewpoint's objects
with their normalized directions, and ``eval_metrics`` scores navigation,
goal progress and detection (the predicted direction inside the target's
polygon, metrics.point_in_polygon).
"""
from __future__ import annotations

import copy
import json
import math
from collections import defaultdict
from typing import Any, Optional

import numpy as np

from ..sim.env import EpisodeBatch
from . import metrics as M
from .r2r import R2RDataset


def _normalize_bboxes(bboxes):
    """Normalize bbox headings/elevations to [0,1) (soon.py:112-128)."""
    out = {}
    for vp, bbox in bboxes.items():
        b = copy.deepcopy(bbox)
        b["heading"] = b["target"]["center"]["heading"] / (2 * math.pi)
        b["elevation"] = (b["target"]["center"]["elevation"] + math.pi) \
            / (2 * math.pi)
        for corner in ("left_top", "right_top", "left_bottom", "right_bottom"):
            b["target"][corner]["heading"] = \
                b["target"][corner]["heading"] / (2 * math.pi)
            b["target"][corner]["elevation"] = \
                (b["target"][corner]["elevation"] + math.pi) / (2 * math.pi)
        out[vp] = b
    return out


class SOONDataset(R2RDataset):
    name = "soon"

    def __init__(self, anno_file, world, max_objects=None, training=False,
                 **kw):
        super().__init__(anno_file, world, training=training, **kw)
        self.training = training
        self.max_objects = max_objects
        self.multi_endpoints = training

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        data = []
        with open(str(anno_file)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                item = json.loads(line)
                item["end_image_ids"] = [x["image_id"] for x in item["bboxes"]]
                item["image_id_to_obj_label"] = {
                    x["image_id"]: x.get("pseudo_label", None)
                    for x in item["bboxes"]}
                item["bboxes"] = {b["image_id"]: b for b in item["bboxes"]}
                data.append(item)

        new_data = []
        sample_index = 0
        for i, item in enumerate(data):
            for j, instr in enumerate(item["instructions"]):
                new_item = copy.deepcopy(item)
                new_item["instr_id"] = "soon_{}_{}_{}".format(
                    i, item["path_id"], j)
                new_item["instruction"] = instr["full"]
                if "instr_encodings" in item:
                    new_item["instr_encoding"] = \
                        item["instr_encodings"][j]["full"][:100]
                    del new_item["instr_encodings"]
                del new_item["instructions"]
                new_item["sample_idx"] = sample_index
                new_item["raw_idx"] = None
                new_item["heading"] = 0.0
                new_item["data_type"] = "soon"
                new_data.append(new_item)
                sample_index += 1
        if debug:
            new_data = new_data[:20]

        gt_trajs = {x["instr_id"]: copy.deepcopy(x) for x in new_data
                    if "bboxes" in x}
        for value in gt_trajs.values():
            value["bboxes"] = _normalize_bboxes(value["bboxes"])
        return new_data, gt_trajs

    def __getitem__(self, index):
        item = copy.deepcopy(self.alldata[index])
        if self.training:
            # random start heading + multi-endpoint resample (soon.py:75-97)
            item["heading"] = np.random.rand() * np.pi * 2
            end_vp = item["path"][-1]
            if self.multi_endpoints:
                end_vp = item["end_image_ids"][
                    np.random.randint(len(item["end_image_ids"]))]
            item["path"] = self.shortest_path(item["scan"], item["path"][0],
                                              end_vp)
        else:
            item["heading"] = 1.52
        item["elevation"] = 0

        env = EpisodeBatch(self.world, 1)
        env.new_episodes([item["scan"]], [item["path"][0]], [item["heading"]])
        observations = self.get_obs(items=[item], env=env,
                                    data_type=item["data_type"])[0]
        return {"sample_idx": index, "instr_id": item["instr_id"],
                "observations": observations, "env": env, "item": item,
                "data_type": item["data_type"]}

    def eval_metrics(self, preds, logger: Optional[Any], name: str):
        """(aggregate navigation, goal-progress and detection metrics in
        percent, per-item metric lists)."""
        if logger is not None:
            logger.info("eval %d predictions" % len(preds))
        per_item = []
        metrics = defaultdict(list)
        for item in preds:
            instr_id = item["instr_id"]
            gt_item = self.gt_trajs[instr_id]
            direction = item.get("pred_obj_direction")
            oh = direction[0] if direction is not None else None
            oe = direction[1] if direction is not None else None
            scores = M.eval_soon_item(self.dist_fn(gt_item["scan"]),
                                      item["trajectory"], gt_item["path"],
                                      gt_item["bboxes"], oh, oe)
            per_item.append(scores)
            for k, v in scores.items():
                metrics[k].append(v)
            metrics["instr_id"].append(instr_id)
        return M.aggregate_soon(per_item), metrics

    def get_object_info(self, item, state):
        """The viewpoint's objects with their normalized directions
        (soon.py:225-252)."""
        obj_img_fts, obj_ang_fts, obj_box_fts, obj_directions, obj_ids = \
            self.obj_feat_db.get_object_feature(
                state.scan, state.viewpoint, state.heading, state.elevation,
                self.angle_feat_size, max_objects=self.max_objects)
        gt_end_vps = item.get("end_image_ids", [])
        gt_obj_id = None
        if state.viewpoint in gt_end_vps:
            pseudo = item["image_id_to_obj_label"][state.viewpoint]
            if pseudo is not None:
                gt_obj_id = pseudo["obj_id"]
        return {
            "obj_img_fts": obj_img_fts,
            "obj_ang_fts": obj_ang_fts,
            "obj_box_fts": obj_box_fts,
            "obj_directions": obj_directions,
            "obj_ids": obj_ids,
            "gt_end_vps": gt_end_vps,
            "gt_obj_id": gt_obj_id,
        }

    def save_json(self, results, path, item_metrics=None):
        """Leaderboard format (soon.py:254-269)."""
        new_results = []
        for item in results:
            instr_id = int(item["instr_id"].split("_")[2].split("-")[0])
            d = item.get("pred_obj_direction")
            new_results.append({
                "instr_id": instr_id,
                "trajectory": [{
                    "path": [[y, 0, 0] for x in item["trajectory"] for y in x],
                    "obj_heading": [d[0] if d is not None else 0],
                    "obj_elevation": [d[1] if d is not None else 0],
                }],
            })
        with open(path, "w") as f:
            json.dump(new_results, f)
