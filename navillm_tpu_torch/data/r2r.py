"""R2R dataset for the port (evaluation and training splits).

Follows navillm_tpu/data/datasets/mp3d_base.py (annotations, __getitem__,
collate_batch, make_candidate, get_obs) and r2r.py (instruction split,
SR/SPL eval) for the R2R navigation task. It builds on the port's own
host layer (its copies of the sim, the feature DBs and the metrics).
Instead of a task config it takes the annotation file of its split and
a WorldModel; ``training`` names the split "train", as mp3d_base does,
and changes nothing else for R2R (otherwise the split is the file's
stem).
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..sim.env import EpisodeBatch, WorldModel
from ..sim.geometry import all_point_angle_features, angle_feature
from . import metrics as M


class R2RDataset:
    name = "r2r"

    def __init__(self, anno_file, world: WorldModel,
                 angle_feat_size: int = 4, debug: bool = False,
                 training: bool = False):
        self.angle_feat_size = angle_feat_size
        self.split = "train" if training else Path(anno_file).stem
        self.alldata, self.gt_trajs = self.load_data(anno_file, debug=debug)
        self.scans = sorted({x["scan"] for x in self.alldata})
        self.world = world
        for scan in self.scans:
            self.world.load_scan(scan)
        # precomputed [36, 36, A] angle-feature table
        self.angle_feature = all_point_angle_features(angle_feat_size)
        self.feat_db = None

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        """One sample per instruction, ids r2r_<path_id>_<j>."""
        with open(str(anno_file)) as f:
            data = json.load(f)
        new_data = []
        for i, item in enumerate(data):
            for j, instr in enumerate(item["instructions"]):
                new_item = dict(item)
                new_item["raw_idx"] = i
                new_item["sample_idx"] = len(new_data)
                new_item["instr_id"] = "r2r_{}_{}".format(item["path_id"], j)
                new_item["instruction"] = instr
                del new_item["instructions"]
                if "instr_encodings" in new_item:
                    new_item["instr_encoding"] = \
                        item["instr_encodings"][j][:max_instr_len]
                    del new_item["instr_encodings"]
                new_item["data_type"] = "r2r"
                new_data.append(new_item)
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: (x["scan"], x["path"])
                    for x in new_data if len(x["path"]) > 1}
        return new_data, gt_trajs

    def init_feat_db(self, feat_db):
        self.feat_db = feat_db

    def dist_fn(self, scan: str):
        return self.world.graph(scan).distance

    def __len__(self):
        return len(self.alldata)

    def __getitem__(self, index):
        item = copy.deepcopy(self.alldata[index])
        env = EpisodeBatch(self.world, 1)
        env.new_episodes([item["scan"]], [item["path"][0]],
                         [item.get("heading") or 0.0])
        observations = self.get_obs(items=[item], env=env,
                                    data_type=item["data_type"])[0]
        return {"sample_idx": index, "instr_id": item["instr_id"],
                "observations": observations, "env": env, "item": item,
                "data_type": item["data_type"]}

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        """Identity list-collate."""
        data_dict = defaultdict(list)
        for sample in batch_list:
            for k, v in sample.items():
                data_dict[k].append(v)
        ret = dict(data_dict)
        ret["batch_size"] = len(batch_list)
        return ret

    def make_candidate(self, feature: np.ndarray, scan: str, viewpoint: str,
                       view_index: int) -> List[Dict[str, Any]]:
        """Candidate dicts with relative angles + per-candidate features."""
        base_heading = (view_index % 12) * np.radians(30)
        base_elevation = (view_index // 12 - 1) * np.radians(30)
        out = []
        for c in self.world.candidates(scan, viewpoint):
            heading = c.normalized_heading - base_heading
            elevation = c.normalized_elevation - base_elevation
            ang = angle_feature(heading, elevation, self.angle_feat_size)
            out.append({
                "heading": heading,
                "elevation": elevation,
                "normalized_heading": c.normalized_heading,
                "normalized_elevation": c.normalized_elevation,
                "scanId": scan,
                "viewpointId": c.viewpoint_id,
                "pointId": c.point_id,
                "distance": c.distance,
                "idx": c.index,
                "feature": np.concatenate((feature[c.point_id], ang), -1),
                "position": c.position,
            })
        return out

    def get_obs(self, items, env: EpisodeBatch, data_type=None):
        obs = []
        for i, state in enumerate(env.get_states()):
            item = items[i]
            feature = self.feat_db.get_image_feature(state.scan,
                                                     state.viewpoint)
            candidate = self.make_candidate(feature, state.scan,
                                            state.viewpoint, state.view_index)
            feature = np.concatenate(
                (feature, self.angle_feature[state.view_index]), -1)
            obs.append({
                "instr_id": item["instr_id"],
                "scan": state.scan,
                "viewpoint": state.viewpoint,
                "viewIndex": state.view_index,
                "position": tuple(state.position),
                "heading": state.heading,
                "elevation": state.elevation,
                "feature": feature,
                "candidate": candidate,
                "instruction": item.get("instruction"),
                "gt_path": item["path"],
                "path_id": item.get("path_id"),
                "distance": 0,
            })
        return obs

    def eval_metrics(self, preds, logger: Optional[Any], name: str):
        """(aggregate SR/SPL/... in percent, per-item metric lists)."""
        per_item = []
        metrics = defaultdict(list)
        for item in preds:
            scan, gt_traj = self.gt_trajs[item["instr_id"]]
            scores = M.eval_r2r_item(self.dist_fn(scan), item["trajectory"],
                                     gt_traj)
            per_item.append(scores)
            for k, v in scores.items():
                metrics[k].append(v)
            metrics["instr_id"].append(item["instr_id"])
        return M.aggregate_r2r(per_item), metrics
