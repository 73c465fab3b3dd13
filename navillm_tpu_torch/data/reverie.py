"""REVERIE dataset for the port (twin of
navillm_tpu/data/datasets/reverie.py; reference tasks/datasets/reverie.py).

Remote object grounding on the R2R dataset's machinery: one sample per
instruction, ids reverie_<path_id>_<objId>_<j>; the visibility map of
the bbox file (``load_obj2vps``: scan_objId -> the viewpoints that see the
object) gives each sample its end viewpoints, and in training
(``multi_endpoints``) ``preprocess_item`` resamples the path to one of them
drawn from numpy's global RNG, as JAX does. ``get_object_info`` adds the
viewpoint's objects from the object feature DB to each observation, and
``eval_metrics`` scores navigation and the grounded object (RGS, RGSPL).
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Optional

import numpy as np

from . import metrics as M
from .r2r import R2RDataset


class REVERIEDataset(R2RDataset):
    name = "reverie"

    def __init__(self, anno_file, world, bbox_file, max_objects=None,
                 multi_endpoints=1, **kw):
        self.load_obj2vps(bbox_file)
        super().__init__(anno_file, world, **kw)
        self.max_objects = max_objects
        self.multi_endpoints = multi_endpoints

    def load_obj2vps(self, bbox_file):
        """scan_objid -> viewpoints where visible (reverie.py:86-98)."""
        obj2vps = {}
        with open(str(bbox_file)) as f:
            bbox_data = json.load(f)
        for scanvp, value in bbox_data.items():
            # maxsplit=1: MP3D scan ids never contain '_' but synthetic
            # viewpoint ids do
            scan, vp = scanvp.split("_", 1)
            for objid, objinfo in value.items():
                if objinfo["visible_pos"]:
                    obj2vps.setdefault(scan + "_" + objid, []).append(vp)
        self.obj2vps = obj2vps
        return obj2vps

    def preprocess_item(self, item):
        """Multi-endpoint path resampling during training (reverie.py:22-42)."""
        if self.split != "train" or "end_vps" not in item or \
                not self.multi_endpoints:
            return item
        start_vp = item["path"][0]
        end_vp = item["end_vps"][np.random.randint(len(item["end_vps"]))]
        item = copy.deepcopy(item)
        item["path"] = self.shortest_path(item["scan"], start_vp, end_vp)
        return item

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        with open(str(anno_file)) as f:
            data = json.load(f)
        new_data = []
        sample_index = 0
        for i, item in enumerate(data):
            for j, instr in enumerate(item["instructions"]):
                new_item = dict(item)
                if "objId" in item:
                    new_item["instr_id"] = "%s_%s_%s_%d" % (
                        "reverie", str(item["path_id"]), str(item["objId"]), j)
                else:
                    new_item["path_id"] = item["id"]
                    new_item["instr_id"] = "%s_%s_%d" % ("reverie",
                                                         item["id"], j)
                    new_item["objId"] = None
                new_item["sample_idx"] = sample_index
                new_item["instruction"] = instr
                del new_item["instructions"]
                new_item["data_type"] = "reverie"
                new_item["raw_idx"] = None
                new_item["instr_encoding"] = None
                if item.get("objId") is not None:
                    new_item["end_vps"] = self.obj2vps[
                        "%s_%s" % (item["scan"], item["objId"])]
                new_data.append(new_item)
                sample_index += 1
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: (x["scan"], x["path"], x["objId"])
                    for x in new_data if x.get("objId") is not None}
        return new_data, gt_trajs

    def eval_metrics(self, preds, logger: Optional[Any], name: str):
        """(aggregate navigation and RGS/RGSPL metrics in percent, per-item
        metric lists)."""
        if logger is not None:
            logger.info("eval %d predictions" % len(preds))
        per_item = []
        metrics = defaultdict(list)
        for item in preds:
            instr_id = item["instr_id"]
            scan, gt_traj, gt_objid = self.gt_trajs[instr_id]
            scores = M.eval_reverie_item(
                self.dist_fn(scan), item["trajectory"],
                item.get("pred_objid"), gt_traj, gt_objid,
                self.obj2vps["%s_%s" % (scan, str(gt_objid))])
            per_item.append(scores)
            for k, v in scores.items():
                metrics[k].append(v)
            metrics["instr_id"].append(instr_id)
        return M.aggregate_reverie(per_item), metrics

    def get_object_info(self, item, state):
        """The viewpoint's objects from the object DB (reverie.py:170-193)."""
        obj_img_fts, obj_ang_fts, obj_box_fts, obj_ids = \
            self.obj_feat_db.get_object_feature(
                state.scan, state.viewpoint, state.heading, state.elevation,
                self.angle_feat_size, max_objects=self.max_objects)
        gt_end_vps = item.get("end_vps", [])
        gt_obj_id = item["objId"] if state.viewpoint in gt_end_vps else None
        return {
            "obj_img_fts": obj_img_fts,
            "obj_ang_fts": obj_ang_fts,
            "obj_box_fts": obj_box_fts,
            "obj_ids": obj_ids,
            "gt_end_vps": gt_end_vps,
            "gt_obj_id": gt_obj_id,
        }

    def save_json(self, results, path, item_metrics=None):
        """Leaderboard format: predObjId beside the flat path."""
        if item_metrics is not None:
            for k in item_metrics:
                for item, v in zip(results, item_metrics[k]):
                    item[k] = v
        for item in results:
            item["instr_id"] = "_".join(item["instr_id"].split("_")[1:])
            item["trajectory"] = [[y, 0, 0] for x in item["trajectory"]
                                  for y in x]
            item["predObjId"] = int(item["pred_objid"]) \
                if item.get("pred_objid") is not None else 0
        with open(path, "w") as f:
            json.dump(results, f)
