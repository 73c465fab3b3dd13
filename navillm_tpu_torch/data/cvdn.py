"""CVDN dataset for the port (twin of navillm_tpu/data/datasets/cvdn.py;
reference tasks/datasets/cvdn.py).

Cooperative vision-and-dialog navigation on the R2R dataset's machinery:
one sample per dialog, ids cvdn_<sample_idx>_<inst_idx>. The target and the
dialog history become the instruction ("The goal room contains a ...",
then one "Question: ..." or "Answer: ..." line per turn); the path is the
planner's. With path_type "trusted_path" a path that does not end at one
of the end panoramas is replaced by the fewest-hop shortest path to the
nearest of them. ``__getitem__`` cuts the instruction to its first 128
words and writes the cut back into ``alldata`` (so a later pass sees the
cut text, as in JAX), and starts at the start panorama's heading.
``eval_metrics`` scores the flattened path (metrics.eval_cvdn_item: goal
progress as dist_to_end_reduction), and ``save_json`` writes eval.ai's
format.
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Optional

from ..sim.env import EpisodeBatch
from . import metrics as M
from .r2r import R2RDataset

# the instruction's word limit (reference cvdn.py:104-108)
MAX_WORDS = 128


class CVDNDataset(R2RDataset):
    name = "cvdn"

    def __init__(self, anno_file, world, max_datapoints: Optional[int] = None,
                 path_type: str = "trusted_path", **kw):
        super().__init__(anno_file, world, **kw)
        if max_datapoints:
            self.alldata = self.alldata[: max_datapoints]
        if path_type == "trusted_path":
            for item in self.alldata:
                if "end_panos" in item and \
                        item["path"][-1] not in item["end_panos"]:
                    best = None
                    for end_vp in item["end_panos"]:
                        p = self.shortest_path(item["scan"],
                                               item["start_pano"]["pano"],
                                               end_vp)
                        if best is None or len(p) < len(best):
                            best = p
                    item["path"] = best

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        with open(str(anno_file)) as f:
            data = json.load(f)
        new_data = []
        for sample_idx, item in enumerate(data):
            new_item = dict(item)
            new_item["heading"] = None
            new_item["path"] = item.get("planner_path") or \
                [item["start_pano"]["pano"]]
            instruction = "The goal room contains a {target}.\n".format(
                target=item["target"])
            sentences = []
            for turn in item["dialog_history"]:
                msg = turn["message"]
                if msg[-1] not in "?.":
                    msg = msg + "."
                if turn["role"] == "navigator":
                    sentences.append("Question: " + msg + "\n")
                elif turn["role"] == "oracle":
                    sentences.append("Answer: " + msg + "\n")
                else:
                    raise NotImplementedError(turn["role"])
            instruction += "".join(sentences)
            if instruction.endswith("\n"):
                instruction = instruction[:-1]
            new_item["instruction"] = instruction
            new_item["path_id"] = item["inst_idx"]
            new_item["raw_idx"] = None
            new_item["instr_encoding"] = None
            new_item["data_type"] = "cvdn"
            new_item["sample_idx"] = sample_idx
            new_item["instr_id"] = "cvdn_{}_{}".format(sample_idx,
                                                       new_item["path_id"])
            new_data.append(new_item)
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: x for x in new_data}
        return new_data, gt_trajs

    def __getitem__(self, index):
        item = copy.deepcopy(self.alldata[index])
        item["heading"] = item["start_pano"]["heading"]
        words = item["instruction"].split()
        if len(words) > MAX_WORDS:
            item["instruction"] = " ".join(words[:MAX_WORDS])
            self.alldata[index]["instruction"] = item["instruction"]
        env = EpisodeBatch(self.world, 1)
        env.new_episodes([item["scan"]], [item["path"][0]], [item["heading"]])
        observations = self.get_obs(items=[item], env=env,
                                    data_type=item["data_type"])[0]
        return {"sample_idx": index, "instr_id": item["instr_id"],
                "observations": observations, "env": env, "item": item,
                "data_type": item["data_type"]}

    def eval_metrics(self, preds, logger: Optional[Any], name: str):
        """(aggregate CVDN metrics, per-item metric lists)."""
        if logger is not None:
            logger.info("eval %d predictions" % len(preds))
        per_item = []
        metrics = defaultdict(list)
        for item in preds:
            instr_id = item["instr_id"]
            gt_item = self.gt_trajs[instr_id]
            path = M.flatten_trajectory(item["trajectory"])
            scores = M.eval_cvdn_item(self.dist_fn(gt_item["scan"]), path,
                                      gt_item["path"],
                                      gt_item["planner_path"],
                                      gt_item["end_panos"])
            per_item.append(scores)
            for k, v in scores.items():
                metrics[k].append(v)
            metrics["instr_id"].append(instr_id)
        return M.aggregate_cvdn(per_item), metrics

    def save_json(self, results, path, item_metrics=None):
        """eval.ai format (reference cvdn.py:209-216)."""
        for item in results:
            item["trajectory"] = [[y, 0, 0] for x in item["trajectory"]
                                  for y in x]
            item["instr_idx"] = item["inst_idx"] = \
                int(item["instr_id"].split("_")[-1])
        with open(path, "w") as f:
            json.dump(results, f)
